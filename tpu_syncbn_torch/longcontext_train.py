"""longcontext_train.py — long-context causal LM training with the sequence
sharded across processes, on the PyTorch port: the counterpart of
``examples/longcontext_train.py``.

    python -m tpu_syncbn_torch.longcontext_train                    # one GPU
    python -m tpu_syncbn_torch.longcontext_train --impl ulysses \\
        --local-impl flash --local-backward pallas                  # every attention kernel
    python -m tpu_syncbn_torch.launch --nproc-per-node 4 \\
        tpu_syncbn_torch/longcontext_train.py -- --impl ring        # 4 GPUs
    python -m tpu_syncbn_torch.longcontext_train --simulate 2 --device cpu

It takes the example's flags and adds ``--device`` (default ``cuda``; raises
without a card). Each of the N processes holds its contiguous chunk of
``--seq-per-device`` tokens of every sequence of the same global batch
(global L = N × that), and attention is the only cross-process operation:

* ``--impl ring``: ring attention (the dense attention at N = 1);
* ``--impl ulysses``: Ulysses attention, whose local attention over the
  whole sequence for N-th of the heads is dense (``--local-impl oracle``)
  or the flash kernels (``--local-impl flash``) with the blockwise-scan
  backward (``--local-backward xla``) or the dK/dV and dQ kernels
  (``--local-backward pallas``).

The loss is the global token mean (each process's cross-entropy sum,
all-reduced, over batch × global L); the gradients are all-reduced once
after the backward, and every process starts from the same seeded
parameters, so they stay equal. ``--simulate N`` runs N gloo processes on
the CPU through the port's launcher (as ``launch --simulate-chips N``;
pass ``--device cpu``). The task is the example's learnable periodic token
sequences, sampled by the same numpy code, so the batches are bit for bit
the example's; the loss must fall.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from tpu_syncbn_torch import runtime
from tpu_syncbn_torch.models.transformer import init_transformer_lm
from tpu_syncbn_torch.parallel import collectives


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--simulate", type=int, default=0,
                   help="run this many gloo processes on the CPU (the seq-shard "
                        "count) through the launcher; 0 = this process alone "
                        "or the launcher's world")
    p.add_argument("--impl", choices=["ring", "ulysses"], default="ring")
    p.add_argument("--local-impl", choices=["oracle", "flash"], default="oracle",
                   help="Ulysses local attention backend (flash = the fused "
                        "CUDA kernel)")
    p.add_argument("--local-backward", choices=["xla", "pallas"], default="xla",
                   help="flash backward (xla = blockwise scan, pallas = the "
                        "dK/dV and dQ kernels)")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-per-device", type=int, default=64)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def attention_kwargs(impl: str, local_impl: str, local_backward: str) -> dict:
    """The LM's attention arguments that the example's flags select; the
    caller adds the sequence group."""
    if impl != "ulysses" and (local_impl == "flash" or local_backward != "xla"):
        raise SystemExit("--local-impl/--local-backward apply to --impl "
                         "ulysses only (the library API rejects the "
                         "combination too)")
    if impl == "ulysses" and local_impl == "flash":
        return dict(attn_impl=impl, local_impl="flash", local_backward=local_backward)
    return dict(attn_impl=impl)  # as the example: --local-backward goes with flash only


def periodic_batches(seed: int, batch: int, length: int, vocab: int):
    """The example's sampler: token[t] = (t * stride + phase) % vocab with
    a per-sample (stride, phase), from ``RandomState(seed + 1)``; yields
    (batch, length + 1) int32 arrays."""
    rng = np.random.RandomState(seed + 1)
    while True:
        stride = rng.randint(1, 7, size=(batch, 1))
        phase = rng.randint(0, vocab, size=(batch, 1))
        t = np.arange(length + 1)[None, :]
        yield ((t * stride + phase) % vocab).astype(np.int32)


def local_chunk(toks: np.ndarray, rank: int, length: int) -> tuple[np.ndarray, np.ndarray]:
    """This rank's (inputs, labels): positions ``[rank·length, (rank+1)·length)``
    of a (batch, L + 1) token array, and the next tokens."""
    lo = rank * length
    return toks[:, lo:lo + length], toks[:, lo + 1:lo + length + 1]


def train_step(model, opt, inputs: torch.Tensor, labels: torch.Tensor, *,
               group=None, **attn) -> torch.Tensor:
    """One Adam step on the global token-mean cross-entropy; ``inputs`` and
    ``labels`` are this rank's chunk of every sequence, ``attn`` the LM's
    attention arguments. Every rank's cross-entropy sum is divided by the
    global token count, the gradients are summed across ``group`` once,
    and the loss returned (a device scalar, not synchronized) is the sum of
    every rank's share."""
    opt.zero_grad(set_to_none=True)
    logits = model(inputs, group=group, **attn)
    total = labels.numel() * collectives.world_size(group)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum") / total
    loss.backward()
    collectives.psum_flat_([p.grad for p in model.parameters() if p.grad is not None],
                           group)
    opt.step()
    return collectives.psum(loss.detach(), group)


def _simulate(args, argv) -> int:
    """Run this script in ``--simulate`` gloo processes on the CPU under the
    port's launcher; returns its exit code."""
    from tpu_syncbn_torch.runtime import launcher

    if args.device != "cpu":
        raise SystemExit("--simulate runs CPU processes: pass --device cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    i = next(j for j, a in enumerate(argv) if a.split("=")[0] == "--simulate")
    del argv[i:i + (1 if "=" in argv[i] else 2)]
    return launcher.main(["--simulate-chips", str(args.simulate),
                          os.path.abspath(__file__), "--", *argv])


def main(argv=None):
    args = parse_args(argv)
    if args.simulate:
        return _simulate(args, argv)
    attn = attention_kwargs(args.impl, args.local_impl, args.local_backward)
    device = runtime.initialize(args.device)
    n = runtime.process_count()
    if args.n_heads % n:
        raise SystemExit(f"--n-heads {args.n_heads} must divide by {n} (Ulysses "
                         "shards heads; ring is fine either way but keep "
                         "configs comparable)")
    group = tdist.group.WORLD if n > 1 else collectives.ALONE
    rank = runtime.process_index()
    L_local = args.seq_per_device
    L = L_local * n  # global sequence length
    model = init_transformer_lm(
        args.seed, vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=L, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    batches = periodic_batches(args.seed, args.batch, L, args.vocab)
    first = last = None
    for it in range(args.steps):
        inputs, labels = (torch.from_numpy(x).to(device)
                          for x in local_chunk(next(batches), rank, L_local))
        loss = float(train_step(model, opt, inputs, labels, group=group, **attn))
        first = loss if first is None else first
        last = loss
        if it % 10 == 0 or it == args.steps - 1:
            runtime.master_print(f"step {it:4d}  loss {loss:.4f}")
    runtime.master_print(
        f"done: {args.impl}"
        + (f"+{args.local_impl}" if args.impl == "ulysses" else "")
        + f" over {n} seq shard{'s' if n > 1 else ''}, global L={L}: "
        f"loss {first:.3f} -> {last:.3f}")
    runtime.shutdown()
    if not last < first:
        raise SystemExit("loss did not decrease — training is broken")


if __name__ == "__main__":
    sys.exit(main())

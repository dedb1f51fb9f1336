"""longcontext_train.py — long-context causal LM training on the PyTorch
port, the counterpart of ``examples/longcontext_train.py`` at one device.

    python -m tpu_syncbn_torch.longcontext_train                    # one GPU
    python -m tpu_syncbn_torch.longcontext_train --impl ulysses \\
        --local-impl flash --local-backward pallas                  # every attention kernel
    python -m tpu_syncbn_torch.longcontext_train --device cpu --steps 30

It takes the example's flags and defaults and adds ``--device`` (default
``cuda``; raises without a card). The example shards the sequence over a
``seq`` mesh axis; at one device its schemes reduce to one attention over
the full sequence, and so do they here:

* ``--impl ring``: the dense single-device attention;
* ``--impl ulysses``: its local attention — dense (``--local-impl
  oracle``), or the flash kernels (``--local-impl flash``) with the
  blockwise-scan backward (``--local-backward xla``) or the dK/dV and dQ
  kernels (``--local-backward pallas``).

More than one process raises: sharding the sequence waits for the
multi-GPU slice of the port. The task is the example's learnable periodic
token sequences, sampled by the same numpy code, so the batches are bit for
bit the example's; the loss (mean token cross-entropy) must fall.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_syncbn_torch import runtime
from tpu_syncbn_torch.models.transformer import init_transformer_lm


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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


def attn_impl(impl: str, local_impl: str, local_backward: str) -> Optional[str]:
    """The LM's ``attn_impl`` that the example's flags run at one device."""
    if impl != "ulysses" and (local_impl == "flash" or local_backward != "xla"):
        raise SystemExit("--local-impl/--local-backward apply to --impl "
                         "ulysses only (the library API rejects the "
                         "combination too)")
    if local_impl != "flash":
        return None  # as the example: --local-backward goes with flash only
    return "flash_pallas_bwd" if local_backward == "pallas" else "flash"


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


def train_step(model, opt, inputs: torch.Tensor, labels: torch.Tensor, *,
               attn_impl: Optional[str]) -> torch.Tensor:
    """One Adam step on the mean token cross-entropy; returns the loss (a
    device scalar, not synchronized)."""
    opt.zero_grad(set_to_none=True)
    logits = model(inputs, attn_impl=attn_impl)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None):
    args = parse_args(argv)
    impl = attn_impl(args.impl, args.local_impl, args.local_backward)
    device = runtime.initialize(args.device)
    n = runtime.process_count()
    if n > 1:
        raise SystemExit(
            f"{n} processes: sharding the sequence across devices waits for "
            "the multi-GPU slice of the port; run one process")
    L = args.seq_per_device
    model = init_transformer_lm(
        args.seed, vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=L, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    batches = periodic_batches(args.seed, args.batch, L, args.vocab)
    first = last = None
    for it in range(args.steps):
        toks = torch.from_numpy(next(batches)).to(device)
        loss = float(train_step(model, opt, toks[:, :L], toks[:, 1:],
                                attn_impl=impl))
        first = loss if first is None else first
        last = loss
        if it % 10 == 0 or it == args.steps - 1:
            runtime.master_print(f"step {it:4d}  loss {loss:.4f}")
    runtime.master_print(
        f"done: {args.impl}"
        + (f"+{args.local_impl}" if args.impl == "ulysses" else "")
        + f" over 1 seq shard, global L={L}: loss {first:.3f} -> {last:.3f}")
    if not last < first:
        raise SystemExit("loss did not decrease — training is broken")


if __name__ == "__main__":
    sys.exit(main())

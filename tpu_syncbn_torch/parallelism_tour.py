"""parallelism_tour.py — one runnable pass over every sharding strategy the
port ships, each checked against its unsharded oracle (the port of
``examples/parallelism_tour.py``).

DP + SyncBN (the reference's strategy), group-scoped SyncBN, ZeRO, ring /
zigzag / Ulysses sequence parallelism, expert parallelism, tensor
parallelism and pipeline parallelism, on tiny shapes, with one PASS or
FAIL line a mode (the JAX tour's numbering and tolerances). Every rank
makes the same global arrays from one seed and works on its share; an
error is the largest over the ranks. A FAIL exits non-zero.

Under the launcher on the CPU (4 processes over gloo):

    python -m tpu_syncbn_torch.launch --simulate-chips 4 tpu_syncbn_torch/parallelism_tour.py -- --device cpu

or on the card(s) the launcher finds (``--device cuda``, the default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from tpu_syncbn_torch import models, nn, parallel, runtime
from tpu_syncbn_torch.parallel import collectives
from tpu_syncbn_torch.parallel.sequence import _single_device_attention
from tpu_syncbn_torch.parallel.tensor import gelu, shard_columns, shard_rows


def _world_max(x: float, group, device) -> float:
    return float(collectives.pmax(torch.tensor(x, device=device), group))


def check(name, got, want, group, device, atol=2e-4):
    """PASS when the largest |got − want| over every rank is within atol."""
    err = float((torch.as_tensor(got).float().cpu()
                 - torch.as_tensor(want).float().cpu()).abs().max())
    err = _world_max(err, group, device)
    status = "PASS" if err <= atol else "FAIL"
    runtime.master_print(f"  [{status}] {name:34s} max|err| = {err:.2e}")
    if err > atol:
        raise SystemExit(f"{name} diverged from its oracle")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = runtime.initialize(args.device)
    n, rank = runtime.process_count(), runtime.process_index()
    group = torch.distributed.group.WORLD if n > 1 else None
    runtime.master_print(f"parallelism tour over {n} {device.type} process(es)")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def mine(a, axis=0):
        """This rank's block of ``a`` along ``axis``."""
        size = a.shape[axis] // n
        return a.narrow(axis, rank * size, size)

    # -- 1. DP + SyncBN (the reference's strategy) ------------------------
    def loss_fn(m, batch):
        x, y = batch
        return F.cross_entropy(m(x).float(), y.long())

    x = t(rng.standard_normal((2 * n, 8, 8, 3)).astype(np.float32))
    y = t(rng.integers(0, 10, (2 * n,)).astype(np.int32))

    def dp_step_loss(group_size=None, zero=False):
        # identical init and data every call: only the BN sync scope varies
        m = nn.convert_sync_batchnorm(
            models.resnet18(num_classes=10, small_input=True, device=device,
                            generator=torch.Generator().manual_seed(0)),
            group_size=group_size)
        d = parallel.DataParallel(m, torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
                                  loss_fn, device=device, zero=zero)
        return float(d.train_step((mine(x), mine(y))).loss)

    out_loss = dp_step_loss()
    # the ZeRO check compares against this run, so a shared defect would
    # pass both; at minimum the loss must be finite
    if not np.isfinite(out_loss):
        runtime.master_print(f"  [FAIL] DP + SyncBN loss = {out_loss}")
        raise SystemExit(1)
    runtime.master_print(f"  [PASS] {'DP + SyncBN':34s} loss = {out_loss:.4f}")

    # -- 1b. group-scoped SyncBN (process-group partitions) ---------------
    if n >= 2:
        # the single-group partition takes the partition code path but must
        # reproduce full-world sync bit for bit
        check("full-partition SyncBN ≡ full sync", dp_step_loss((tuple(range(n)),)),
              out_loss, group, device, atol=0.0)
        # interleaved halves sync separately: the statistics must change
        loss_g = dp_step_loss((tuple(range(0, n, 2)), tuple(range(1, n, 2))))
        distinct = bool(np.isfinite(loss_g)) and loss_g != out_loss
        runtime.master_print(
            f"  [{'PASS' if distinct else 'FAIL'}] {'grouped SyncBN (rank partition)':34s} "
            f"loss = {loss_g:.4f} (≠ full-sync {out_loss:.4f})")
        if not distinct:
            raise SystemExit(1)
    else:
        runtime.master_print("  [SKIP] grouped SyncBN (needs >= 2 processes)")

    # -- 2. ZeRO: sharded update and optimizer state ----------------------
    check("ZeRO step ≡ replicated step", dp_step_loss(zero=True), out_loss, group, device,
          atol=1e-5)

    # -- 3. sequence parallelism: ring + Ulysses attention ----------------
    # every dimension scales with the process count (Ulysses needs heads
    # divisible by the group size)
    B, L, H, D = 2, 8 * n, 2 * n, 16
    q, k, v = (t(rng.standard_normal((B, L, H, D)).astype(np.float32)) for _ in range(3))
    oracle = _single_device_attention(q, k, v, causal=True, scale=None)
    for impl in ("ring", "ring_zigzag", "ulysses"):
        got = parallel.sharded_self_attention(group, q, k, v, causal=True, impl=impl)
        check(f"{impl} attention ≡ full attention", got, oracle, group, device)

    # -- 4. expert parallelism: Switch MoE --------------------------------
    T, Dm, Hm = 8, 8, 16
    xe = t(rng.standard_normal((n * T, Dm)).astype(np.float32))
    router = t(rng.standard_normal((Dm, n)).astype(np.float32))
    w_in = t(rng.standard_normal((n, Dm, Hm)).astype(np.float32) * 0.1)
    w_out = t(rng.standard_normal((n, Hm, Dm)).astype(np.float32) * 0.1)
    ye, _ = parallel.expert_parallel_moe(mine(xe), router, shard_rows(w_in, rank, n),
                                         shard_rows(w_out, rank, n), group)
    check("expert-parallel MoE ≡ dense MoE", ye,
          parallel.dense_moe(mine(xe), router, w_in, w_out)[0], group, device)

    # -- 5. tensor parallelism: Megatron MLP ------------------------------
    xt = t(rng.standard_normal((B, 4, Dm)).astype(np.float32))
    w1 = t(rng.standard_normal((Dm, 8 * n)).astype(np.float32) * 0.1)
    w2 = t(rng.standard_normal((8 * n, Dm)).astype(np.float32) * 0.1)
    got = parallel.tp_mlp(xt, shard_columns(w1, rank, n), None, shard_rows(w2, rank, n),
                          None, group)
    check("TP MLP ≡ dense MLP", got, gelu(xt @ w1) @ w2, group, device)

    # -- 6. pipeline parallelism: GPipe schedule --------------------------
    stacked = {"w": t(rng.standard_normal((n, Dm, Dm)).astype(np.float32) * 0.5),
               "b": t(rng.standard_normal((n, Dm)).astype(np.float32) * 0.1)}
    mb = t(rng.standard_normal((3, 2, Dm)).astype(np.float32))

    def stage_fn(p, xx):
        return torch.tanh(xx @ p["w"] + p["b"])

    row = parallel.pipeline_parallel(stage_fn, group)(stacked, mb)
    want = mb
    for s in range(n):
        want = stage_fn({name: leaf[s] for name, leaf in stacked.items()}, want)
    # every stage's row, in stage order; the true output is the last one
    rows = collectives.all_gather(row[0], group)
    check("pipeline ≡ sequential stages", parallel.last_stage_output(rows), want, group,
          device)

    runtime.master_print("tour complete: every mode matches its oracle")
    runtime.shutdown()


if __name__ == "__main__":
    main()

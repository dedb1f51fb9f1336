"""PLANTED VIOLATIONS — raw_api_bypass.

Raw ``torch.distributed`` collectives outside parallel/collectives.py
(they bypass ``collectives._tally``, which the audit's recorder and
``DispatchWireTally`` read) and the raw torch profiler outside
obs/profiling.py (a Kineto singleton that wedges off the main thread on
the card).
"""

import torch
import torch.distributed as tdist
from torch import distributed as dist2
from torch.distributed import all_gather_into_tensor  # bad: import form
from torch.profiler import profile  # bad: import form

from tpu_syncbn_torch.runtime import distributed as dist


def reduce(t, group):
    tdist.all_reduce(t, group=group)  # bad
    dist2.broadcast(t, src=0)  # bad: another alias of torch.distributed
    torch.distributed.barrier()  # bad: the full path
    reqs = [tdist.isend(t, 1), tdist.irecv(t, 1)]  # bad x2
    tdist.all_to_all_single(t, t, group=group)  # bad
    op = tdist.ReduceOp.SUM  # ok: not a collective
    dist.barrier("ckpt-load")  # ok: the port's runtime.distributed wrapper
    return reqs, op, all_gather_into_tensor


def prof(log_dir):
    p = torch.profiler.profile()  # bad
    with torch.autograd.profiler.profile():  # bad
        with torch.profiler.record_function("region"):  # ok: a label
            pass
    torch.profiler._KinetoProfile()  # bad
    return p, profile, log_dir


def suppressed(t):
    # documented escape hatch: a reason beside the marker
    tdist.barrier()  # audit: ok[raw_api_bypass]

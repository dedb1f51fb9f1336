"""PLANTED VIOLATIONS — unpaired_trace_span.

Span/timer context managers created as bare statements are never
entered, never close, and silently drop the region from the trace.
"""

from tpu_syncbn_torch.obs import telemetry, tracing
from tpu_syncbn_torch.obs.stepstats import timed_span


def work(batch):
    tracing.span("serve.batch")  # bad: discarded, never entered
    telemetry.timed("step.time_s")  # bad: same for the timer form
    timed_span("data.fetch")  # bad: bare-name helper form
    with tracing.span("serve.infer"):  # ok: entered
        out = batch * 2
    span = tracing.span("serve.flush")  # ok: stored for a caller's with
    return out, span

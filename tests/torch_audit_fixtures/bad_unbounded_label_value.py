"""PLANTED VIOLATIONS — unbounded_label_value.

Label values are dimensions (a small closed set: tenant names, model
names, modes). A per-request value mints one registry series per
request; identity belongs in trace spans and flight-recorder rings.
"""

from tpu_syncbn_torch.obs import telemetry


def record(rid, tenant):
    telemetry.count("serve.requests", labels={"tenant": f"t-{rid}"})  # bad: f-string
    telemetry.count("serve.requests", labels={"tenant": "t-" + rid})  # bad: concatenation
    telemetry.count("serve.requests", labels={"tenant": str(rid)})  # bad: str() conversion
    telemetry.count("serve.requests", labels={"tenant": "req-{}".format(rid)})  # bad: .format()
    telemetry.count("serve.requests", labels={"model": "0123456789abcdef"})  # bad: id-shaped literal
    telemetry.count("serve.requests", labels={"tenant": tenant})  # ok: bounded variable
    telemetry.count("serve.requests", labels={"mode": "active"})  # ok: closed-set literal

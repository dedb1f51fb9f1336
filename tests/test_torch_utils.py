"""The port's meters and scalar log (tpu_syncbn_torch.utils) against
tpu_syncbn.utils.metrics: the same averages, the same windowed rate on the
same clock readings, the same JSONL rows."""

import json

import pytest

from tpu_syncbn.utils import metrics as jm
from tpu_syncbn_torch import utils as tu
from tpu_syncbn_torch.utils import metrics as tm


def test_average_meter_matches():
    j, t = jm.AverageMeter("top1"), tu.AverageMeter("top1")
    assert t.avg == j.avg == 0.0  # no update yet: no division by zero
    for v, n in ((0.5, 8), (0.25, 4), (1.0, 1)):
        j.update(v, n)
        t.update(v, n)
    assert t.avg == j.avg and t.count == j.count == 13 and str(t) == str(j)
    t.reset()
    assert (t.sum, t.count) == (0.0, 0)


@pytest.mark.parametrize("window", [2, 20])
def test_throughput_meter_matches_on_the_same_clock(monkeypatch, window):
    ticks = iter([10.0, 10.5, 11.0, 11.25, 12.0, 12.5])
    reads = []

    def clock():
        reads.append(next(ticks))
        return reads[-1]

    j, t = jm.ThroughputMeter(window), tu.ThroughputMeter(window)
    assert t.samples_per_sec == j.samples_per_sec == 0.0
    for n in (64, 64, 32):
        monkeypatch.setattr(jm.time, "perf_counter", clock)
        j.tick(n)
        monkeypatch.setattr(tm.time, "perf_counter", clock)
        t.tick(n)
    # the same pairs of readings: j saw 10.0, 11.0, 12.0; t saw 10.5, 11.25, 12.5
    assert j.samples_per_sec == pytest.approx(96 / 2.0)
    assert t.samples_per_sec == pytest.approx(96 / 2.0)


def test_step_timer_and_scalar_logger(tmp_path):
    with tu.step_timer() as out:
        pass
    assert out["seconds"] >= 0.0
    rows = {}
    for name, mod in (("jax", jm), ("torch", tm)):
        path = tmp_path / name / "log.jsonl"
        with mod.ScalarLogger(str(path)) as log:
            log.log(3, loss=0.5, top1=float("nan"), img_per_sec=812)
            log.log(4, loss=float("inf"))
        rows[name] = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows.values():
        for row in r:
            row.pop("wall_time")
    assert rows["torch"] == rows["jax"] == [
        {"step": 3, "loss": 0.5, "top1": None, "img_per_sec": 812.0},
        {"step": 4, "loss": None}]


def test_scalar_logger_writes_nothing_off_the_master(tmp_path, monkeypatch):
    monkeypatch.setattr(tm.dist, "is_master", lambda: False)
    log = tu.ScalarLogger(str(tmp_path / "sub" / "log.jsonl"))
    log.log(1, loss=1.0)
    log.close()
    assert not (tmp_path / "sub").exists()

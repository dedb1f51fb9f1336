"""The port's pipeline schedule tables
(``tpu_syncbn_torch.parallel.pipeline_schedule``) against the JAX
package's: every table equal array for array over JAX's (M, N) grid, the
tick and bubble arithmetic, 1F1B's in-flight bound, the timing reference,
and each of the validator's planted faults raising with JAX's message.
Host-side numpy only: no processes."""

import numpy as np
import pytest

from tpu_syncbn.parallel import pipeline_schedule as J
from tpu_syncbn_torch.parallel import pipeline_schedule as ps

GRID = [(1, 2), (2, 2), (3, 2), (8, 2), (3, 4), (4, 4), (8, 4),
        (16, 4), (2, 8), (8, 8), (6, 3)]
BUILDERS = ("gpipe_schedule", "one_f1b_schedule", "dense_timing_schedule")


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("m,n", GRID)
def test_tables_equal_jaxs(builder, m, n):
    got, want = getattr(ps, builder)(m, n), getattr(J, builder)(m, n)
    assert (got.name, got.n_stages, got.n_microbatches) == \
        (want.name, want.n_stages, want.n_microbatches)
    for table in ("fwd", "bwd"):
        a, b = getattr(got, table), getattr(want, table)
        assert a.dtype == b.dtype and np.array_equal(a, b), (builder, table)
    assert got.ticks == want.ticks
    assert got.predicted_bubble_frac == want.predicted_bubble_frac
    assert got.max_in_flight() == want.max_in_flight()


@pytest.mark.parametrize("m,n", GRID)
def test_generated_tables_are_legal_and_ticks_are_jaxs_arithmetic(m, n):
    g, f = ps.gpipe_schedule(m, n), ps.one_f1b_schedule(m, n)
    ps.validate_schedule(g)
    ps.validate_schedule(f)
    assert g.ticks == 2 * (m + n - 1)
    if m >= n:
        assert f.ticks == m + 2 * (n - 1)
    for s in (g, f):
        assert s.predicted_bubble_frac == pytest.approx(1 - m / s.ticks)
        assert 0.0 <= s.predicted_bubble_frac < 1.0
    assert ps.canonical_gpipe_bubble(m, n) == pytest.approx((n - 1) / (m + n - 1))
    assert ps.canonical_gpipe_bubble(m, n) == J.canonical_gpipe_bubble(m, n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_1f1b_beats_gpipe_at_m_ge_2n(n):
    for m in (2 * n, 4 * n):
        f, g = ps.one_f1b_schedule(m, n), ps.gpipe_schedule(m, n)
        assert f.predicted_bubble_frac < g.predicted_bubble_frac
        assert f.ticks < g.ticks


@pytest.mark.parametrize("m,n", [(8, 2), (16, 4), (8, 4)])
def test_1f1b_in_flight_is_o_n_not_o_m(m, n):
    for s, peak in enumerate(ps.one_f1b_schedule(m, n).max_in_flight()):
        assert peak <= 2 * (n - s) - 1
    assert ps.gpipe_schedule(m, n).max_in_flight()[0] == m


def test_dense_timing_schedule_is_zero_bubble_but_illegal():
    d = ps.dense_timing_schedule(6, 4)
    assert d.ticks == 6 and d.predicted_bubble_frac == pytest.approx(0.0)
    assert (d.fwd != ps.IDLE).all() and (d.bwd != ps.IDLE).all()
    with pytest.raises(ValueError) as got:
        ps.validate_schedule(d)
    with pytest.raises(ValueError) as want:
        J.validate_schedule(J.dense_timing_schedule(6, 4))
    assert str(got.value) == str(want.value)


def _error(mod, fn, *args):
    with pytest.raises(ValueError) as e:
        getattr(mod, fn)(*args)
    return str(e.value)


def test_get_schedule_and_degenerate_sizes_raise_jaxs_messages():
    s = ps.get_schedule("gpipe", 4, 2)
    assert s.name == "gpipe" and s.n_microbatches == 4
    custom = ps.one_f1b_schedule(4, 2)
    assert ps.get_schedule(custom, 4, 2) is custom
    assert _error(ps, "get_schedule", custom, 8, 2) == \
        _error(J, "get_schedule", J.one_f1b_schedule(4, 2), 8, 2)
    assert "trainer wants 8 x 2" in _error(ps, "get_schedule", custom, 8, 2)
    for args in (("zigzag", 4, 2),):
        assert _error(ps, "get_schedule", *args) == _error(J, "get_schedule", *args)
    assert _error(ps, "gpipe_schedule", 0, 2) == _error(J, "gpipe_schedule", 0, 2)
    assert _error(ps, "one_f1b_schedule", 4, 1) == _error(J, "one_f1b_schedule", 4, 1)


# the validator's mutation matrix (tests/test_pipeline_schedule.py): each
# rule fires on a planted illegal table, in both packages, with one message


def _dup_fwd(fwd, bwd, s):
    t = int(np.argwhere(fwd[:, 1] == ps.IDLE)[0, 0])
    fwd[t, 1] = 0


def _missing_bwd(fwd, bwd, s):
    t = int(np.argwhere(bwd[:, 2] == 3)[0, 0])
    bwd[t, 2] = ps.IDLE


def _early_fwd(fwd, bwd, s):
    t = int(np.argwhere(fwd[:, 1] == 0)[0, 0])
    fwd[t, 1] = ps.IDLE
    fwd[0, 1] = 0


def _early_bwd(fwd, bwd, s):
    t1 = int(np.argwhere(bwd[:, 1] == 0)[0, 0])
    t0 = int(np.argwhere(bwd[:, 0] == 0)[0, 0])
    bwd[t0, 0] = ps.IDLE
    bwd[t1, 0] = 0


def _bwd_before_fwd(fwd, bwd, s):
    last = s.n_stages - 1
    t = int(np.argwhere(bwd[:, last] == 0)[0, 0])
    bwd[t, last] = ps.IDLE
    bwd[0, last] = 0


def _out_of_range(fwd, bwd, s):
    fwd[0, 0] = 99


MUTATIONS = {
    "twice": _dup_fwd,
    "never runs bwd": _missing_bwd,
    "activation only lands": _early_fwd,
    "cotangent only lands": _early_bwd,
    "before its own forward": _bwd_before_fwd,
    "out of range": _out_of_range,
}


def _mutated(mod, edit):
    s = mod.gpipe_schedule(4, 3)
    fwd, bwd = s.fwd.copy(), s.bwd.copy()
    edit(fwd, bwd, s)
    return mod.Schedule(s.name, s.n_stages, s.n_microbatches, fwd, bwd)


@pytest.mark.parametrize("match", list(MUTATIONS))
def test_validator_catches_each_planted_fault_with_jaxs_message(match):
    with pytest.raises(ValueError, match=match) as got:
        ps.validate_schedule(_mutated(ps, MUTATIONS[match]))
    with pytest.raises(ValueError) as want:
        J.validate_schedule(_mutated(J, MUTATIONS[match]))
    assert str(got.value) == str(want.value)


def test_validator_catches_shape_mismatch():
    s = ps.gpipe_schedule(4, 3)
    with pytest.raises(ValueError, match="shape") as got:
        ps.validate_schedule(ps.Schedule(s.name, s.n_stages, s.n_microbatches,
                                         s.fwd, s.bwd[:-1]))
    j = J.gpipe_schedule(4, 3)
    with pytest.raises(ValueError) as want:
        J.validate_schedule(J.Schedule(j.name, j.n_stages, j.n_microbatches,
                                       j.fwd, j.bwd[:-1]))
    assert str(got.value) == str(want.value)

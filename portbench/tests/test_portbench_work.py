"""The copied work arithmetic gives the bounds ``chip_smoke.py`` recorded
for the port's kernels (PERF.md's kernel table)."""
import pytest

from portbench.work import agg_work, bound_from, train_work, wire_emit_work


@pytest.mark.parametrize("work, want_us, last_digit, term", [
    (train_work((32, 16, 8, 16, 32), 200, 256, 40, 32, False), 27.4, 0.1, "operations"),
    (agg_work(200, 1352, 20), 1.00, 0.01, "bytes"),
    (wire_emit_work(512, 1352, 68, True), 2.53, 0.01, "bytes"),
    (train_work((32, 16, 8, 16, 32), 3200, 256, 40, 32, False), 438.5, 0.1, "operations"),
    (agg_work(3200, 1352, 320), 16.02, 0.01, "bytes"),
    (agg_work(10_000, 1352, 1000), 50.1, 0.1, "bytes"),
])
def test_recorded_bounds(work, want_us, last_digit, term):
    """Each bound rounds to the recorded figure (half a unit of its last
    digit)."""
    seconds, which = bound_from(*work)
    assert which == term
    assert abs(seconds * 1e6 - want_us) <= 0.5 * last_digit

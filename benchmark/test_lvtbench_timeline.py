"""Busy time, idle share and gap names on a known timeline (the union of
``chip_smoke.py`` ``_busy_profile``)."""

import pytest

from lvtbench import cells, timeline, window

MS = 1_000_000


def trace():
    device = [("k1", 0 * MS, 2 * MS), ("k2", 1 * MS, 3 * MS),  # overlap on two streams
              ("k3", 5 * MS, 6 * MS), ("copy", 6 * MS, 7 * MS), ("k1", 9 * MS, 10 * MS)]
    spans = [("stretch", 0, 10 * MS), ("encode", 0, 4 * MS), ("rollout", 4 * MS, 8 * MS),
             ("generate", 4 * MS, 10 * MS)]
    return timeline.Trace(device, spans, 0, 10 * MS)


def test_busy_is_the_union():
    assert timeline.busy_seconds(trace()) == pytest.approx(6e-3)


@pytest.mark.parametrize("name,stretch", [("idle_share.gen", {}),
                                          ("idle_share.train", {"steps": 2})])
def test_idle_share_reader(name, stretch):
    """Busy per unit from the trace (6 ms over the traced units), time per
    unit from the unprofiled window (40 ms over 4 units)."""
    class R:
        timeline = trace()
        layer = {"window": window.Window(0.0, 0.04, 4, [])}

    R.stretch = stretch
    idle = cells.module("metrics", name).read(R())
    assert idle == pytest.approx(100.0 * (1 - 6e-3 / stretch.get("steps", 1) / 1e-2))


def test_gaps_are_named_by_the_innermost_span():
    gaps = timeline.idle_gaps(trace())
    assert gaps == [(3 * MS, 5 * MS), (7 * MS, 9 * MS)]
    named = dict((n, s) for n, s in timeline.named_gaps(trace()))
    # a gap is named by the span open at its midpoint: 4 ms (rollout), 8 ms (generate)
    assert named["rollout (all gaps)"] == pytest.approx(2e-3)
    assert named["generate (all gaps)"] == pytest.approx(2e-3)
    assert "encode (all gaps)" not in named


def test_device_ops_and_counts():
    t = trace()
    assert timeline.device_ops(t)[0] == ["k1", pytest.approx(3e-3)]
    assert timeline.seconds_of(t, ("k1", "k3")) == (pytest.approx(4e-3), 3)
    assert timeline.activities_after(t, 5 * MS) == 3

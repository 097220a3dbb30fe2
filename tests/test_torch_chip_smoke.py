"""chip_smoke.py's rule for profiler windows, on the CPU with a stand-in
profiler: a window that lost device events is never read, the next one is,
and when every window lost events the calls are timed on a held stream."""
from __future__ import annotations

import collections

import pytest

import chip_smoke as cs

CALLS = 10
KERNEL = "minplus_kernel"


def _window(us_each: float, events: int, other: int = 0):
    """A stand-in window: ``events`` events of KERNEL at ``us_each`` us and
    ``other`` events of another kernel."""
    by_name, count = {}, collections.Counter()
    if events:
        by_name[KERNEL], count[KERNEL] = us_each * events, events
    if other:
        by_name["elementwise"], count["elementwise"] = 1.0 * other, other
    return 0.0, by_name, count


@pytest.mark.parametrize("windows, must_see, want", [
    ([_window(2.0, CALLS)], KERNEL, 2.0e-3),
    ([_window(2.0, CALLS - 3), _window(3.0, CALLS)], KERNEL, 3.0e-3),
    ([_window(2.0, 0, other=5), _window(2.0, 2 * CALLS, other=5)], KERNEL,
     4.0e-3),
    ([_window(2.0, CALLS - 1)] * cs.PROFILE_WINDOWS, KERNEL, "held"),
    ([_window(2.0, 0)] * cs.PROFILE_WINDOWS, KERNEL, "held"),
    ([_window(2.0, 0)] * cs.PROFILE_WINDOWS, None, "held"),
    ([_window(2.0, CALLS - 1, other=CALLS)] * cs.PROFILE_WINDOWS, None,
     "held"),
], ids=["whole", "lost-then-whole", "empty-then-whole", "all-lost",
        "all-empty", "all-empty-plain", "all-lost-plain"])
def test_a_lossy_window_is_never_read(monkeypatch, capsys, windows,
                                      must_see, want):
    left = list(windows)
    monkeypatch.setattr(cs, "_device_events", lambda fn: left.pop(0))
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: 7.5)
    got = cs._kernel_device_ms(lambda: None, CALLS, must_see)
    if want == "held":
        assert got == 7.5
        assert not left
        assert "held stream" in capsys.readouterr().out
    else:
        assert got == pytest.approx(want)


def test_a_name_no_window_saw_raises(monkeypatch):
    monkeypatch.setattr(cs, "_device_events",
                        lambda fn: _window(2.0, CALLS, other=CALLS))
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: 7.5)
    with pytest.raises(AssertionError, match="no_such_kernel"):
        cs._kernel_device_ms(lambda: None, CALLS, "no_such_kernel")

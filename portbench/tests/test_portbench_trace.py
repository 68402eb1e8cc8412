r"""The reading of a device trace: busy time as the union of intervals,
and the breakdown's operations and idle gaps."""

from portbench.harness import breakdown, busy_union
from portbench.readers import device_idle, kernels_per_step

EVENTS = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 41, 45)]
SPANS = [("call", -5, 22), ("call", 28, 50)]


def test_busy_is_the_union_clipped_to_the_window():
    assert busy_union(EVENTS) == 20 + 10 + 4
    assert busy_union(EVENTS, 8, 35) == 12 + 5


def test_breakdown_sums_by_name_and_names_gaps_by_the_host_span():
    b = breakdown(EVENTS, SPANS, 0, 60)
    assert b["device_ops"][0] == ["a", 20 / 1e9]
    gaps = dict((name, s) for name, s in b["idle_gaps"])
    assert gaps["between calls: b -> a"] == 10 / 1e9
    assert gaps["between calls: c -> window end"] == 15 / 1e9
    assert gaps["call: a -> c"] == 1 / 1e9


def test_idle_and_kernels_per_step():
    r = {"events": EVENTS, "lo": 0, "hi": 68,
         "record": {"calls": [{"steps": 2}, {"steps": 2}]}}
    assert device_idle(r) == 100.0 * (1 - 34 / 68)
    assert kernels_per_step(r) == 1.0

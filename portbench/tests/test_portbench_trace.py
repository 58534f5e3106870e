"""Reading a profile: kernel names, the device's busy time, and idle
gaps split by the benchmark span that was open."""

from __future__ import annotations

import pytest

from portbench.trace import Trace, kernel_name


@pytest.mark.parametrize("raw, want", [
    ("void (anonymous namespace)::scan_resident(int const*, int)", "scan_resident"),
    ("void (anonymous namespace)::sample_slots<4>(int const*)", "sample_slots"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >"
     "(int, at::native::FillFunctor<float>)", "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_name(raw, want):
    assert kernel_name(raw) == want


def test_busy_and_gaps():
    trace = Trace(
        (0.0, 10.0),
        [("a::scan_resident", 1.0, 2.0), ("copy", 1.5, 2.5), ("sample_slots", 5.0, 6.0)],
        [("dispatch", 0.5, 3.0), ("reap", 3.0, 5.5), ("dispatch", 7.0, 9.0)])
    assert trace.busy_s() == pytest.approx(2.5)
    assert trace.device_s({"scan_resident"}) == pytest.approx(1.0)
    gaps = trace.gaps()
    assert [round(s, 6) for s, _ in gaps] == [1.0, 2.5, 4.0]
    assert gaps[1][1] == pytest.approx({"dispatch": 0.5, "reap": 2.0})
    assert gaps[2][1] == pytest.approx({"dispatch": 2.0, "harness": 2.0})
    assert sum(s for s, _ in gaps) + trace.busy_s() == pytest.approx(trace.window_s())
    rows = trace.idle_breakdown()
    assert rows[0] == ["all idle in dispatch", pytest.approx(3.0)]
    assert rows[3] == ["longest gap, mostly in dispatch", pytest.approx(4.0)]
    assert len(trace.idle_breakdown(n=4)) == 4

"""The window's arithmetic: when a step starts, busy time, idle gaps, span labels."""
from perf_bench import harness


def test_first_step_always_starts():
    assert harness.start_next(0, now=100.0, last=50.0, start=0.0, seconds=10)


def test_a_step_expected_to_end_late_is_not_started():
    assert harness.start_next(2, now=6.0, last=3.0, start=0.0, seconds=10)
    assert harness.start_next(2, now=7.0, last=3.0, start=0.0, seconds=10)
    assert not harness.start_next(3, now=7.5, last=3.0, start=0.0, seconds=10)


def test_busy_is_the_union_and_gaps_the_holes():
    busy, gaps = harness.busy_and_gaps([(0, 10), (5, 12), (20, 25), (30, 31), (12, 14)])
    assert busy == 14 + 5 + 1
    assert gaps == [(6, 14), (5, 25)]


def test_span_label_is_the_innermost_open_span():
    s = harness.Spans()
    s.items = [("frame_step", 0, 100, 0), ("denoiser_call", 10, 20, 1)]
    assert s.label(15) == "denoiser_call"
    assert s.label(50) == "frame_step"
    assert s.label(150) == "host"

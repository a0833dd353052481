"""The join of a profiled window to the program's spans (attribution.py), on synthetic events.

Correlation ids tie device time to the call that issued it; the marker's
offset moves profiler times onto the span clock; the innermost span open on
the calling thread takes the call, else the innermost on the root spans'
thread; self and inclusive sums; gap labels; the per-call and per-step
metrics.
"""
from autoregressive_diffusion_tpu_torch.utils.profiling import Span

from perf_bench import attribution

MAIN, AUTOGRAD = 100, 200
OFF = 1_000  # the profiler's clock runs 1000 ns ahead of the spans'


def sp(sid, parent, name, t0, t1, /, thread=MAIN, root=1, **attrs):
    return Span(sid, parent, root, thread, name, attrs, t0, t1)


def rollout_spans():
    """Two cached calls, each a Block holding an attention layer, then a
    second Block."""
    out = []
    for k, base in enumerate((0, 1000)):
        c = 10 * k + 1
        out += [sp(c, None, "model.call", base, base + 900, root=c, mode="cached"),
                sp(c + 1, c, "model.block", base + 100, base + 500, root=c,
                   name="enc_8x8_block0"),
                sp(c + 2, c + 1, "model.attention", base + 200, base + 400, root=c,
                   kind="video"),
                sp(c + 3, c, "model.block", base + 600, base + 800, root=c, name="out_conv")]
    return out


def launch(t, corr, thread=MAIN, name="cudaLaunchKernel"):
    return (t + OFF, thread, corr, name)


def test_offset_is_the_midpoint_of_the_tightest_marker_bounds():
    # true offset 1000: each synchronise [start, end] on the profiler's clock
    # lies inside [before, after] on the span clock, shifted by it
    marks = [(0, 100), (200, 260), (400, 430)]
    events = [(1050, 1060), (1210, 1255), (1420, 1425)]
    # bounds: ends - afters = 960, 995, 995; starts - befores = 1050, 1010, 1020
    assert attribution.offset_ns(events, marks) == (1002, 7)
    assert attribution.offset_ns(events[:1], marks[:1]) == (1005, 45)


def test_innermost_of_nested_intervals():
    ivs = [(0, 100, "a"), (10, 20, "b"), (30, 40, "c"), (32, 35, "d"), (100, 200, "e")]
    assert attribution.innermost(ivs, [5, 15, 25, 33, 38, 99, 100, 250]) == [
        "a", "b", "a", "d", "c", "a", "e", None]


def test_calls_map_by_offset_and_device_time_by_correlation():
    spans = rollout_spans()
    calls = [launch(250, 1), launch(150, 2), launch(650, 3), launch(50, 4),
             launch(300, 5, name="cudaMemcpyAsync"), launch(1250, 6), launch(950, 7)]
    device = {1: 2e-3, 2: 1e-3, 3: 4e-3, 4: 0.5e-3, 5: 8e-3, 6: 2e-3, 99: 1.0}
    att = attribution.attribute(calls, device, spans, OFF)
    # self: attention (launch 1 and the copy 5), the first Block (2), out_conv
    # (3), the call itself (4), the second call's attention (6); launch 7 is
    # outside every span
    assert att[3] == [1, 10e-3] and att[2] == [1, 1e-3] and att[4] == [1, 4e-3]
    assert att[1] == [1, 0.5e-3] and att[13] == [1, 2e-3] and att[None] == [1, 0.0]
    # without the offset the launches land 1000 ns late: the first call's
    # land in the second call
    moved = attribution.attribute(calls[:1], device, spans, 0)
    assert list(moved) == [13]


def test_a_call_on_a_thread_with_no_open_span_takes_the_root_threads_span():
    spans = [sp(1, None, "train.step", 0, 1000), sp(2, 1, "train.backward", 100, 900),
             sp(3, 2, "model.block", 300, 400, thread=AUTOGRAD, name="enc_8x8_block0")]
    calls = [launch(200, 1, thread=AUTOGRAD), launch(350, 2, thread=AUTOGRAD),
             launch(500, 3, thread=7)]
    assert attribution.span_of(spans, [c[0] for c in calls], [c[1] for c in calls], OFF) == [
        2, 3, 2]


def test_self_and_inclusive_sums_by_name():
    spans = rollout_spans()
    calls = [launch(250, 1), launch(260, 2), launch(150, 3), launch(650, 4), launch(1300, 5)]
    device = {1: 1e-3, 2: 1e-3, 3: 2e-3, 4: 3e-3, 5: 1e-3}
    att = attribution.attribute(calls, device, spans, OFF)
    rows = attribution.by_name(att, spans)
    assert rows["model.attention"]["self_launches"] == rows["model.attention"]["launches"] == 3
    assert rows["model.block"]["self_launches"] == 2  # launches 3 and 4
    assert rows["model.block"]["launches"] == 5  # a call counted once a name
    assert rows["model.call"]["self_launches"] == 0 and rows["model.call"]["launches"] == 5
    assert abs(rows["model.block"]["device_ms"] - 8.0) < 1e-9
    assert abs(rows["model.block"]["self_device_ms"] - 5.0) < 1e-9
    assert rows["model.block"]["count"] == 4 and rows["model.call"]["host_ms"] == 1800 / 1e6
    assert attribution.under(att, spans, ["model.block"], but=["model.attention"]) == (2, 5e-3)


def test_rollout_and_train_metrics():
    spans = rollout_spans()
    calls = [launch(250, 1), launch(260, 2), launch(150, 3), launch(650, 4), launch(50, 5)]
    device = {1: 1e-3, 2: 1e-3, 3: 2e-3, 4: 3e-3}
    att = attribution.attribute(calls, device, spans, OFF)
    m = attribution.rollout_metrics(att, spans)
    assert m == {"attention_ms.rollout": 1.0, "attention_launches.rollout": 1.0,
                 "block_launches.rollout": 1.0, "call_host_ms.rollout": 900 / 1e6}
    prefill = [s._replace(attrs={"mode": "prefill"}) if s.name == "model.call" else s
               for s in spans]
    assert attribution.rollout_metrics(att, prefill) == {}
    steps = [sp(1, None, "train.step", 0, 1000), sp(2, 1, "train.backward", 0, 500),
             sp(3, 1, "train.optimizer", 500, 700), sp(4, 1, "train.weight_norm", 700, 800),
             sp(5, 1, "train.ema", 800, 900),
             sp(6, None, "train.step", 1000, 2000, root=6),
             sp(7, 6, "train.optimizer", 1500, 1900, root=6)]
    calls = [launch(100, 1), launch(600, 2), launch(750, 3), launch(850, 4), launch(1600, 5)]
    device = {1: 9e-3, 2: 1e-3, 3: 1e-3, 4: 1e-3, 5: 1e-3}
    att = attribution.attribute(calls, device, steps, OFF)
    m = attribution.train_metrics(att, steps)
    assert m["update_launches.train"] == 2.0 and abs(m["update_ms.train"] - 2.0) < 1e-9
    assert attribution.train_metrics(att, []) == {}


def test_gaps_are_labelled_by_the_innermost_program_or_benchmark_span():
    spans = rollout_spans()
    bench = [("frame_step", -100, 2100, 0), ("denoiser_call", -50, 950, 1),
             ("denoiser_call", 950, 1950, 1)]
    gaps = [(30, 300 + OFF), (50, 920 + OFF), (10, 2050 + OFF), (5, 3000 + OFF)]
    assert attribution.label_gaps(gaps, OFF, spans, bench) == [
        ["denoiser_call", 50e-9], ["model.attention", 30e-9], ["frame_step", 10e-9],
        ["host", 5e-9]]
    assert attribution.inside([0 + OFF, 960 + OFF, 5000 + OFF], OFF,
                              [(-50, 950), (960, 1950)]) == [True, True, False]

"""The port's span tracer (utils/profiling.span, tracing) at a tiny size on the CPU.

Off, it records nothing and leaves a cached call bit for bit as it was; on,
a cached call, a train step (with microbatches, and with remat) give their
spans with the right parents; and the join of a profiled window to the
spans (perf_bench/attribution.py) places every aten op that ran inside an
attention layer inside a model.attention span.
"""
import gc
import threading
import time
import weakref

import pytest
import torch

from autoregressive_diffusion_tpu_torch.generate import build_model
from autoregressive_diffusion_tpu_torch.models import init_cache
from autoregressive_diffusion_tpu_torch.train import (create_train_state, make_optimizer,
                                                      make_train_step)
from autoregressive_diffusion_tpu_torch.train.cli import GYM_LOSS, TINY_CONFIG
from autoregressive_diffusion_tpu_torch.utils import profiling
from perf_bench import attribution


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the tier-1 run's six workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prefilled(seed=0, batch=2):
    torch.manual_seed(seed)
    model = build_model("cpu", torch.float32, seed, **TINY_CONFIG)
    cache = init_cache(model, batch, device="cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 3, 16, 16, 4), generator=g)
    with torch.no_grad():
        _, cache = model(x, torch.full((batch, 3), 0.5), None, cache=cache, update_cache=True)
    x1 = torch.randn((batch, 1, 16, 16, 4), generator=g)
    return model, cache, x1, torch.full((batch, 1), 1.3)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def _labels(model):
    return [name if side == "out" else f"{side}_{name}" for side, name, _ in model.unet.layout]


def _attention_blocks(model):
    return [f"{side}_{name}" for side, name, spec in model.unet.layout
            if spec.get("attention") and hasattr(getattr(model.unet, f"{side}_{name}"), "attn")]


def test_tracer_off_records_nothing_and_leaves_the_call_bitwise_equal():
    assert profiling.span("a", k=1) is profiling.span("b")  # one shared null context
    with profiling.span("a"):
        pass
    model, cache, x1, s1 = _prefilled()
    with torch.no_grad():
        y_off, c_off = model(x1, s1, None, cache=cache, update_cache=True)
        with profiling.tracing() as records:
            y_on, c_on = model(x1, s1, None, cache=cache, update_cache=True)
        with profiling.span("after"):
            pass
    assert records and all(r.name != "after" for r in records)
    assert profiling.span("a") is profiling.span("b")  # off again on exit
    assert torch.equal(y_off, y_on)
    on = dict(_leaves(c_on))
    for name, leaf in _leaves(c_off):
        if torch.is_tensor(leaf):
            assert torch.equal(leaf, on[name]), name
        else:
            assert leaf == on[name], name


def test_cached_call_spans_and_parents():
    model, cache, x1, s1 = _prefilled()
    with torch.no_grad(), profiling.tracing() as records:
        model(x1, s1, None, cache=cache)
    calls = [r for r in records if r.name == "model.call"]
    assert len(calls) == 1
    call = calls[0]
    assert call.attrs == {"mode": "cached", "update_cache": False, "graph": "eager"}
    assert call.parent is None and call.root == call.id
    blocks = sorted((r for r in records if r.name == "model.block"), key=lambda r: r.t0_ns)
    assert [b.attrs["name"] for b in blocks] == _labels(model)
    assert all(b.parent == call.id and b.root == call.id for b in blocks)
    by_id = {b.id: b for b in blocks}
    attn = [r for r in records if r.name == "model.attention"]
    want = _attention_blocks(model)
    assert len(want) >= 2 and sorted(by_id[a.parent].attrs["name"] for a in attn) == sorted(want)
    assert {a.attrs["kind"] for a in attn} == {"video", "frame"}
    for a in attn:
        parent = by_id[a.parent]
        assert parent.t0_ns <= a.t0_ns <= a.t1_ns <= parent.t1_ns
        assert a.attrs["ring_frames"] == (3 if a.attrs["kind"] == "video" else 0)
    assert len(records) == 1 + len(blocks) + len(attn)
    with torch.no_grad(), profiling.tracing() as records:
        model(torch.cat([x1, x1], 1), torch.cat([s1, s1], 1), None, cache=cache)
    assert [r.attrs for r in records if r.name == "model.call"] == [
        {"mode": "prefill", "update_cache": False, "graph": "eager"}]


def _train_records(remat: bool, microbatch: int):
    torch.manual_seed(0)
    model = build_model("cpu", torch.float32, 0, remat=remat, **TINY_CONFIG).train()
    tx = make_optimizer(1e-3)
    state = create_train_state(model, tx)
    step = make_train_step(GYM_LOSS, tx, 2, microbatch=microbatch)
    images = torch.randn((2, 3, 16, 16, 4), generator=torch.Generator().manual_seed(1))
    with profiling.tracing() as records:
        step(state, images, None, 7)
    return model, sorted(records, key=lambda r: r.t0_ns)


def test_train_step_spans_per_microbatch_then_the_update():
    model, records = _train_records(remat=False, microbatch=1)
    step = [r for r in records if r.name == "train.step"]
    assert len(step) == 1 and step[0].attrs == {"just_2d": False} and step[0].parent is None
    top = [r for r in records if r.parent == step[0].id]
    assert [(r.name, r.attrs.get("microbatch")) for r in top] == [
        ("train.forward", 0), ("train.backward", 0), ("train.forward", 1), ("train.backward", 1),
        ("train.optimizer", None), ("train.weight_norm", None), ("train.ema", None)]
    assert all(r.root == step[0].id for r in records)
    fwd = {r.id for r in top if r.name == "train.forward"}
    calls = [r for r in records if r.name == "model.call"]
    assert len(calls) == 2 and all(c.parent in fwd and c.attrs == {
        "mode": "train", "update_cache": False, "graph": "eager"} for c in calls)
    assert sum(r.name == "model.block" for r in records) == 2 * len(_labels(model))


def test_remat_recompute_spans_nest_under_the_backward():
    model, records = _train_records(remat=True, microbatch=2)
    by_id = {r.id: r for r in records}
    (bwd,) = [r for r in records if r.name == "train.backward"]
    (call,) = [r for r in records if r.name == "model.call"]
    blocks = [r for r in records if r.name == "model.block"]
    n_blocks = sum(spec["kind"] == "block" for _, _, spec in model.unet.layout)
    recompute = [b for b in blocks if b.parent == bwd.id]
    assert len(blocks) == len(_labels(model)) + n_blocks
    assert len(recompute) == n_blocks
    assert sorted(b.attrs["name"] for b in recompute) == sorted(
        f"{side}_{name}" for side, name, spec in model.unet.layout if spec["kind"] == "block")
    assert all(bwd.t0_ns <= b.t0_ns and b.t1_ns <= bwd.t1_ns for b in recompute)
    attn = [r for r in records if r.name == "model.attention"]
    assert len(attn) == 2 * len(_attention_blocks(model))
    assert {by_id[a.parent].parent for a in attn} == {call.id, bwd.id}


def test_a_thread_with_no_open_span_nests_under_the_root_thread():
    """Autograd's thread runs a card's backward and a remat'd Block's
    recompute: its spans take the innermost span open on the thread that
    opened the root, and the root's id."""
    seen = []

    def worker():
        with profiling.span("model.block", name="x"):
            with profiling.span("model.attention", kind="video"):
                seen.append(threading.get_native_id())

    with profiling.tracing() as records:
        with profiling.span("train.step"):
            with profiling.span("train.backward", microbatch=0):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
        assert not t.is_alive()
    by = {r.name: r for r in records}
    assert by["model.block"].parent == by["train.backward"].id
    assert by["model.attention"].parent == by["model.block"].id
    assert {r.root for r in records} == {by["train.step"].id}
    assert by["model.block"].thread == seen[0] != by["train.step"].thread


def test_join_puts_every_attention_aten_op_inside_model_attention():
    """A CPU window: the spans are record_function ranges there (a trace
    window) and are recorded (tracing); every aten op that starts inside a
    model.attention range on the profiler's clock maps, by the join's
    offset rule (marker ops stand in for the synchronises), into a
    model.attention span on the span clock."""
    model, cache, x1, s1 = _prefilled()
    with torch.no_grad():
        model(x1, s1, None, cache=cache)  # warm
        with profiling.trace(None, host=True) as prof, profiling.tracing() as records:
            torch.zeros(1)  # the window's first op pays the profiler's set-up
            marks = []
            for _ in range(3):  # the markers, each timed on the span clock
                before = time.time_ns()
                torch.zeros(1)
                marks.append((before, time.time_ns()))
            model(x1, s1, None, cache=cache)
    events = [e for e in prof.profiler.kineto_results.events()]
    zeros = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "aten::zeros")
    off, err = attribution.offset_ns(zeros[1:4], marks)
    assert err >= 0
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name() == "model.attention"]
    assert len(ranges) == len(_attention_blocks(model))
    ops = [e for e in events if e.name().startswith("aten::")
           and any(a <= e.start_ns() < b for a, b in ranges)]
    assert len(ops) > 10 * len(ranges)
    ids = attribution.span_of(records, [e.start_ns() for e in ops],
                              [e.start_thread_id() for e in ops], off)
    by_id = {r.id: r for r in records}
    assert all(i is not None and by_id[i].name == "model.attention" for i in ids)


class _FakeGraph:
    """A recorded call as the CPU can stand in for one: replay() runs the
    recorded function again, with no span recorded (a graph's replay runs
    no Python), and writes its output where the capture's was."""

    def __init__(self, fn, out, pool):
        self.fn, self.out, self.pool_id, self.replays = fn, out, pool, 0

    def replay(self):
        self.replays += 1
        sink, profiling._sink = profiling._sink, None
        try:
            self.out.copy_(self.fn()[0])
        finally:
            profiling._sink = sink

    def pool(self):
        return self.pool_id


@pytest.fixture
def stubbed_graph(monkeypatch):
    """CallGraph on the CPU: inputs count as on the card, the capture
    stream is the current one, and a capture is a _FakeGraph. Yields the
    list of (a weak reference to the graph, the pool asked for, the graph's
    pool) of every capture."""
    from autoregressive_diffusion_tpu_torch.models import call_graph
    captures = []

    def capture(self, fn, pool):
        result = fn()
        graph = _FakeGraph(fn, result[0], pool if pool is not None else len(captures))
        captures.append((weakref.ref(graph), pool, graph.pool_id))
        return graph, result

    monkeypatch.setattr(call_graph.CallGraph, "on_card", staticmethod(lambda *t: True))
    monkeypatch.setattr(call_graph.CallGraph, "on_capture_stream", lambda self, fn: fn())
    monkeypatch.setattr(call_graph.CallGraph, "capture", capture)
    yield captures


def _graph_calls(model, cache, x, s, grad=False, **kw):
    """(output, returned cache, the call's model.call span, its other spans)."""
    with torch.set_grad_enabled(grad), profiling.tracing() as records:
        y, c = model(x, s, None, cache=cache, **kw)
    (call,) = [r for r in records if r.name == "model.call"]
    return y, c, call, [r for r in records if r.name != "model.call"]


def test_cached_call_is_recorded_once_then_replayed(stubbed_graph):
    """With the capture stubbed: eval + no grad + one frame + a cache + no
    update runs eagerly the first time its shapes are seen, records the
    next time and replays after; each replay's output equals the eager
    call's, is a fresh tensor, and returns the input cache; no other call
    takes the graph, and none of them drops it."""
    model, cache, x1, s1 = _prefilled()
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(x1.shape, generator=g) for _ in range(4)]
    with torch.no_grad():
        want = [model._call(x, s1, None, cache, False, "eval", False, None)[0] for x in xs]
    kinds, outs = [], []
    for x, w in zip(xs, want):
        y, c, call, inner = _graph_calls(model, cache, x, s1)
        kinds.append(call.attrs["graph"])
        assert call.attrs["mode"] == "cached" and call.attrs["update_cache"] is False
        assert torch.equal(y, w)
        assert bool(inner) == (kinds[-1] != "replay")  # a replay runs no Python inside
        if kinds[-1] != "eager":
            assert c is cache
            assert all(y.data_ptr() != o.data_ptr() for o in outs)
            assert y.data_ptr() != model.call_graph.live.out.data_ptr()
        outs.append(y)
    assert kinds == ["eager", "capture", "replay", "replay"]
    assert len(stubbed_graph) == 1 and stubbed_graph[0][0]().replays == 3
    assert all(torch.equal(o, w) for o, w in zip(outs, want))  # no later call wrote them
    live = model.call_graph.live
    for kw in ({"update_cache": True}, {"just_2d": True}):
        _, _, call, _ = _graph_calls(model, cache, xs[0], s1, **kw)
        assert call.attrs["graph"] == "eager"
    _, _, call, _ = _graph_calls(model, cache, xs[0], s1, grad=True)
    assert call.attrs["graph"] == "eager"
    _, _, call, _ = _graph_calls(model, cache, torch.cat(xs[:2], 1), torch.cat([s1, s1], 1))
    assert call.attrs == {"mode": "prefill", "update_cache": False, "graph": "eager"}
    assert model.call_graph.live is live and len(stubbed_graph) == 1


def test_each_key_change_drops_the_graph_and_records_again(stubbed_graph):
    """The frame counter, a cache tensor, a weight changed in place and an
    input's shape each make the next call record a new graph (a new shape
    runs eagerly first), in the pool of the graph it replaces, which is
    dropped; every output equals the eager call's."""
    model, cache, x1, s1 = _prefilled()

    def call(cache, x=x1, s=s1):
        y, _, span_, _ = _graph_calls(model, cache, x, s)
        with torch.no_grad():
            want = model._call(x, s, None, cache, False, "eval", False, None)[0]
        assert torch.equal(y, want)
        return span_.attrs["graph"]

    assert [call(cache) for _ in range(3)] == ["eager", "capture", "replay"]
    moved = dict(cache, frames=cache["frames"] + 1)
    leaf = dict(cache, out_conv={"act": cache["out_conv"]["act"] * 0.5})
    changes = [lambda: moved, lambda: leaf]

    def weight():
        with torch.no_grad():
            model.unet.out_gain.mul_(0.5)
        return leaf
    changes.append(weight)
    for change in changes:
        old = weakref.ref(model.call_graph.live.graph)
        c = change()
        assert [call(c), call(c)] == ["capture", "replay"]
        assert old() is None  # the replaced graph is gone
        assert stubbed_graph[-1][1] == stubbed_graph[-2][2]  # recorded into its pool
    x2 = x1.double()  # a new input shape set: eager on the capture stream, then recorded
    assert [call(leaf, x2), call(leaf, x2), call(leaf, x2)] == ["eager", "capture", "replay"]
    assert [call(leaf)] == ["capture"]  # the first set's shapes are still warm
    assert len(stubbed_graph) == 6


def test_a_train_call_or_a_prefill_drops_the_graph_and_frees_its_cache(stubbed_graph):
    """The live graph holds the cache it reads while a later call may
    replay it, through a frame step's last call (one frame, written into
    the cache); a prefill that writes several frames into a new cache, and
    a train-mode call, drop it, and with it the old cache's tensors."""
    from autoregressive_diffusion_tpu_torch.models import call_graph
    model, cache, x1, s1 = _prefilled()
    assert [_graph_calls(model, cache, x1, s1)[2].attrs["graph"] for _ in range(2)] == [
        "eager", "capture"]
    old = [weakref.ref(t) for t in call_graph._leaves(cache, [])]
    graph = weakref.ref(model.call_graph.live.graph)
    _, cache, call, _ = _graph_calls(model, cache, x1, s1, update_cache=True)
    assert call.attrs["graph"] == "eager" and model.call_graph.live is not None
    del cache, call
    gc.collect()
    assert all(r() is not None for r in old)  # held by the live graph alone
    fresh = init_cache(model, 2, device="cpu")
    _, fresh, call, _ = _graph_calls(model, fresh, torch.cat([x1, x1], 1),
                                     torch.cat([s1, s1], 1), update_cache=True)
    gc.collect()
    assert call.attrs == {"mode": "prefill", "update_cache": True, "graph": "eager"}
    assert model.call_graph.live is None and graph() is None
    assert all(r() is None for r in old)
    assert [_graph_calls(model, fresh, x1, s1)[2].attrs["graph"] for _ in range(2)] == [
        "capture", "replay"]  # the shapes are still warm
    model.train()
    images = torch.randn((2, 4, 16, 16, 4), generator=torch.Generator().manual_seed(3))
    with profiling.tracing() as records:
        model(images, torch.full((2, 4), 0.7), None, mode="train")
    assert [r.attrs["graph"] for r in records if r.name == "model.call"] == ["eager"]
    assert model.call_graph.live is None


def test_graph_probe_counts_a_rollouts_cached_calls(stubbed_graph):
    """perf_bench/graph_probe.py on a tiny rollout cell with the capture
    stubbed: the set-up's warm-up calls run eagerly (the first call of its
    shapes, then the cache-writing one); every frame step records once,
    replays its other non-updating calls and writes the cache eagerly;
    the run stays correct."""
    from perf_bench import graph_probe
    from perf_bench.tests.conftest import tiny_cell
    cell = tiny_cell("gym_rollout")
    out = graph_probe.probe(cell, 2 ** 31 + 5, 1, "cpu", time.perf_counter())
    n = 2 * cell["traffic_spec"]["num_steps"] - 1
    assert out["correct"] and out["device"] == "cpu"
    assert out["setup"] == {"eager": 2}
    assert out["frames"] and all(f == {"capture": 1, "replay": n - 2, "eager": 1}
                                 for f in out["frames"])
    assert out["replay_share"] == (n - 2) / n

"""The launch path's spans (utils/profiling.py::span) on the CPU.

- Without a profiler, ``span`` enters no record function and hands back
  one shared no-op context; under one it is a record function of function
  scope, a host op in the trace with no copy on a device stream; a cached regen render is bit-equal with
  and without a CPU profiler recording.
- Under a CPU profiler, a 2-launch ``render_image_regen`` gives two
  ``render.launch`` ranges, each holding ``regen.prepass``, ``regen.loop``,
  the two reads of the rays and ``render.accumulate`` in that order, the prepass and
  the loop each with its ``regen.context``; every two spans are disjoint
  or nested. On the stand-in graphs the job warms up and captures each
  loop once: the prepass's warm-up in the warm-up launch, its capture and
  the loop's warm-up and capture in the first launch, none in the second.
- ``regen.sync`` counts the host reads: one a loop condition (iterations
  + 1), one a prepass chunk whose prefix is below its rows, and the fixed
  reads (the prepass's counts, the cached route's ray count), the same on
  a second run of the seed.
- On the stand-in graphs of tests/test_torch_prepass_graph.py each
  ``GraphedLoop`` gives one ``graph.warm_up`` and one ``graph.capture``,
  and a replay gives no span.
- ``device_trace``'s Chrome trace holds the span names.
- ``parallel.mesh.gather_rows`` (a gloo group of one rank) is one
  ``parallel.gather`` span a call, and none without a profiler; the
  benchmark's ``allgather_ms`` reads those spans a launch, and nothing
  from a program that emits spans but not this one.
- Each ``diff.inverse.recover_materials`` step is one ``inverse.step``
  span holding ``inverse.target``, ``inverse.forward``,
  ``inverse.backward``, ``inverse.update`` and ``inverse.sync`` in that
  order, and each render in it one ``wavefront.sync`` a bounce after the
  first; the benchmark's ``inverse_*`` readers read them a step, and
  nothing from a trace without ``inverse.step``.
The benchmark's readers of these spans: benchmark/tests/test_spans.py."""

import dataclasses
import functools
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils import profiling
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_prepass_graph import _stand_in_graphs
from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")
W = H = 16
LANES = 128


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(CORNELL, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=W, height=H))


def _cfg(**kw):
    base = dict(width=W, height=H, spp=2, estimator="mis", light_sampler="spherical_triangle",
                max_depth=16, seed=11)
    base.update(kw)
    return RenderConfig(**base)


def _spans(fn):
    """(fn's result, the spans it recorded under a CPU profiler as
    (start ns, end ns, name), sorted by start, outer first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
          for e in prof.profiler.kineto_results.events() if e.name() in profiling.SPANS]
    return out, sorted(ev, key=lambda r: (r[0], -r[1]))


def _inside(outer, spans):
    return [s for s in spans if outer[0] <= s[0] and s[1] <= outer[1] and s is not outer]


def _children(outer, spans):
    """The spans directly inside ``outer``, in order."""
    inner = _inside(outer, spans)
    return [s for s in inner if not any(s in _inside(o, inner) for o in inner)]


def test_span_without_a_profiler_enters_no_record_function(scene, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError(f"a record function {a} without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert profiling.span("render.launch") is profiling.span("regen.sync")
    r = render_image_regen(scene, _cfg(), lanes=LANES, max_samples_per_launch=W * H)
    assert r.spp_done == 2 and np.isfinite(r.image).all()


def test_span_under_a_profiler_is_a_host_op():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = profiling.span("regen.sync")
        assert isinstance(sp, torch._C._profiler._RecordFunctionFast)
        with sp:
            torch.ones(2).add_(1)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "regen.sync"]
    assert ev.activity_type() == "cpu_op"


def test_image_is_bit_equal_with_and_without_a_profiler(scene):
    plain = render_image_regen(scene, _cfg(), lanes=LANES)
    traced, spans = _spans(lambda: render_image_regen(scene, _cfg(), lanes=LANES))
    assert spans and np.array_equal(plain.image, traced.image)
    assert plain.rays_traced == traced.rays_traced


def test_two_launches_nest_their_spans_in_order(scene, monkeypatch):
    _stand_in_graphs(monkeypatch, _state_of)
    _, spans = _spans(lambda: render_image_regen(scene, _cfg(), lanes=LANES,
                                                 max_samples_per_launch=W * H))
    launches = [s for s in spans if s[2] == "render.launch"]
    assert len(launches) == 2
    for lau in launches:
        kids = _children(lau, spans)
        # the cached route's ray count, then the launch's
        assert [k[2] for k in kids] == ["regen.prepass", "regen.loop", "regen.sync",
                                        "regen.sync", "render.accumulate"]
        for k in kids[:2]:
            assert [c[2] for c in _children(k, spans)][0] == "regen.context"
    # The warm-up launch's prepass and loop lie before the first launch.
    assert [s[2] for s in spans if s[1] <= launches[0][0]
            and s[2] in ("regen.prepass", "regen.loop")] == ["regen.prepass", "regen.loop"]
    # One job: its graphs warm up and capture in its first launches only.
    where = [(sum(lau[0] <= g[0] for lau in launches) - 1, g[2]) for g in spans
             if g[2].startswith("graph.")]
    assert where == [(-1, "graph.warm_up"), (0, "graph.capture"), (0, "graph.warm_up"),
                     (0, "graph.capture")]
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            assert b[0] >= a[1] or b[1] <= a[1], f"{a} and {b} overlap out of order"


def _syncs(spans):
    return sum(1 for s in spans if s[2] == "regen.sync")


def _route(scene, cfg, route, graph=None):
    """A call of the regen route ``route`` at W x H and 4 spp: the cached
    render (one prepass chunk), the uncached loop, or the prepass alone in
    four chunks of 64 pixels x 16 rows (P = 768 of S = 1,024 rows)."""
    key, n_pix = rng.base_key(cfg.seed), W * H
    if route == "cached":
        return lambda: regen.render_regen_cached(scene, cfg, key, n_pix, 4, 4, lanes=LANES,
                                                 graph=graph)
    if route == "uncached":
        return lambda: regen.render_regen(scene, cfg, key, n_pix, n_pix * 4, lanes=LANES,
                                          graph=graph)
    return lambda: regen.primary_prepass(scene, cfg, key, n_pix, 16, 4, pix_chunk=64,
                                         graph=graph)


def _fixed(scene, cfg, route, out):
    """(regen.sync spans, other spans) that a call of ``route`` records
    outside its graphs: a loop condition an iteration and one more, a
    predicate a prepass chunk whose prefix is below its rows, the
    prepass's counts and the cached route's ray count; the prepass and
    loop spans with their contexts."""
    key, n_pix = rng.base_key(cfg.seed), W * H
    prepass = route in ("cached", "prepass")
    chunks = 0
    if prepass:
        loop = (regen.PrepassLoop(scene, cfg, key, n_pix, 4, 4) if route == "cached"
                else regen.PrepassLoop(scene, cfg, key, n_pix, 16, 4, pix_chunk=64))
        chunks = loop.n_chunks if loop.P < loop.S else 0
        assert chunks == (1 if route == "cached" else 4)
    syncs = chunks + (1 if prepass else 0)
    if route != "prepass":
        syncs += out[2] + 1 + (1 if route == "cached" else 0)
    others = 2 * prepass + 2 * (route != "prepass")
    return syncs, others


@pytest.mark.parametrize("route", ["cached", "uncached", "prepass"])
def test_sync_spans_count_the_host_reads(scene, route):
    cfg = _cfg(spp=4)
    run = _route(scene, cfg, route)
    out, spans = _spans(run)
    again, spans2 = _spans(run)
    syncs, _ = _fixed(scene, cfg, route, out)
    if route != "prepass":
        assert out[2] == again[2]
    assert _syncs(spans) == syncs == _syncs(spans2)


def _state_of(step):
    return step.args[0] if isinstance(step, functools.partial) else step.__self__.state


@pytest.mark.parametrize("route", ["uncached", "prepass"])
def test_each_graphed_loop_gives_one_warm_up_and_one_capture(scene, monkeypatch, route):
    loops = _stand_in_graphs(monkeypatch, _state_of)
    cfg = _cfg(spp=4)
    out, spans = _spans(_route(scene, cfg, route, graph=True))
    (loop,) = loops
    assert loop.captured.graph.replays > 0
    names = Counter(s[2] for s in spans)
    assert names["graph.warm_up"] == names["graph.capture"] == 1
    # Every other span is one of the call's fixed ones: none comes from a replay.
    syncs, others = _fixed(scene, cfg, route, out)
    assert names["regen.sync"] == syncs
    assert sum(names.values()) == syncs + others + 2


def test_device_trace_holds_the_span_names(scene, tmp_path):
    with profiling.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        render_image_regen(scene, _cfg(spp=1), lanes=LANES)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"render.launch", "render.accumulate", "regen.prepass", "regen.loop",
            "regen.context", "regen.sync"} <= names


@pytest.fixture
def mesh1(tmp_path):
    """A gloo group of this one process and its (1,) tiles mesh; the group
    is destroyed after the test, so no other test sees it."""
    import torch.distributed as dist

    from monte_carlo_path_tracing_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield make_mesh((1,), ("tiles",))
    finally:
        dist.destroy_process_group()


def test_gather_rows_is_one_parallel_gather_span_a_call(mesh1, monkeypatch):
    from monte_carlo_path_tracing_tpu_torch.parallel import gather_rows

    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    outs, spans = _spans(lambda: [gather_rows(x + i, mesh1) for i in range(3)])
    assert [s[2] for s in spans] == ["parallel.gather"] * 3
    assert all(torch.equal(o, x + i) for i, o in enumerate(outs))

    def boom(*a, **kw):
        raise AssertionError(f"a record function {a} without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert torch.equal(gather_rows(x, mesh1), x)


def test_allgather_ms_reads_parallel_gather_spans():
    from benchmark import harness, trace

    def window(*hosts, launches=2):
        out = []
        for host in hosts:
            names, s, e = zip(*host)
            h = trace.Intervals(list(names), np.asarray(s, float), np.asarray(e, float))
            dev = trace.Intervals(["k"], np.zeros(1), np.ones(1))
            out.append(trace.TraceSummary(dev, dev, h, 0.0, 1e3, launches, 1))
        return harness.Window(start=0.0, launches=[], setup_s=0.0, traces=out)

    read = harness.metric_module("allgather_ms").read
    loop = [("regen.loop", 0, 100), ("parallel.reduce", 100, 110)]
    a = loop + [("parallel.gather", 110, 150), ("parallel.gather", 300, 340)]
    b = loop + [("parallel.gather", 110, 170), ("parallel.gather", 300, 360)]
    assert read(window(a, b)) == pytest.approx((80 + 120) / 2 / 2 * 1e-3)
    assert read(window(loop, loop)) is None               # spans, but none of these
    assert read(window([("aten::add", 0, 1)])) is None    # a program without spans


def _inverse_steps(scene, steps=2, max_depth=3):
    from monte_carlo_path_tracing_tpu_torch.cli import perturb_materials
    from monte_carlo_path_tracing_tpu_torch.diff.inverse import recover_materials

    cfg = _cfg(spp=1, max_depth=max_depth)
    init = perturb_materials(scene.materials, 0.2, ("kd", "ks", "ns", "emission"))
    return recover_materials(scene, init, cfg, steps=steps, lr=0.1, rays_per_step=W * H,
                             seed=11)


@pytest.mark.parametrize("max_depth", [3, 4])
def test_each_inverse_step_nests_its_spans_in_order(scene, max_depth):
    _, spans = _spans(lambda: _inverse_steps(scene, 2, max_depth))
    steps = [s for s in spans if s[2] == "inverse.step"]
    assert len(steps) == 2
    for st in steps:
        kids = _children(st, spans)
        assert [k[2] for k in kids] == ["inverse.target", "inverse.forward", "inverse.backward",
                                        "inverse.update", "inverse.sync"]
        syncs = [[c[2] for c in _children(k, spans)] for k in kids]
        # one render in the target, two in the forward pass
        assert syncs == [["wavefront.sync"] * (max_depth - 1),
                         ["wavefront.sync"] * (2 * (max_depth - 1)), [], [], []]
    assert all(s[2].startswith(("inverse.", "wavefront.")) for s in spans)


def test_the_inverse_readers_read_the_steps_spans(scene):
    from benchmark import harness, trace

    def window(fn, launches):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return harness.Window(start=0.0, launches=[], setup_s=0.0,
                              traces=[trace.summarize(prof, launches, launches * 3 * W * H)])

    names = ["inverse_target_ms", "inverse_forward_ms", "inverse_backward_ms", "inverse_sync_ms",
             "inverse_host_syncs"]
    got = {n: harness.metric_module(n).read(window(lambda: _inverse_steps(scene), 2))
           for n in names}
    assert got["inverse_host_syncs"] == 7.0           # the loss, and 2 + 4 live-mask reads
    assert all(got[n] > 0.0 for n in names), got
    regen = window(lambda: render_image_regen(scene, _cfg(), lanes=LANES), 1)
    assert {n: harness.metric_module(n).read(regen) for n in names} == dict.fromkeys(names)

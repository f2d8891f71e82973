"""The regeneration loop as an in-place iteration (integrator/regen.py::
regen_loop) and its CUDA graph machinery (integrator/graph.py), on the CPU.

- The iteration function, run eagerly, against the JAX package's
  render_regen / render_regen_cached on the cells of
  tests/test_torch_regen.py and tests/test_torch_prepass.py, at their
  tolerances (logical rays to 0.5%, at most 1% of pixels (at least 2)
  diverged beyond rtol 1e-2 / atol 1e-3, image means to 1e-3) and with
  JAX's iteration count. Its snapshots are a function of the state dict
  alone: the iteration run on a copy of one snapshot gives the next,
  bit for bit, which is what lets a graph replay it.
- ``graph=True`` on CPU tensors raises.
- The bookkeeping of a captured iteration, with stand-in graphs: launch
  counters rise by the captured launches once per replay, and a loop whose
  second iteration is captured (which runs nothing) and replayed keeps the
  eager loop's iterations, rays and framebuffer; its capture is one
  ``graph.capture`` span under a profiler.
The card runs the captured loop against the eager one (tests/test_torch_cuda.py,
chip_smoke.py phase "graph")."""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.integrator import regen as jregen
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.integrator import regen
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda, launches, rng_cuda
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

LANES, SPP, SEED = 512, 2, 11


def _pair(jax_scene, w, h):
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=w, height=h))
    return js, scene_from_arrays(scene_arrays(jax_scene), w, h, device="cpu")


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _eager_snapshots(ts, cfg, n_pix, total, seed_mode=None):
    """The loop run eagerly through regen_loop: (snapshots, iterate), one
    snapshot before the first iteration and one after each."""
    st, iterate, more = regen.regen_loop(ts, cfg, rng.base_key(cfg.seed), n_pix, total,
                                         lanes=LANES, seed_mode=seed_mode)
    snaps = [_clone(st)]
    while more(st):
        iterate(st)
        snaps.append(_clone(st))
    return snaps, iterate


def _gaps(a, b):
    fine = ~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    coarse = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    return int(fine.sum()), int(coarse.sum())


@pytest.mark.parametrize("name,w,h,depth,jitter,cached", [
    ("cornell", 24, 24, 32, False, False), ("veach", 16, 16, 16, False, False),
    ("cornell", 24, 24, 32, True, False), ("cornell", 24, 16, 16, False, True),
])
def test_in_place_iteration_matches_jax(request, name, w, h, depth, jitter, cached):
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), w, h)
    n_pix = w * h
    kw = dict(width=w, height=h, spp=SPP, estimator="mis", light_sampler="spherical_triangle",
              max_depth=depth, seed=SEED, pixel_jitter=jitter)
    jcfg, cfg = JaxConfig(**kw), RenderConfig(**kw)
    if cached:
        fa, ra, ia, _ = jax.jit(lambda s, k: jregen.render_regen_cached(
            s, jcfg, k, n_pix, SPP, SPP, lanes=LANES))(js, jrng.base_key(SEED))
        seeds, total, rays0, _ = regen.primary_prepass(ts, cfg, rng.base_key(SEED), n_pix, SPP,
                                                       SPP)
    else:
        fa, ra, ia, _ = jax.jit(lambda s, k: jregen.render_regen(
            s, jcfg, k, n_pix, n_pix * SPP, lanes=LANES))(js, jrng.base_key(SEED))
        seeds, total, rays0 = None, n_pix * SPP, 0
    snaps, iterate = _eager_snapshots(ts, cfg, n_pix, total, seeds)
    last = snaps[-1]
    iters, rays = len(snaps) - 1, rays0 + int(last["nrays"])
    assert not bool(last["alive"].any()) and int(last["counter"]) == total
    a = np.asarray(fa) / SPP
    b = last["fb"][:n_pix].numpy() / SPP
    fine, coarse = _gaps(a, b)
    print(f"{name} cached={cached}: iterations {int(ia)} vs {iters}; rays {float(ra)} vs "
          f"{rays}; {fine} of {n_pix} pixels beyond rtol 1e-4, {coarse} diverged")
    assert iters == int(ia)
    assert abs(rays - float(ra)) <= 0.005 * float(ra)
    assert coarse <= max(2, n_pix // 100)
    assert abs(b.mean() / a.mean() - 1.0) < 1e-3

    # The iteration reads and writes the state dict and nothing else: on a
    # copy of snapshot i it gives snapshot i + 1.
    for i in sorted({0, 1, 2, iters // 2, iters - 1}):
        st = _clone(snaps[i])
        iterate(st)
        for k, v in st.items():
            assert torch.equal(v, snaps[i + 1][k]), (i, k)


def test_render_regen_on_iter_sees_the_loop(cornell_scene):
    """render_regen (eager on the CPU) hands on_iter the same states as
    regen_loop run by hand, the loop's own buffers (cloned by the caller),
    and returns its iterations, rays and framebuffer."""
    _, ts = _pair(cornell_scene, 12, 12)
    cfg = RenderConfig(width=12, height=12, spp=2, estimator="mis", max_depth=16, seed=SEED)
    snaps, _ = _eager_snapshots(ts, cfg, 144, 288)
    seen, bufs = [], []
    fb, nrays, iters, _ = regen.render_regen(
        ts, cfg, rng.base_key(SEED), 144, 288, lanes=LANES,
        on_iter=lambda st: (seen.append(_clone(st)), bufs.append(st["fb"].data_ptr())))
    assert iters == len(snaps) - 1 == len(seen) - 1
    assert len(set(bufs)) == 1                  # one buffer, written in place
    for a, b in zip(snaps, seen):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(fb, snaps[-1]["fb"][:144]) and int(nrays) == int(snaps[-1]["nrays"])


def test_graph_true_on_cpu_raises(cornell_scene):
    _, ts = _pair(cornell_scene, 8, 8)
    cfg = RenderConfig(width=8, height=8, spp=1, estimator="mis", seed=1)
    with pytest.raises(ValueError, match="graph=True"):
        regen.render_regen(ts, cfg, rng.base_key(1), 64, 64, lanes=32, graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        regen.render_regen_cached(ts, cfg, rng.base_key(1), 64, 1, 1, lanes=32, graph=True)
    assert graph_mod.use_graph(None, torch.device("cpu")) is False
    assert graph_mod.use_graph(False, torch.device("cpu")) is False


class _Graph:
    """A stand-in CUDA graph: replay() runs ``on_replay``."""

    def __init__(self, on_replay=None):
        self.replays = 0
        self.on_replay = on_replay

    def replay(self):
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay()


@contextlib.contextmanager
def _capture(graph):
    yield


def test_captured_launches_count_once_per_replay():
    """The wrappers run once, at capture, where nothing launches: the
    counters stay; each replay adds what the captured step launched."""
    def step():                                   # what the wrappers count
        intersect_cuda.nearest_hit.launches += 1
        intersect_cuda.occluded.launches += 1
        rng_cuda.threefry.launches += 15

    before = launches.counts()
    graph = _Graph()
    cap = graph_mod.CapturedStep(step, graph=graph, capture=_capture)
    assert launches.counts() == before
    assert cap.delta == {**dict.fromkeys(before, 0), "K1 nearest_hit": 1, "K2 occluded": 1,
                         "K6 threefry": 15}
    for _ in range(3):
        cap.replay()
    after = launches.counts()
    assert graph.replays == 3
    assert {k: after[k] - before[k] for k in after} == {k: 3 * n for k, n in cap.delta.items()}
    launches.restore(before)


def test_failed_capture_raises_and_keeps_the_counters():
    def step():
        rng_cuda.threefry.launches += 2
        raise RuntimeError("operation not permitted when stream is capturing")

    before = launches.counts()
    with pytest.raises(RuntimeError, match="capturing"):
        graph_mod.CapturedStep(step, graph=_Graph(), capture=_capture)
    assert launches.counts() == before


def test_graphed_loop_keeps_the_eager_loops_iterations(cornell_scene, monkeypatch):
    """The captured loop's schedule on stand-ins: the first iteration runs
    (warm-up), the second is captured, which runs nothing (the stand-in
    restores the state it ran on), and replayed; every later one replays.
    Iterations, rays and framebuffer are the eager loop's."""
    _, ts = _pair(cornell_scene, 12, 12)
    cfg = RenderConfig(width=12, height=12, spp=2, estimator="mis", max_depth=16, seed=SEED,
                       primary_cache=False)
    fb0, rays0, iters0, _ = regen.render_regen(ts, cfg, rng.base_key(SEED), 144, 288,
                                               lanes=LANES, graph=False)
    loops = []

    @contextlib.contextmanager
    def records_nothing(state):
        saved = _clone(state)
        yield
        for k, v in saved.items():
            state[k].copy_(v)

    def capture(step):
        state = step.args[0]            # functools.partial(iterate, state)
        return graph_mod.CapturedStep(step, graph=_Graph(step),
                                      capture=lambda g: records_nothing(state))

    class Loop(graph_mod.GraphedLoop):
        def __init__(self, step, device, pool=None):     # a stand-in allocates no pool
            super().__init__(step, device, capture=capture)
            loops.append(self)

        def warm_up(self):
            self.step()

    monkeypatch.setattr(graph_mod, "use_graph", lambda graph, device: True)
    monkeypatch.setattr(graph_mod, "GraphedLoop", Loop)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fb, rays, iters, _ = regen.render_regen(ts, cfg, rng.base_key(SEED), 144, 288,
                                                lanes=LANES)
    (loop,) = loops
    assert iters == iters0 and loop.calls == iters0 and loop.captured.graph.replays == iters0 - 1
    assert int(rays) == int(rays0) and torch.equal(fb, fb0)
    captures = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "graph.capture"]
    assert len(captures) == 1 and captures[0] > 0

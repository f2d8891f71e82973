"""What ``jax.jit`` gives the primary prepass and the fixed-depth bounce, on
the CPU: the prepass's fixed survivor prefix and its overflow tail
(integrator/regen.py::PrepassLoop), the in-place bounce step
(integrator/wavefront.py::bounce_loop), and the CUDA graph schedules of
both on stand-in graphs (integrator/graph.py).

- The prepass over several chunks whose prefix P is below their S rows,
  against JAX's primary_prepass (its fixed prefix and ``lax.cond`` tail)
  at tests/test_torch_prepass.py's tolerances: equal primary hits, seed
  counts, seed sample ids and ray counts; seed directions to 1e-5,
  throughputs and pdfs to 1e-2 relative. At this size (768 pixels, 1,827
  seeds) the prepass of one chunk differs from JAX's as much as that of
  three, and the port's is the same bit for bit as before the fixed
  prefix: one seed direction sits 1.6e-5 from JAX's (f32 rounding through
  a glossy lobe), so 0.1% of the seeds may lie beyond 1e-5, none beyond
  1e-4; and fb_pre is held as the renders are (at most 1% of pixels, at
  least 2, beyond rtol 1e-2 / atol 1e-3; sums to 1e-3): two pixels differ
  by ~4% with the spherical sampler, sums by 1.1e-4.
- The forced tail: P set to 256 through the test seam ``_prefix_rows``, so
  that the tail runs in several chunks. Seeds (sample, wi, tp, pdf) are
  bit-equal to the unforced prepass, counts and rays equal, fb_pre within
  rtol 1e-6.
- The captured schedules on stand-in graphs (as in tests/test_torch_graph.py:
  a capture runs the step and restores the state it ran on, so it runs
  nothing; a replay runs the step with the launch counters held, as a
  graph replay runs no wrapper): the prepass's chunk 0 eager, chunk 1
  captured, the rest replays; the bounce's first bounce eager, its second
  captured, every later bounce of every batch a replay. Results are
  bit-equal to ``graph=False``, and the launch counters (the culled
  kernels', K1's and K3's with its picks, bumped by stand-in wrappers)
  equal the eager ones; a prepass chunk picks its lights for every round
  in one K3 launch.
- The in-place bounce step against JAX's render_rays on the cells of
  tests/test_torch_wavefront.py::test_render_rays_matches_jax, at its
  tolerances (rays to 0.5%, at most 1% of lanes (at least 2) beyond rtol
  1e-2 / atol 1e-3); the step on a copy of the state after bounce i gives
  the state after bounce i + 1, bit for bit.
- ``graph=True`` raises on CPU tensors, with gradients, on the grid and for
  the shoot estimator; with gradients on, pixel_grad never captures and
  its gradients are those of the eager loop, bit for bit.
The card runs the captured prepass and bounce against the eager ones
(tests/test_torch_cuda.py, chip_smoke.py phases "graph" and "e2e
fixed-depth")."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.integrator import regen as jregen
from monte_carlo_path_tracing_tpu.integrator import render_rays as jax_render_rays
from monte_carlo_path_tracing_tpu.render.camera import generate_rays as jax_generate_rays
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as tgrad
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.integrator import regen, wavefront
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda, launches
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

SEEDS = ("sample", "wi", "tp", "pdf")
#: Veach 32x24 in chunks of 256 pixels x 4 spp: three chunks of S = 1,024
#: rows, P = 768 (mis, brdf) or 1,024 (split).
W, H, SPP, CHUNK = 32, 24, 4, 256


def _pair(jax_scene, w, h):
    js = dataclasses.replace(jax_scene, camera=dataclasses.replace(
        jax_scene.camera, width=w, height=h))
    return js, scene_from_arrays(scene_arrays(jax_scene), w, h, device="cpu")


def _cfg(**kw):
    base = dict(width=W, height=H, spp=SPP, estimator="mis", light_sampler="spherical_triangle",
                max_depth=16, seed=7)
    base.update(kw)
    return base


def _prepass(ts, cfg, **kw):
    return regen.primary_prepass(ts, cfg, rng.base_key(7), W * H, SPP, SPP, pix_chunk=CHUNK,
                                 **kw)


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _assert_same_prepass(a, b, fb_rtol=0.0):
    """Two prepass results: counts and rays equal, seeds up to the count
    and the per-pixel cache bit-equal, fb_pre within ``fb_rtol``."""
    assert a[1:] == b[1:]
    k = a[1]
    for f in SEEDS:
        assert torch.equal(getattr(a[0], f)[:k], getattr(b[0], f)[:k]), f
    for f in ("cache_p", "cache_ns", "cache_wsum", "cache_tri"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    torch.testing.assert_close(b[0].fb_pre, a[0].fb_pre, rtol=fb_rtol, atol=0.0)


@pytest.fixture
def tails(monkeypatch):
    """The number of overflow tails the prepass runs."""
    ran = []
    real = regen.PrepassLoop.tail
    monkeypatch.setattr(regen.PrepassLoop, "tail", lambda self: ran.append(1) or real(self))
    return ran


@pytest.mark.parametrize("est,sampler", [("mis", "spherical_triangle"), ("brdf", "uniform_area"),
                                         ("split", "spherical_triangle")])
def test_fixed_prefix_matches_jax_over_chunks(veach_scene, tails, est, sampler):
    js, ts = _pair(veach_scene, W, H)
    kw = _cfg(estimator=est, light_sampler=sampler)
    fb_pre, cache_f, cache_tri, ss, sf, count, n_log, n_phys = jregen.primary_prepass(
        js, JaxConfig(**kw), jrng.base_key(7), W * H, SPP, jnp.int32(SPP), pix_chunk=CHUNK)
    cfg = RenderConfig(**kw)
    loop = regen.PrepassLoop(ts, cfg, rng.base_key(7), W * H, SPP, SPP, pix_chunk=CHUNK)
    assert (loop.n_chunks, loop.S, loop.P) == (3, 1024, 1024 if est == "split" else 768)
    seeds, count_t, n_log_t, n_phys_t = _prepass(ts, cfg)
    assert not tails                       # survivors stay below P, as JAX's cond finds
    assert count_t == int(count) > 0 and (n_log_t, n_phys_t) == (int(n_log), int(n_phys))
    np.testing.assert_array_equal(seeds.cache_tri.numpy(), np.asarray(cache_tri))
    k = count_t
    np.testing.assert_array_equal(seeds.sample[:k].numpy(), np.asarray(ss)[:k])
    wi_gap = np.abs(seeds.wi[:k].numpy() - np.stack([np.asarray(x) for x in sf[0:3]], 1)[:k])
    assert int((wi_gap.max(-1) > 1e-5).sum()) <= k // 1000 and wi_gap.max() <= 1e-4
    np.testing.assert_allclose(seeds.tp[:k].numpy(),
                               np.stack([np.asarray(x) for x in sf[3:6]], 1)[:k], rtol=1e-2)
    np.testing.assert_allclose(seeds.pdf[:k].numpy(), np.asarray(sf[6])[:k], rtol=1e-2)
    a, b = np.asarray(fb_pre), seeds.fb_pre.numpy()
    coarse = ~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)
    assert int(coarse.sum()) <= max(2, W * H // 100) and abs(b.sum() / a.sum() - 1.0) < 1e-3


@pytest.mark.parametrize("change", [
    {}, dict(estimator="brdf"), dict(estimator="split", light_sampler="uniform_area"),
    dict(light_sampler="uniform_area"), dict(ref_mis_weights=True),
])
def test_forced_tail_is_exact(veach_scene, monkeypatch, tails, change):
    _, ts = _pair(veach_scene, W, H)
    cfg = RenderConfig(**_cfg(**change))
    want = _prepass(ts, cfg)
    assert not tails
    monkeypatch.setattr(regen, "_prefix_rows", lambda S, cfg: 256)
    got = _prepass(ts, cfg)
    assert len(tails) == 3                 # every chunk overflows 256 rows
    _assert_same_prepass(want, got, fb_rtol=1e-6)


def test_zero_round_prepass_shades_nothing(veach_scene, counted_traces):
    """A 0-round prepass (render_image_regen's warm-up) against JAX's: no
    seed, the same ray counts and primary hits, fb_pre zero; it traces
    each chunk's camera fan (K4) and runs the chunk any launch runs, so
    that a job's graph captures it: its shadow batch (K5) holds only
    masked rows and counts no ray."""
    js, ts = _pair(veach_scene, W, H)
    kw = _cfg()
    fb_pre, _, cache_tri, _, _, count, n_log, n_phys = jregen.primary_prepass(
        js, JaxConfig(**kw), jrng.base_key(7), W * H, SPP, jnp.int32(0), pix_chunk=CHUNK)
    c0 = launches.counts()
    seeds, count_t, n_log_t, n_phys_t = regen.primary_prepass(
        ts, RenderConfig(**kw), rng.base_key(7), W * H, SPP, 0, pix_chunk=CHUNK)
    c1 = launches.counts()
    assert count_t == int(count) == 0 and (n_log_t, n_phys_t) == (int(n_log), int(n_phys))
    np.testing.assert_array_equal(seeds.cache_tri.numpy(), np.asarray(cache_tri))
    assert not seeds.fb_pre.any() and not np.asarray(fb_pre).any()
    assert c1["K4 nearest_hit_culled"] - c0["K4 nearest_hit_culled"] == 3
    assert c1["K5 occluded_culled"] - c0["K5 occluded_culled"] == 3


@pytest.fixture
def counted_traces(monkeypatch):
    """Stand-ins for the kernels' launches on CPU tensors: each trace bumps
    the counter of the kernel it would launch on the card (K4 / K5 culled,
    K1 / K2 otherwise), each light pick K3's launches and its picks (one
    a uniform)."""
    real_i, real_o = ops_intersect.intersect, ops_intersect.occluded
    real_k3 = arvo_cuda.arvo_select

    def intersect(*a, **kw):
        k = intersect_cuda.nearest_hit_culled if kw.get("cull") else intersect_cuda.nearest_hit
        k.launches += 1
        return real_i(*a, **kw)

    def occluded(*a, **kw):
        k = intersect_cuda.occluded_culled if kw.get("cull") else intersect_cuda.occluded
        k.launches += 1
        return real_o(*a, **kw)

    def arvo_select(C, x1, n, u):
        real_k3.launches += 1
        real_k3.picks += u.numel()
        return real_k3(C, x1, n, u)

    monkeypatch.setattr(ops_intersect, "intersect", intersect)
    monkeypatch.setattr(ops_intersect, "occluded", occluded)
    monkeypatch.setattr(arvo_cuda, "arvo_select", arvo_select)
    before = launches.counts()
    yield
    launches.restore(before)


class _Graph:
    """A stand-in CUDA graph whose replay runs the step with the launch
    counters held: a replay runs no Python wrapper, and CapturedStep adds
    the captured launches."""

    def __init__(self, step):
        self.step, self.replays = step, 0

    def replay(self):
        self.replays += 1
        held = launches.counts()
        self.step()
        launches.restore(held)


def _stand_in_graphs(monkeypatch, state_of):
    """GraphedLoop on stand-ins: the first call runs (warm-up), the second
    captures, which runs the step on the state ``state_of(step)`` and
    restores it (it runs nothing), and replays; the rest replay. Returns
    the list of loops made."""
    loops = []

    @contextlib.contextmanager
    def records_nothing(state):
        saved = _clone(state)
        yield
        for k, v in saved.items():
            state[k].copy_(v)

    def capture(step):
        return graph_mod.CapturedStep(step, graph=_Graph(step),
                                      capture=lambda g: records_nothing(state_of(step)))

    class Loop(graph_mod.GraphedLoop):
        def __init__(self, step, device, pool=None):     # a stand-in allocates no pool
            super().__init__(step, device, capture=capture)
            loops.append(self)

        def warm_up(self):
            self.step()

    monkeypatch.setattr(graph_mod, "use_graph", lambda graph, device: True)
    monkeypatch.setattr(graph_mod, "GraphedLoop", Loop)
    return loops


@pytest.mark.parametrize("forced", [False, True])
def test_prepass_graph_schedule_keeps_the_eager_prepass(veach_scene, monkeypatch, tails,
                                                        counted_traces, forced):
    _, ts = _pair(veach_scene, W, H)
    cfg = RenderConfig(**_cfg())
    if forced:
        monkeypatch.setattr(regen, "_prefix_rows", lambda S, cfg: 256)
    c0 = launches.counts()
    want = _prepass(ts, cfg, graph=False)
    c1 = launches.counts()
    loops = _stand_in_graphs(monkeypatch, lambda step: step.__self__.state)
    got = _prepass(ts, cfg)
    c2 = launches.counts()
    (loop,) = loops
    assert loop.calls == 3 and loop.captured.graph.replays == 2
    assert len(tails) == (6 if forced else 0)
    _assert_same_prepass(want, got)
    eager = {k: c1[k] - c0[k] for k in c0}
    assert eager == {k: c2[k] - c1[k] for k in c0}
    assert eager["K4 nearest_hit_culled"] == 3 and eager["K5 occluded_culled"] == (6 if forced
                                                                                    else 3)
    # One light pick a chunk for all its rounds: CHUNK x SPP picks.
    assert eager["K3 arvo_select"] == 3 and eager["K3 arvo_select picks"] == 3 * CHUNK * SPP


def test_graph_true_on_cpu_raises(cornell_scene):
    _, ts = _pair(cornell_scene, 8, 8)
    cfg = RenderConfig(width=8, height=8, spp=1, estimator="mis", max_depth=4, seed=1)
    with pytest.raises(ValueError, match="graph=True"):
        regen.primary_prepass(ts, cfg, rng.base_key(1), 64, 1, 1, graph=True)
    idx = torch.arange(64)
    ro, rd = generate_rays(ts.camera, idx)
    with pytest.raises(ValueError, match="graph=True"):
        wavefront.RayRenderer(ts, cfg, graph=True)(rng.lane_keys(rng.base_key(1), idx), ro, rd)
    with pytest.raises(ValueError, match="graph=True"):
        render_image(ts, cfg, graph=True)


def _rays(ts, seed=5):
    idx = torch.arange(ts.camera.width * ts.camera.height)
    return (rng.lane_keys(rng.sample_key(rng.base_key(seed), 0), idx),
            *generate_rays(ts.camera, idx))


def _run_steps(ts, cfg, key, ro, rd):
    """bounce_loop run by hand: the states before the first bounce and
    after each one, and iterate."""
    st, load, iterate = wavefront.bounce_loop(ts, cfg, ops_intersect.build_accel(ts), ro.shape[0],
                                              tuple(key.shape))
    load(key, ro, rd)
    snaps = [_clone(st)]
    for d in range(cfg.max_depth):
        if d and not bool(st["active"].any()):
            break
        iterate(st)
        snaps.append(_clone(st))
    return snaps, iterate


@pytest.mark.parametrize("estimator,sampler", [
    ("brdf", "spherical_triangle"), ("split", "spherical_triangle"), ("split", "uniform_area"),
    ("mis", "spherical_triangle"), ("mis", "uniform_area"),
])
def test_in_place_bounce_matches_jax(cornell_scene, estimator, sampler):
    js, ts = _pair(cornell_scene, 16, 16)
    kw = dict(spp=1, estimator=estimator, light_sampler=sampler, max_depth=32, seed=0)
    idx = np.arange(256, dtype=np.int32)
    jk = jrng.lane_keys(jrng.sample_key(jrng.base_key(5), 0), jnp.asarray(idx))
    la, sa = jax_render_rays(js, JaxConfig(**kw), jk, *jax_generate_rays(js.camera,
                                                                         jnp.asarray(idx)),
                             with_stats=True)
    cfg = RenderConfig(**kw)
    snaps, iterate = _run_steps(ts, cfg, *_rays(ts))
    last = snaps[-1]
    a, b = np.asarray(la), last["L"].numpy()
    assert np.isfinite(b).all()
    ra, rb = int(sa["rays"]), int(last["nrays"])
    assert abs(rb - ra) <= 0.005 * ra, (ra, rb)
    assert int((~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)).sum()) <= max(2, 256 // 100)
    assert int(last["d"]) == len(snaps) - 1

    # The eager loop's result, and the step as a function of the state.
    L, stats = wavefront.render_rays(ts, cfg, *_rays(ts), with_stats=True)
    assert torch.equal(L, last["L"]) and int(stats["rays"]) == rb
    for i in sorted({0, 1, len(snaps) // 2, len(snaps) - 2}):
        st = _clone(snaps[i])
        iterate(st)
        for k, v in st.items():
            assert torch.equal(v, snaps[i + 1][k]), (i, k)


@pytest.mark.parametrize("estimator,ref_mis", [("mis", False), ("split", False), ("brdf", False),
                                               ("mis", True)])
def test_bounce_graph_schedule_keeps_the_eager_loop(cornell_scene, monkeypatch, counted_traces,
                                                    estimator, ref_mis):
    """RayRenderer on the stand-ins against render_rays (eager): radiance
    bit-equal, rays and K1 / K2 launches equal; render_image keeps one
    graph over its chunks and spp: bounce 0 of the first chunk the
    warm-up, every later bounce a replay, the image bit-equal."""
    _, ts = _pair(cornell_scene, 16, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, estimator=estimator, max_depth=16, seed=3,
                       ray_chunk=96, ref_mis_weights=ref_mis)
    key, ro, rd = _rays(ts)
    c0 = launches.counts()
    want, ws = wavefront.render_rays(ts, cfg, key, ro, rd, with_stats=True)
    c1 = launches.counts()
    img = render_image(ts, cfg, graph=False).image
    c2 = launches.counts()
    loops = _stand_in_graphs(monkeypatch, lambda step: step.args[0])
    got, gs = wavefront.RayRenderer(ts, cfg)(key, ro, rd, with_stats=True)
    c3 = launches.counts()
    (loop,) = loops
    # K1 traces each bounce's extension rays (and, with ref_mis_weights,
    # its BRDF rays against the lights-only accel).
    bounces = (c1["K1 nearest_hit"] - c0["K1 nearest_hit"]) // (2 if ref_mis else 1)
    assert torch.equal(got, want) and int(gs["rays"]) == int(ws["rays"])
    assert {k: c1[k] - c0[k] for k in c0} == {k: c3[k] - c2[k] for k in c0}
    assert loop.calls == bounces > 2 and loop.captured.graph.replays == bounces - 1
    res = render_image(ts, cfg)
    c4 = launches.counts()
    assert np.array_equal(res.image, img)
    assert {k: c2[k] - c1[k] for k in c0} == {k: c4[k] - c3[k] for k in c0}
    one = loops[1]
    assert one.captured.graph.replays == one.calls - 1 and one.calls > 2 * 3


def test_grad_and_grid_never_capture(cornell_scene, monkeypatch):
    """With gradients on, pixel_grad and a RayRenderer left to decide
    (graph=None) run the eager loop even where a graph would be taken (the
    stand-in GraphedLoop raises if it is made), and pixel_grad's gradients
    equal the eager loop's bit for bit; graph=True with gradients, the
    grid or the shoot estimator raises."""
    _, ts = _pair(cornell_scene, 8, 8)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=4, seed=0)
    key, ro, rd = _rays(ts, seed=3)
    sel = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 1.0, (64, 3)).astype(np.float32))
    want = tgrad.pixel_grad(ts, cfg, key, ro, rd, sel)

    class NoCapture:
        def __init__(self, *a, **kw):
            raise AssertionError("the gradient path captured its bounce")

    monkeypatch.setattr(graph_mod, "use_graph", lambda graph, device: True)
    monkeypatch.setattr(graph_mod, "GraphedLoop", NoCapture)
    got = tgrad.pixel_grad(ts, cfg, key, ro, rd, sel)
    for f in ("kd", "ks", "ns", "emission"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    m = ts.materials
    sc = ts.with_materials(dataclasses.replace(m, kd=m.kd.clone().requires_grad_(True)))
    L = wavefront.RayRenderer(sc, cfg)(key, ro, rd)
    assert L.requires_grad and torch.equal(L.detach(), wavefront.render_rays(ts, cfg, key, ro, rd))
    with pytest.raises(ValueError, match="graph=True"):
        wavefront.RayRenderer(sc, cfg, graph=True)(key, ro, rd)
    with pytest.raises(ValueError, match="graph=True"), torch.no_grad():
        wavefront.RayRenderer(ts, cfg.replace(accel="grid"), graph=True)(key, ro, rd)
    with pytest.raises(ValueError, match="graph=True"), torch.no_grad():
        wavefront.RayRenderer(ts, cfg.replace(estimator="shoot"), graph=True)(key, ro, rd)

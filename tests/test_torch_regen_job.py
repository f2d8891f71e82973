"""One ``render_image_regen`` job (integrator/regen.py::RegenJob) on the CPU:
its launches keep one scene context, one state and one captured step per
loop, on the stand-in graphs of tests/test_torch_prepass_graph.py (a
capture runs nothing; a replay re-runs the job's one step, so a launch
value that the step took from Python when it was built, and not from the
state, would replay the first launch's value and show here).

- The cached route (prepass and loop) and the uncached route (loop), in a
  job of four launches: the warm-up (0 rounds cached, ``lanes`` samples
  uncached), 2 spp, 2 spp from spp0 = 2, and a short last launch of 1 spp.
  Each loop has one ``GraphedLoop`` a job, which warms up once, captures
  once and replays in every launch after the one that captures; the scene
  context is built once. Every launch's framebuffer, logical rays and
  iterations are those of the same launch run as its own eager call
  (``graph=False``) bit for bit, and so are the image and the rays.
- A job takes a new key at every launch (the sharded renderer's launches,
  each keyed by its index): three launches of three keys folded from one
  seed, cached and uncached, are each bit-equal to a one-launch job of
  their own key, and the job builds its context, parts and key buffer
  once; the stand-in replays read the key buffer, which each launch
  rewrites.
- A launch that changes an argument its part was built from (here the
  lanes) raises, a new key gives that key's image, and the job frees its
  parts and key buffer when its ``with`` block ends.
The card runs a job against eager launches (tests/test_torch_cuda.py)."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen, shading
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_prepass_graph import _stand_in_graphs
from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")
W = H = 12
N_PIX = W * H
LANES = 64
#: (spp0, spp) of the timed launches: 5 spp in launches of at most 2.
LAUNCHES = [(0, 2), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def scene():
    sc = load_scene(CORNELL, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=W, height=H))


def _cfg(cached):
    return RenderConfig(width=W, height=H, spp=5, estimator="mis",
                        light_sampler="spherical_triangle", max_depth=16, seed=9,
                        primary_cache=cached)


def _launch(scene, cfg, cached, spp0, spp, **kw):
    """One launch of the job's route: the warm-up for spp None."""
    key = kw.pop("key", rng.base_key(cfg.seed))
    if cached:
        return regen.render_regen_cached(scene, cfg, key, N_PIX, 2, spp or 0, lanes=LANES,
                                         spp0=spp0, **kw)
    total = min(LANES, N_PIX * cfg.spp) if spp is None else N_PIX * spp
    return regen.render_regen(scene, cfg, key, N_PIX, total, lanes=LANES, spp0=spp0, **kw)


def _state_of(step):
    return step.args[0] if isinstance(step, functools.partial) else step.__self__.state


@pytest.mark.parametrize("cached", [True, False])
def test_job_replays_its_launches_as_eager_launches(scene, monkeypatch, cached):
    cfg = _cfg(cached)
    want = [_launch(scene, cfg, cached, 0, None, graph=False)]
    want += [_launch(scene, cfg, cached, s0, s, graph=False) for s0, s in LAUNCHES]

    loops = _stand_in_graphs(monkeypatch, _state_of)
    name = "render_regen_cached" if cached else "render_regen"
    real, made = getattr(regen, name), []
    got = []

    def launch(*a, **kw):
        out = real(*a, **kw)
        got.append((out[0].clone(), int(out[1]), out[2],
                    [(lp.calls, lp.captured.graph.replays if lp.captured else 0)
                     for lp in loops]))
        return out

    real_context = shading.scene_context
    monkeypatch.setattr(regen, name, launch)
    monkeypatch.setattr(shading, "scene_context", lambda *a: made.append(1) or real_context(*a))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = render_image_regen(scene, cfg, lanes=LANES, max_samples_per_launch=2 * N_PIX)

    assert len(got) == len(want) == 1 + len(LAUNCHES) and len(made) == 1
    for i, ((fb, rays, iters, _), w) in enumerate(zip(got, want)):
        assert torch.equal(fb, w[0]), i
        assert rays == int(w[1]) and iters == w[2], i
        assert iters > 0 or (i == 0 and cached)      # a 0-round loop does not iterate
    acc = np.zeros((N_PIX, 3), np.float32)
    for w in want[1:]:
        acc += w[0].numpy()
    assert np.array_equal(r.image, (acc / cfg.spp).reshape(H, W, 3))
    assert r.rays_traced == sum(int(w[1]) for w in want[1:])

    # One GraphedLoop a loop a job: one warm-up, one capture, every later
    # step a replay, and every launch after the first timed one replays only.
    assert len(loops) == (2 if cached else 1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("graph.warm_up") == names.count("graph.capture") == len(loops)
    for j, lp in enumerate(loops):
        assert lp.captured is not None and lp.captured.graph.replays == lp.calls - 1
        for prev, now in zip(got[1:], got[2:]):
            (c0, r0), (c1, r1) = prev[3][j], now[3][j]
            assert r1 - r0 == c1 - c0 > 0


@pytest.mark.parametrize("cached", [True, False])
def test_a_job_takes_a_new_key_at_every_launch(scene, monkeypatch, cached):
    cfg = _cfg(cached)
    keys = [rng.fold_in(rng.base_key(cfg.seed), i) for i in range(3)]
    want = [_launch(scene, cfg, cached, 0, 2, key=k, graph=False) for k in keys]
    for a, b in zip(want, want[1:]):
        assert not torch.equal(a[0], b[0])           # the keys give other images

    loops = _stand_in_graphs(monkeypatch, _state_of)
    real_context, made = shading.scene_context, []
    monkeypatch.setattr(shading, "scene_context", lambda *a: made.append(1) or real_context(*a))
    with regen.RegenJob() as job:
        for i, (k, w) in enumerate(zip(keys, want)):
            fb, rays, iters, _ = _launch(scene, cfg, cached, 0, 2, key=k, job=job)
            assert torch.equal(fb, w[0]), i
            assert int(rays) == int(w[1]) and iters == w[2], i
            if i == 0:
                parts = {name: part for name, (_, part) in job.parts.items()}
                key_buf = job.key_buf
            assert {name: part for name, (_, part) in job.parts.items()} == parts
            assert job.key_buf is key_buf and torch.equal(key_buf, k)
    assert len(made) == 1 and len(loops) == (2 if cached else 1)
    for lp in loops:
        assert lp.captured is not None and lp.captured.graph.replays == lp.calls - 1


def test_a_job_keeps_its_launches_arguments(scene):
    cfg = _cfg(False)
    key = rng.base_key(cfg.seed)
    new = rng.fold_in(key, 1)
    with regen.RegenJob() as job:
        _launch(scene, cfg, False, 0, 1, key=key, job=job)
        _launch(scene, cfg, False, 1, 1, key=key, job=job)
        with pytest.raises(ValueError, match="changed what its loop was built from"):
            regen.render_regen(scene, cfg, key, N_PIX, N_PIX, lanes=2 * LANES, job=job)
        fb, rays, _, _ = _launch(scene, cfg, False, 0, 1, key=new, job=job)
        want = _launch(scene, cfg, False, 0, 1, key=new)
        assert torch.equal(fb, want[0]) and int(rays) == int(want[1])
        assert not torch.equal(fb, _launch(scene, cfg, False, 0, 1, key=key)[0])
        assert set(job.parts) == {"context", "loop"}
    assert not job.parts and job.key_buf is None

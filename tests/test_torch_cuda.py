"""The port's CUDA kernels K1-K3 against their plain torch versions, and the
port's render on the card against the same render on the CPU.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build, arvo_cuda, intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu_torch.ops import intersect_ref
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(name, wh=None):
    sc = load_scene(os.path.join(SCENES, name, f"{name}.obj"))
    if wh:
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=wh, height=wh))
    return sc


def _rays(T, N, dev, seed=0):
    g = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    W = intersect_ref.pack_tri_matrix(f(g.uniform(-2, 2, (T, 3))), f(g.normal(size=(T, 3))),
                                      f(g.normal(size=(T, 3)))).contiguous()
    rd = g.normal(size=(N, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    g10 = intersect_ref.ray_features(f(g.uniform(-4, 4, (N, 3))), f(rd)).contiguous()
    excl = torch.from_numpy(np.where(np.arange(N) % 7 == 0, np.arange(N) % T, -1)
                            .astype(np.int32)).to(dev)
    tmax = f(g.uniform(0.5, 6.0, N)) * (1.0 - ops_intersect.OCCLUSION_MARGIN)
    return g10, W, torch.arange(T, dtype=torch.int32, device=dev), excl, tmax


@pytest.mark.parametrize("T,N", [(1, 5), (300, 257), (3000, 4097)])
def test_k1_k2_match_plain(dev, T, N):
    """Same f32 arithmetic (ordered dots, -fmad=false): ids and blocked
    flags equal, t / u / v to 1e-6."""
    g, W, ids, excl, tmax = _rays(T, N, dev, seed=T)
    n1, n2 = intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches
    hk = intersect_cuda.nearest_hit(g, W, ids, excl)
    hp = intersect_cuda.nearest_hit_plain(g, W, ids, excl)
    assert (intersect_cuda.nearest_hit.launches, intersect_cuda.occluded.launches) == (n1 + 1, n2)
    assert (hk.tri_id == hp.tri_id).all() and (hk.valid == hp.valid).all()
    for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    bk = intersect_cuda.occluded(g, W, ids, excl, tmax)
    assert intersect_cuda.occluded.launches == n2 + 1
    assert (bk == intersect_cuda.occluded_plain(g, W, ids, excl, tmax)).all()


def test_k3_matches_plain(dev):
    sc = _scene("veach-mis").to(dev)
    g = np.random.default_rng(3)
    v = sc.tri_v0.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    x1 = f(g.random((8192, 3)) * (hi - lo) * 0.8 + lo + 0.1 * (hi - lo))
    nrm = g.normal(size=(8192, 3))
    nrm = f(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    u = f(g.random(8192))
    C = arvo_cuda.pack_consts(sc)
    n3 = arvo_cuda.arvo_select.launches
    ik, wk = arvo_cuda.arvo_select(C, x1, nrm, u)
    ip, wp = arvo_cuda.arvo_select_plain(C, x1, nrm, u)
    assert arvo_cuda.arvo_select.launches == n3 + 1
    assert int((ik != ip).sum()) <= 8                 # CDF-boundary fringe
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g, W, ids, excl, tmax = _rays(16, 8, dev)
    with pytest.raises(TypeError):
        intersect_cuda.nearest_hit(g.double(), W, ids, excl)
    with pytest.raises(ValueError):
        intersect_cuda.nearest_hit(g, W, ids, excl.cpu())
    with pytest.raises(ValueError):
        intersect_cuda.occluded(g, W, ids, excl, tmax[:4])
    with pytest.raises(ValueError):
        intersect_cuda.nearest_hit(g.t().contiguous().t(), W, ids, excl)
    assert _build.load() is _build.load()             # one build per process


def test_render_card_matches_cpu(dev):
    """The port's render_image_regen on the card (K1-K3) and on the CPU
    (plain versions): ray counts to 0.1%, at most 1% of pixels diverged
    beyond rtol 1e-2 / atol 1e-3 (transcendentals differ by ulps)."""
    sc = _scene("cornell", 24)
    cfg = RenderConfig(width=24, height=24, spp=2, estimator="mis", seed=11, max_depth=32)
    counts = (intersect_cuda.nearest_hit.launches, arvo_cuda.arvo_select.launches)
    a = render_image_regen(sc, cfg, lanes=512)
    b = render_image_regen(sc.to(dev), cfg, lanes=512)
    assert intersect_cuda.nearest_hit.launches > counts[0]
    assert arvo_cuda.arvo_select.launches > counts[1]
    assert abs(a.rays_traced - b.rays_traced) <= a.rays_traced // 1000
    diverged = ~np.isclose(b.image, a.image, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)

"""The blocker-chain queue (``mis_blocker_compat``, the reference's full MIS
recursion) of the port's regeneration loop, against the JAX package on
the CPU and on its own contract.

Tolerances. Chain k of a launch draws from fold(chain_base, k), and k is
the order in which the loop enqueued it, so one path that diverges (a ulp
flip, see tests/test_torch_regen.py) renumbers every later chain and its
stream: the images of the two packages then agree only in the mean. So:
logical rays within 0.5% and chains within 1% of JAX's, at most 1% of
pixels (at least 2) beyond rtol 1e-2 / atol 1e-3 and means to 1e-3 on
cornell 16^2 x 8 spp (measured: rays, chains and image equal); the chain
stream keys bit-equal to JAX's formula for the same sample ids."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.integrator import regen as jregen
from monte_carlo_path_tracing_tpu.oracle import ScalarOracle
from monte_carlo_path_tracing_tpu.render.camera import generate_rays as jax_generate_rays
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen, render_rays
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _pair

BLOCKER = dict(estimator="mis", max_depth=32, ref_mis_weights=True, mis_blocker_compat=True)


def _regen(ts, cfg, n_pix, lanes, **kw):
    fb, nrays, iters, stats = regen.render_regen(ts, cfg, rng.base_key(cfg.seed), n_pix,
                                                 n_pix * cfg.spp, lanes=lanes, **kw)
    return fb.numpy() / cfg.spp, int(nrays), iters, stats


def test_blocker_queue_vs_restructure(cornell_scene):
    """JAX tests/test_regen.py:138 on the port: the queue runs, traces more
    rays (the chains), spills nothing, and agrees with the restructured
    estimator within Monte Carlo noise (7%) on cornell 16^2 x 48 spp."""
    _, ts = _pair(cornell_scene, 16)
    base = dict(width=16, height=16, spp=48, estimator="mis", max_depth=32, seed=4,
                ref_mis_weights=True)
    img_nb, rays_nb, _, st_nb = _regen(ts, RenderConfig(**base), 256, 512)
    img_bl, rays_bl, _, st_bl = _regen(ts, RenderConfig(**base, mis_blocker_compat=True), 256,
                                       512)
    assert st_nb.chains == 0 and st_bl.spilled == 0 and st_bl.chains > 0
    assert rays_bl > rays_nb
    assert np.isfinite(img_bl).all()
    ratio = img_bl.mean() / img_nb.mean()
    assert 0.93 < ratio < 1.07, (img_bl.mean(), img_nb.mean())


def test_blocker_queue_conservation(cornell_scene):
    """JAX tests/test_regen.py:173 on the port, record by record (the loop
    state seen through ``on_iter``): every chain enqueued is dequeued
    exactly once, with a unit direction and a non-zero throughput; nothing
    spills; the queue drains; the chain count is the number dequeued."""
    _, ts = _pair(cornell_scene, 8)
    cfg = RenderConfig(width=8, height=8, spp=24, seed=4, branch_pdf_compat=True, **BLOCKER)
    snaps = []
    _, _, _, stats = _regen(ts, cfg, 64, 256,
                            on_iter=lambda st: snaps.append({k: v.clone() for k, v in st.items()}))
    assert stats.spilled == 0 and stats.chains > 0
    started = {}
    for it in range(1, len(snaps)):
        prev, cur = snaps[it - 1], snaps[it]
        newly = (cur["sample"] < 0) & cur["alive"] & ((prev["sample"] != cur["sample"])
                                                      | ~prev["alive"])
        for lane in torch.nonzero(newly).flatten().tolist():
            cid = int(-1 - cur["sample"][lane])
            assert cid not in started, f"chain {cid} dequeued twice"
            started[cid] = it
            assert abs(float(torch.linalg.norm(cur["rd"][lane])) - 1.0) < 1e-3
            assert float(cur["tp"][lane].abs().sum()) > 0.0
    assert len(started) == stats.chains
    assert sorted(started) == list(range(stats.chains))
    assert int(snaps[-1]["buf_count"]) == 0


def test_blocker_spills_on_a_small_queue(cornell_scene, capsys, monkeypatch):
    """One lane, so a queue of one row: a path that spawns a second chain
    before it ends spills it. render_image_regen sums ``spilled`` over its
    launches and prints JAX's warning with that sum; spilled chains are not
    counted in ``chains``."""
    _, ts = _pair(cornell_scene, 8)
    cfg = RenderConfig(width=8, height=8, spp=1, seed=4, **BLOCKER)
    stats = []
    real = regen.render_regen
    monkeypatch.setattr(regen, "render_regen", lambda *a, **k: _record(real, stats, *a, **k))
    r = render_image_regen(ts, cfg, lanes=1)
    out = capsys.readouterr().out
    assert np.isfinite(r.image).all()
    timed = stats[1:]                      # stats[0]: the warm-up launch
    spilled = sum(s.spilled for s in timed)
    assert spilled > 0
    assert f"[regen] WARNING: {spilled} blocker chains spilled" in out


def _record(fn, into, *a, **k):
    out = fn(*a, **k)
    into.append(out[3])
    return out


def test_blocker_matches_jax(cornell_scene):
    js, ts = _pair(cornell_scene, 16)
    kw = dict(width=16, height=16, spp=8, seed=4, **BLOCKER)
    fa, ra, _, sa = jax.jit(lambda s, k: jregen.render_regen(
        s, JaxConfig(**kw), k, 256, 256 * 8, lanes=512))(js, jrng.base_key(4))
    b, rb, _, sb = _regen(ts, RenderConfig(**kw), 256, 512)
    a = np.asarray(fa) / 8
    ra, ca = float(ra), int(sa.chains)
    assert abs(rb - ra) <= 0.005 * ra, (ra, rb)
    assert abs(sb.chains - ca) <= 0.01 * ca and sb.spilled == int(sa.spilled) == 0
    coarse = int((~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)).sum())
    print(f"rays {ra} vs {rb}, chains {ca} vs {sb.chains}, {coarse} of 256 pixels diverged")
    assert coarse <= max(2, 256 // 100)
    assert abs(b.mean() / a.mean() - 1.0) < 1e-3


def test_chain_stream_keys_match_jax():
    """lane_keys against JAX's lane_stream formula (integrator/regen.py:
    340-352) for real and chain sample ids, negatives included, with a
    pixel stride, offset and spp0: bit-equal words."""
    n_pix, spp0, stride, offset = 96, 3, 2, 1
    sample = np.array([0, 1, 95, 96, 500, -1, -2, -7, -96, -97, -1000], np.int32)
    pixel = np.abs(sample) % n_pix
    base = jrng.base_key(9)
    chain_base = jrng.fold_in(jrng.fold_in(base, jregen._CHAIN_TAG), spp0)
    s, p = jnp.asarray(sample), jnp.asarray(pixel)
    real = jnp.where(s < 0, 0, s)
    k_real = jrng.fold_in(jrng.fold_in(base, spp0 + real // n_pix), p * stride + offset)
    want = jnp.where((s < 0)[:, None], jax.random.key_data(jrng.fold_in(chain_base, -1 - s)),
                     jax.random.key_data(k_real))
    tb = rng.base_key(9)
    got = regen.lane_keys(tb, torch.as_tensor(sample, dtype=torch.int64),
                          torch.as_tensor(pixel, dtype=torch.int64), n_pix, spp0, stride, offset,
                          regen.chain_key(tb, spp0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert regen._CHAIN_TAG == jregen._CHAIN_TAG


def test_render_rays_and_cache_refuse_blocker(cornell_scene):
    """As in JAX: the fixed-depth path raises (the queue belongs to the
    regeneration renderer), the cache is never eligible, and the seeded
    loop refuses it."""
    js, ts = _pair(cornell_scene, 4)
    cfg = RenderConfig(**BLOCKER)
    assert not regen.primary_cache_eligible(cfg)
    assert not jregen.primary_cache_eligible(JaxConfig(**BLOCKER))
    idx = torch.arange(16)
    with pytest.raises(NotImplementedError, match="render_image_regen"):
        render_rays(ts, cfg, rng.lane_keys(rng.base_key(0), idx), *[torch.zeros(16, 3)] * 2)
    with pytest.raises(ValueError, match="requires ref_mis_weights"):
        RenderConfig(estimator="mis", mis_blocker_compat=True).validate()


_PIXELS = (17, 60, 100, 120, 137, 200, 230, 150)


@pytest.mark.slow
def test_blocker_queue_matches_reference_oracle(cornell_scene):
    """JAX tests/test_oracle.py:125 on the port: --ref-mis-full against the
    independent numpy oracle running the reference's exact recursion
    (main.cpp:402-494, the occluded-blocker branch included). (1) The
    probe patch's mean agrees within 6% (Monte Carlo); (2) chains per path
    (RegenStats.chains) match the oracle's blocker events per path within
    15%. Slow, as JAX's is: 153,600 paths on the CPU."""
    cam16 = dataclasses.replace(cornell_scene.camera, width=16, height=16)
    ro, rd = jax_generate_rays(cam16, jnp.asarray(_PIXELS, jnp.int32))
    oracle = ScalarOracle(cornell_scene, estimator="mis", blocker_recursion=True,
                          ref_mis_weights=True, branch_pdf=True)
    img_o, img_o_rest = oracle.trace_pair(np.random.default_rng(7), np.asarray(ro),
                                          np.asarray(rd), 600)
    _, ts = _pair(cornell_scene, 16)
    cfg = RenderConfig(width=16, height=16, spp=600, seed=13, branch_pdf_compat=True, **BLOCKER)
    img, _, _, stats = _regen(ts, cfg, 256, 2048)
    assert stats.spilled == 0
    ma, mb = img_o.mean(), img[list(_PIXELS)].mean()
    assert abs(ma - mb) / max(ma, mb) < 0.06, (ma, mb)

    rate_w = stats.chains / (256 * 600)
    ro_all, rd_all = jax_generate_rays(cam16, jnp.arange(256, dtype=jnp.int32))
    oracle.trace(np.random.default_rng(21), np.asarray(ro_all), np.asarray(rd_all), 30)
    rate_o = oracle.chain_events / (256 * 30)
    assert rate_o > 0 and rate_w > 0, (rate_o, rate_w)
    assert abs(rate_o - rate_w) / max(rate_o, rate_w) < 0.15, (rate_o, rate_w)
    assert (img_o - img_o_rest).mean() > 0

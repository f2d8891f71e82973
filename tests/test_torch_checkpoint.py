"""The port's render checkpoints (utils/checkpoint.py) against the JAX
package's: the same npz layout read and accepted in both directions, the
same compatibility keys, and exact resume of the fixed-depth render."""

import dataclasses

import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.utils import checkpoint as jck
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image
from monte_carlo_path_tracing_tpu_torch.scene import scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils import checkpoint as ck
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

#: A change of each compatibility key that moves the estimate.
CHANGES = {"width": 25, "height": 23, "estimator": "brdf", "light_sampler": "uniform_area",
           "rr_prob": 0.5, "max_depth": 5, "seed": 5, "pixel_jitter": True}


def _ckpt(cfg, spp_done=2, seed=4):
    fb = np.random.default_rng(0).uniform(0, 3, (cfg.height, cfg.width, 3)).astype(np.float32)
    return ck.RenderCheckpoint(framebuffer_sum=fb, spp_done=spp_done, seed=seed,
                               config=ck.config_dict(cfg))


def test_save_load_round_trip(tmp_path):
    cfg = RenderConfig(width=24, height=24, spp=8, seed=4)
    c = _ckpt(cfg)
    path = str(tmp_path / "sub" / "ck.npz")
    ck.save(path, c)
    ck.save(path, c)                           # overwrites atomically
    c2 = ck.load(path)
    assert (c2.spp_done, c2.seed, c2.config) == (2, 4, json_round(ck.config_dict(cfg)))
    np.testing.assert_array_equal(c2.framebuffer_sum, c.framebuffer_sum)
    np.testing.assert_array_equal(c2.mean_image(), c.framebuffer_sum / 2)
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["ck.npz"]
    ck.check_compatible(c2, cfg.replace(spp=16, ray_chunk=128))


def json_round(d):
    """A config dict as JSON gives it back (tuples become lists)."""
    import json

    return json.loads(json.dumps(d))


def test_compat_keys_are_jax_keys():
    assert set(CHANGES) == set(ck.COMPAT_KEYS)


@pytest.mark.parametrize("key", sorted(CHANGES))
def test_check_compatible_refuses_each_key(key):
    cfg = RenderConfig(width=24, height=24, spp=8, seed=4)
    with pytest.raises(ValueError, match=key):
        ck.check_compatible(_ckpt(cfg), cfg.replace(**{key: CHANGES[key]}))


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint written by JAX's save loads and is accepted by the port,
    and the other way round."""
    kw = dict(width=16, height=12, spp=6, estimator="mis", max_depth=4, seed=9)
    fb = np.random.default_rng(1).uniform(0, 2, (12, 16, 3)).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save(jpath, jck.RenderCheckpoint(framebuffer_sum=fb, spp_done=3, seed=9,
                                         config=jck.config_dict(JaxConfig(**kw))))
    ck.save(tpath, ck.RenderCheckpoint(framebuffer_sum=fb, spp_done=3, seed=9,
                                       config=ck.config_dict(RenderConfig(**kw))))
    for loaded in (ck.load(jpath), jck.load(tpath)):
        assert loaded.spp_done == 3 and loaded.seed == 9
        np.testing.assert_array_equal(loaded.framebuffer_sum, fb)
    ck.check_compatible(ck.load(jpath), RenderConfig(**kw))
    jck.check_compatible(jck.load(tpath), JaxConfig(**kw))
    with pytest.raises(ValueError):
        ck.check_compatible(ck.load(jpath), RenderConfig(**dict(kw, seed=1)))
    with pytest.raises(ValueError):
        jck.check_compatible(jck.load(tpath), JaxConfig(**dict(kw, max_depth=3)))


def test_render_resume_equals_uninterrupted(cornell_scene, tmp_path):
    """tests/test_render.py's pattern: 2 spp, checkpoint, resume to 4
    through the saved framebuffer; equal to 4 spp uninterrupted."""
    sc = scene_from_arrays(scene_arrays(cornell_scene), 16, 16, device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=4, estimator="mis", seed=4, max_depth=4,
                       ray_chunk=100)
    full = render_image(sc, cfg).image
    r2 = render_image(sc, cfg.replace(spp=2))
    path = str(tmp_path / "ck.npz")
    ck.save(path, ck.RenderCheckpoint(framebuffer_sum=r2.image * 2, spp_done=2, seed=cfg.seed,
                                      config=ck.config_dict(cfg)))
    c = ck.load(path)
    ck.check_compatible(c, cfg)
    resumed = render_image(sc, cfg, start_spp=c.spp_done, framebuffer=c.framebuffer_sum)
    assert resumed.rays_traced == 2 * 16 * 16
    np.testing.assert_allclose(resumed.image, full, rtol=1e-5, atol=1e-6)


def test_resume_from_jax_checkpoint(cornell_scene, tmp_path):
    """A render checkpointed by the JAX package at 2 spp and resumed by the
    port to 4 lands on the port's uninterrupted render (the packages' images
    agree to f32 round-off: XLA fuses multiply-adds)."""
    from monte_carlo_path_tracing_tpu.render.renderer import render_image as jax_render

    js = dataclasses.replace(cornell_scene, camera=dataclasses.replace(
        cornell_scene.camera, width=12, height=12))
    kw = dict(width=12, height=12, spp=4, estimator="mis", seed=4, max_depth=4)
    jr = jax_render(js, JaxConfig(**dict(kw, spp=2)))
    path = str(tmp_path / "jax.npz")
    jck.save(path, jck.RenderCheckpoint(framebuffer_sum=jr.image * 2, spp_done=2, seed=4,
                                        config=jck.config_dict(JaxConfig(**kw))))
    sc = scene_from_arrays(scene_arrays(cornell_scene), 12, 12, device="cpu")
    c = ck.load(path)
    ck.check_compatible(c, RenderConfig(**kw))
    resumed = render_image(sc, RenderConfig(**kw), start_spp=2, framebuffer=c.framebuffer_sum)
    full = render_image(sc, RenderConfig(**kw)).image
    diverged = ~np.isclose(resumed.image, full, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= 2
    assert abs(resumed.image.mean() / full.mean() - 1.0) < 1e-3

"""The port's scene loading, scene hand-over, camera and tone map against
the JAX package."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import radiometry as jrad
from monte_carlo_path_tracing_tpu.render import camera as jcam
from monte_carlo_path_tracing_tpu.scene import load_scene as jax_load_scene
from monte_carlo_path_tracing_tpu_torch.core import radiometry as trad
from monte_carlo_path_tracing_tpu_torch.render import camera as tcam
from monte_carlo_path_tracing_tpu_torch.render import film
from monte_carlo_path_tracing_tpu_torch.scene import load_scene, scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.scene.types import SCENE_ARRAYS

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture(autouse=True)
def torch_single_thread():
    """Torch on one thread in the port's CPU tests. Tier-1 runs six pytest
    workers on a few cores, and torch's intra-op pool in each worker would
    oversubscribe them (measured on 8 cores: one port test took 188 s in
    the six-worker run instead of 3.9 s alone). Test modules import this
    fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_arrays(scene) -> dict:
    """A Scene's (JAX or port) array leaves as numpy, keyed like SCENE_ARRAYS."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(v, prefix + f.name + ".")
            elif hasattr(v, "shape"):
                out[prefix + f.name] = np.asarray(v)

    walk(scene, "")
    return out


@pytest.mark.parametrize("name", ["cornell", "veach-mis", "veach-mis-golden", "bathroom"])
def test_load_scene_arrays_equal(name):
    path = os.path.join(SCENES, name, "veach-mis.obj" if "veach" in name else f"{name}.obj")
    a = scene_arrays(jax_load_scene(path))
    b = scene_arrays(load_scene(path, device="cpu"))
    assert sorted(a) == sorted(b) == sorted(SCENE_ARRAYS)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_scene_from_arrays_round_trip(veach_scene):
    cam = veach_scene.camera
    sc = scene_from_arrays(scene_arrays(veach_scene), cam.width, cam.height,
                           cam.fov_bug_compat, device="cpu")
    assert sc.num_tris == veach_scene.num_tris and sc.num_lights == veach_scene.num_lights
    a, b = scene_arrays(veach_scene), scene_arrays(sc.to("cpu"))
    for k in SCENE_ARRAYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(veach_scene.light_emission()),
                                  sc.light_emission().numpy())
    for x, y in zip(veach_scene.light_verts(), sc.light_verts()):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    with pytest.raises(KeyError):
        scene_from_arrays({"tri_v0": a["tri_v0"]}, 4, 4, device="cpu")


@pytest.mark.parametrize("entry", ["load_scene", "scene_from_arrays"])
def test_scene_entry_points_default_to_the_card(veach_scene, entry):
    """device="cpu" gives CPU tensors; without device= the scene goes to the
    card, and on a machine without one the call raises instead of quietly
    building a CPU scene."""
    path = os.path.join(SCENES, "veach-mis", "veach-mis.obj")
    cam = veach_scene.camera
    build = {
        "load_scene": lambda **kw: load_scene(path, **kw),
        "scene_from_arrays": lambda **kw: scene_from_arrays(
            scene_arrays(veach_scene), cam.width, cam.height, **kw),
    }[entry]
    sc = build(device="cpu")
    assert all(t.device.type == "cpu" for t in (sc.tri_v0, sc.materials.kd, sc.camera.eye))
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()


@pytest.mark.parametrize("compat", [False, True])
def test_camera_rays(cornell_scene, compat):
    """Camera frame and primary rays to f32 round-off (XLA may fuse
    multiply-adds that torch rounds separately)."""
    jc = dataclasses.replace(cornell_scene.camera, width=40, height=30, fov_bug_compat=compat)
    sc = scene_from_arrays(scene_arrays(cornell_scene), 40, 30, compat, device="cpu")
    tc = sc.camera
    for x, y in zip(jcam.camera_basis(jc), tcam.camera_basis(tc)):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=1e-6, atol=1e-6)
    ju, jv, jn, jd = jcam.camera_basis(jc)
    tu, tv, tn, td = tcam.camera_basis(tc)
    np.testing.assert_allclose(float(jcam.pixel_len(jc, jd)), float(tcam.pixel_len(tc, td)),
                               rtol=1e-6)
    pix = np.arange(0, 1200, 13, dtype=np.int32)
    jro, jrd = jcam.generate_rays(jc, jnp.asarray(pix))
    tro, trd = tcam.primary_dirs(tc, tu, tv, tn, td, tcam.pixel_len(tc, td),
                                 torch.from_numpy(pix).long())
    np.testing.assert_allclose(np.asarray(jro), tro.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(jrd), trd.numpy(), rtol=1e-5, atol=1e-6)


def test_tone_map_and_write(tmp_path):
    rad = np.random.default_rng(0).uniform(0, 500, size=(16, 16, 3)).astype(np.float32)
    a = np.asarray(jrad.tone_map(jnp.asarray(rad)))
    b = trad.tone_map(torch.from_numpy(rad)).numpy()
    assert a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for ext in ("png", "bmp", "npy"):
        film.write_image(str(tmp_path / f"x.{ext}"), rad, 380.0, 0.25)
        assert (tmp_path / f"x.{ext}").stat().st_size > 0
    with pytest.raises(ValueError):
        film.write_image(str(tmp_path / "x.tga"), rad, 380.0, 0.25)

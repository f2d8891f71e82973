"""The port's scene loading remainders against the JAX package: the native
OBJ/MTL parser (scene/native_loader.py, ctypes into
native/libmcpt_loader.so) against the port's Python parser and JAX's
native one, ``load_scene``'s preference for it, and ``subdivide_scene``
(scene/transform.py). The native cases skip, as tests/test_native.py's
do, when the library cannot be built or loaded.

Tolerances: the parsers' arrays equal (floats to rtol 1e-6, the bound of
tests/test_native.py); subdivide_scene is the same numpy code on the same
arrays: equal."""

import os
import subprocess

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.scene import native_loader as jnative
from monte_carlo_path_tracing_tpu.scene.transform import subdivide_scene as jax_subdivide
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator.regen import render_regen
from monte_carlo_path_tracing_tpu_torch.scene import build as tbuild
from monte_carlo_path_tracing_tpu_torch.scene import load_scene, native_loader
from monte_carlo_path_tracing_tpu_torch.scene.objparse import parse_obj
from monte_carlo_path_tracing_tpu_torch.scene.transform import subdivide_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _pair

ROOT = os.path.join(os.path.dirname(__file__), "..")
NATIVE_DIR = os.path.join(ROOT, "native")
SCENES = ["cornell/cornell.obj", "veach-mis/veach-mis.obj"]


@pytest.fixture(scope="module")
def native_lib():
    so = os.path.join(NATIVE_DIR, "libmcpt_loader.so")
    if not os.path.exists(so):
        r = subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"native build failed: {r.stderr[-500:]}")
    native_loader._checked, native_loader._lib = False, None
    if not native_loader.native_available():
        pytest.skip("native loader unavailable")
    return native_loader


def _assert_same_mesh(a, b):
    for f in ("face_v", "face_vn", "face_mat"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_allclose(a.vertices, b.vertices, rtol=1e-6)
    np.testing.assert_allclose(a.normals, b.normals, rtol=1e-6)
    assert a.material_names == b.material_names and set(a.materials) == set(b.materials)
    for name, pm in b.materials.items():
        nm = a.materials[name]
        np.testing.assert_allclose(nm.kd, pm.kd, rtol=1e-6)
        np.testing.assert_allclose(nm.ks, pm.ks, rtol=1e-6)
        assert abs(nm.ns - pm.ns) < 1e-4


@pytest.mark.parametrize("scene", SCENES)
def test_native_matches_python_parser_and_jax(native_lib, scene):
    path = os.path.join(ROOT, "scenes", scene)
    nat = native_lib.parse_obj_native(path)
    _assert_same_mesh(nat, parse_obj(path))
    jnative._checked, jnative._lib = False, None
    if jnative.native_available():
        _assert_same_mesh(nat, jnative.parse_obj_native(path))


def test_native_error_on_missing_file(native_lib):
    with pytest.raises(IOError):
        native_lib.parse_obj_native("/nonexistent/scene.obj")


def test_load_scene_prefers_native_else_python(native_lib, monkeypatch):
    """load_scene parses with the native library when it loads and in
    Python otherwise; the scenes are equal."""
    path = os.path.join(ROOT, "scenes", SCENES[0])
    calls = []
    real = native_lib.parse_obj_native
    monkeypatch.setattr(native_lib, "parse_obj_native", lambda p: calls.append(p) or real(p))
    a = load_scene(path, device="cpu")
    assert calls == [path]
    monkeypatch.setattr(native_lib, "native_available", lambda: False)
    py_calls = []
    monkeypatch.setattr(tbuild, "parse_obj", lambda p: py_calls.append(p) or parse_obj(p))
    b = load_scene(path, device="cpu")
    assert calls == [path] and py_calls == [path]
    want = scene_arrays(b)
    for k, v in scene_arrays(a).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("name,levels", [("cornell", 1), ("cornell", 2), ("veach", 1)])
def test_subdivide_matches_jax(request, name, levels):
    """subdivide_scene's arrays equal JAX's; counts and areas as JAX
    tests/test_transform.py checks them."""
    js, ts = _pair(request.getfixturevalue(f"{name}_scene"), 8)
    a, b = jax_subdivide(js, levels), subdivide_scene(ts, levels)
    got = scene_arrays(b)
    for k, v in scene_arrays(a).items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    L = ts.num_lights
    assert b.num_tris == L + (ts.num_tris - L) * 4 ** levels and b.num_lights == L
    area = lambda sc: float((0.5 * torch.linalg.norm(  # noqa: E731
        torch.cross(sc.tri_e1, sc.tri_e2, dim=-1), dim=-1))[~sc.is_light].sum())
    np.testing.assert_allclose(area(b), area(ts), rtol=1e-5)
    torch.testing.assert_close(b.light_emission(), ts.light_emission())
    assert b.device == ts.device


def test_subdivided_render_matches(cornell_scene):
    """JAX tests/test_transform.py's render check on the port: same
    surfaces and streams, so 95% of values equal to rtol 1e-4 and means to
    2%."""
    _, ts = _pair(cornell_scene, 16)
    cfg = RenderConfig(width=16, height=16, spp=4, estimator="mis", max_depth=4, seed=0)

    def render(sc):
        fb, _, _, _ = render_regen(sc, cfg, rng.base_key(0), 256, 256 * 4, lanes=256)
        return fb.numpy() / 4

    a, b = render(ts), render(subdivide_scene(ts, 1))
    assert np.mean(np.isclose(a, b, rtol=1e-4, atol=1e-5)) > 0.95
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.02)

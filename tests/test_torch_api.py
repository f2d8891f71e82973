"""The port's top-level API (``monte_carlo_path_tracing_tpu_torch/__init__.py``)
and ``core/radiometry.parse_radiance`` against the JAX package's.

The package exports ``__version__`` and ``RenderConfig`` eagerly and nine
names lazily, each resolving to the port's counterpart of the JAX
package's; importing the package loads neither JAX nor the kernel modules
(``ops/_build``, ``ops/intersect_cuda``, ``ops/arvo_cuda``), checked in a
fresh interpreter."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import monte_carlo_path_tracing_tpu as jmc
import monte_carlo_path_tracing_tpu_torch as mc
from monte_carlo_path_tracing_tpu.core.radiometry import parse_radiance as jax_parse_radiance
from monte_carlo_path_tracing_tpu_torch.core.radiometry import parse_radiance
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LAZY = {
    "load_scene": "scene.build", "Scene": "scene.types", "Camera": "scene.types",
    "Materials": "scene.types", "render_rays": "integrator.wavefront",
    "render_image": "render.renderer", "render_image_regen": "render.renderer",
    "write_image": "render.film", "recover_materials": "diff.inverse",
}


def test_version_and_render_config():
    assert mc.__version__ == jmc.__version__
    assert mc.RenderConfig is RenderConfig


@pytest.mark.parametrize("name", sorted(LAZY))
def test_lazy_names_resolve_to_the_port(name):
    """Each name is the port's object in the module that mirrors the JAX
    package's, and the JAX package exports the same name."""
    import importlib

    obj = getattr(mc, name)
    assert obj is getattr(importlib.import_module(f"{mc.__name__}.{LAZY[name]}"), name)
    assert obj.__module__ == f"{mc.__name__}.{LAZY[name]}"
    assert getattr(jmc, name).__module__ == f"{jmc.__name__}.{LAZY[name]}"


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'render_everything'"):
        mc.render_everything  # noqa: B018
    assert not hasattr(mc, "device_trace")


def test_import_is_cheap():
    """In a fresh interpreter: the import loads neither JAX nor the kernel
    modules, and a lazy name then loads its module."""
    code = ("import sys, json, monte_carlo_path_tracing_tpu_torch as mc\n"
            "before = sorted(sys.modules)\n"
            "mc.render_image_regen\n"
            "print(json.dumps([before, sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    before, after = json.loads(out.strip().splitlines()[-1])
    pkg = "monte_carlo_path_tracing_tpu_torch"
    for mod in ("jax", f"{pkg}.ops._build", f"{pkg}.ops.intersect_cuda", f"{pkg}.ops.arvo_cuda",
                "monte_carlo_path_tracing_tpu"):
        assert mod not in before, mod
    assert f"{pkg}.render.renderer" in after and "jax" not in after


@pytest.mark.parametrize("text", ["1,2,3", "0.25, 17.5 ,1e-3", "-1,0,380"])
def test_parse_radiance_matches_jax(text):
    got = parse_radiance(text, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_parse_radiance(text)))


@pytest.mark.parametrize("text", ["1,2", "1,2,3,4", ""])
def test_parse_radiance_rejects_other_than_three_parts(text):
    with pytest.raises(ValueError):
        parse_radiance(text, device="cpu")
    with pytest.raises(ValueError):
        jax_parse_radiance(text)


def test_parse_radiance_defaults_to_the_card():
    """Its device follows the entry points' rule: the card unless the
    caller names the CPU (without a card the default fails)."""
    if torch.cuda.is_available():
        assert parse_radiance("1,2,3").device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            parse_radiance("1,2,3")

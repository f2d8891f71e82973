"""The PyTorch/CUDA port of the differentiable Monte Carlo path tracer.

Counterpart of ``monte_carlo_path_tracing_tpu``, with the same top-level
API: cg23 OBJ/MTL/XML scene ingestion, Phong BRDF sampling, uniform-area
and Arvo spherical-triangle light sampling, the three estimators (split,
BRDF-only, Veach MIS), the fixed-depth differentiable wavefront and the
path-regeneration renderer, inverse rendering and the CLI. Its five
intersection and light-pick kernels are CUDA C++ for Hopper
(``csrc/``); every other op is plain torch, on the device that holds the
scene's tensors.
"""

__version__ = "0.1.0"

from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig  # noqa: F401

_LAZY = {
    "load_scene": ("monte_carlo_path_tracing_tpu_torch.scene.build", "load_scene"),
    "Scene": ("monte_carlo_path_tracing_tpu_torch.scene.types", "Scene"),
    "Camera": ("monte_carlo_path_tracing_tpu_torch.scene.types", "Camera"),
    "Materials": ("monte_carlo_path_tracing_tpu_torch.scene.types", "Materials"),
    "render_rays": ("monte_carlo_path_tracing_tpu_torch.integrator.wavefront", "render_rays"),
    "render_image": ("monte_carlo_path_tracing_tpu_torch.render.renderer", "render_image"),
    "render_image_regen": ("monte_carlo_path_tracing_tpu_torch.render.renderer",
                           "render_image_regen"),
    "write_image": ("monte_carlo_path_tracing_tpu_torch.render.film", "write_image"),
    "recover_materials": ("monte_carlo_path_tracing_tpu_torch.diff.inverse",
                          "recover_materials"),
}


def __getattr__(name):
    """Lazy top-level API: ``import monte_carlo_path_tracing_tpu_torch``
    stays cheap, and the kernel modules load on first use."""
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

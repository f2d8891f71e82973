"""Differentiable rendering: pixel gradients with respect to the materials.

Counterpart of ``monte_carlo_path_tracing_tpu/diff/grad.py`` on
``torch.autograd``. ``integrator/wavefront.render_rays`` is differentiable
end to end: gradients flow through BRDF values (Kd, Ks, Ns), emission,
cosines and MIS weights, while discrete events and sampling pdfs are
detached — the detached-sampling estimator. This module packages the
loss / gradient entry points, the reparameterisation that keeps an
optimisation inside the feasible set, and one optimiser step over the
latents (``make_latent_step``: the optax step of the JAX package as a
``torch.optim`` step); ``diff/inverse.py`` runs the optimisation.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.scene.types import Materials, Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig


def render_loss(materials: Materials, scene: Scene, cfg: RenderConfig, key, ro, rd,
                target) -> torch.Tensor:
    """Mean squared error between the rendered radiance and ``target`` [N,3]."""
    rad = render_rays(scene.with_materials(materials), cfg, key, ro, rd)
    return torch.mean((rad - target) ** 2)


def _grads(out: torch.Tensor, fields: dict) -> dict:
    """d out / d each tensor of ``fields``: zeros where ``out`` does not
    depend on it, as jax.grad gives."""
    names = list(fields)
    gs = torch.autograd.grad(out, [fields[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(fields[k]) if g is None else g for k, g in zip(names, gs)}


def _leaves(obj):
    """A copy of the dataclass ``obj`` whose tensors are fresh leaves that
    require grad, and those leaves by field name."""
    leaves = {f.name: getattr(obj, f.name).detach().requires_grad_(True)
              for f in dataclasses.fields(obj)}
    return dataclasses.replace(obj, **leaves), leaves


def loss_and_grad(materials: Materials, scene, cfg, key, ro, rd, target):
    """(loss, d loss / d materials) as a Materials of gradients."""
    m, leaves = _leaves(materials)
    with torch.enable_grad():
        loss = render_loss(m, scene, cfg, key, ro, rd, target)
        g = _grads(loss, leaves)
    return loss.detach(), Materials(**g)


def pixel_grad(scene: Scene, cfg: RenderConfig, key, ro, rd, select) -> Materials:
    """d(sum(select * radiance)) / d(materials), a Materials of gradients:
    the raw pixel gradient of the finite-difference checks."""
    m, leaves = _leaves(scene.materials)
    with torch.enable_grad():
        rad = render_rays(scene.with_materials(m), cfg, key, ro, rd)
        g = _grads(torch.sum(rad * select), leaves)
    return Materials(**g)


# -- Feasible-set reparameterisation ----------------------------------------

@dataclasses.dataclass(frozen=True)
class LatentMaterials:
    """Unconstrained latents: kd / ks through a sigmoid (in (0, 1)), ns and
    emission through exp (positive, scale-free: an optimiser step moves a
    latent by about the learning rate, so every decade of shininess costs
    the same ~2.3 latent units)."""

    kd_l: torch.Tensor
    ks_l: torch.Tensor
    ns_l: torch.Tensor
    emission_l: torch.Tensor


def to_latent(m: Materials) -> LatentMaterials:
    def logit(p):
        p = torch.clamp(p, 1e-4, 1.0 - 1e-4)
        return torch.log(p) - torch.log1p(-p)

    return LatentMaterials(
        kd_l=logit(m.kd), ks_l=logit(m.ks),
        ns_l=torch.log(torch.clamp(m.ns, min=1e-3)),
        emission_l=torch.log(torch.clamp(m.emission, min=1e-6)),
    )


def from_latent(lm: LatentMaterials) -> Materials:
    return Materials(kd=torch.sigmoid(lm.kd_l), ks=torch.sigmoid(lm.ks_l),
                     ns=torch.exp(lm.ns_l), emission=torch.exp(lm.emission_l))


def latent_leaves(lm: LatentMaterials) -> list:
    """The latent tensors in field order: what an optimiser over ``lm``
    holds as its parameters."""
    return [getattr(lm, f.name) for f in dataclasses.fields(lm)]


def latent_loss(lm: LatentMaterials, scene, cfg, key, ro, rd, target) -> torch.Tensor:
    return render_loss(from_latent(lm), scene, cfg, key, ro, rd, target)


def latent_loss_and_grad(lm: LatentMaterials, scene, cfg, key, ro, rd, target):
    """(loss, d loss / d latents) as a LatentMaterials of gradients."""
    m, leaves = _leaves(lm)
    with torch.enable_grad():
        loss = latent_loss(m, scene, cfg, key, ro, rd, target)
        g = _grads(loss, leaves)
    return loss.detach(), LatentMaterials(**g)


def make_latent_step(scene: Scene, cfg: RenderConfig, optimizer: torch.optim.Optimizer):
    """One optimiser step over latent materials. ``optimizer`` holds the
    tensors of ``latent_leaves(lm)`` as its parameters; ``step(lm, key, ro,
    rd, target)`` updates them in place and returns the loss before the
    update."""

    def step(lm: LatentMaterials, key, ro, rd, target) -> torch.Tensor:
        loss, g = latent_loss_and_grad(lm, scene, cfg, key, ro, rd, target)
        for p, gi in zip(latent_leaves(lm), latent_leaves(g)):
            p.grad = gi
        optimizer.step()
        return loss

    return step

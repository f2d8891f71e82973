"""Inverse rendering: recover Phong rho_d / rho_s / shininess and light
radiance from a target image by pixel-gradient descent.

Counterpart of ``monte_carlo_path_tracing_tpu/diff/inverse.py``, with the
same streams: step i draws its keys as ``split(fold_in(key(seed), i), 3)``
and its pixels as ``randint(k_pix, (n_rays,), 0, n_pix)`` (``core/rng.py``
reproduces both bit for bit), so on the same materials both packages render
the same rays. The optax optimiser (Adam under a cosine decay to 2% of the
learning rate) is ``torch.optim.Adam`` with the learning rate set before
each step from :func:`cosine_decay`. The optimisation's checkpoint
(:func:`save_state`) has the port's own npz layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene.types import Materials, Scene
from monte_carlo_path_tracing_tpu_torch.utils.checkpoint import savez_atomic
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

#: Adam's moments and epsilon (optax.adam's defaults).
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
#: The cosine schedule ends at this fraction of the learning rate.
COSINE_ALPHA = 0.02
#: Material families, in the order of LatentMaterials' fields.
FAMILIES = ("kd", "ks", "ns", "emission")


@dataclasses.dataclass
class InverseResult:
    materials: Materials
    losses: list
    steps: int


def cosine_decay(lr: float, decay_steps: int, count: int, alpha: float = COSINE_ALPHA) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)(count)``, in
    f32 as optax computes it."""
    f = np.float32
    c = f(min(count, decay_steps))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * c / f(decay_steps), dtype=np.float32))
    return float(f(lr) * ((f(1.0) - f(alpha)) * cos + f(alpha)))


def make_optimizer(lm: dgrad.LatentMaterials, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(dgrad.latent_leaves(lm), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def save_state(path: str, lm: dgrad.LatentMaterials, opt: torch.optim.Adam, step: int,
               losses: list) -> None:
    """Checkpoint the optimisation as one npz, written atomically: the
    latents, Adam's per-parameter step count and moments, the next step and
    the losses."""
    arrays = {f"lm_{k}": v.detach().cpu().numpy()
              for k, v in zip(FAMILIES, dgrad.latent_leaves(lm))}
    for j, p in enumerate(dgrad.latent_leaves(lm)):
        st = opt.state[p]
        arrays[f"adam_{j}_step"] = np.float32(float(st["step"]))
        arrays[f"adam_{j}_exp_avg"] = st["exp_avg"].detach().cpu().numpy()
        arrays[f"adam_{j}_exp_avg_sq"] = st["exp_avg_sq"].detach().cpu().numpy()
    savez_atomic(path, step=np.int64(step), losses=np.asarray(losses, np.float64), **arrays)


def load_state(path: str, lm: dgrad.LatentMaterials, opt: torch.optim.Adam):
    """Restore :func:`save_state` into ``lm``'s tensors (in place) and
    ``opt``; returns (step, losses)."""
    with np.load(path) as z:
        params = dgrad.latent_leaves(lm)
        with torch.no_grad():
            for k, p in zip(FAMILIES, params):
                p.copy_(torch.from_numpy(z[f"lm_{k}"]))
        sd = opt.state_dict()
        sd["state"] = {
            j: {"step": torch.tensor(float(z[f"adam_{j}_step"])),
                "exp_avg": torch.from_numpy(z[f"adam_{j}_exp_avg"]),
                "exp_avg_sq": torch.from_numpy(z[f"adam_{j}_exp_avg_sq"])}
            for j in range(len(params))
        }
        opt.load_state_dict(sd)
        return int(z["step"]), [float(x) for x in z["losses"]]


def step_keys(seed: int, i: int, n_rays: int, n_pix: int, device):
    """(k_step, pixel ids [n_rays]) of step ``i``: the JAX loop's
    ``split(fold_in(key(seed), i), 3)`` and ``randint(k_pix, ...)``."""
    _, k_step, k_pix = rng.split(rng.fold_in(rng.base_key(seed, device=device), i), 3)
    return k_step, rng.randint(k_pix, (n_rays,), 0, n_pix)


def two_stream_loss(scene_true: Scene, lm: dgrad.LatentMaterials, cfg: RenderConfig, k_step,
                    ro, rd, squash: Callable = lambda x: x) -> torch.Tensor:
    """The step's loss: a target rendered from the true materials on one
    stream, and the latents' render on two more, multiplied. Two
    independent streams make E[grad] the gradient of ||E[render] -
    E[target]||^2; a single-stream MSE adds d(Var)/d(theta), which drags
    the materials toward dark, low-variance renders at low spp."""
    k_t, k_r = rng.split(k_step)
    with torch.no_grad():
        target = squash(render_rays(scene_true, cfg, k_t, ro, rd))
    k1, k2 = rng.split(k_r)
    sc = scene_true.with_materials(dgrad.from_latent(lm))
    r1 = squash(render_rays(sc, cfg, k1, ro, rd))
    r2 = squash(render_rays(sc, cfg, k2, ro, rd))
    return torch.mean((r1 - target) * (r2 - target))


def recover_materials(
    scene_true: Scene,
    materials_init: Materials,
    cfg: RenderConfig,
    steps: int = 100,
    lr: float = 5e-2,
    rays_per_step: Optional[int] = None,
    seed: int = 0,
    progress: Optional[Callable[[int, float], None]] = None,
    optimize: tuple = FAMILIES,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    loss_clip: Optional[float] = None,
) -> InverseResult:
    """Gradient-descend latent materials so renders match the true scene,
    on the device of ``scene_true``'s tensors.

    The target is rendered each step from the true materials on a fresh
    stream (a stochastic target: unbiased gradients through the Monte
    Carlo noise). Families not named in ``optimize`` are frozen by zeroing
    their gradients. ``loss_clip`` compresses radiance as x / (1 + x/clip)
    before the loss, for scenes whose emitters are orders of magnitude
    brighter than their surfaces (veach-mis): monotone per pixel, so the
    optimum is unchanged. With ``checkpoint_path``, an existing checkpoint
    is resumed and one is written every ``checkpoint_every`` steps; resuming
    reproduces the uninterrupted run."""
    dev = scene_true.device
    cam = scene_true.camera
    n_pix = cam.width * cam.height
    n_rays = min(rays_per_step or n_pix, n_pix)
    decay_steps = max(steps, 1)
    lm = dgrad.to_latent(materials_init)
    lm = dgrad.LatentMaterials(*(x.detach().to(dev).clone().requires_grad_(True)
                                 for x in dgrad.latent_leaves(lm)))
    opt = make_optimizer(lm, lr)
    mask = [f in optimize for f in FAMILIES]
    squash = (lambda x: x) if loss_clip is None else (lambda x: x / (1.0 + x / loss_clip))

    losses: list = []
    start = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        start, losses = load_state(checkpoint_path, lm, opt)
    for i in range(start, steps):
        k_step, idx = step_keys(seed, i, n_rays, n_pix, dev)
        ro, rd = generate_rays(cam, idx)
        with torch.enable_grad():
            loss = two_stream_loss(scene_true, lm, cfg, k_step, ro, rd, squash)
            opt.zero_grad()
            loss.backward()
        # Frozen families take zero gradients, and so does a latent the loss
        # does not reach: Adam steps every parameter each step, as optax.
        for p, keep in zip(dgrad.latent_leaves(lm), mask):
            if p.grad is None or not keep:
                p.grad = torch.zeros_like(p)
        for group in opt.param_groups:
            group["lr"] = cosine_decay(lr, decay_steps, i)
        opt.step()
        losses.append(float(loss.detach()))
        if progress is not None:
            progress(i, losses[-1])
        if checkpoint_path is not None and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_state(checkpoint_path, lm, opt, i + 1, losses)

    final = dgrad.from_latent(dgrad.LatentMaterials(*(x.detach()
                                                      for x in dgrad.latent_leaves(lm))))
    return InverseResult(materials=final, losses=losses, steps=steps)

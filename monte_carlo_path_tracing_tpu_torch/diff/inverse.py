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

Each step of :func:`recover_materials` is an ``inverse.step`` span
(``utils.profiling.span``, recorded only under a profiler) holding, in
order, ``inverse.target`` (the no-grad target render), ``inverse.forward``
(the two renders under autograd and the loss), ``inverse.backward``
(``loss.backward()``), ``inverse.update`` (the frozen-family masks, the
learning rate and ``opt.step()``) and ``inverse.sync`` (the host read of
the loss); the renders' host reads are ``wavefront.sync`` spans inside
them. On CUDA a step's renders are CUDA graphs (:class:`StepRenders`):
the target's bounces are replays of one graph, with a live-mask read
between them, and the two streams' forward and backward passes are one
replay each, with no host read inside. Its ``on_step`` observer sees, once a step, what that step itself
computed (its renders, loss, latents and gradients), so that a check of
the step compares the timed path and not a second run of it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.integrator import graph as graph_mod
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays, shading, wavefront
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene.types import Materials, Scene
from monte_carlo_path_tracing_tpu_torch.utils.checkpoint import savez_atomic
from monte_carlo_path_tracing_tpu_torch.utils.config import EST_SHOOT, RenderConfig
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span

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


def target_radiance(scene_true: Scene, cfg: RenderConfig, k_step, ro, rd) -> torch.Tensor:
    """The step's target [N, 3]: the true materials on the first stream of
    ``k_step``, without autograd."""
    k_t, _ = rng.split(k_step)
    with torch.no_grad():
        return render_rays(scene_true, cfg, k_t, ro, rd)


def stream_radiance(scene_true: Scene, lm: dgrad.LatentMaterials, cfg: RenderConfig, k_step,
                    ro, rd):
    """(r1, r2): the latents' renders [N, 3] on the two streams of
    ``k_step``'s second half, under autograd where it records."""
    _, k_r = rng.split(k_step)
    k1, k2 = rng.split(k_r)
    sc = scene_true.with_materials(dgrad.from_latent(lm))
    return render_rays(sc, cfg, k1, ro, rd), render_rays(sc, cfg, k2, ro, rd)


def unrolled_streams(scene_true: Scene, cfg: RenderConfig, accel, kd_l, ks_l, ns_l, emission_l,
                     k_step, ro, rd):
    """:func:`stream_radiance` of the latents (kd_l, ks_l, ns_l,
    emission_l) through the triangle accel ``accel``, with every one of
    ``cfg.max_depth`` bounces run and no host read (``wavefront.run_loop``
    without its early exit): the same values, as one function of tensors
    that :class:`StepRenders` captures."""
    _, k_r = rng.split(k_step)
    k1, k2 = rng.split(k_r)
    sc = scene_true.with_materials(dgrad.from_latent(
        dgrad.LatentMaterials(kd_l, ks_l, ns_l, emission_l)))
    # a context a stream, as render_rays builds one a call
    return tuple(wavefront.run_loop(shading.scene_context(sc, cfg, accel), k, ro, rd,
                                    early_exit=False)["L"] for k in (k1, k2))


class StepRenders:
    """The renders of a :func:`recover_materials` step for batches of
    ``n_rays`` rays of ``scene_true`` under ``cfg``: :meth:`target` and
    :meth:`streams`.

    On CUDA tensors (``graph`` None or True; the triangle accel, not the
    shoot estimator) both are captured as CUDA graphs when the object is
    built. The target is ``wavefront.RayRenderer``'s bounce graph. The two
    streams are one ``torch.cuda.make_graphed_callables`` callable of
    :func:`unrolled_streams`, whose forward pass is one replay and whose
    backward pass, inside ``loss.backward()``, another: the host launches
    a handful of graphs a step where the eager loop launches thousands of
    kernels, and the step runs at the device's pace. The streams of a
    captured call are views of the graph's output buffers, which the next
    call overwrites. Elsewhere, or with ``graph=False``, both run eagerly
    (:func:`target_radiance`, :func:`stream_radiance`). Either way the
    values are the same."""

    def __init__(self, scene_true: Scene, cfg: RenderConfig, n_rays: int,
                 graph: bool | None = None):
        self.scene, self.cfg, self.n_rays = scene_true, cfg, n_rays
        self._target = self._streams = None
        capturable = cfg.accel != "grid" and cfg.estimator != EST_SHOOT
        if graph and not capturable:
            raise ValueError("graph=True captures the triangle accel's loop: "
                             f"accel {cfg.accel!r}, estimator {cfg.estimator!r}")
        if not (capturable and graph_mod.use_graph(graph, scene_true.device)):
            return
        cam = scene_true.camera
        k_step, idx = step_keys(0, 0, n_rays, cam.width * cam.height, scene_true.device)
        ro, rd = generate_rays(cam, idx)
        self._target = wavefront.RayRenderer(scene_true, cfg, graph=True)
        with torch.no_grad():
            self._target(rng.split(k_step)[0], ro, rd)          # warm-up and capture
        accel = self._target.accel
        lm = dgrad.latent_leaves(dgrad.to_latent(scene_true.materials))
        sample = tuple(x.detach().clone().requires_grad_(True) for x in lm) + (k_step, ro, rd)
        with torch.enable_grad():
            self._streams = torch.cuda.make_graphed_callables(
                lambda *a: unrolled_streams(scene_true, cfg, accel, *a), sample,
                allow_unused_input=True)

    def _batch(self, ro) -> None:
        if ro.shape[0] != self.n_rays:
            raise ValueError(f"these renders take batches of {self.n_rays} rays: got "
                             f"{ro.shape[0]}")

    def target(self, k_step, ro, rd) -> torch.Tensor:
        """:func:`target_radiance`."""
        if self._target is None:
            return target_radiance(self.scene, self.cfg, k_step, ro, rd)
        self._batch(ro)
        with torch.no_grad():
            return self._target(rng.split(k_step)[0], ro, rd)

    def streams(self, lm: dgrad.LatentMaterials, k_step, ro, rd):
        """:func:`stream_radiance` of ``lm``."""
        if self._streams is None:
            return stream_radiance(self.scene, lm, self.cfg, k_step, ro, rd)
        self._batch(ro)
        return self._streams(*dgrad.latent_leaves(lm), k_step, ro, rd)


def stream_loss(target, r1, r2, squash: Callable = lambda x: x) -> torch.Tensor:
    """mean((squash(r1) - squash(target)) * (squash(r2) - squash(target)))."""
    t = squash(target)
    return torch.mean((squash(r1) - t) * (squash(r2) - t))


def two_stream_loss(scene_true: Scene, lm: dgrad.LatentMaterials, cfg: RenderConfig, k_step,
                    ro, rd, squash: Callable = lambda x: x) -> torch.Tensor:
    """The step's loss: a target rendered from the true materials on one
    stream, and the latents' render on two more, multiplied. Two
    independent streams make E[grad] the gradient of ||E[render] -
    E[target]||^2; a single-stream MSE adds d(Var)/d(theta), which drags
    the materials toward dark, low-variance renders at low spp."""
    target = target_radiance(scene_true, cfg, k_step, ro, rd)
    return stream_loss(target, *stream_radiance(scene_true, lm, cfg, k_step, ro, rd), squash)


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
    on_step: Optional[Callable] = None,
    renders: Optional[StepRenders] = None,
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
    reproduces the uninterrupted run.

    ``on_step(i, latents, grads, loss, (target, r1, r2))``, where given, is
    called once a step, after the backward pass and before the update, with
    what the step itself computed: the latents before the update and their
    gradients as Adam will see them (frozen families' and unreached
    latents' zero), each a list in ``FAMILIES`` order, the loss, and the
    step's three radiance tensors [N, 3] before ``loss_clip``'s squash.
    All are detached, on the scene's device, and not copied: the latents
    are views that the update overwrites, so an observer that keeps them
    clones them, and so are the streams' radiance where ``renders``
    captures them. Without ``on_step`` nothing is copied or built for it.

    ``renders`` (a :class:`StepRenders` of this scene, configuration and
    ray count) renders each step; without one, one is built, which on CUDA
    captures the step's graphs first. A caller that runs several jobs
    passes one, so that its graphs are captured once."""
    dev = scene_true.device
    cam = scene_true.camera
    n_pix = cam.width * cam.height
    n_rays = min(rays_per_step or n_pix, n_pix)
    if renders is None:
        renders = StepRenders(scene_true, cfg, n_rays)
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
        with span("inverse.step"):
            k_step, idx = step_keys(seed, i, n_rays, n_pix, dev)
            ro, rd = generate_rays(cam, idx)
            with span("inverse.target"):
                target = renders.target(k_step, ro, rd)
            with span("inverse.forward"), torch.enable_grad():
                r1, r2 = renders.streams(lm, k_step, ro, rd)
                loss = stream_loss(target, r1, r2, squash)
            with span("inverse.backward"), torch.enable_grad():
                opt.zero_grad()
                loss.backward()
            params = dgrad.latent_leaves(lm)
            if on_step is not None:
                on_step(i, [p.detach() for p in params],
                        [p.grad if keep and p.grad is not None else torch.zeros_like(p)
                         for p, keep in zip(params, mask)],
                        loss.detach(), (target, r1.detach(), r2.detach()))
            with span("inverse.update"):
                # Frozen families take zero gradients, and so does a latent the
                # loss does not reach: Adam steps every parameter each step, as
                # optax.
                for p, keep in zip(params, mask):
                    if p.grad is None or not keep:
                        p.grad = torch.zeros_like(p)
                for group in opt.param_groups:
                    group["lr"] = cosine_decay(lr, decay_steps, i)
                opt.step()
            with span("inverse.sync"):
                losses.append(float(loss.detach()))
        if progress is not None:
            progress(i, losses[-1])
        if checkpoint_path is not None and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_state(checkpoint_path, lm, opt, i + 1, losses)

    final = dgrad.from_latent(dgrad.LatentMaterials(*(x.detach()
                                                      for x in dgrad.latent_leaves(lm))))
    return InverseResult(materials=final, losses=losses, steps=steps)

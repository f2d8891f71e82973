"""Sharded rendering and the distributed differentiable train step.

Counterpart of ``monte_carlo_path_tracing_tpu/parallel/sharded.py``, on
torch.distributed: one process per device, each running the same program
on its share of the rays, with collectives where JAX's ``shard_map`` has
``psum`` / ``pmean``. K1-K5 run inside every rank, as in the single-device
renders.

- :func:`render_rays_sharded`: each rank renders its block of the global
  rays with that block's row offset, so its draws are its rows of the
  global draw, as under JAX's globally sharded ``jit``; the blocks are
  all-gathered.
- :func:`make_regen_sharded` / :func:`render_regen_sharded`: each rank runs
  the path-regeneration loop (cached or not) over an interleaved pixel
  subset; streams are keyed by global (spp round, pixel id), so the image
  does not depend on the rank count. The renderer that
  :func:`make_regen_sharded` returns is one ``RegenJob`` a rank, so its
  calls after the first replay what the first captured.
- :func:`make_train_step`: rays split over ``tiles``, sample streams over
  ``spp``; the material gradient is all-reduced over every mesh axis, so
  every rank leaves the step with the same materials.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.parallel.mesh import (
    AXIS_SPP, AXIS_TILES, Mesh, axis_index, axis_size, gather_rows, shard_rows,
)
from monte_carlo_path_tracing_tpu_torch.scene.types import Materials, Scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span


def _local_key(key: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A scalar [2] key as it is; [N, 2] lane keys split like the rays."""
    return key if key.dim() == 1 else shard_rows(key, mesh)


def render_rays_sharded(
    scene: Scene, cfg: RenderConfig, key: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor,
    mesh: Mesh,
) -> torch.Tensor:
    """Radiance [N, 3] of the global rays ``ro`` / ``rd``, their rows split
    over the mesh's ``tiles`` axis (``shard_rows``). Each rank renders its
    block of rows [r0, r0 + n) with ``row_offset=r0``, so a scalar key's
    draws are the block's rows of the single-device draw, and every rank
    returns the global [N, 3], all-gathered: this stands in for the
    globally sharded array JAX's version returns. Forward only."""
    n_local = ro.shape[0] // axis_size(mesh, AXIS_TILES)
    with torch.no_grad():
        rad = render_rays(scene, cfg, _local_key(key, mesh), shard_rows(ro, mesh),
                          shard_rows(rd, mesh),
                          row_offset=axis_index(mesh, AXIS_TILES) * n_local)
    return gather_rows(rad, mesh)


class ShardedRegen:
    """The renderer :func:`make_regen_sharded` returns: this rank's one
    ``integrator.regen.RegenJob`` for as long as it lives, and ``render``,
    which renders a launch of it. ``close()`` (or the end of a ``with``
    block) frees the job."""

    def __init__(self, render, job):
        self._render, self.job = render, job

    def __call__(self, scene: Scene, key: torch.Tensor, spp: int):
        return self._render(scene, key, spp)

    def close(self) -> None:
        self.job.close()

    def __enter__(self) -> ShardedRegen:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_regen_sharded(
    scene_like: Scene,
    cfg: RenderConfig,
    mesh: Mesh,
    lanes_per_device: int = 1 << 16,
    spp_cap: int | None = None,
    with_physical: bool = False,
) -> ShardedRegen:
    """A sharded path-regeneration renderer
        fn(scene, key, samples_per_pixel) -> (framebuffer_sum [n_pix / ranks, 3],
                                               rays_traced)
    returning this rank's framebuffer shard (on the scene's device) and the
    logical ray count summed over the ``tiles`` axis.

    Rank d of the ``tiles`` axis's nd ranks owns pixels d, d + nd, ...
    (interleaved: neighbouring pixels cost similar work, so the Russian
    roulette load balances) and runs its own loop over them; streams are
    keyed by global (spp round, pixel id), so the image does not depend on
    nd. ``spp_cap`` takes the primary-hit cache exactly when JAX's does
    (the config eligible, or ``cfg.primary_cache`` True): each rank runs the
    prepass over its pixel subset, then the seeded loop. Raises, as JAX's
    does, when nd does not divide the pixel count or when the cache is
    taken and ``cfg.spp`` exceeds ``spp_cap``. ``with_physical=True``
    returns a third output, the summed physically traced ray count.

    The renderer (:class:`ShardedRegen`) is one job a rank
    (``integrator.regen.RegenJob``). Its first call builds the scene
    context and the state buffers; on the card the job's first prepass
    chunk and first loop iteration run eagerly and its second of each is
    captured. Once both are captured, a call copies its key into the job,
    resets the state in place and replays, with no build, capture or
    device allocation. Each call may bring its own key and
    ``samples_per_pixel`` (at most ``spp_cap`` cached) and keeps the
    scene. The shard it returns is a view of the job's buffer,
    which the next call overwrites. ``close()`` frees the job."""
    from monte_carlo_path_tracing_tpu_torch.integrator.regen import (
        RegenJob, primary_cache_eligible, render_regen, render_regen_cached,
    )

    cam = scene_like.camera
    n_pix = cam.height * cam.width
    nd = axis_size(mesh, AXIS_TILES)
    if n_pix % nd:
        raise ValueError(f"pixel count {n_pix} not divisible by {nd} devices")
    local = n_pix // nd
    use_cache = spp_cap is not None and (
        cfg.primary_cache if cfg.primary_cache is not None else primary_cache_eligible(cfg)
    )
    if use_cache and cfg.spp > spp_cap:
        # the prepass clamps its rounds to the cap, which sizes its seed
        # buffer: a larger spp would silently under-sample.
        raise ValueError(
            f"cfg.spp={cfg.spp} exceeds spp_cap={spp_cap}: the primary-cache pre-pass "
            "sizes its seed buffers by spp_cap and clamps the traced round count to it"
        )
    d = axis_index(mesh, AXIS_TILES)
    group = mesh.get_group(AXIS_TILES)
    job = RegenJob()

    def render(sc: Scene, key: torch.Tensor, spp: int):
        if use_cache:
            fb, nrays, _, stats = render_regen_cached(
                sc, cfg, key, local, spp_cap, spp, lanes=lanes_per_device,
                pixel_offset=d, pixel_stride=nd, job=job,
            )
            nphys = stats.rays_physical
        else:
            fb, nrays, _, _ = render_regen(
                sc, cfg, key, local, local * spp, lanes=lanes_per_device,
                pixel_offset=d, pixel_stride=nd, job=job,
            )
            nphys = nrays
        # Under a profiler, the span is this rank's wait for the slowest.
        with span("parallel.reduce"):
            counts = torch.stack([torch.as_tensor(n, dtype=torch.int64, device=fb.device)
                                  for n in (nrays, nphys)])
            dist.all_reduce(counts, group=group)
            out = (fb, int(counts[0]))
            if with_physical:
                out += (int(counts[1]),)
        return out

    return ShardedRegen(render, job)


def deinterleave_framebuffer(fb, n_devices: int):
    """Undo the interleaved pixel assignment of :func:`make_regen_sharded`:
    in the concatenated shards, row d * local + i holds global pixel
    i * n_devices + d. Takes a numpy array or a tensor."""
    n_pix = fb.shape[0]
    local = n_pix // n_devices
    return fb.reshape(n_devices, local, 3).swapaxes(0, 1).reshape(n_pix, 3)


def render_regen_sharded(
    scene: Scene,
    cfg: RenderConfig,
    key: torch.Tensor,
    mesh: Mesh,
    lanes_per_device: int = 1 << 16,
    spp_cap: int | None = None,
):
    """One-shot :func:`make_regen_sharded` at ``cfg.spp``, a job of one
    launch: (framebuffer_sum [n_pix, 3] in global pixel order as a host
    array, on every rank; rays_traced)."""
    with make_regen_sharded(scene, cfg, mesh, lanes_per_device, spp_cap) as fn:
        fb, nrays = fn(scene, key, cfg.spp)
        fb = gather_rows(fb, mesh).cpu().numpy()
    return deinterleave_framebuffer(fb, axis_size(mesh, AXIS_TILES)), nrays


def make_train_step(scene: Scene, cfg: RenderConfig, mesh: Mesh, lr: float = 2e-2):
    """A distributed inverse-rendering step

        step(materials, key, ro, rd, target) -> (new_materials, loss)

    with JAX's semantics. ``ro`` / ``rd`` / ``target`` are the global
    [N, 3] arrays, the same on every rank; each rank takes its block of
    rows along ``tiles`` and renders it from row 0 of its key (shard-local
    counters, as under JAX's ``shard_map``), the key first folded with the
    rank's ``spp`` coordinate. Radiance is averaged over ``spp``; the L2
    loss is summed over ``tiles`` and divided by N x 3; the material
    gradients (autograd through the port's ``.detach()`` sites) are summed
    over every rank, which is the gradient of that global loss; the update
    is plain SGD, ``p - lr * g``. The all-reduce hands every rank the same
    sums, so every rank leaves with the same materials."""
    fields = [f.name for f in dataclasses.fields(Materials)]
    has_spp = AXIS_SPP in mesh.mesh_dim_names
    n_spp = axis_size(mesh, AXIS_SPP)
    tiles = mesh.get_group(AXIS_TILES)

    def step(materials: Materials, key: torch.Tensor, ro, rd, target):
        key = _local_key(key, mesh)
        if has_spp:
            key = rng.fold_in(key, axis_index(mesh, AXIS_SPP))
        leaves = {f: getattr(materials, f).detach().clone().requires_grad_(True)
                  for f in fields}
        with torch.enable_grad():
            rad = render_rays(scene.with_materials(Materials(**leaves)), cfg, key,
                              shard_rows(ro, mesh), shard_rows(rd, mesh))
        mean = rad.detach().clone()
        if has_spp:
            dist.all_reduce(mean, group=mesh.get_group(AXIS_SPP))
            mean = mean / n_spp
        diff = mean - shard_rows(target, mesh)
        total = (diff * diff).sum().reshape(1)
        dist.all_reduce(total, group=tiles)
        count = ro.shape[0] * 3
        # d loss / d rad of this rank: its rays' share of the spp mean.
        grads = torch.autograd.grad(rad, list(leaves.values()),
                                    grad_outputs=diff * (2.0 / (count * n_spp)),
                                    allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(leaves.values(), grads)])
        dist.all_reduce(flat)
        new, i = {}, 0
        for f, p in leaves.items():
            g = flat[i:i + p.numel()].view_as(p)
            new[f] = (p - lr * g).detach()
            i += p.numel()
        return Materials(**new), (total / count).reshape(())

    return step

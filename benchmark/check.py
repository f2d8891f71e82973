"""The comparison of the ``image`` check kind (``checks/image.py``), the
kind of every configuration whose ``check`` block names none; another kind
is its own module in ``checks/``, found by the name a configuration gives.

A run's image is the summed radiance of every spp round that the window's
last job (single card) or all its launches (sharded) rendered. A sample of
pixels drawn from the seed, one in each of ``pixels`` equal runs of the
row-major pixel ids, is rendered again by the plain reference
(``reference/``) from the raw scene files and the same stream keys, and
the two are compared:

- ``pixels_off_share``: the share of sampled pixels whose summed radiance
  is off by more than ``PIXEL_RTOL`` (the L1 gap over R, G, B, against the
  reference's L1 plus a thousandth of its mean, so that dark pixels do not
  count on noise alone), or is not finite on either side;
- ``sum_gap``: |sum of the program's sampled pixels / the reference's - 1|,
  over the pixels finite on both sides;
- ``rays_per_path_gap``: |the program's logical rays per path over the
  window / the reference's over the sampled pixels - 1|. The program
  counts over the whole image, so this one holds the pixels' sampling
  noise besides.

Each has its limit in the configuration's file (``check.limits``),
set from the readings in PERF.md. Two guards hold besides: the image is
finite and its sum positive, and the logical rays per second stay under
the physical ceiling of the port's bench (a rate above it means the clock
stopped before the work did).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import scene as ref_scene
from benchmark.reference import threefry, tracer

#: A pixel is off when its summed radiance is this far from the reference's.
PIXEL_RTOL = 1e-2

# The ceiling of the port's bench (monte_carlo_path_tracing_tpu_torch/
# bench.py, after bench.py:40-58 of the JAX package): ~90 flops a
# (ray, triangle) pair, a 10x culling factor, a 4e14 flop/s peak.
_PEAK_FLOPS, _FLOPS_PER_PAIR, _CULL_FACTOR = 4.0e14, 90.0, 0.1


def sample_pixels(n_pix: int, k: int, seed: int) -> np.ndarray:
    """[k] sorted pixel ids, one drawn from the seed in each of k equal
    runs of 0 .. n_pix - 1."""
    k = min(k, n_pix)
    edges = np.linspace(0, n_pix, k + 1).astype(np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**63 - 1), 0x5EED]))
    return edges[:-1] + (rng.random(k) * (edges[1:] - edges[:-1])).astype(np.int64)


def round_keys(seed: int, rounds) -> torch.Tensor:
    """[R, 2] keys of spp rounds: ``rounds`` a list of spp indices (one job
    keyed by the seed) or of (launch, spp index) pairs (each launch's key
    folded from the seed and the launch index)."""
    base = threefry.base_key(seed)
    keys = []
    for r in rounds:
        k = base
        for d in (r if isinstance(r, tuple) else (r,)):
            k = threefry.fold_in(k, d)
        keys.append(k)
    return torch.stack(keys)


def reference(cfg: dict, root: str, seed: int, rounds, pixels: np.ndarray, device,
              dtype=torch.float32):
    """(summed radiance [P, 3] float64, logical rays) of ``pixels`` over
    ``rounds`` by the plain reference, TF32 off, on ``device``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sc = ref_scene.load(f"{root}/{cfg['scene']}", cfg["width"], cfg["height"],
                            device=device, dtype=dtype)
        out, rays = tracer.render_pixels(sc, round_keys(seed, rounds),
                                         torch.as_tensor(pixels), rr_prob=cfg["rr_prob"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.numpy(), rays


def compare(prog: np.ndarray, ref: np.ndarray, prog_rays_per_path: float,
            ref_rays_per_path: float) -> dict:
    """The compared numbers of the program's summed radiance ``prog`` [P, 3]
    and logical rays per path against the reference's. A pixel that is not
    finite on either side is off; the sums run over the pixels finite on
    both."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    finite = np.isfinite(prog).all(axis=1) & np.isfinite(ref).all(axis=1)
    l1 = np.abs(ref).sum(axis=1)
    scale = 1e-3 * (l1[finite].mean() if finite.any() else 0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.abs(prog - ref).sum(axis=1) / (l1 + scale + 1e-30)
        s_ref, s_prog = ref[finite].sum(), prog[finite].sum()
    return {"pixels_off_share": float(np.mean(~(finite & (gap <= PIXEL_RTOL)))),
            "sum_gap": float(abs(s_prog / s_ref - 1.0)) if s_ref > 0 else float("inf"),
            "rays_per_path_gap": float(abs(prog_rays_per_path / ref_rays_per_path - 1.0))}


def ceiling_rays_per_s(num_tris: int) -> float:
    return _PEAK_FLOPS / (_FLOPS_PER_PAIR * num_tris * _CULL_FACTOR)


def checks(numbers: dict, limits: dict, image_sum: float, rays_per_s: float,
           num_tris: int) -> dict:
    """name -> {"value", "limit"} of every number compared and guard, in
    the order they print; a value passes when it is at most its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    finite = bool(np.isfinite(image_sum) and image_sum > 0)
    out["image_not_finite_or_empty"] = {"value": 0 if finite else 1, "limit": 0}
    out["rays_per_s_over_ceiling"] = {"value": rays_per_s / ceiling_rays_per_s(num_tris),
                                      "limit": 1.0}
    return out


def passed(ch: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in ch.values())

"""Phong BRDF evaluation, sampling and pdf — batched and branch-free.

Counterpart of ``monte_carlo_path_tracing_tpu/sampling/phong.py``
(reference BRDF.cpp):

- eval: f_r = Kd/pi + Ks (Ns+1)/(2 pi) max(wo . R, 0)^Ns, R = reflect(wi, N);
- sample: diffuse vs specular lobe with probabilities mean(Kd) : mean(Ks),
  then a cosine-hemisphere or Phong-lobe warp;
- pdf: the mixture density (or, with ``branch_pdf_compat``, quirk Q4's
  chosen-branch density).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class BsdfSample:
    wi: torch.Tensor           # [N,3]
    pdf: torch.Tensor          # [N]
    is_specular: torch.Tensor  # [N] bool


def lobe_probs(kd: torch.Tensor, ks: torch.Tensor):
    """P(diffuse), P(specular) proportional to mean(Kd), mean(Ks); an
    all-zero material falls back to diffuse."""
    wd = (kd[..., 0] + kd[..., 1] + kd[..., 2]) / 3.0
    ws = (ks[..., 0] + ks[..., 1] + ks[..., 2]) / 3.0
    tot = wd + ws
    pd = torch.where(tot > 0, wd / torch.where(tot > 0, tot, torch.ones_like(tot)),
                     torch.ones_like(tot))
    return pd, 1.0 - pd


def _powfast(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x**n for x >= 0 with pow(0, n) = 0, as exp(n log x)."""
    safe = torch.clamp(x, min=1e-30)
    return torch.where(x > 0.0, torch.exp(n * torch.log(safe)), torch.zeros_like(x))


def eval_brdf(n, wi, wo, kd, ks, ns) -> torch.Tensor:
    """f_r(wi -> wo), shape [N,3] (BRDF.cpp:17-25)."""
    r = vm.reflect(wi, n)
    cos_rw = torch.clamp(vm.dot(wo, r), min=0.0)
    spec = (ns + 1.0) * INV_2PI * _powfast(cos_rw, ns)
    return kd * INV_PI + ks * spec[..., None]


def eval_and_pdf_brdf(n, wi, wo, kd, ks, ns):
    """(f_r(wi -> wo), mixture pdf of wi) sharing one specular pow: the
    Phong lobe is reflection-symmetric, wo . reflect(wi) == wi . reflect(wo)."""
    r = vm.reflect(wi, n)
    cos_rw = torch.clamp(vm.dot(wo, r), min=0.0)
    spec = (ns + 1.0) * INV_2PI * _powfast(cos_rw, ns)
    f = kd * INV_PI + ks * spec[..., None]
    pd, ps = lobe_probs(kd, ks)
    p_diff = torch.clamp(vm.dot(wi, n), min=0.0) * INV_PI
    return f, pd * p_diff + ps * spec


def pdf_brdf(n, wi, wo, kd, ks, ns) -> torch.Tensor:
    """Mixture sampling density of wi given wo (BRDF.cpp:107-133)."""
    pd, ps = lobe_probs(kd, ks)
    p_diff = torch.clamp(vm.dot(wi, n), min=0.0) * INV_PI
    r = vm.reflect(wo, n)
    cos_r = torch.clamp(vm.dot(wi, r), min=0.0)
    p_spec = (ns + 1.0) * INV_2PI * _powfast(cos_r, ns)
    return pd * p_diff + ps * p_spec


def sample_brdf(key, n, wo, kd, ks, ns, branch_pdf_compat: bool = False) -> BsdfSample:
    """Draw wi from the two-lobe Phong mixture (BRDF.cpp:28-100)."""
    N = n.shape[0]
    xi_lobe = rng.uniform(rng.fold_in(key, 0), (N,))
    xi = rng.uniform(rng.fold_in(key, 1), (N, 2))

    pd, ps = lobe_probs(kd, ks)
    pick_spec = xi_lobe >= pd

    # Diffuse: cos(theta) = sqrt(1 - xi1) (cosine-weighted hemisphere).
    cos_t_d = torch.sqrt(torch.clamp(1.0 - xi[:, 0], min=0.0))
    sin_t_d = torch.sqrt(torch.clamp(xi[:, 0], min=0.0))
    # Specular: cos(theta) = xi1^(1/(Ns+1)) about R (BRDF.cpp:86-89).
    cos_t_s = _powfast(xi[:, 0], 1.0 / (ns + 1.0))
    sin_t_s = torch.sqrt(torch.clamp(1.0 - cos_t_s * cos_t_s, min=0.0))

    phi = 2.0 * math.pi * xi[:, 1]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    cos_t = torch.where(pick_spec, cos_t_s, cos_t_d)
    sin_t = torch.where(pick_spec, sin_t_s, sin_t_d)
    local = torch.stack([sin_t * cphi, sin_t * sphi, cos_t], dim=-1)

    r = vm.reflect(wo, n)
    axis = torch.where(pick_spec[:, None], r, n)
    t, b = vm.orthonormal_basis(axis)
    # Detached sampling: the sampled direction is a constant of
    # differentiation (gradients flow through f_r, emission and cosines
    # evaluated at the sample, not through the warp).
    wi = vm.from_local(local, t, b, axis).detach()

    if branch_pdf_compat:
        pdf_d = cos_t_d * INV_PI
        pdf_s = (ns + 1.0) * INV_2PI * _powfast(xi[:, 0], ns / (ns + 1.0))
        pdf = torch.where(pick_spec, ps * pdf_s, pd * pdf_d)
    else:
        pdf = pdf_brdf(n, wi, wo, kd, ks, ns)
    return BsdfSample(wi=wi, pdf=pdf, is_specular=pick_spec)

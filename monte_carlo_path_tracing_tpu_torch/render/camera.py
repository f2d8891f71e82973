"""Pinhole camera and primary-ray generation (reference main.cpp:497-564).

Counterpart of ``monte_carlo_path_tracing_tpu/render/camera.py``:
    N = normalize(lookat - eye); V = normalize(N x up); U = normalize(V x N)
with pixel_len = tan_half_fovy * dist / (h/2). ``fov_bug_compat``
reproduces quirk Q2 (main.cpp:547): tan(fovy/360), degrees as radians.
The "2x distance" experiment (main.cpp:509-510) is :func:`push_back_camera`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from monte_carlo_path_tracing_tpu_torch.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu_torch.scene.types import Camera


def push_back_camera(cam: Camera, factor: float = 2.0) -> Camera:
    """Move the eye to ``factor`` x the lookat distance (main.cpp:509-510)."""
    w = cam.lookat - cam.eye
    return dataclasses.replace(cam, eye=cam.lookat - factor * w)


def camera_basis(cam: Camera):
    """(u, v, n, dist) of the camera frame."""
    w = cam.lookat - cam.eye
    dist = vm.norm(w)
    n = w / dist
    v = vm.normalize(vm.cross(n, cam.up))
    u = vm.normalize(vm.cross(v, n))
    return u, v, n, dist


def pixel_len(cam: Camera, dist: torch.Tensor) -> torch.Tensor:
    if cam.fov_bug_compat:
        tan_half = torch.tan(cam.fovy_deg / 360.0)          # Q2
    else:
        tan_half = torch.tan(cam.fovy_deg * (math.pi / 360.0))
    return tan_half * dist / (cam.height / 2.0)


def primary_dirs(cam: Camera, u, v, n, dist, plen, gpix: torch.Tensor,
                 jitter: torch.Tensor | None = None):
    """Camera rays (ro, rd) [N,3] for global row-major pixel ids ``gpix``;
    ``jitter`` [N,2] offsets (i, j) inside the pixel footprint."""
    i = torch.div(gpix, cam.width, rounding_mode="floor").to(torch.float32)
    j = (gpix % cam.width).to(torch.float32)
    if jitter is not None:
        i = i + jitter[:, 0]
        j = j + jitter[:, 1]
    dx = -plen * (i - (cam.height - 1) / 2.0)
    dy = plen * (j - (cam.width - 1) / 2.0)
    rd = vm.normalize(dx[:, None] * u[None] + dy[:, None] * v[None] + dist * n[None])
    ro = cam.eye.expand(rd.shape)
    return ro, rd


def generate_rays(cam: Camera, pixel_idx: torch.Tensor, jitter_key: torch.Tensor | None = None):
    """Primary rays (ro, rd) [N,3] for flat pixel indices i * width + j
    (row 0 at the image top, main.cpp:557-564). Without a jitter key every
    sample of a pixel shares one direction, as in the reference; with
    per-lane keys [N,2] the position is jittered in the pixel footprint by
    ``uniform(jitter_key, (N, 2), -0.5, 0.5)``."""
    u, v, n, dist = camera_basis(cam)
    jitter = None
    if jitter_key is not None:
        jitter = rng.uniform(jitter_key, (pixel_idx.shape[0], 2), -0.5, 0.5)
    return primary_dirs(cam, u, v, n, dist, pixel_len(cam, dist), pixel_idx, jitter)

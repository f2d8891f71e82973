"""The ``image`` kind: a window's summed radiance against the plain
reference's at pixels drawn from the seed (``benchmark/check.py`` holds
the comparison, its numbers and guards). It reads ``Measured.image``,
``rounds``, ``rays`` and ``num_tris``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import check


def compare(cell, measured, seed: int, device: str = "cuda", dtype=None):
    """(compared numbers, checks, reference rays, pixels) of a window's image
    against the plain reference, computed in ``dtype`` (float32 unless
    given: the control puts bfloat16 here, in the program's place)."""
    c, m = cell.config, measured
    pixels = check.sample_pixels(c["width"] * c["height"], c["check"]["pixels"], seed)
    ref, ref_rays = check.reference(c, cell.root, seed, m.rounds, pixels, device)
    w = m.window
    prog = m.image[pixels]
    prog_rpp = m.rays / sum(p for _, _, p in w.launches)
    ref_rpp = ref_rays / (len(pixels) * len(m.rounds))
    if dtype is not None and dtype != torch.float32:
        prog, low_rays = check.reference(c, cell.root, seed, m.rounds, pixels, device, dtype)
        prog_rpp = low_rays / (len(pixels) * len(m.rounds))
    numbers = check.compare(prog, ref, prog_rpp, ref_rpp)
    elapsed = w.launches[-1][1] - w.start
    checks = check.checks(numbers, c["check"]["limits"], float(np.sum(m.image)),
                          m.rays / elapsed / cell.chips, m.num_tris)
    return numbers, checks, ref_rays, pixels


def judge(cell, measured, seed: int, device: str = "cuda", dtype=None):
    """(compared numbers, checks, diagnostics): :func:`compare`'s numbers
    and checks, and the image's spp, pixels and rays a path on both sides."""
    numbers, checks, ref_rays, pixels = compare(cell, measured, seed, device, dtype)
    m = measured
    paths = sum(p for _, _, p in m.window.launches)
    diag = {"spp_checked": len(m.rounds), "pixels_checked": len(pixels), "rays": m.rays,
            "rays_per_path": m.rays / paths,
            "reference_rays_per_path": ref_rays / (len(pixels) * len(m.rounds))}
    return numbers, checks, diag


def control(cell, seed: int, n: int, device: str = "cuda") -> dict:
    """The numbers of the bfloat16 reference against the float32 one at a
    run's pixels and ``n`` spp rounds (for the sharded mix, ``n`` launches
    of its ``launch_spp``), without the program."""
    c = cell.config
    per = cell.mix.get("launch_spp") if cell.mix["launcher"] == "sharded" else None
    rounds = [(i, s) for i in range(n) for s in range(per)] if per else list(range(n))
    pixels = check.sample_pixels(c["width"] * c["height"], c["check"]["pixels"], seed)
    ref, rays = check.reference(c, cell.root, seed, rounds, pixels, device)
    low, low_rays = check.reference(c, cell.root, seed, rounds, pixels, device, torch.bfloat16)
    paths = len(pixels) * len(rounds)
    return check.compare(low, ref, low_rays / paths, rays / paths)

"""Faults planted under the harness, in the program's timed path, for the
test that sees ``correct`` come out false: each wraps an entry point of the
port and breaks what it returns."""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half_batch", "altered", "no_exchange")


def _broken_launch(fn, kind):
    def call(*a, **kw):
        fb, *rest = fn(*a, **kw)
        if kind == "unchanged":          # the launch leaves the framebuffer as it was
            fb = torch.zeros_like(fb)
        elif kind == "half_batch":       # odd rows left out, the mean taken over the rest
            keep = (torch.arange(fb.shape[0], device=fb.device) % 2 == 0)[:, None]
            fb = torch.where(keep, 2.0 * fb, torch.zeros_like(fb))
        elif kind == "altered":          # one row in eight altered where it is produced
            hit = (torch.arange(fb.shape[0], device=fb.device) % 8 == 0)[:, None]
            fb = torch.where(hit, 1.5 * fb, fb)
        return (fb, *rest)
    return call


def _no_exchange(fn):
    def call(x, mesh, *a, **kw):         # every rank's own block in place of the others'
        n = fn(x, mesh, *a, **kw).shape[0] // x.shape[0]
        return torch.cat([x] * n)
    return call


def install(kind: str):
    """Plant ``kind``; returns the function that takes it out again."""
    from monte_carlo_path_tracing_tpu_torch import parallel
    from monte_carlo_path_tracing_tpu_torch.integrator import regen
    from monte_carlo_path_tracing_tpu_torch.parallel import mesh

    if kind not in KINDS:
        raise ValueError(kind)
    saved = [(regen, "render_regen_cached", regen.render_regen_cached),
             (parallel, "gather_rows", parallel.gather_rows),
             (mesh, "gather_rows", mesh.gather_rows)]
    if kind == "no_exchange":
        parallel.gather_rows = mesh.gather_rows = _no_exchange(mesh.gather_rows)
    else:
        regen.render_regen_cached = _broken_launch(regen.render_regen_cached, kind)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo

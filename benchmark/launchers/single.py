"""One card: jobs through ``render.renderer.render_image_regen``, the CLI's
``render --regen [--preview-every N]`` path, as users launch them.

A job renders the configuration's spp in launches of the mix's size
(``launch_spp`` samples per pixel, or ``launch_samples`` paths: the
renderer's own split). Each launch is timed by its ``on_launch`` callback,
which fires with the framebuffer on the host: from the previous callback,
or from the job's call for its first launch. When the window has elapsed
the callback raises, which ends the job; a job that ends before the
window does is followed by the next, so the window is always full. Only
whole launches count. Set-up renders one launch of the same shapes first.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import Window
from benchmark.launchers import common


class WindowClosed(Exception):
    """Raised from a launch's callback once the window has elapsed."""


def launch_samples(cell) -> int:
    """``max_samples_per_launch`` of the mix: pixels x ``launch_spp``, or
    ``launch_samples`` as it stands."""
    c, m = cell.config, cell.mix
    if m.get("launch_spp"):
        return c["width"] * c["height"] * int(m["launch_spp"])
    return int(m["launch_samples"])


def run(cell, seed: int, seconds: float, traced: bool, clock: common.SetupClock,
        device: str = "cuda") -> common.Measured:
    from monte_carlo_path_tracing_tpu_torch.ops import _build
    from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen

    common.check_port_is_the_checkouts()
    clock.mark("port_import_s")
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device="cuda")
    clock.mark("cuda_init_s")
    if device == "cuda":
        _build.load()
    clock.mark("kernel_library_s")
    scene = common.load_scene(cell, device)
    clock.mark("scene_s")
    cfg = common.render_config(cell, seed)
    lanes, per_launch = cell.config["lanes"], launch_samples(cell)
    n_pix = cfg.width * cfg.height
    spp_launch = max(1, min(cfg.spp, per_launch // n_pix))
    render_image_regen(scene, cfg.replace(spp=spp_launch), lanes=lanes,
                       max_samples_per_launch=per_launch)
    if device == "cuda":
        torch.cuda.synchronize()
    clock.mark("warm_launch_s")

    launches, calls = [], []
    state = {"t_prev": 0.0, "done": 0, "image": None}
    sub = common.SubWindow(traced, cell.mix.get("trace_skip", 1),
                           cell.mix.get("trace_launches", 1), device)

    def on_launch(img, spp_done):
        t = time.perf_counter()
        paths = n_pix * (spp_done - state["done"])
        launches.append((state["t_prev"], t, paths))
        state.update(t_prev=t, done=spp_done, image=img)
        sub.after_launch(len(launches) - 1, paths)
        if t >= deadline:
            raise WindowClosed

    t_win = time.perf_counter()
    deadline = t_win + seconds
    with common.observed(calls):
        while True:
            state.update(t_prev=time.perf_counter(), done=0)
            try:
                render_image_regen(scene, cfg, lanes=lanes, max_samples_per_launch=per_launch,
                                   on_launch=on_launch)
            except WindowClosed:
                break
    sub.close()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    rays = int(sum(int(c[2]) for c in calls))
    done = state["done"]
    image = state["image"].reshape(n_pix, 3).astype(np.float64) * done
    window = Window(start=t_win, launches=launches, setup_s=clock.total(),
                    setup_parts=dict(clock.parts),
                    traces=[sub.summary] if sub.summary is not None else [])
    num_tris = scene.num_tris
    del scene, calls
    if device == "cuda":
        torch.cuda.empty_cache()
    return common.Measured(window, image, list(range(done)), rays,
                           common.device_record(device, 1, peak), num_tris)

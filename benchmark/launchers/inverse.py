"""One card: optimisation steps through ``diff.inverse.recover_materials``,
the CLI's ``inverse`` path, as users run it.

A job recovers the configuration's materials from its scene file: it
starts from the CLI's start (``cli.perturb_materials``: the optimised
families moved off their true values by ``perturb``) and runs ``steps``
Adam steps at ``lr``, each rendering the mix's ``rays_per_step`` rays a
stream: the target, then the two streams under autograd, then the backward
pass and the update. The step's renders (``diff.inverse.StepRenders``:
on the card, CUDA graphs of the target and of the two streams' forward
and backward passes) are built once, in set-up, and serve every job.
Each step is one launch, timed by the job's
``progress`` callback, which fires after the step's loss is on the host:
from the previous callback, or from the job's call for its first step. Its
paths are the three renders' rays (the backward pass is not counted). When
the window has elapsed the callback raises, which ends the job; a job that
ends before the window does is followed by the next. Set-up runs one step
of the same shapes first.

Through ``recover_materials``' ``on_step`` observer the launcher keeps
what the window's last whole step computed (its index, the latents before
its update, their gradients as Adam took them, its loss and its three
radiance tensors), the latents after its update (the observer's latents
uncloned: views that the update overwrites, and the window ends at the
step's callback, after which nothing updates them), the latents at its
job's start and the gradients of each of the job's steps, and hands them
to the ``inverse`` check kind in ``Measured.extra``. It counts no logical
rays (``Measured.rays`` stays 0): the kind reads none.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import Window
from benchmark.launchers import common


class WindowClosed(Exception):
    """Raised from a step's callback once the window has elapsed."""


def run(cell, seed: int, seconds: float, traced: bool, clock: common.SetupClock,
        device: str = "cuda") -> common.Measured:
    from monte_carlo_path_tracing_tpu_torch.cli import perturb_materials
    from monte_carlo_path_tracing_tpu_torch.diff.inverse import StepRenders, recover_materials
    from monte_carlo_path_tracing_tpu_torch.ops import _build

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
    c = cell.config
    cfg = common.render_config(cell, seed)
    fams = tuple(c["optimize"])
    init = perturb_materials(scene.materials, c["perturb"], fams)
    n_rays = min(int(cell.mix["rays_per_step"]), cfg.width * cfg.height)
    renders = StepRenders(scene, cfg, n_rays)
    if device == "cuda":
        torch.cuda.synchronize()
    clock.mark("capture_s")
    job = dict(lr=c["lr"], rays_per_step=n_rays, seed=int(seed), optimize=fams,
               loss_clip=c["loss_clip"], renders=renders)
    recover_materials(scene, init, cfg, steps=1, on_step=lambda *a: None, **job)
    if device == "cuda":
        torch.cuda.synchronize()
    clock.mark("warm_step_s")

    launches = []
    state = {"t_prev": 0.0, "step": None, "job_start": None}
    sub = common.SubWindow(traced, cell.mix.get("trace_skip", 1),
                           cell.mix.get("trace_launches", 1), device)
    paths = 3 * n_rays

    def on_step(i, latents, grads, loss, radiance):
        if i == 0:
            state["job_start"] = [x.clone() for x in latents]
            state["grads_history"] = []
        grads = [g.clone() for g in grads]
        state["grads_history"].append(grads)
        state["pending"] = {"index": i, "latents": [x.clone() for x in latents],
                            "after": latents, "grads": grads, "loss": loss,
                            "radiance": radiance, "job_start": state["job_start"],
                            "grads_history": state["grads_history"]}

    def progress(i, loss):
        t = time.perf_counter()
        launches.append((state["t_prev"], t, paths))
        state.update(t_prev=t, step=state.pop("pending"))
        sub.after_launch(len(launches) - 1, paths)
        if t >= deadline:
            raise WindowClosed

    t_win = time.perf_counter()
    deadline = t_win + seconds
    while True:
        state["t_prev"] = time.perf_counter()
        try:
            recover_materials(scene, init, cfg, steps=c["steps"], progress=progress,
                              on_step=on_step, **job)
        except WindowClosed:
            break
    sub.close()
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    window = Window(start=t_win, launches=launches, setup_s=clock.total(),
                    setup_parts=dict(clock.parts),
                    traces=[sub.summary] if sub.summary is not None else [])
    del scene
    if device == "cuda":
        torch.cuda.empty_cache()
    return common.Measured(window, device=common.device_record(device, 1, peak),
                           extra={"step": state["step"], "n_rays": n_rays})

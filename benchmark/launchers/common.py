"""What the launchers share: what a run hands its check, the program's
configuration from a cell's files, the timing of set-up by part, the
traced sub-window, and the observer of the regeneration entry points."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from benchmark import trace as trace_mod
from benchmark.harness import ROOT


@dataclasses.dataclass
class Measured:
    """A launcher's run: the window, and what the configuration's check
    kind reads of it (``checks/<kind>.py``). Every launcher gives the
    window, the logical rays of the window's launches and the device record.
    The ``image`` kind reads the image (summed radiance [n_pix, 3] on the
    host, pixel order), the spp rounds it holds (see ``check.round_keys``)
    and the triangle count; another kind reads what its launchers put in
    ``extra``."""

    window: object
    image: object = None
    rounds: list | None = None
    rays: int = 0
    device: dict = dataclasses.field(default_factory=dict)
    num_tris: int | None = None
    extra: dict = dataclasses.field(default_factory=dict)


class SetupClock:
    """Set-up seconds by part, from the process's start."""

    def __init__(self, t_start: float):
        self.t_start = self.t_last = t_start
        self.parts: dict = {}

    def mark(self, part: str) -> None:
        t = time.perf_counter()
        self.parts[part] = t - self.t_last
        self.t_last = t

    def total(self) -> float:
        return self.t_last - self.t_start


def check_port_is_the_checkouts() -> None:
    """Raise unless the port is imported from this checkout: the system
    under test is the one beside the benchmark, never an installed copy."""
    import monte_carlo_path_tracing_tpu_torch as port

    where = os.path.realpath(os.path.dirname(port.__file__))
    if os.path.dirname(where) != os.path.realpath(ROOT):
        raise RuntimeError(f"the port is imported from {where}, not from this checkout {ROOT}")


def render_config(cell, seed: int):
    """The program's RenderConfig of the cell's configuration file."""
    from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

    c = cell.config
    return RenderConfig(
        width=c["width"], height=c["height"], spp=c["spp"], estimator=c["estimator"],
        light_sampler=c["light_sampler"], rr_prob=c["rr_prob"], max_depth=c["max_depth"],
        pixel_jitter=c["pixel_jitter"], seed=int(seed), ray_chunk=c["lanes"], accel=c["accel"],
        primary_cache=c["primary_cache"])


def load_scene(cell, device):
    """The program's scene at the configuration's image size."""
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene as load

    c = cell.config
    sc = load(os.path.join(ROOT, c["scene"]), device=device)
    return dataclasses.replace(sc, camera=dataclasses.replace(
        sc.camera, width=c["width"], height=c["height"]))


@contextlib.contextmanager
def observed(record: list):
    """Wraps ``integrator.regen.render_regen_cached`` and ``render_regen``,
    the calls through which every launch renders, so that each outermost
    call appends (start, end, logical rays tensor) to ``record``; calls
    made inside one (the cached route's own loop) are not recorded again."""
    from monte_carlo_path_tracing_tpu_torch.integrator import regen

    depth = [0]

    def wrap(fn):
        def call(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                record.append((t0, time.perf_counter(), out[1]))
            return out
        return call

    saved = {n: getattr(regen, n) for n in ("render_regen_cached", "render_regen")}
    for n, fn in saved.items():
        setattr(regen, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(regen, n, fn)


class SubWindow:
    """The traced sub-window: after ``skip`` whole launches a profiler
    (CPU and CUDA activity) starts at a launch boundary and stops after
    ``count`` more, or when the window closes; events stay in memory."""

    def __init__(self, enabled: bool, skip: int, count: int, device: str):
        self.enabled, self.skip, self.count = enabled, int(skip), int(count)
        self.cuda = device == "cuda"
        self.prof = None
        self.paths = self.launches = 0
        self.summary = None

    def after_launch(self, index: int, paths: int) -> None:
        """Called after launch ``index`` (0-based) with its paths."""
        if not self.enabled or self.summary is not None:
            return
        if self.prof is not None:
            self.paths += paths
            self.launches += 1
            if self.launches >= self.count:
                self.close()
        elif index + 1 >= self.skip:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def close(self) -> None:
        if self.prof is None or self.summary is not None:
            return
        self.prof.stop()
        if self.launches:
            self.summary = trace_mod.summarize(self.prof, self.launches, self.paths)
        self.prof = None


def device_record(device: str, chips: int, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}

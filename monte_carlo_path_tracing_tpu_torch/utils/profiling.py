"""Profiling: wall-clock phase timers, the device trace, the launch path's
spans, operation counts.

Counterpart of ``monte_carlo_path_tracing_tpu/utils/profiling.py``, on
``torch.profiler`` where the JAX package uses ``jax.profiler`` and XLA's
cost analysis. :func:`span` is the port's own: named ranges at the
launch path's layer boundaries, on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import DeviceType, _profiler_enabled
from torch.profiler import ProfilerActivity

from monte_carlo_path_tracing_tpu_torch.utils.timing import materialize


class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name.

    A CUDA call returns before its kernels run, so pass ``block=`` the
    phase's output (or copy it to the host inside the region): the region
    then ends at its materialization, and the device time is charged to the
    phase that queued it.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                materialize(block)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in sorted(self.totals.items())
        }

    def dump(self) -> str:
        return json.dumps(self.summary(), indent=2)


#: The spans of the launch path and of the inverse-rendering step (name:
#: what it covers). Only these names are emitted, and only while a torch
#: profiler records.
SPANS = {
    "render.launch": "one timed launch of render_image_regen, up to its on_launch",
    "render.accumulate": "the framebuffer's copy to the host, the add and the mean image",
    "regen.prepass": "a primary_prepass call (a launch's prepass)",
    "regen.loop": "a render_regen call (a launch's loop)",
    "regen.context": "a job's first build of accel, light tables, constants and state buffers; "
                     "in its later launches the key's copy, the state's in-place reset and "
                     "the launch's scalar writes",
    "regen.prepass_tail": "a prepass chunk's overflow tail",
    "regen.sync": "a host read of a device value (the loop's condition, a chunk's "
                  "overflow predicate, a count)",
    "graph.warm_up": "a captured loop's eager first step (once a job)",
    "graph.capture": "a step's capture and instantiation as a CUDA graph (once a job)",
    "parallel.reduce": "a sharded launch's count all_reduce and its host reads",
    "parallel.gather": "a gather_rows call: the all_gather of every rank's rows",
    "wavefront.sync": "the fixed-depth bounce loop's host read of the live mask, before each "
                      "bounce after the first",
    "inverse.step": "one step of diff.inverse.recover_materials",
    "inverse.target": "a step's target render from the true materials, without autograd",
    "inverse.forward": "a step's two renders of the latents under autograd (on CUDA one replay of "
                       "their graph), and the loss",
    "inverse.backward": "a step's loss.backward() (on CUDA, the streams' backward graph replayed "
                        "inside it)",
    "inverse.update": "a step's frozen-family masks, learning rate and Adam step",
    "inverse.sync": "a step's host read of the loss",
}

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A named range of the launch path while a torch profiler records
    (``device_trace``, or any ``torch.profiler.profile``): a host op
    (``cpu_op``) named ``name`` in the trace, on the device events' clock;
    otherwise a shared no-op context, after one check of the profiler's
    state. It never synchronizes the device, reads a tensor or allocates.

    The range is torch's ``_RecordFunctionFast``, a record function of
    function scope, and not ``torch.profiler.record_function``: a
    user-scope range that holds kernel launches also gets a copy on the
    CUDA stream (``gpu_user_annotation``), which a reader of device
    events can take for device work."""
    if _profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(logdir: Optional[str],
                 device="cuda") -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` trace of the block, written under ``logdir`` as a
    Chrome trace (``*.pt.trace.json``, which Perfetto and TensorBoard's
    profiler plugin open); yields the profiler, whose ``trace_path`` names
    the file once the block has exited. No-op (yields None) if ``logdir``
    is falsy.

    On the card (``device`` of type cuda) it records CPU and CUDA activity,
    and raises if the trace holds no CUDA kernel: a trace that cannot see
    the device (no CUPTI) is an error, never a CPU-only trace. With
    ``device="cpu"`` it records CPU activity only. The trace holds the
    launch path's :data:`SPANS` as host ops (:func:`span`)."""
    if not logdir:
        yield None
        return
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("device_trace: device is cuda but torch.cuda.is_available() is False")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if cuda and not any(e.device_type() == DeviceType.CUDA
                        and not e.name().startswith(("Memcpy", "Memset"))
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError("device_trace: the trace holds no CUDA kernel "
                           "(is CUPTI available to torch.profiler?)")
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def compiled_stats(fn, *args, **kwargs) -> dict:
    """Operation counts of one call ``fn(*args, **kwargs)``, with the keys of
    the JAX package's XLA cost analysis; a key holds None where torch
    counts nothing.

    ``flops`` is the sum of ``torch.profiler``'s ``with_flops`` estimates.
    Those cover matmul-class operators (``mm``, ``bmm``, ``addmm``,
    convolutions), of which this renderer has none, and elementwise
    ``mul`` / ``add`` (one operation an output element); subtractions,
    divisions, comparisons, transcendentals and the custom kernels count
    nothing. So on the renderer's functions it is a partial count, not the
    work done. torch counts no bytes accessed, so ``bytes_accessed`` and
    ``memory_mb`` (bytes accessed in MB, as the JAX package defines it)
    are None."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        fn(*args, **kwargs)
    flops = sum(e.flops for e in prof.events() if e.flops)
    return {"flops": flops or None, "bytes_accessed": None, "memory_mb": None}

"""A loop's step, captured once as a CUDA graph and replayed.

Counterpart of what ``jax.jit`` gives the JAX loops: the JAX renderer jits
``render_regen`` (``monte_carlo_path_tracing_tpu/render/renderer.py``), whose
loop is a ``lax.while_loop`` and whose prepass a ``lax.fori_loop`` over
pixel chunks (``integrator/regen.py``), and its fixed-depth path runs a
``fori_loop`` over bounces (``integrator/wavefront.py``), so a step is one
compiled program that never returns to the host. Here, on CUDA tensors,
:class:`GraphedLoop` runs such a step (a function that reads and writes
buffers in place: ``regen.regen_loop``'s iteration, ``regen.PrepassLoop``'s
chunk, ``wavefront.bounce_loop``'s bounce) as follows:

1. the first iteration eagerly, on a side stream: the warm-up, which loads
   the kernel library (nvcc must never run inside a capture) and lets the
   caching allocator settle, as ``torch.cuda.graphs`` requires;
2. the second is captured into a ``torch.cuda.CUDAGraph`` (capturing runs
   nothing) and replayed;
3. every later iteration is one ``replay()``.

The loop's condition stays on the host: one read a replay, the ``cond`` of
JAX's while_loop (the prepass: its ``lax.cond`` on the overflow tail). One
graph serves one job (``regen.RegenJob``: every launch of a
``render_image_regen`` call, or the one launch of a ``render_regen`` /
``primary_prepass`` call), or one ``render_image``; its private memory
pool, which a job's prepass and loop graphs share, holds one step's
temporaries and goes with it. A capture that fails raises; nothing falls
back to the eager loop. The first call and the capture each run inside a
span (``graph.warm_up``, ``graph.capture``: ``utils.profiling.span``); a
replay runs none.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from monte_carlo_path_tracing_tpu_torch.ops import launches
from monte_carlo_path_tracing_tpu_torch.utils.profiling import span


def use_graph(graph: bool | None, device: torch.device) -> bool:
    """Whether a loop on ``device`` is captured: ``None`` captures on CUDA
    and runs eagerly elsewhere; ``False`` runs eagerly; ``True`` captures
    and raises off CUDA."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph: the tensors are on {device}")
    return bool(graph)


class CapturedStep:
    """``step()`` captured as a graph: :meth:`replay` runs it and adds the
    kernels' launches of one captured step to their counters (the wrappers
    ran once, at capture, where nothing launched). ``graph`` and
    ``capture`` (a context manager factory taking the graph) default to
    ``torch.cuda.CUDAGraph()`` and ``torch.cuda.graph`` into the memory
    pool ``pool`` (``torch.cuda.graph_pool_handle()``; None: the graph's
    own)."""

    def __init__(self, step: Callable[[], None], graph=None,
                 capture: Callable[..., contextlib.AbstractContextManager] | None = None,
                 pool=None):
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        if capture is None:
            capture = functools.partial(torch.cuda.graph, pool=pool)
        before = launches.counts()
        try:
            with capture(self.graph):
                step()
        finally:
            after = launches.counts()
            launches.restore(before)
        self.delta = {k: after[k] - before[k] for k in before}

    def replay(self) -> None:
        self.graph.replay()
        launches.add(self.delta)


class GraphedLoop:
    """Calls of ``step`` as a captured loop: the first runs eagerly on a side
    stream, the second captures (``capture(step)``, by default a
    :class:`CapturedStep` into the memory pool ``pool``) and replays, every
    later one replays."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 capture: Callable[[Callable[[], None]], CapturedStep] | None = None,
                 pool=None):
        self.step = step
        self.device = device
        self.capture = capture or functools.partial(CapturedStep, pool=pool)
        self.calls = 0
        self.captured: CapturedStep | None = None

    def warm_up(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step()
        main.wait_stream(side)

    def __call__(self) -> None:
        self.calls += 1
        if self.calls == 1:
            with span("graph.warm_up"):
                self.warm_up()
            return
        if self.captured is None:
            with span("graph.capture"):
                self.captured = self.capture(self.step)
        self.captured.replay()

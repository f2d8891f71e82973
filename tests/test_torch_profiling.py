"""The port's utils/timing.py and utils/profiling.py against the JAX
package's on the CPU: materialize's leaf walk, timed, PhaseTimer's summary
(keys, counts and rounding equal to JAX's for the same phases on the same
clock), device_trace (a no-op without a logdir; on the CPU a Chrome trace
of a render that names aten ops; on cuda without a card an error, never a
CPU-only trace) and compiled_stats (JAX's keys; what torch counts). The
trace on the card: tests/test_torch_cuda.py."""

import dataclasses
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.utils import profiling as jprof
from monte_carlo_path_tracing_tpu_torch.integrator.regen import RegenStats
from monte_carlo_path_tracing_tpu_torch.render.renderer import RenderResult, render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils import profiling, timing
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

CORNELL = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")


def test_materialize_walks_nested_results():
    """Leaves in order: dict keys sorted (jax.tree_util's order), the
    fields of a dataclass and a NamedTuple, tuples and lists by position;
    tensors and numbers land on the host as numpy; None holds no leaf."""
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    out = {"stats": RegenStats(spilled=1, chains=torch.tensor(5), rays_physical=7),
           "a": [torch.ones(2), (torch.zeros(3, dtype=torch.int32), None)],
           "res": RenderResult(image=img, spp_done=4, seconds=0.5, rays_traced=99)}
    leaves = timing.materialize(out)
    assert all(isinstance(x, np.ndarray) for x in leaves)
    want = [np.ones(2), np.zeros(3), img, 4, 0.5, 99, 1, 5, 7]
    assert len(leaves) == len(want)
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(got, w)
    assert leaves[1].dtype == np.int32


def test_timed_returns_the_last_output_and_positive_seconds():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2.0}

    x = torch.arange(4.0)
    sec, out = timing.timed(fn, x, n=3)
    assert sec > 0.0 and len(calls) == 4          # warm-up outside the clock
    torch.testing.assert_close(out["y"], x * 2.0)


def test_phase_timer_summary_matches_jax(monkeypatch):
    """The same phases on the same (fake) clock, each with a ``block=``:
    the same summary and dump, rounding included."""
    ticks = iter([0.0, 0.00123456, 1.0, 1.5, 2.0, 2.2500049, 3.0, 3.1234567] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    def run(timer, block):
        for name in ("b", "a", "b", "c"):
            with timer.phase(name, block=block):
                pass
        return timer

    mine = run(profiling.PhaseTimer(), torch.ones(2))
    ref = run(jprof.PhaseTimer(), jnp.ones(2))
    assert mine.summary() == ref.summary()
    assert mine.dump() == ref.dump()
    assert list(mine.summary()) == ["a", "b", "c"]
    assert mine.summary()["b"] == {"total_s": round(0.00123456 + 0.2500049, 4), "count": 2,
                                   "mean_ms": round(1e3 * (0.00123456 + 0.2500049) / 2, 3)}


@pytest.mark.parametrize("logdir", [None, ""])
def test_device_trace_without_logdir_is_a_no_op(logdir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.device_trace(logdir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    """Around a cornell 8^2 render: one *.pt.trace.json under the logdir,
    valid JSON, with aten operators among its CPU events; the profiler's
    own events stay readable."""
    sc = load_scene(CORNELL, device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1, estimator="mis", max_depth=4, seed=3)
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=8, height=8))
    with profiling.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        res = render_image_regen(sc, cfg, lanes=64)
    assert np.isfinite(res.image).all()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert prof.trace_path == str(tmp_path / "trace" / files[0])
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::add", "aten::mul", "aten::index_add_"} <= ops, sorted(ops)[:20]
    assert not any(e.get("cat") == "kernel" for e in events)
    assert any(e.name == "aten::mul" for e in prof.events())


def test_device_trace_on_cuda_without_a_card_raises(tmp_path):
    """No CPU-only trace where the card was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py traces it")
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.device_trace(str(tmp_path), device="cuda"):
            pass
    assert os.listdir(tmp_path) == []


def test_compiled_stats_has_jaxs_keys_and_counts_what_torch_counts():
    """JAX's keys; a matmul counts 2 M N K operations, an elementwise mul or
    add one an element; other work counts nothing: None, not 0."""
    want_keys = set(jprof.compiled_stats(lambda a, b: a @ b, jnp.ones((4, 5)), jnp.ones((5, 6))))
    a, b = torch.ones(4, 5), torch.ones(5, 6)
    st = profiling.compiled_stats(torch.mm, a, b)
    assert set(st) == want_keys == {"flops", "bytes_accessed", "memory_mb"}
    assert st["flops"] == 2 * 4 * 5 * 6
    assert st["bytes_accessed"] is None and st["memory_mb"] is None
    assert profiling.compiled_stats(lambda x, y: (x * y + x).sin() - y, a, a)["flops"] == 40
    st = profiling.compiled_stats(lambda x: (x.sin() / 3.0).exp(), a)
    assert st == {"flops": None, "bytes_accessed": None, "memory_mb": None}

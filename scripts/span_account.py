"""The launch path's spans in a traced run of a benchmark cell, on the card.

    python3 scripts/span_account.py --workload <cell> --seed <n> [--seconds 51]

Runs the cell's window as ``python3 -m benchmark.run --trace 1`` does
(the same launcher, traced sub-window and check) and prints, besides the
cell's per-layer metrics:

- ``span_cost``: the host cost of one ``utils.profiling.span`` with no
  profiler recording, over 10^5 calls;
- for each chip's traced sub-window, the device's idle milliseconds a
  launch by the innermost program span open (``none`` where no span is
  open: the harness between launches);
- the shared clock: the share of device busy time inside ``render.launch``
  spans, and (one card) the share of the graph replays' device time inside
  ``regen.prepass`` and ``regen.loop`` spans, the replays' kernels found by
  the correlation id of their ``cudaGraphLaunch``;
- every launch's wall in ms and which of them were traced.

Standard output ends with one JSON line holding all of it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import check, harness, run, trace  # noqa: E402

SPAN_CALLS = 100_000


def span_cost_ns() -> float:
    """Host nanoseconds of one span with no profiler recording."""
    from monte_carlo_path_tracing_tpu_torch.utils.profiling import SPANS, span

    names = list(SPANS) * (SPAN_CALLS // len(SPANS))
    t0 = time.perf_counter()
    for n in names:
        with span(n):
            pass
    return (time.perf_counter() - t0) / len(names) * 1e9


def _span_rows(ts):
    """(names, starts, ends) of the program's spans among the host intervals."""
    from monte_carlo_path_tracing_tpu_torch.utils.profiling import SPANS

    sel = np.array([n in SPANS for n in ts.host.names], bool)
    names = [n for n, k in zip(ts.host.names, sel) if k]
    return names, ts.host.start[sel], ts.host.end[sel]


def innermost(names, ss, se):
    """(times, names): from each time on, the innermost span open, until
    the next time (spans nest, as one thread opens them)."""
    cp_t, cp_n, stack = [-np.inf], ["none"], []
    for i in np.lexsort((-se, ss)):                   # by start, outer first
        while stack and stack[-1][0] <= ss[i]:
            cp_t.append(stack.pop()[0])
            cp_n.append(stack[-1][1] if stack else "none")
        stack.append((se[i], names[i]))
        cp_t.append(ss[i])
        cp_n.append(names[i])
    while stack:
        cp_t.append(stack.pop()[0])
        cp_n.append(stack[-1][1] if stack else "none")
    return np.asarray(cp_t), cp_n


def idle_by_span(ts):
    """Idle ms a launch by the innermost program span open (``none``: no
    span open), over the chip's traced sub-window; and, where that span is
    ``render.launch``, by the innermost host op open (a runtime call, an
    operator or the span itself)."""
    cp_t, cp_n = innermost(*_span_rows(ts))
    out: dict = {}
    ops: dict = {}
    for a, b in zip(*ts.gaps()):
        if b <= a:
            continue
        i = np.searchsorted(cp_t, a, side="right") - 1
        j = np.searchsorted(cp_t, b, side="left")
        edges = np.r_[a, cp_t[i + 1:j], b]
        for k, (x, y) in enumerate(zip(edges[:-1], edges[1:])):
            ms = (y - x) / 1e3 / ts.launches
            out[cp_n[i + k]] = out.get(cp_n[i + k], 0.0) + ms
            if cp_n[i + k] == "render.launch" and y > x:
                op = trace.host_op_at(ts.host, 0.5 * (x + y)) or "none"
                ops[op] = ops.get(op, 0.0) + ms
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return order(out), order(ops)


def _inside(s, e, us, ue) -> float:
    """Microseconds of the intervals [s, e) inside the union (us, ue)."""
    s, e = np.asarray(s, float), np.asarray(e, float)
    return float(sum(np.clip(np.minimum(e, b) - np.maximum(s, a), 0.0, None).sum()
                     for a, b in zip(us, ue)))


def shared_clock(ts, raw=None) -> dict:
    """Shares of device time inside the launch spans, and of the graph
    replays' device time inside the prepass and loop spans (from ``raw``,
    the profiler's events with correlation ids)."""
    names, ss, se = _span_rows(ts)
    sel = np.array([n == "render.launch" for n in names], bool)
    ls, le = trace.union(ss[sel], se[sel])
    bs, be = ts.busy()
    busy = float((be - bs).sum())
    out = {"busy_in_launch": trace.overlap(bs, be, ls, le) / busy if busy else None}
    if raw is not None:
        graph = {c for n, kind, _, _, c in raw if kind in trace._HOST and "GraphLaunch" in n}
        ks = [(s, e) for n, kind, s, e, c in raw if kind == "kernel" and c in graph]
        sel = np.array([n in ("regen.prepass", "regen.loop") for n in names], bool)
        ps, pe = trace.union(ss[sel], se[sel])
        total = float(sum(e - s for s, e in ks))
        out["replay_kernels"] = len(ks)
        out["replay_ms_a_launch"] = total / 1e3 / ts.launches
        out["replay_in_prepass_loop"] = (_inside([s for s, _ in ks], [e for _, e in ks], ps, pe)
                                         / total if total else None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at the cell's size")
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload)
    run._cache_env()
    cost = span_cost_ns()
    raw: list = []
    summarize = trace.summarize

    def keep(prof, launches, paths):             # one card: the events with correlation ids
        raw.append([(ev.name(), trace._kind(ev), ev.start_ns() / 1e3,
                     (ev.start_ns() + ev.duration_ns()) / 1e3, ev.correlation_id())
                    for ev in prof.profiler.kineto_results.events()])
        return summarize(prof, launches, paths)

    trace.summarize = keep
    m = run.window_run(cell, args.seed, args.seconds, True, args.device, T_START)
    _, checks, _, _ = run.judge(cell, m, args.seed, args.device)
    w = m.window
    chips = [dict(launches=ts.launches, **dict(zip(("idle_ms", "launch_idle_ops"),
                                                   idle_by_span(ts))),
                  idle_ms_total=(ts.window_us - ts.busy_us()) / 1e3 / ts.launches,
                  **shared_clock(ts, raw[i] if len(raw) == len(w.traces) else None))
             for i, ts in enumerate(w.traces)]
    skip = cell.mix.get("trace_skip", 1)
    out = {"workload": cell.name, "seed": args.seed, "span_cost_ns": cost,
           "correct": check.passed(checks),
           "metrics": harness.read_metrics(cell.per_layer, w),
           "launch_ms": [(t1 - t0) * 1e3 for t0, t1, _ in w.launches],
           "traced": [skip, skip + cell.mix.get("trace_launches", 1)],
           "setup_s": w.setup_s, "chips": chips}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Several cards: ``parallel.sharded.make_regen_sharded`` with one process
per card, which the run starts itself (``torch.distributed``, NCCL on the
cards, gloo on the CPU), as a ``torchrun --nproc_per_node N`` job runs
``render_regen_sharded``.

Each launch is one call of the sharded renderer with a key folded from the
seed and the launch index, every rank rendering its interleaved pixels; the
rank framebuffers are then gathered to rank 0 (``parallel.gather_rows``),
copied to the host and deinterleaved, inside the clock, as the port's
``bench.py`` does. The sum that the check reads is kept on rank 0's card
and deinterleaved once, after the window, so the harness adds no host work
to a launch. Rank 0 decides when the window has elapsed and broadcasts it
(gloo, on the host), so every rank stops after the same launch. Set-up
renders one launch of the same shapes first.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np

from benchmark import harness
from benchmark.launchers import common

#: Seconds to wait for the ranks' records beyond the window.
_WAIT_S = 600.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, traced: bool, clock: common.SetupClock,
        device: str = "cuda") -> common.Measured:
    common.check_port_is_the_checkouts()
    world = cell.chips
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, cell, seed, seconds, traced,
                                                device, q))
             for r in range(world)]
    for p in procs:
        p.start()
    recs = {}
    try:
        while len(recs) < world:
            try:
                rank, rec, err = q.get(timeout=_WAIT_S + seconds)
            except queue.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(recs))} sent "
                                   "nothing") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            recs[rank] = rec
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    found = sorted({m for r in recs.values() for m in r["forbidden"]})
    if found:
        raise RuntimeError(f"a rank loaded modules of JAX or the JAX package: {found}")
    r0 = recs[0]
    n = len(r0["launches"])
    render_end = np.array([[recs[r]["render_end"][i] for r in range(world)] for i in range(n)])
    spans = {"rank_render_s": [[recs[r]["render_s"][i] for r in range(world)] for i in range(n)],
             "gather_s": list(np.asarray(r0["gathered"]) - render_end.max(axis=1))}
    parts = dict(clock.parts)
    parts.update(r0["setup_parts"])
    window = harness.Window(start=r0["t_win"], launches=r0["launches"],
                            setup_s=r0["t_win"] - clock.t_start, setup_parts=parts, spans=spans,
                            traces=[recs[r]["trace"] for r in range(world)
                                    if recs[r]["trace"] is not None])
    peak = max(recs[r]["peak"] for r in range(world))
    spp = int(cell.mix["launch_spp"])
    return common.Measured(window, r0["image"], [(i, s) for i in range(n) for s in range(spp)],
                           r0["rays"], common.device_record(device, world, peak), r0["num_tris"])


def _worker(rank, world, port, cell, seed, seconds, traced, device, q):
    try:
        q.put((rank, _rank(rank, world, port, cell, seed, seconds, traced, device), None))
    except BaseException:
        q.put((rank, None, traceback.format_exc()))


def _rank(rank, world, port, cell, seed, seconds, traced, device):
    clock = common.SetupClock(time.perf_counter())
    import torch
    import torch.distributed as dist

    clock.mark("rank_import_s")
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:                                       # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        return _measure(rank, world, cell, seed, seconds, traced, device, clock)
    finally:
        dist.destroy_process_group()


def _measure(rank, world, cell, seed, seconds, traced, device, clock):
    import torch
    import torch.distributed as dist

    from monte_carlo_path_tracing_tpu_torch.core import rng
    from monte_carlo_path_tracing_tpu_torch.ops import _build
    from monte_carlo_path_tracing_tpu_torch.parallel import gather_rows, make_mesh
    from monte_carlo_path_tracing_tpu_torch.parallel.sharded import (
        deinterleave_framebuffer, make_regen_sharded,
    )

    mesh = make_mesh((world,), ("tiles",))
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    clock.mark("process_group_s")
    if device == "cuda":
        _build.load()
    clock.mark("kernel_library_s")
    scene = common.load_scene(cell, device)
    clock.mark("scene_s")
    spp = int(cell.mix["launch_spp"])
    cfg = common.render_config(cell, seed).replace(spp=spp)
    calls = []
    with common.observed(calls):
        fn = make_regen_sharded(scene, cfg, mesh, cell.config["lanes"], spp_cap=spp)
    base = rng.base_key(seed, device=dev)
    n_pix = cfg.width * cfg.height

    def launch(i):
        fb, nrays = fn(scene, rng.fold_in(base, i), spp)
        full = gather_rows(fb, mesh)
        if rank == 0:
            deinterleave_framebuffer(full.cpu().numpy(), world)
        return full, nrays

    launch(0)
    if device == "cuda":
        torch.cuda.synchronize()
    clock.mark("warm_launch_s")

    sub = common.SubWindow(traced, cell.mix.get("trace_skip", 1),
                           cell.mix.get("trace_launches", 1), device)
    # The window's end is decided on rank 0 and broadcast through a gloo
    # group on the host, so that waiting for it keeps no kernel on a card.
    host = dist.new_group(backend="gloo")
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev) if rank == 0 else None
    launches, gathered, rays = [], [], 0
    dist.barrier()
    t_win = t_prev = time.perf_counter()
    first = len(calls)
    flag = torch.zeros(1, dtype=torch.int64)
    i = 0
    while True:
        full, nrays = launch(i)
        rays += nrays
        t = time.perf_counter()
        if rank == 0:
            acc += full
            flag.fill_(int(t - t_win >= seconds))
        gathered.append(t)
        launches.append((t_prev, t, n_pix * spp))
        sub.after_launch(i, n_pix * spp)
        dist.broadcast(flag, src=0, group=host)
        t_prev = time.perf_counter() if rank else t
        i += 1
        if int(flag.item()):
            break
    sub.close()
    if device == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) if device == "cuda" else 0
    mine = calls[first:]
    return {"launches": launches, "gathered": gathered, "t_win": t_win, "rays": rays,
            "render_s": [c[1] - c[0] for c in mine], "render_end": [c[1] for c in mine],
            "image": None if acc is None else
            deinterleave_framebuffer(acc.cpu().numpy(), world).astype(np.float64),
            "peak": int(peak),
            "trace": sub.summary,
            "setup_parts": dict(clock.parts), "num_tris": scene.num_tris,
            "forbidden": harness.forbidden_modules()}

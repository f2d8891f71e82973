"""The port's bench (``python -m monte_carlo_path_tracing_tpu_torch.bench``)
on the CPU (``BENCH_DEVICE=cpu``): the JSON contract of
``tests/test_bench_smoke.py`` as a subprocess, parity with the JAX
package's regen renders on the bench's configuration, the refusals, the
sharded branch in 2 gloo ranks, and the physical ceiling against the root
``bench.py``.

Tolerances. Against JAX the regen fringe of ``tests/test_torch_regen.py``
applies (XLA on the CPU fuses multiply-adds, so a few discrete decisions
flip): rays and rays_physical to 0.5%, at most 1% of pixels (at least 2)
beyond rtol 1e-2 / atol 1e-3. The sharded bench renders the same paths as
one process and only sums reorder: rays equal, checksum to JAX's sharded
rtol 2e-4 (``tests/test_parallel.py``).
"""

import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.core import rng as jax_rng
from monte_carlo_path_tracing_tpu.integrator import regen as jax_regen
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch import bench

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell", "cornell.obj")
VEACH = os.path.join(REPO, "scenes", "veach-mis", "veach-mis.obj")
#: The extra line's keys: the root bench.py's (bench.py:255-280) and the port's.
EXTRA_KEYS = {
    "device", "backend", "res", "spp", "estimator", "jitter", "seconds", "seconds_median",
    "rep_seconds", "rep_tenancy", "calib_seconds", "headline_phase", "paths_per_s",
    "rays_per_path", "total_rays", "rays_physical", "mrays_physical", "fb_checksum",
    "power_limit", "lanes", "launches",
}
#: tests/test_bench_smoke.py's configuration at 16^2.
SMALL = dict(BENCH_DEVICE="cpu", BENCH_SCENE=CORNELL, BENCH_RES="16", BENCH_SPP="2",
             BENCH_CHUNK="256", BENCH_REPS="1", BENCH_REP_SPACING_S="0")
PROC_S = 300


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SLURM_", "XLA_", "MASTER_"))}
    env.update(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **kw)
    return env


def _bench(env):
    return subprocess.run([sys.executable, "-m", "monte_carlo_path_tracing_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=PROC_S)


def _lines(out):
    """(contract lines on stdout, extra lines on stderr)."""
    return ([ln for ln in out.stdout.splitlines() if ln.startswith("{")],
            [ln for ln in out.stderr.splitlines() if ln.startswith("# {")])


@pytest.mark.parametrize("cache,jitter", [("1", "0"), ("0", "0"), ("1", "1")])
def test_bench_contract(cache, jitter):
    """One JSON line on stdout with the metric fields, one ``# {...}`` line
    on stderr with every key; tests/test_bench_smoke.py's assertions."""
    out = _bench(_env(**SMALL, BENCH_PRIMARY_CACHE=cache, BENCH_JITTER=jitter))
    assert out.returncode == 0, out.stderr[-3000:]
    lines, extra = _lines(out)
    assert len(lines) == 1 and len(out.stdout.strip().splitlines()) == 1, out.stdout
    d = json.loads(lines[0])
    assert set(d) == {"metric", "value", "unit", "vs_baseline"}
    assert d["metric"] == "Mrays/s/chip" and d["unit"] == "Mrays/s"
    assert d["value"] > 0
    assert len(extra) == 1, out.stderr[-2000:]
    e = json.loads(extra[0][2:])
    assert set(e) == EXTRA_KEYS
    assert e["total_rays"] > 0 and e["fb_checksum"] > 0
    assert e["backend"] == "cpu" and e["power_limit"] is None and e["lanes"] == 256
    assert e["rep_tenancy"] == [] and e["calib_seconds"] == [] and e["headline_phase"] == "n/a"
    assert len(e["rep_seconds"]) == 1 and e["seconds"] == min(e["rep_seconds"])
    assert e["paths_per_s"] == pytest.approx(16 * 16 * 2 / e["seconds"], rel=0.01)
    if cache == "1" and jitter == "0":
        assert e["rays_physical"] < e["total_rays"]
    if jitter == "1":
        # jitter forfeits the cache: every logical ray physically traced
        assert e["jitter"] is True
        assert e["rays_physical"] == e["total_rays"]


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
def test_bench_matches_jax(veach_scene, cached):
    """run() on Veach 16^2 x 2 spp with the bench's configuration (mis,
    spherical_triangle, depth 16, seed 0) against JAX's
    render_regen_cached / render_regen on the same configuration."""
    res, spp, lanes = 16, 2, 256
    n_pix = res * res
    env = dict(BENCH_DEVICE="cpu", BENCH_SCENE=VEACH, BENCH_RES=str(res), BENCH_SPP=str(spp),
               BENCH_CHUNK=str(lanes), BENCH_REPS="1", BENCH_DOT_MODE="vpu",
               BENCH_PRIMARY_CACHE="1" if cached else "0")
    _, e, fb = bench.run(env)
    assert fb.shape == (n_pix, 3) and np.isfinite(fb).all()
    assert e["fb_checksum"] == float(fb.sum())

    js = dataclasses.replace(veach_scene, camera=dataclasses.replace(
        veach_scene.camera, width=res, height=res))
    cfg = JaxConfig(width=res, height=res, spp=spp, estimator="mis",
                    light_sampler="spherical_triangle", max_depth=16, ray_chunk=lanes, seed=0)
    key = jax_rng.base_key(0)
    if cached:
        jfb, jrays, _, stats = jax_regen.render_regen_cached(js, cfg, key, n_pix, spp, spp,
                                                             lanes=lanes)
    else:
        jfb, jrays, _, stats = jax_regen.render_regen(js, cfg, key, n_pix, n_pix * spp,
                                                      lanes=lanes)
    jrays = int(jrays)
    jphys = int(stats.rays_physical) or jrays
    assert abs(e["total_rays"] - jrays) <= 0.005 * jrays, (e["total_rays"], jrays)
    assert abs(e["rays_physical"] - jphys) <= 0.005 * jphys, (e["rays_physical"], jphys)
    assert (e["rays_physical"] < e["total_rays"]) == cached
    a, b = np.asarray(jfb) / spp, fb / spp
    diverged = int((~np.isclose(b, a, rtol=1e-2, atol=1e-3).all(-1)).sum())
    fine = int((~np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)).sum())
    print(f"rays {jrays} vs {e['total_rays']}, physical {jphys} vs {e['rays_physical']}; "
          f"{fine} of {n_pix} pixels beyond rtol 1e-4, {diverged} diverged")
    assert diverged <= max(2, n_pix // 100)


def test_bench_refuses_tpu_dot_modes():
    out = _bench(_env(**SMALL, BENCH_DOT_MODE="mxu_fast"))
    assert out.returncode != 0 and not _lines(out)[0]
    assert "ROADMAP" in out.stderr and "Do not port" in out.stderr, out.stderr[-2000:]
    with pytest.raises(bench.BenchError, match="ROADMAP"):
        bench.run(dict(SMALL, BENCH_DOT_MODE="mxu_bf16"))


def test_bench_without_a_card_does_not_fall_back_to_the_cpu():
    """BENCH_DEVICE unset asks for the card; with none visible the bench
    exits non-zero and prints no result."""
    env = _env(**{k: v for k, v in SMALL.items() if k != "BENCH_DEVICE"},
               CUDA_VISIBLE_DEVICES="")
    out = _bench(env)
    assert out.returncode != 0 and not _lines(out)[0], out.stdout
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_bench_sharded_branch():
    """2 gloo ranks (torchrun's variables, the launch pattern of
    tests/test_torch_parallel.py): only rank 0 prints, and its rays and
    checksum are the single-process run's."""
    cfg = dict(SMALL, BENCH_PRIMARY_CACHE="1")
    _, single, _ = bench.run(cfg)
    env = _env(**cfg, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-m", "monte_carlo_path_tracing_tpu_torch.bench"],
                              cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    (out0, err0), (out1, err1) = outs
    assert not [ln for ln in out1.splitlines() if ln.startswith("{")]
    assert not [ln for ln in err1.splitlines() if ln.startswith("# {")]
    lines = [ln for ln in out0.splitlines() if ln.startswith("{")]
    extra = [ln for ln in err0.splitlines() if ln.startswith("# {")]
    assert len(lines) == 1 and len(extra) == 1, (out0, err0[-2000:])
    assert json.loads(lines[0])["value"] > 0
    e = json.loads(extra[0][2:])
    assert set(e) == EXTRA_KEYS and e["rep_seconds"] == []
    assert e["total_rays"] == single["total_rays"]
    assert e["rays_physical"] == single["rays_physical"]
    assert e["fb_checksum"] == pytest.approx(single["fb_checksum"], rel=2e-4)


def test_ceiling_is_the_jax_bench_formula():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    assert bench.REF_PATHS_PER_S == jax_bench.REF_PATHS_PER_S
    for n_tris in (2, 36, 3136, 29596):
        assert bench._ceiling_mrays(n_tris) == jax_bench._ceiling_mrays(n_tris)

"""The port's parallel/ (torch.distributed) against the JAX package's
parallel/ on the CPU, with gloo.

The port runs one process per device. Its ranks here are subprocesses
(``_WORKER``), joined through ``init_distributed_if_needed`` from
torchrun-style variables on a free port, each on one torch thread, with a
timeout on the rendezvous, on every collective and on every join. One
4-rank launch runs the sharded fixed-depth render, the sharded regen
render (uncached and cached), the sharded renderer as one job across
launches and the train step; every rank writes its results, which the
tests hold against JAX's ``parallel/`` on 4 of the 8 virtual CPU devices
that ``tests/conftest.py`` makes, against the port's single-device
renders, and (the job's launches) against one-launch renderers and the
benchmark's plain reference (``benchmark/reference/``).

Tolerances are JAX's own (``tests/test_parallel.py``,
``tests/test_primary_cache.py``) where the port is held against itself:
the shards compute the same paths as one device and only sums reorder.
Against JAX's regen renders the port's regen fringe applies
(``tests/test_torch_regen.py``): XLA on the CPU fuses multiply-adds, so a
few discrete decisions flip.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import regen, render_rays
from monte_carlo_path_tracing_tpu_torch.parallel import mesh as tmesh
from monte_carlo_path_tracing_tpu_torch.parallel.sharded import deinterleave_framebuffer
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell", "cornell.obj")
#: Seconds a rank may take to join, for any one collective, and in all.
RENDEZVOUS_S, RANK_S = 60, 240
#: The configurations, as in tests/test_parallel.py and test_primary_cache.py.
RAYS = dict(spp=1, estimator="mis", max_depth=4, seed=3)
REGEN = dict(width=16, height=16, spp=16, estimator="mis", max_depth=6, seed=2)
CACHED = dict(width=24, height=16, spp=3, estimator="mis", light_sampler="spherical_triangle",
              max_depth=16, seed=7, primary_cache=True)
#: The sharded renderer's job: the four-card configuration's scene (Veach
#: MIS), cached, and the spp of its launches after a 0-spp warm-up.
JOB = dict(CACHED, width=16, height=16)
JOB_SPP = [3, 1, 2]
TRAIN = dict(spp=1, estimator="brdf", max_depth=3, seed=1)
FIELDS = ("kd", "ks", "ns", "emission")

_WORKER = r"""
import dataclasses, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.environ["MCPT_REPO"])
from monte_carlo_path_tracing_tpu_torch.parallel import mesh as tmesh

tmesh.init_distributed_if_needed(backend="gloo", timeout_s=float(os.environ["MCPT_TIMEOUT"]))
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.parallel import (
    make_mesh, make_train_step, ray_sharding, render_rays_sharded, replicated,
)
from monte_carlo_path_tracing_tpu_torch.integrator import shading
from monte_carlo_path_tracing_tpu_torch.parallel.mesh import gather_rows
from monte_carlo_path_tracing_tpu_torch.parallel.sharded import (
    deinterleave_framebuffer, make_regen_sharded, render_regen_sharded,
)
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.scene.types import Materials
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

out_dir, jobs = sys.argv[1], sys.argv[2:]
cfgs = json.loads(os.environ["MCPT_CFGS"])
rank, world = dist.get_rank(), dist.get_world_size()
base = load_scene(os.path.join(os.environ["MCPT_REPO"], "scenes", "cornell", "cornell.obj"),
                  device="cpu")
res = lambda w, h: dataclasses.replace(base, camera=dataclasses.replace(base.camera, width=w,
                                                                        height=h))
inp = np.load(os.path.join(out_dir, "inputs.npz"))
t = lambda name: torch.from_numpy(inp[name])
out = {}
for job in jobs:
    if job == "init":
        assert dist.is_initialized() and world == 1
        group = dist.group.WORLD
        tmesh.init_distributed_if_needed(backend="gloo")        # a second call: nothing
        assert dist.group.WORLD is group
        for shape in ((2,), (1, 2)):
            try:
                make_mesh(shape, ("tiles", "spp")[:len(shape)])
                raise AssertionError(f"make_mesh{shape} on one rank did not raise")
            except ValueError:
                pass
        out["init_mesh_size"] = make_mesh().size()
    elif job == "rays":
        mesh = make_mesh((world,), ("tiles",))
        x = t("ro")
        assert torch.equal(distribute_tensor(x, mesh, ray_sharding(mesh)).to_local(),
                           tmesh.shard_rows(x, mesh))
        assert torch.equal(distribute_tensor(x, mesh, replicated(mesh)).to_local(), x)
        out["rays"] = render_rays_sharded(res(16, 16), RenderConfig(**cfgs["rays"]),
                                          rng.base_key(0), t("ro"), t("rd"), mesh).numpy()
    elif job == "regen":
        cfg = RenderConfig(**cfgs["regen"])
        fb, n = render_regen_sharded(res(16, 16), cfg, rng.base_key(cfg.seed),
                                     make_mesh((world,), ("tiles",)), lanes_per_device=256)
        out["regen_fb"], out["regen_rays"] = fb, n
    elif job == "cached":
        cfg = RenderConfig(**cfgs["cached"])
        mesh = make_mesh((world,), ("tiles",))
        fb, n = render_regen_sharded(res(24, 16), cfg, rng.base_key(cfg.seed), mesh,
                                     lanes_per_device=64, spp_cap=cfg.spp)
        fn = make_regen_sharded(res(24, 16), cfg, mesh, 64, spp_cap=cfg.spp, with_physical=True)
        _, n2, phys = fn(res(24, 16), rng.base_key(cfg.seed), cfg.spp)
        assert n2 == n
        out["cached_fb"], out["cached_rays"], out["cached_phys"] = fb, n, phys
    elif job == "job":
        # One renderer: a 0-spp warm-up, then a launch a key folded from the
        # seed; then each key again through a renderer of its own.
        cfg = RenderConfig(**cfgs["job"])
        mesh = make_mesh((world,), ("tiles",))
        sc = load_scene(os.path.join(os.environ["MCPT_REPO"], "scenes", "veach-mis",
                                     "veach-mis.obj"), device="cpu")
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=cfg.width,
                                                                height=cfg.height))
        keys = [rng.fold_in(rng.base_key(cfg.seed), i) for i in range(len(cfgs["job_spp"]))]
        shards = lambda fb: deinterleave_framebuffer(gather_rows(fb, mesh).numpy(), world)
        real, made = shading.scene_context, []
        shading.scene_context = lambda *a: made.append(1) or real(*a)
        with make_regen_sharded(sc, cfg, mesh, 64, spp_cap=cfg.spp) as fn:
            fn(sc, keys[0], 0)
            parts = {name: part for name, (_, part) in fn.job.parts.items()}
            assert set(parts) == {"context", "prepass", "loop"}
            for i, (k, spp) in enumerate(zip(keys, cfgs["job_spp"])):
                fb, n = fn(sc, k, spp)
                out[f"job_fb_{i}"], out[f"job_rays_{i}"] = shards(fb), n
                assert {name: part for name, (_, part) in fn.job.parts.items()} == parts
        assert not fn.job.parts
        shading.scene_context = real
        out["job_contexts"] = len(made)
        for i, (k, spp) in enumerate(zip(keys, cfgs["job_spp"])):
            with make_regen_sharded(sc, cfg, mesh, 64, spp_cap=cfg.spp) as one:
                fb, n = one(sc, k, spp)
                out[f"one_fb_{i}"], out[f"one_rays_{i}"] = shards(fb), n
    elif job == "raises":
        mesh = make_mesh((world,), ("tiles",))
        cases = [(res(15, 15), RenderConfig(width=15, height=15, spp=2), None),
                 (res(16, 16), RenderConfig(width=16, height=16, spp=4), 2)]
        for sc, cfg, cap in cases:
            try:
                make_regen_sharded(sc, cfg, mesh, 64, spp_cap=cap)
                raise AssertionError(f"make_regen_sharded did not raise ({cfg.spp}, {cap})")
            except ValueError:
                pass
        out["raised"] = len(cases)
    elif job == "train":
        shape = (2, 2) if world == 4 else (world,)
        mesh = make_mesh(shape, ("tiles", "spp")[:len(shape)])
        step = make_train_step(res(16, 16), RenderConfig(**cfgs["train"]), mesh, lr=0.5)
        m = Materials(**{f: t(f) for f in ("kd", "ks", "ns", "emission")})
        key = rng.base_key(7)
        losses = []
        for i in range(6):
            m, loss = step(m, key if i == 0 else rng.fold_in(key, i - 1), t("train_ro"),
                           t("train_rd"), t("target"))
            losses.append(float(loss))
            for f in ("kd", "ks", "ns", "emission"):
                out[f"train_{f}_{i}"] = getattr(m, f).numpy()
        out["train_losses"] = np.asarray(losses)
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank, flush=True)
# Leave without the interpreter's teardown: under load torch's teardown of
# the gloo groups now and then aborted a rank whose work was done.
os._exit(0)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world: int, jobs, out_dir, inputs: dict) -> list:
    """Run ``jobs`` in ``world`` gloo ranks (torchrun's variables, a free
    port); every rank must exit 0 within RANK_S seconds. Returns each
    rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "inputs.npz"), **inputs)
    worker = os.path.join(out_dir, "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SLURM_", "XLA_"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               MCPT_REPO=REPO, MCPT_TIMEOUT=str(RENDEZVOUS_S), OMP_NUM_THREADS="1",
               MCPT_CFGS=json.dumps(dict(rays=RAYS, regen=REGEN, cached=CACHED, train=TRAIN,
                                         job=JOB, job_spp=JOB_SPP)))
    procs = [subprocess.Popen([sys.executable, worker, str(out_dir), *jobs],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in o, f"rank {r} failed:\n{o[-4000:]}"
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def _scene(w, h):
    sc = load_scene(CORNELL, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=w, height=h))


def _jax_scene(cornell_scene, w, h):
    return dataclasses.replace(cornell_scene, camera=dataclasses.replace(
        cornell_scene.camera, width=w, height=h))


@pytest.fixture(scope="module")
def inputs(cornell_scene):
    """The rays of tests/test_parallel.py (JAX's camera, 16^2): 256 for the
    fixed-depth render, 64 for the train step, its JAX target and its
    perturbed starting materials."""
    import jax
    import jax.numpy as jnp

    from monte_carlo_path_tracing_tpu.integrator import render_rays as jax_render_rays
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    cam = dataclasses.replace(cornell_scene.camera, width=16, height=16)
    ro, rd = generate_rays(cam, jnp.arange(256, dtype=jnp.int32))
    tro, trd = ro[:64], rd[:64]
    target = jax_render_rays(cornell_scene, JaxConfig(**TRAIN), jax.random.key(99), tro, trd)
    mats = cornell_scene.materials
    mats0 = dataclasses.replace(mats, kd=jnp.clip(mats.kd + 0.2, 0, 1))
    out = dict(ro=ro, rd=rd, train_ro=tro, train_rd=trd, target=target,
               **{f: getattr(mats0, f) for f in FIELDS})
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks4(inputs, tmp_path_factory):
    """One 4-rank launch of every sharded path."""
    return launch(4, ["rays", "regen", "cached", "job", "train"],
                  tmp_path_factory.mktemp("ranks4"), inputs)


# ---------------------------------------------------------------------------
# The row offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(96,), (96, 2), (96, 3)])
def test_row_offset_draw_is_the_slice_of_the_global_draw(shape):
    """A scalar key's draw over rows [r0, r0 + n) with ``row_offset=r0``
    is those rows of the global draw, bit for bit, and of
    ``jax.random.uniform``'s."""
    import jax

    key = rng.fold_in(rng.base_key(5), 3)
    jkey = jax.random.fold_in(jax.random.key(5), 3)
    whole = rng.uniform(key, shape)
    jwhole = np.asarray(jax.random.uniform(jkey, shape))
    assert np.array_equal(whole.numpy(), jwhole)
    for r0, n in ((0, 96), (24, 24), (72, 24), (95, 1)):
        part = rng.uniform(key, (n,) + shape[1:], row_offset=r0)
        assert torch.equal(part, whole[r0:r0 + n]), (r0, n)
        bits = rng.random_bits(key, (n,) + shape[1:], row_offset=r0)
        assert torch.equal(bits, rng.random_bits(key, shape)[r0:r0 + n])


def test_row_offset_counts_past_two_to_the_32():
    """Counts above 2**32 carry into the high counter word, as jax's 64-bit
    iota does: row 2**31 of a [*, 2] draw counts from 2**32."""
    key = rng.base_key(1)
    bits = rng.random_bits(key, (2, 2), row_offset=1 << 31)
    count = torch.arange(1 << 32, (1 << 32) + 4, dtype=torch.int64).reshape(2, 2)
    y0, y1 = rng.threefry2x32(key[0], key[1], count >> 32, count & 0xFFFFFFFF)
    assert torch.equal(bits, y0 ^ y1)


def test_row_offset_of_lane_keys_and_default_leave_draws_alone():
    """Batched lane keys draw per lane whatever the offset; the default
    offset is the draw from row 0."""
    keys = rng.lane_keys(rng.base_key(2), torch.arange(8))
    assert torch.equal(rng.uniform(keys, (8, 2), row_offset=5), rng.uniform(keys, (8, 2)))
    key = rng.base_key(2)
    assert torch.equal(rng.uniform(key, (8,), row_offset=0), rng.uniform(key, (8,)))


@pytest.mark.parametrize("estimator,sampler", [
    ("mis", "spherical_triangle"), ("split", "uniform_area"), ("brdf", "spherical_triangle"),
])
def test_render_rays_blocks_with_offsets_make_the_whole(inputs, estimator, sampler):
    """render_rays of a scalar key over blocks of rows, each with its row
    offset, equals the render of all the rows: every scalar-key draw under
    it puts the ray axis first."""
    sc = _scene(16, 16)
    cfg = RenderConfig(**dict(RAYS, estimator=estimator, light_sampler=sampler))
    ro, rd = torch.from_numpy(inputs["ro"]), torch.from_numpy(inputs["rd"])
    key = rng.base_key(0)
    whole = render_rays(sc, cfg, key, ro, rd)
    parts = [render_rays(sc, cfg, key, ro[r0:r0 + 64], rd[r0:r0 + 64], row_offset=r0)
             for r0 in range(0, 256, 64)]
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The sharded renders and the train step, on 4 ranks
# ---------------------------------------------------------------------------

def test_render_rays_sharded_matches_single_device_and_jax(ranks4, inputs, cornell_scene):
    """render_rays_sharded on 4 ranks (cornell 16^2, 256 rays, MIS, depth
    4, seed 3): every rank holds the gathered [256, 3]; it equals the
    port's single-device render_rays, and JAX's render_rays_sharded on 4
    devices within rtol 2e-4 / atol 1e-5 (tests/test_parallel.py:33)."""
    import jax

    from monte_carlo_path_tracing_tpu.parallel import make_mesh as jax_make_mesh
    from monte_carlo_path_tracing_tpu.parallel import render_rays_sharded as jax_sharded
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    outs = [r["rays"] for r in ranks4]
    assert outs[0].shape == (256, 3) and np.isfinite(outs[0]).all()
    assert all(np.array_equal(o, outs[0]) for o in outs[1:])
    single = render_rays(_scene(16, 16), RenderConfig(**RAYS), rng.base_key(0),
                         torch.from_numpy(inputs["ro"]), torch.from_numpy(inputs["rd"]))
    np.testing.assert_allclose(outs[0], single.numpy(), rtol=2e-4, atol=1e-5)
    mesh = jax_make_mesh((4,), ("tiles",), devices=jax.devices()[:4])
    want = jax_sharded(cornell_scene, JaxConfig(**RAYS), jax.random.key(0), inputs["ro"],
                       inputs["rd"], mesh)
    np.testing.assert_allclose(outs[0], np.asarray(want), rtol=2e-4, atol=1e-5)


def _lit(img):
    """Directly seen light pixels: exactly (34, 24, 8) in every renderer."""
    return np.all(np.abs(img - np.asarray([34.0, 24.0, 8.0])) < 1e-3, -1)


def _regen_fringe(img, want, rays, want_rays):
    """The port's regen fringe against JAX (tests/test_torch_regen.py)."""
    assert abs(rays - want_rays) <= 0.005 * want_rays, (rays, want_rays)
    diverged = ~np.isclose(img, want, rtol=1e-2, atol=1e-3).all(-1)
    assert int(diverged.sum()) <= max(2, diverged.size // 100)
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-3


def test_render_regen_sharded_matches_single_device_and_jax(ranks4, cornell_scene):
    """render_regen_sharded on 4 ranks (cornell 16^2, 16 spp, MIS, depth 6,
    256 lanes a rank): equal on every rank; equal to the port's
    render_image_regen within rtol 1e-4 / atol 1e-5 with the lit pixels in
    the same places (tests/test_parallel.py:60-85), ray counts equal; and
    JAX's render_regen_sharded on 4 devices within the regen fringe."""
    import jax

    from monte_carlo_path_tracing_tpu.parallel import make_mesh as jax_make_mesh
    from monte_carlo_path_tracing_tpu.parallel.sharded import render_regen_sharded as jax_regen
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    fbs = [r["regen_fb"] for r in ranks4]
    assert all(np.array_equal(f, fbs[0]) for f in fbs[1:])
    img = fbs[0].reshape(16, 16, 3) / REGEN["spp"]
    rays = int(ranks4[0]["regen_rays"])
    assert np.isfinite(img).all() and rays > 0
    ref = render_image_regen(_scene(16, 16), RenderConfig(**REGEN), lanes=1024)
    np.testing.assert_allclose(img, ref.image, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_lit(img), _lit(ref.image))
    assert _lit(img).sum() >= 1 and rays == ref.rays_traced
    mesh = jax_make_mesh((4,), ("tiles",), devices=jax.devices()[:4])
    jfb, jrays = jax_regen(_jax_scene(cornell_scene, 16, 16), JaxConfig(**REGEN),
                           jax.random.key(REGEN["seed"]), mesh, lanes_per_device=256)
    want = np.asarray(jfb).reshape(16, 16, 3) / REGEN["spp"]
    _regen_fringe(img, want, rays, int(jrays))
    np.testing.assert_array_equal(_lit(img), _lit(want))


def test_sharded_cached_matches_unsharded_and_jax(ranks4, cornell_scene):
    """The sharded cached render (spp_cap: each rank's prepass over its
    interleaved pixels) on 4 ranks equals the unsharded cached render
    within rtol 1e-5 (tests/test_primary_cache.py:131-153), its logical
    and (``with_physical``) physical ray counts equal; and JAX's sharded
    cached render within the regen fringe."""
    import jax

    from monte_carlo_path_tracing_tpu.parallel import make_mesh as jax_make_mesh
    from monte_carlo_path_tracing_tpu.parallel.sharded import render_regen_sharded as jax_regen
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    img = ranks4[0]["cached_fb"].reshape(16, 24, 3) / CACHED["spp"]
    rays = int(ranks4[0]["cached_rays"])
    un = render_image_regen(_scene(24, 16), RenderConfig(**CACHED), lanes=64)
    np.testing.assert_allclose(img, un.image, rtol=1e-5, atol=1e-5)
    assert rays == un.rays_traced
    cfg = RenderConfig(**CACHED)
    *_, stats = regen.render_regen_cached(_scene(24, 16), cfg, rng.base_key(cfg.seed), 24 * 16,
                                          cfg.spp, cfg.spp, lanes=64)
    assert int(ranks4[0]["cached_phys"]) == stats.rays_physical
    mesh = jax_make_mesh((4,), ("tiles",), devices=jax.devices()[:4])
    jfb, jrays = jax_regen(_jax_scene(cornell_scene, 24, 16), JaxConfig(**CACHED),
                           jax.random.key(CACHED["seed"]), mesh, lanes_per_device=64,
                           spp_cap=CACHED["spp"])
    _regen_fringe(img, np.asarray(jfb).reshape(16, 24, 3) / CACHED["spp"], rays, int(jrays))


def test_sharded_renderer_is_one_job_across_launches(ranks4):
    """One make_regen_sharded renderer on 4 ranks (Veach MIS 16^2, cached,
    spp_cap 3, 64 lanes a rank): after a 0-spp warm-up, three launches of
    3, 1 and 2 spp, each keyed fold(base(7), i). Every rank holds the same
    gathered image; each launch is bit-equal, with the same ray count, to a
    fresh renderer's one call with its key (the same ranks sum in the same
    order); the keys give other images; the job built its scene context
    and parts once, and freed them when its ``with`` block ended."""
    r0 = ranks4[0]
    for r in ranks4:
        assert int(r["job_contexts"]) == 1
    for i in range(len(JOB_SPP)):
        img = r0[f"job_fb_{i}"]
        assert np.isfinite(img).all() and img.sum() > 0
        assert all(np.array_equal(r[f"job_fb_{i}"], img) for r in ranks4[1:])
        assert np.array_equal(img, r0[f"one_fb_{i}"]), i
        assert int(r0[f"job_rays_{i}"]) == int(r0[f"one_rays_{i}"]) > 0
    assert not np.array_equal(r0["job_fb_0"] / JOB_SPP[0], r0["job_fb_2"] / JOB_SPP[2])


def test_sharded_renderer_launches_match_the_plain_reference(ranks4):
    """The job's three launches summed, on every pixel, against the
    benchmark's plain reference (``benchmark/reference/tracer.py``: plain
    PyTorch float32, nothing of the port) over the same rounds, each round
    keyed fold(fold(base(7), launch), spp index) as the four-card cell's
    launches are. The limits are the four-card configuration's own
    (``benchmark/configs/veach-mis-2048-4chip.json``, ``check.limits``), the
    ones that decide its ``correct`` on the card, set in PERF.md §2 between
    the sound runs' readings and the bfloat16 control's:

    - ``pixels_off_share`` 0.05: a pixel is off past 1e-2 of its L1; the
      two trace the same paths from the same streams, so only a path whose
      discrete decision flips on rounding can move a pixel;
    - ``sum_gap`` 0.002: the image sum, which such a flip moves by one
      path's radiance;
    - ``rays_per_path_gap`` 0.009: the logical rays a path, which a flip
      moves by a few rays; here both count every pixel."""
    from benchmark import check

    r0 = ranks4[0]
    n_pix = JOB["width"] * JOB["height"]
    rounds = [(i, s) for i, spp in enumerate(JOB_SPP) for s in range(spp)]
    prog = sum(r0[f"job_fb_{i}"].astype(np.float64) for i in range(len(JOB_SPP)))
    rays = sum(int(r0[f"job_rays_{i}"]) for i in range(len(JOB_SPP)))
    conf = {"scene": "scenes/veach-mis/veach-mis.obj", "width": JOB["width"],
            "height": JOB["height"], "rr_prob": RenderConfig(**JOB).rr_prob}
    ref, ref_rays = check.reference(conf, REPO, JOB["seed"], rounds, np.arange(n_pix), "cpu")
    got = check.compare(prog, ref, rays / (n_pix * len(rounds)), ref_rays / (n_pix * len(rounds)))
    with open(os.path.join(REPO, "benchmark", "configs", "veach-mis-2048-4chip.json")) as f:
        limits = json.load(f)["check"]["limits"]
    assert set(limits) == set(got)
    for k, limit in limits.items():
        assert got[k] <= limit, (k, got)


def test_train_step_matches_jax_and_descends(ranks4, inputs, cornell_scene):
    """make_train_step on a (2, 2) tiles x spp mesh of 4 ranks (cornell
    16^2, 64 rays, BRDF, depth 3, lr 0.5): the first step's loss and new
    materials equal JAX's make_train_step on a (2, 2) mesh of 4 CPU devices
    within rtol 1e-4 / atol 1e-5 (the same streams; only f32 sums
    reorder); over 5 more steps the loss descends
    (tests/test_parallel.py:37-58); every rank holds bit-identical
    materials after every step."""
    import jax

    from monte_carlo_path_tracing_tpu.parallel import make_mesh as jax_make_mesh
    from monte_carlo_path_tracing_tpu.parallel import make_train_step as jax_step
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    for i in range(6):
        for f in FIELDS:
            a = ranks4[0][f"train_{f}_{i}"]
            assert np.isfinite(a).all()
            assert all(np.array_equal(r[f"train_{f}_{i}"], a) for r in ranks4[1:]), (i, f)
    losses = ranks4[0]["train_losses"]
    assert all(np.array_equal(r["train_losses"], losses) for r in ranks4[1:])
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    mesh = jax_make_mesh((2, 2), ("tiles", "spp"), devices=jax.devices()[:4])
    mats0 = dataclasses.replace(cornell_scene.materials,
                                **{f: inputs[f] for f in FIELDS})
    step = jax_step(_jax_scene(cornell_scene, 16, 16), JaxConfig(**TRAIN), mesh, lr=0.5)
    m, loss = step(mats0, jax.random.key(7), inputs["train_ro"], inputs["train_rd"],
                   inputs["target"])
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(ranks4[0][f"train_{f}_0"], np.asarray(getattr(m, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# Two processes through init_distributed_if_needed; the raises
# ---------------------------------------------------------------------------

def test_two_process_train_step_and_regen(ranks4, inputs, cornell_scene, tmp_path):
    """The pattern of tests/test_multiprocess.py, small: 2 processes joined
    by init_distributed_if_needed run the sharded regen render and the
    train step on a (2,) tiles mesh against a constant target of 0.25 (as
    there). The image equals the 4-rank one within rtol 1e-5 (streams are
    keyed by global pixel: the rank count is invisible) with an equal ray
    count; the losses are finite, the materials bit-identical across the
    ranks after every step, and the first step equals JAX's on a (2,) mesh
    of 2 CPU devices within rtol 1e-4 / atol 1e-5; an indivisible pixel
    count and spp > spp_cap raise ValueError."""
    import jax

    from monte_carlo_path_tracing_tpu.parallel import make_mesh as jax_make_mesh
    from monte_carlo_path_tracing_tpu.parallel import make_train_step as jax_step
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig

    target = np.full((64, 3), 0.25, np.float32)
    out = launch(2, ["regen", "raises", "train"], tmp_path, dict(inputs, target=target))
    np.testing.assert_allclose(out[0]["regen_fb"], ranks4[0]["regen_fb"], rtol=1e-5, atol=1e-5)
    assert int(out[0]["regen_rays"]) == int(ranks4[0]["regen_rays"])
    assert all(int(r["raised"]) == 2 for r in out)
    for i in range(6):
        for f in FIELDS:
            assert np.array_equal(out[0][f"train_{f}_{i}"], out[1][f"train_{f}_{i}"]), (i, f)
    losses = out[0]["train_losses"]
    assert np.isfinite(losses).all() and np.array_equal(out[1]["train_losses"], losses)

    mesh = jax_make_mesh((2,), ("tiles",), devices=jax.devices()[:2])
    mats0 = dataclasses.replace(cornell_scene.materials, **{f: inputs[f] for f in FIELDS})
    step = jax_step(_jax_scene(cornell_scene, 16, 16), JaxConfig(**TRAIN), mesh, lr=0.5)
    m, loss = step(mats0, jax.random.key(7), inputs["train_ro"], inputs["train_rd"], target)
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(out[0][f"train_{f}_0"], np.asarray(getattr(m, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


def test_init_distributed_under_explicit_variables(inputs, tmp_path):
    """A world-size-1 gloo process under torchrun's variables initialises,
    a second call changes nothing, and make_mesh raises when the shape
    needs more ranks than there are."""
    out = launch(1, ["init"], tmp_path, inputs)
    assert int(out[0]["init_mesh_size"]) == 1


def _clear_launch_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SLURM_") or k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                           "LOCAL_RANK"):
            monkeypatch.delenv(k)


def test_init_distributed_does_nothing_without_a_launcher(monkeypatch):
    import torch.distributed as dist

    _clear_launch_env(monkeypatch)
    tmesh.init_distributed_if_needed(backend="gloo")
    assert not dist.is_initialized()
    # one SLURM task is no multi-process launch
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    tmesh.init_distributed_if_needed(backend="gloo")
    assert not dist.is_initialized()


def test_init_distributed_raises_on_a_bad_explicit_address(monkeypatch):
    """An explicit launch that cannot initialise is loud (no fallback)."""
    import torch.distributed as dist

    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "99999")          # no such port
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError):
        tmesh.init_distributed_if_needed(backend="gloo", timeout_s=5)
    assert not dist.is_initialized()


def test_init_distributed_warns_on_a_slurm_misfire(monkeypatch):
    """Only SLURM's auto-configuration may fail softly: a warning, and the
    run stays single-process."""
    import torch.distributed as dist

    _clear_launch_env(monkeypatch)
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "")          # no host to meet at
    with pytest.warns(RuntimeWarning):
        tmesh.init_distributed_if_needed(backend="gloo", timeout_s=5)
    assert not dist.is_initialized()


@pytest.mark.parametrize("nodelist,host", [
    ("gpu07", "gpu07"), ("gpu07,gpu09", "gpu07"), ("n[03-05,7],m", "n03"), ("a-b[1,2]", "a-b1"),
])
def test_slurm_first_host(nodelist, host):
    assert tmesh._slurm_first_host(nodelist) == host


def test_deinterleave_framebuffer_matches_jax():
    from monte_carlo_path_tracing_tpu.parallel.sharded import (
        deinterleave_framebuffer as jax_deinterleave,
    )

    g = np.random.default_rng(0)
    for nd, local in ((1, 5), (4, 6), (8, 3)):
        fb = g.normal(size=(nd * local, 3)).astype(np.float32)
        want = jax_deinterleave(fb, nd)
        assert np.array_equal(deinterleave_framebuffer(fb, nd), want)
        assert np.array_equal(deinterleave_framebuffer(torch.from_numpy(fb), nd).numpy(), want)

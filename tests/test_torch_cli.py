"""The port's CLI (monte_carlo_path_tracing_tpu_torch/cli.py) on the CPU:
render with checkpoints and resume, the regeneration render, the inverse
demo, its last-line JSON against the JAX package's CLI, the flags it
refuses, and the ``python -m`` entry."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from monte_carlo_path_tracing_tpu import cli as jax_cli
from monte_carlo_path_tracing_tpu_torch import cli
from monte_carlo_path_tracing_tpu_torch.render.renderer import render_image, render_image_regen
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils import checkpoint as ck
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(REPO, "scenes", "cornell", "cornell.obj")


def _run(capsys, argv):
    """(exit code, stdout lines, stderr) of cli.main(argv)."""
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err


def _scene(wh):
    import dataclasses

    sc = load_scene(SCENE, device="cpu")
    return dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=wh, height=wh))


def test_render_checkpoint_and_resume(capsys, tmp_path):
    """4 spp in checkpointed segments of 2, then resumed to 6: the resumed
    image is the uninterrupted 6 spp render (the checkpoint holds image x
    spp, whose rounding rtol 1e-5 allows)."""
    out, ckpt = str(tmp_path / "a.npy"), str(tmp_path / "ck.npz")
    common = ["render", SCENE, "--width", "16", "--height", "16", "--estimator", "mis",
              "--max-depth", "3", "--checkpoint", ckpt, "--checkpoint-every", "2", "--cpu"]
    rc, lines, err = _run(capsys, common + ["--spp", "4", "--out", out])
    assert rc == 0 and "spp 4/4 (checkpointed)" in err
    stats = json.loads(lines[-1])
    assert stats["spp"] == 4 and stats["mean_radiance"] > 0
    c = ck.load(ckpt)
    assert c.spp_done == 4 and c.framebuffer_sum.shape == (16, 16, 3)
    rc, lines, _ = _run(capsys, common + ["--spp", "6", "--resume", "--out", out])
    assert rc == 0 and any(line.startswith("resuming from") for line in lines)
    cfg = RenderConfig(width=16, height=16, spp=6, estimator="mis", max_depth=3)
    want = render_image(_scene(16), cfg).image
    np.testing.assert_allclose(np.load(out), want, rtol=1e-5, atol=1e-6)
    assert ck.load(ckpt).spp_done == 6


def test_render_resume_without_segments(capsys, tmp_path):
    """--resume with no --checkpoint-every continues the checkpoint's
    framebuffer in one render_image call."""
    out, ckpt = str(tmp_path / "b.npy"), str(tmp_path / "ck.npz")
    common = ["render", SCENE, "--width", "12", "--height", "12", "--max-depth", "3", "--cpu",
              "--checkpoint", ckpt]
    assert _run(capsys, common + ["--spp", "2", "--checkpoint-every", "2"])[0] == 0
    rc, lines, _ = _run(capsys, common + ["--spp", "3", "--resume", "--out", out])
    assert rc == 0 and "resuming" in lines[0]
    want = render_image(_scene(12), RenderConfig(width=12, height=12, spp=3, max_depth=3)).image
    np.testing.assert_allclose(np.load(out), want, rtol=1e-5, atol=1e-6)


def test_render_regen_npy(capsys, tmp_path):
    out = str(tmp_path / "r.npy")
    rc, lines, _ = _run(capsys, ["render", SCENE, "--width", "16", "--height", "16",
                                 "--spp", "2", "--max-depth", "8", "--regen", "--lanes", "256",
                                 "--out", out, "--cpu"])
    assert rc == 0 and lines[-2] == f"wrote {out}"
    img = np.load(out)
    want = render_image_regen(_scene(16), RenderConfig(width=16, height=16, spp=2, max_depth=8),
                              lanes=256).image
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, want, rtol=1e-6, atol=0)
    assert json.loads(lines[-1])["spp"] == 2


def test_render_under_a_world_size_1_launch(capsys, tmp_path, monkeypatch):
    """cli.main under torchrun's variables for one process, with --cpu:
    it joins a gloo group first (init_distributed_if_needed), and its image
    and JSON equal the run without the variables."""
    import socket

    import torch.distributed as dist

    argv = ["render", SCENE, "--width", "12", "--height", "12", "--spp", "2", "--max-depth",
            "4", "--regen", "--lanes", "128", "--cpu", "--out"]
    plain, launched = str(tmp_path / "plain.npy"), str(tmp_path / "launched.npy")
    rc, lines, _ = _run(capsys, argv + [plain])
    assert rc == 0 and not dist.is_initialized()
    want = json.loads(lines[-1])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                     LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    try:
        rc, lines, _ = _run(capsys, argv + [launched])
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    got = json.loads(lines[-1])
    assert rc == 0 and got["spp"] == want["spp"] and got["mean_radiance"] == want["mean_radiance"]
    assert np.array_equal(np.load(launched), np.load(plain))


def test_inverse_runs(capsys):
    rc, lines, err = _run(capsys, ["inverse", SCENE, "--width", "8", "--height", "8",
                                   "--max-depth", "2", "--steps", "3", "--rays-per-step", "32",
                                   "--cpu"])
    assert rc == 0 and "step 0 loss" in err
    out = json.loads(lines[-1])
    assert out["steps"] == 3 and all(np.isfinite(v) for v in out.values())


def test_last_line_keys_match_jax_cli(capsys):
    """The last JSON line of render and inverse has the JAX CLI's keys."""
    argv = [SCENE, "--width", "4", "--height", "4", "--max-depth", "2", "--cpu"]
    for cmd, extra in (("render", ["--spp", "1"]), ("inverse", ["--steps", "1",
                                                                "--rays-per-step", "8"])):
        assert jax_cli.main([cmd] + argv + extra) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rc, lines, _ = _run(capsys, [cmd] + argv + extra)
        assert rc == 0 and sorted(json.loads(lines[-1])) == sorted(want), cmd


def _outcome(main, capsys, argv):
    """What ``main(argv)`` does, as a shell would see it: ("rc", exit code,
    sorted keys of the last-line JSON) or ("raises", exception type)."""
    try:
        rc = main(argv)
    except Exception as e:  # noqa: BLE001  (the CLI lets errors propagate)
        capsys.readouterr()
        return ("raises", type(e).__name__)
    lines = capsys.readouterr().out.strip().splitlines()
    keys = sorted(json.loads(lines[-1])) if rc == 0 else None
    return ("rc", rc, keys)


#: The flags of the reference-parity options, once refused by the port as
#: "Compat and accel extras" and now run: each case's id is kept. The
#: TPU-only flags that name what the port runs on the CPU anyway run there
#: too (refused on the card: ``test_cpu_only_flags_are_refused_on_the_card``);
#: their ids keep the ROADMAP item that refuses them on the card.
RUN_WITH_CPU = (["--impl", "matmul"], ["--no-fused-arvo"])


@pytest.mark.parametrize("flags,item", [
    (["--estimator", "shoot"], "Compat and accel extras"),
    (["--accel", "grid"], "Compat and accel extras"),
    (["--ref-mis-weights"], "Compat and accel extras"),
    (["--ref-mis-full"], "Compat and accel extras"),
    (["--impl", "matmul"], "Do not port"),
    (["--impl", "pallas"], "Do not port"),
    (["--dot-mode", "vpu"], "Do not port"),
    (["--no-fused-arvo"], "Do not port"),
])
@pytest.mark.parametrize("cmd", ["render", "inverse"])
def test_refused_flags_name_their_roadmap_item(capsys, cmd, flags, item):
    """The TPU-only flags ("Do not port") exit non-zero naming their ROADMAP
    item, apart from ``RUN_WITH_CPU`` under ``--cpu``. The reference-parity
    flags and ``RUN_WITH_CPU`` run, and the port's outcome equals the JAX
    CLI's: exit code and last-line keys, or the same exception where the
    JAX CLI fails (inverse --ref-mis-full: the blocker queue is a regen
    feature; inverse --accel grid: no gradient through the grid's loop)."""
    if item == "Do not port" and flags not in RUN_WITH_CPU:
        rc, _, err = _run(capsys, [cmd, SCENE, "--cpu"] + flags)
        assert rc != 0 and "ROADMAP" in err and item in err, err
        return
    argv = [cmd, SCENE, "--width", "4", "--height", "4", "--max-depth", "2", "--cpu"] + flags
    argv += (["--spp", "1", "--lanes", "64"] if cmd == "render"
             else ["--steps", "1", "--rays-per-step", "8"])
    want = _outcome(jax_cli.main, capsys, argv)
    got = _outcome(cli.main, capsys, argv)
    assert got == want, (got, want)


@pytest.mark.parametrize("flags", RUN_WITH_CPU, ids=["impl-matmul", "no-fused-arvo"])
@pytest.mark.parametrize("cmd", ["render", "inverse"])
def test_cpu_only_flags_are_refused_on_the_card(capsys, monkeypatch, cmd, flags):
    """Without ``--cpu`` the plain intersection and the plain Arvo pick
    would replace K1 / K2 / K3 on the card's path: refused, naming the
    ROADMAP item, before any scene loads."""
    def no_load(args):
        raise AssertionError("the scene loaded before the refusal")

    monkeypatch.setattr(cli, "_load_scene", no_load)
    rc, _, err = _run(capsys, [cmd, SCENE] + flags)
    assert rc != 0 and "ROADMAP" in err and "Do not port" in err and "--cpu" in err, err


def test_fused_arvo_needs_the_card(capsys):
    rc, _, err = _run(capsys, ["render", SCENE, "--cpu", "--fused-arvo"])
    assert rc != 0 and "only on the card" in err


def test_python_m_entry(tmp_path):
    out = str(tmp_path / "m.png")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "monte_carlo_path_tracing_tpu_torch.cli", "render", SCENE,
         "--width", "8", "--height", "8", "--spp", "1", "--max-depth", "3", "--out", out,
         "--cpu"], capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(stats) == {"seconds", "spp", "mean_radiance"} and stats["spp"] == 1
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (the card's machine has no JAX)."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "monte_carlo_path_tracing_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax", "monte_carlo_path_tracing_tpu"), \
                    (path, name)

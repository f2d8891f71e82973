"""The port's two-scene inverse run (scripts/torch_inverse_twoscene.py)
against a JAX replica of scripts/tpu_inverse_twoscene.py's step, built here
from the JAX package's functions (the JAX script itself is never run: it
writes docs/inverse_twoscene.json).

At 8x8 views and 64 rays a scene, the first step's pixel ids are bit-equal
(the port's split / randint twins). The two packages render the same rays
on the same streams, so cornell's latent gradients agree to rtol 1e-4. On
veach-mis, 3-4 of the 64 rays differ by up to 4e-3 relative: the recorded
f32 fringe of the Arvo weights on its small lights (ROADMAP section 3,
"Arvo weights cancel in f32"; with the uniform-area sampler 0-1 rays
differ, by 6e-4). So the joint loss is held to rtol 1e-3 (measured
2.6e-4) and veach's gradients to 1e-2 of each field's largest (measured
1.2e-3 on ns, 2e-4 on the others), the bound the port's other Veach
parity tests use for that fringe."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.diff import grad as jgrad
from monte_carlo_path_tracing_tpu.integrator import render_rays as jax_render_rays
from monte_carlo_path_tracing_tpu.render.camera import generate_rays as jax_generate_rays
from monte_carlo_path_tracing_tpu.scene import load_scene as jax_load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = (("cornell", 8, 8), ("veach-mis", 8, 8))
RAYS = 64


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_inverse_twoscene", os.path.join(ROOT, "scripts", "torch_inverse_twoscene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_step0(sizes, rays):
    """tpu_inverse_twoscene.py's step 0 (its _setup, squash, joint_loss and
    target streams) on the JAX package: (loss, latent grads per scene,
    pixel ids per scene)."""
    clip = 5.0
    squash = lambda x: x / (1.0 + x / clip)  # noqa: E731
    setups = []
    for name, w, h in sizes:
        sc = jax_load_scene(os.path.join(ROOT, "scenes", name, f"{name}.obj"))
        sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=w, height=h))
        cfg = JaxConfig(spp=1, estimator="mis", max_depth=3, seed=0, use_pallas=False)
        m = sc.materials
        init = dataclasses.replace(
            m, kd=jnp.clip(m.kd + 0.15 * (m.kd.sum(-1, keepdims=True) > 0), 0.02, 0.95),
            ks=jnp.clip(m.ks - 0.3 * (m.ks > 0), 0.0, 0.95), ns=m.ns * 0.4,
            emission=m.emission * 0.5)
        setups.append((sc, init, cfg))
    lms = tuple(jgrad.to_latent(init) for _, init, _ in setups)
    k_pix, k_step = jax.random.split(jax.random.fold_in(jax.random.key(2), 0))
    idxs = tuple(jax.random.randint(jax.random.fold_in(k_pix, j), (rays,), 0,
                                    s.camera.width * s.camera.height, dtype=jnp.int32)
                 for j, (s, _, _) in enumerate(setups))
    targets = []
    for j, (sc, _, cfg) in enumerate(setups):
        ro, rd = jax_generate_rays(sc.camera, idxs[j])
        k_t = jax.random.fold_in(jax.random.fold_in(k_step, 77), j)
        targets.append(squash(jax_render_rays(sc, cfg, k_t, ro, rd)))

    def joint_loss(lms):
        total = 0.0
        for j, (sc, _, cfg) in enumerate(setups):
            s = sc.with_materials(jgrad.from_latent(lms[j]))
            ro, rd = jax_generate_rays(sc.camera, idxs[j])
            k1, k2 = jax.random.split(jax.random.fold_in(k_step, j))
            r1 = squash(jax_render_rays(s, cfg, k1, ro, rd))
            r2 = squash(jax_render_rays(s, cfg, k2, ro, rd))
            total = total + jnp.mean((r1 - targets[j]) * (r2 - targets[j]))
        return total

    loss, g = jax.value_and_grad(joint_loss)(lms)
    return float(loss), g, [np.asarray(i) for i in idxs]


@pytest.fixture(scope="module")
def jax_step0():
    return _jax_step0(TINY, RAYS)


def test_first_step_matches_jax_replica(script, jax_step0):
    """Pixel ids bit-equal; the joint loss and every latent gradient of
    both scenes (tolerances in the module docstring)."""
    jloss, jg, jidx = jax_step0
    setups = script.make_setups("cpu", TINY)
    lms = script.latents(setups)
    k_step, idxs = script.step_inputs(0, RAYS, setups)
    for a, b in zip(idxs, jidx):
        np.testing.assert_array_equal(a.numpy(), b)
    with torch.enable_grad():
        loss = script.joint_loss(setups, lms, k_step, idxs)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-3)
    for j, lm in enumerate(lms):
        for f, p in zip(dataclasses.fields(jg[j]), dgrad.latent_leaves(lm)):
            want = np.asarray(getattr(jg[j], f.name))
            assert p.grad is not None, (j, f.name)
            if TINY[j][0] == "cornell":
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, err_msg=f.name)
            else:
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                           atol=1e-2 * np.abs(want).max(), err_msg=f.name)


def test_run_reports_the_jax_artifacts_keys(script, jax_step0):
    """run() on tiny work: its first loss is the replica's, and its results
    carry the JAX artifact's keys with [initial, final] per family."""
    out = script.run(2, RAYS, 0.06, "cpu", sizes=TINY)
    np.testing.assert_allclose(out["losses"][0], jax_step0[0], rtol=1e-3)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert set(out["gates"]) == {"kd_cornell", "ns_log_veach", "ks_veach", "em_rel_cornell",
                                 "em_rel_veach", "pass_kd_0.06_and_nslog_0.2"}
    for name in ("cornell", "veach-mis"):
        assert set(out["scenes"][name]) == {"kd", "ks", "ns_log", "em_rel"}
        np.testing.assert_allclose(out["scenes"][name]["kd"][0], 0.15, rtol=1e-5)


def test_torch_twoscene_artifact_gates():
    """The committed card run (docs/torch_inverse_twoscene.json, 1,500 steps
    x 4,096 rays a scene) keeps JAX's gates (tests/test_diff.py:217): kd
    (cornell) <= 0.06 and ns_log (veach-mis) <= 0.2 from one optimisation,
    and every family improved on both scenes."""
    import json

    with open(os.path.join(ROOT, "docs", "torch_inverse_twoscene.json")) as f:
        d = json.load(f)
    assert (d["steps"], d["rays_per_scene_per_step"]) == (1500, 4096)
    assert "H100" in d["device"]["name"]
    g = d["gates"]
    assert g["pass_kd_0.06_and_nslog_0.2"] is True
    assert g["kd_cornell"] <= 0.06
    assert g["ns_log_veach"] <= 0.2
    for scene in ("cornell", "veach-mis"):
        for fam in ("kd", "ks", "ns_log"):
            init, final = d["scenes"][scene][fam]
            assert final < init, (scene, fam, init, final)

"""The benchmark's plain reference of an inverse-rendering step
(benchmark/reference/fixed_depth.py) against the port on the CPU.

- Its streams: ``split``, ``randint`` and a scalar key's row draws
  (``row_bits`` / ``row_uniform`` from any row offset) are bit-equal to
  the port's ``core/rng``.
- Its material table is the port's loader's, in the same order, so the
  program's latents index the same materials on both sides.
- One ``recover_materials`` step, as ``on_step`` hands it over, against
  the reference's recomputation from the same latents: cornell 24x16 at
  1,024 rays a stream (``recover_materials`` draws at most one pixel's
  worth, 384), depth 3, latents drawn from the seed around the true
  materials, three seeds, each within the ``inverse`` kind's limits
  (benchmark/configs/cornell-256-inverse.json), its update against the
  reference's Adam replayed over the step's gradients. The two sides trace
  the same rays on the same streams, so on cornell they agree to float
  rounding: radiance 1e-5, loss 1e-7 relative, and each family's gradient
  within 1e-3 (ns, whose gradient is the smallest, reads up to 3.5e-5 on
  these seeds and 3.5e-4 over fifteen). That bound also catches a port
  that drops the NEE denominator's detach (2.9e-3 or more on these seeds)
  or the BRDF continuation pdf's (0.12 or more); one that drops the
  detach of the BRDF pdf carried to the next vertex reads 1.2e-3, 1.0 and
  1.6e-4, caught on two of the three (its bias is small where few paths
  reach the light by a BRDF bounce).
- Veach MIS 16² with ``loss_clip`` 5, for the 320-light Arvo table's
  emission gradient, on five seeds, against the reference in float64,
  within the kind's limits. Veach is worse conditioned than cornell: its
  Phong exponents reach 10,000, which multiply the f32 rounding of a
  lobe's cosine by as much, and a 256-ray step rests on a few bright
  rays. So the float32 reference itself departs from the float64 one by
  up to 0.0096 in ``loss_gap`` (seed 2**31 + 5, where it alone takes
  another branch on one ray in 384: 0.0026 of the rays off) and 1.3e-3 in
  ``grad_gap``; the port reads 0 rays off, ``loss_gap`` at most 2.5e-4
  and ``grad_gap`` at most 1.3e-3 against the float64 reference.
"""

import dataclasses
import json
import os
import types

import pytest
import torch

from benchmark.checks import inverse as kind
from benchmark.reference import fixed_depth as fd
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff.inverse import recover_materials
from monte_carlo_path_tracing_tpu_torch.scene import load_scene
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
KEYS = (0, 7, 2**31 + 5, 2**33 + 9, 123_456_789_012)
#: The recover_materials job of a step test.
STEPS, LR = 2, 0.1


def _limits():
    with open(os.path.join(ROOT, "benchmark", "configs", "cornell-256-inverse.json")) as f:
        return json.load(f)["check"]["limits"]


def _path(name):
    return os.path.join(ROOT, "scenes", name, name + ".obj")


@pytest.mark.parametrize("seed", KEYS)
def test_split_and_randint_are_the_ports(seed):
    key = rng.base_key(seed)
    for num in (2, 3, 5):
        assert torch.equal(fd.split(key, num), rng.split(key, num))
    for n, lo, hi in ((384, 0, 384), (65_536, 0, 65_536), (100, 0, 921_600), (16, -5, 5),
                      (4, 7, 7)):
        assert torch.equal(fd.randint(key, n, lo, hi), rng.randint(key, (n,), lo, hi))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("n,k,row_offset", [(1, 1, 0), (300, 1, 0), (300, 2, 0), (64, 2, 1000),
                                            (33, 1, 65_536), (8, 2, 2**31 + 3)])
def test_row_draws_are_the_ports(seed, n, k, row_offset):
    key = rng.fold_in(rng.base_key(seed), 3)
    shape = (n,) if k == 1 else (n, k)
    bits = rng.random_bits(key, shape, row_offset).reshape(n, k)
    assert torch.equal(fd.row_bits(key, n, k, row_offset), bits)
    u = rng.uniform(key, shape, row_offset=row_offset).reshape(n, k)
    assert torch.equal(fd.row_uniform(key, n, k, row_offset), u)


@pytest.mark.parametrize("name", ["cornell", "veach-mis"])
def test_the_material_table_is_the_ports(name):
    sc = load_scene(_path(name), device="cpu")
    table, tri_mat = fd.material_table(_path(name))
    for f in fd.FAMILIES:
        assert torch.equal(table[f], getattr(sc.materials, f)), f
    assert torch.equal(tri_mat, sc.tri_mat_id.long())


def _one_step(name, w, h, n_rays, seed, loss_clip=None, spread=0.3):
    """(the port's step record, the reference's) of the last step of a
    recover_materials job of ``STEPS`` steps whose start latents are the true ones plus
    normal noise of ``spread`` drawn from the seed."""
    sc = load_scene(_path(name), device="cpu")
    sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=w, height=h))
    g = torch.Generator().manual_seed(seed % 2**63)
    lat = [x + spread * torch.randn(x.shape, generator=g)
           for x in dgrad.latent_leaves(dgrad.to_latent(sc.materials))]
    init = dgrad.from_latent(dgrad.LatentMaterials(*lat))
    cfg = RenderConfig(width=w, height=h, spp=1, estimator="mis",
                       light_sampler="spherical_triangle", rr_prob=0.6, max_depth=3, seed=seed)
    recs, history = [], []

    def on_step(i, latents, grads, loss, radiance):
        history.append([x.clone() for x in grads])
        recs.append({"index": i, "latents": [x.clone() for x in latents], "after": latents,
                     "grads": history[-1], "loss": loss, "radiance": radiance,
                     "grads_history": history})

    recover_materials(sc, init, cfg, steps=STEPS, lr=LR, rays_per_step=n_rays, seed=seed,
                      loss_clip=loss_clip, on_step=on_step)
    assert [r["index"] for r in recs] == list(range(STEPS))
    rec = dict(recs[-1], job_start=recs[0]["latents"])
    return rec, _reference(name, w, h, seed, rec, n_rays, loss_clip)


def _reference(name, w, h, seed, rec, n_rays, loss_clip, dtype=torch.float32):
    ref = fd.step(_path(name), w, h, seed, rec["index"], [x.to(dtype) for x in rec["latents"]],
                  n_rays, 3, 0.6, loss_clip, dtype=dtype)
    return {"radiance": (ref["target"], ref["r1"], ref["r2"]), "loss": ref["loss"],
            "grads": ref["grads"], "loss_abs_mean": ref["loss_abs_mean"]}


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**40 + 7])
def test_a_cornell_step_matches_the_reference(seed):
    rec, ref = _one_step("cornell", 24, 16, 1024, seed)
    assert rec["radiance"][0].shape == (384, 3)
    got = kind.compare(rec, ref)
    limits = _limits()
    assert got["radiance_off_share"] == 0.0
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-3, got
    job = types.SimpleNamespace(config={"lr": LR, "steps": STEPS})
    got["update_gap"] = kind.worst_gap(
        [a - b for a, b in zip(rec["after"], rec["latents"])],
        kind.stored_change(rec["latents"], kind.update_change(job, rec)))
    assert got["update_gap"] < 1e-5, got
    assert all(got[k] <= limits[k] for k in got), (got, limits)
    for a, b in zip(rec["radiance"], ref["radiance"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [11, 12, 13, 2**31 + 5, 2**33 + 1])
def test_a_veach_step_with_loss_clip_matches_the_reference(seed):
    rec, ref = _one_step("veach-mis", 16, 16, 256, seed, loss_clip=5.0)
    exact = _reference("veach-mis", 16, 16, seed, rec, 256, 5.0, torch.float64)
    got = kind.compare(rec, exact)
    limits = _limits()
    assert all(got[k] <= limits[k] for k in got), (got, limits)
    # the 320-light table's emission gradient is there on both sides
    assert float(ref["grads"][3].abs().sum()) > 0.0

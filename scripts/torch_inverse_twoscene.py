#!/usr/bin/env python
"""One optimisation recovering all four material families, on the port.

Counterpart of ``scripts/tpu_inverse_twoscene.py`` (whose artifact is
``docs/inverse_twoscene.json``), on ``monte_carlo_path_tracing_tpu_torch``:
a single Adam run over the concatenated latent materials of cornell (32^2)
AND veach-mis (48x27), MIS at depth 3, with the loss summed over the two
scenes every step: the two-stream product loss on radiance squashed as
x / (1 + x / 5), the perturbation of the JAX runs, and the learning rate
under ``inverse.cosine_decay`` (optax's cosine schedule, alpha 0.02). The
streams are the JAX script's, through the port's bit-equal ``rng.split``
and ``rng.randint``: step i folds i into key(2) and splits it into the
pixel key and the step key; scene j draws its pixels from fold(pixel key,
j), its target from fold(fold(step key, 77), j) and its two renders from
split(fold(step key, j)).

Gates (those of ``tests/test_diff.py::test_twoscene_artifact_gates``):
kd (cornell) <= 0.06 and ns_log (veach-mis) <= 0.2, in one run.

Run on the card, from the repository root:

    python scripts/torch_inverse_twoscene.py

It writes ``docs/torch_inverse_twoscene.json`` with the card's name and
power limit. Environment: INV2_STEPS (1500), INV2_RAYS (4096), INV2_LR
(0.06).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from monte_carlo_path_tracing_tpu_torch.core import rng  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.diff import inverse  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.scene import load_scene  # noqa: E402
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig  # noqa: E402

OUT = os.path.join(ROOT, "docs", "torch_inverse_twoscene.json")
CLIP = 5.0
#: (scene, width, height) of the two setups.
SIZES = (("cornell", 32, 32), ("veach-mis", 48, 27))
#: The run's key is key(SEED); the targets' streams fold TARGET_FOLD.
SEED, TARGET_FOLD = 2, 77


def squash(x):
    return x / (1.0 + x / CLIP)


def make_setups(device, sizes=SIZES):
    """[(name, scene with the true materials, perturbed materials, cfg)]."""
    setups = []
    for name, w, h in sizes:
        scene = load_scene(os.path.join(ROOT, "scenes", name, f"{name}.obj"), device=device)
        scene = dataclasses.replace(scene, camera=dataclasses.replace(scene.camera, width=w,
                                                                      height=h))
        m = scene.materials
        init = dataclasses.replace(
            m,
            kd=torch.clamp(m.kd + 0.15 * (m.kd.sum(-1, keepdim=True) > 0), 0.02, 0.95),
            ks=torch.clamp(m.ks - 0.3 * (m.ks > 0), 0.0, 0.95),
            ns=m.ns * 0.4,
            emission=m.emission * 0.5,
        )
        setups.append((name, scene, init, RenderConfig(spp=1, estimator="mis", max_depth=3,
                                                        seed=0)))
    return setups


def step_inputs(i: int, rays: int, setups):
    """(step key, pixel ids of each scene) of step ``i``."""
    device = setups[0][1].device
    k_pix, k_step = rng.split(rng.fold_in(rng.base_key(SEED, device=device), i))
    idxs = [rng.randint(rng.fold_in(k_pix, j), (rays,), 0,
                        scene.camera.width * scene.camera.height)
            for j, (_, scene, _, _) in enumerate(setups)]
    return k_step, idxs


def joint_loss(setups, lms, k_step, idxs) -> torch.Tensor:
    """The loss summed over the scenes: each scene's target from its true
    materials, and two renders of its latents, multiplied."""
    total = 0.0
    for j, (_, scene, _, cfg) in enumerate(setups):
        ro, rd = generate_rays(scene.camera, idxs[j])
        with torch.no_grad():
            target = squash(render_rays(scene, cfg, rng.fold_in(rng.fold_in(k_step, TARGET_FOLD),
                                                                 j), ro, rd))
        sc = scene.with_materials(dgrad.from_latent(lms[j]))
        k1, k2 = rng.split(rng.fold_in(k_step, j))
        r1 = squash(render_rays(sc, cfg, k1, ro, rd))
        r2 = squash(render_rays(sc, cfg, k2, ro, rd))
        total = total + torch.mean((r1 - target) * (r2 - target))
    return total


def latents(setups):
    """The perturbed materials of each scene as latents that require grad."""
    return [dgrad.LatentMaterials(*(x.detach().clone().requires_grad_(True)
                                    for x in dgrad.latent_leaves(dgrad.to_latent(init))))
            for _, _, init, _ in setups]


def _errors(m, init, r) -> dict:
    """[initial, final] error of each family, on the materials that show it."""
    m, init, r = ({f: getattr(x, f).detach().cpu().numpy() for f in inverse.FAMILIES}
                  for x in (m, init, r))
    spec = m["ks"].sum(1) > 0
    lit = m["emission"].sum(1) > 0
    vis = (m["kd"].sum(1) > 0) & ~lit
    em = m["emission"].sum(1)

    def mae(f, x, k):
        return float(np.abs(x[f] - m[f])[k].mean())

    def ns_log(x):
        return float(np.abs(np.log(x["ns"] / m["ns"]))[spec].mean())

    return {
        "kd": [mae("kd", init, vis), mae("kd", r, vis)],
        "ks": [mae("ks", init, spec), mae("ks", r, spec)],
        "ns_log": [ns_log(init), ns_log(r)],
        "em_rel": [0.5, float((np.abs(r["emission"].sum(1) - em)[lit] / em[lit]).mean())],
    }


def run(steps: int, rays: int, lr: float, device, sizes=SIZES) -> dict:
    """The optimisation on ``device``; returns the results (the JAX
    artifact's keys, and its seconds)."""
    setups = make_setups(device, sizes)
    lms = latents(setups)
    params = [p for lm in lms for p in dgrad.latent_leaves(lm)]
    opt = torch.optim.Adam(params, lr=lr, betas=inverse.ADAM_BETAS, eps=inverse.ADAM_EPS)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        k_step, idxs = step_inputs(i, rays, setups)
        with torch.enable_grad():
            loss = joint_loss(setups, lms, k_step, idxs)
            opt.zero_grad()
            loss.backward()
        # A latent the loss does not reach takes a zero gradient: Adam steps
        # every parameter each step, as optax does.
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in opt.param_groups:
            group["lr"] = inverse.cosine_decay(lr, steps, i)
        opt.step()
        losses.append(float(loss.detach()))
        if i % 100 == 0:
            print(f"step {i}: joint loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    seconds = time.perf_counter() - t0

    results = {}
    for (name, scene, init, _), lm in zip(setups, lms):
        results[name] = _errors(scene.materials, init, dgrad.from_latent(lm))
        print(name, json.dumps(results[name]), flush=True)
    kd_c = results["cornell"]["kd"][1]
    ns_v = results["veach-mis"]["ns_log"][1]
    return {
        "method": "ONE Adam run over the concatenated latents of both scenes, loss summed "
                  "per step (two-stream product loss, clip 5, cosine lr, the JAX runs' "
                  "perturbation and streams), on the PyTorch/CUDA port "
                  "(scripts/torch_inverse_twoscene.py).",
        "steps": steps, "rays_per_scene_per_step": rays, "lr": lr,
        "seconds": seconds, "ms_per_step": 1e3 * seconds / max(steps, 1),
        "scenes": results,
        "losses_every100": [round(x, 5) for x in losses[::100]],
        "losses": losses,
        "gates": {
            "kd_cornell": kd_c,
            "ns_log_veach": ns_v,
            "ks_veach": results["veach-mis"]["ks"][1],
            "em_rel_cornell": results["cornell"]["em_rel"][1],
            "em_rel_veach": results["veach-mis"]["em_rel"][1],
            "pass_kd_0.06_and_nslog_0.2": bool(kd_c <= 0.06 and ns_v <= 0.2),
        },
    }


def main():
    steps = int(os.environ.get("INV2_STEPS", "1500"))
    rays = int(os.environ.get("INV2_RAYS", "4096"))
    lr = float(os.environ.get("INV2_LR", "0.06"))
    if not torch.cuda.is_available():
        raise SystemExit("torch_inverse_twoscene: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = run(steps, rays, lr, "cuda")
    out["device"] = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(out["gates"]))
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()

"""The ``inverse`` kind: the window's last whole optimisation step against
the plain reference's recomputation of it (``reference/fixed_depth.py``).

It reads ``Measured.extra`` as ``launchers/inverse.py`` fills it: the
checked step's index, the program's latents before and after that step's
update, their gradients as Adam took them, its loss and its three radiance
tensors (the target and the two streams, [N, 3] each), the latents at the
start of its job and the gradients of each of the job's steps. After the
window the reference renders the same step, from the program's own
latents, on the same streams and pixels, and takes its loss and gradients
by autograd, in float32 with TF32 off. Compared:

- ``radiance_off_share``: the share of the step's 3 x N rays whose
  radiance is off by more than the ``image`` kind's per-pixel rule
  (``check.compare``: the L1 gap over R, G, B against the reference's L1
  plus a thousandth of its mean, above 1e-2), or not finite;
- ``loss_gap``: |the program's loss - the reference's| over the mean of
  |(r1 - t)(r2 - t)| (after the squash), since the two-stream loss can be
  near 0;
- ``grad_gap``: ||g - g_ref||_2 of the latents' gradients for each
  family over the larger of ||g_ref||_2 and ``GRAD_FLOOR`` times the norm
  of the reference's whole gradient, the worst of the four (a frozen
  family's are 0 on both sides, and read 0): the emission's gradient is
  orders of magnitude larger than the others', and would hide their
  errors in one norm over all four; the floor keeps a family whose
  gradient cancels to almost nothing at the checked step (ns, late in a
  job: its one glossy material's terms) from reading its float32 rounding
  as an error;
- ``update_gap``: the checked step's change of the latents against the
  reference's, ||d - d_ref||_2 / ||d_ref||_2 for each family, the worst
  of the four, where d_ref is the change that a plain Adam under the
  configuration's cosine decay (``fixed_depth.adam_replay``, float64)
  makes at that step, replayed from the job's start over the program's
  own gradients, as the program's float32 latents hold it (the step from
  its latents before the update, rounded to float32: a family whose
  change is small against its latents would otherwise read that rounding
  alone): a skipped update, or a family the optimiser leaves out, reads 1;
- ``material_error_ratio``: the mean absolute kd error against the scene
  file's materials (the CLI's ``kd_mae``) at the checked step's latents
  over that at its job's start: the job's progress over its steps.

Each has its limit in the configuration's file (``check.limits``), set
from the readings in PERF.md. A guard holds besides: the program's loss
and every gradient are finite.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import check
from benchmark.reference import fixed_depth as fd

#: ``grad_gap`` judges a family's gradient error against at least this
#: share of the reference's whole gradient (its norm over the four
#: families).
GRAD_FLOOR = 1e-3


def reference(cell, seed: int, index: int, latents, device: str = "cuda",
              dtype=torch.float32) -> dict:
    """The reference's step ``index`` of the cell at ``latents``, as a
    record of the launcher's fields (radiance, loss, grads), computed in
    ``dtype``; the frozen families' gradients zeroed."""
    c = cell.config
    n = min(int(cell.mix["rays_per_step"]), c["width"] * c["height"])
    r = fd.step(os.path.join(cell.root, c["scene"]), c["width"], c["height"], seed, index,
                latents, n, c["max_depth"], c["rr_prob"], c["loss_clip"], device, dtype)
    grads = [g if f in c["optimize"] else torch.zeros_like(g)
             for f, g in zip(fd.FAMILIES, r["grads"])]
    return {"radiance": (r["target"], r["r1"], r["r2"]), "loss": r["loss"], "grads": grads,
            "loss_abs_mean": r["loss_abs_mean"], "rays": r["rays"]}


def compare(prog: dict, ref: dict) -> dict:
    """``radiance_off_share``, ``loss_gap`` and ``grad_gap`` of a step
    record against the reference's."""
    host = lambda ts: torch.cat([t.detach().double().cpu() for t in ts]).numpy()  # noqa: E731
    off = check.compare(host(prog["radiance"]), host(ref["radiance"]), 1.0, 1.0)
    scale = float(ref["loss_abs_mean"])
    with np.errstate(invalid="ignore", divide="ignore"):
        loss_gap = abs(float(prog["loss"]) - float(ref["loss"])) / scale if scale > 0 else np.inf
    return {"radiance_off_share": off["pixels_off_share"], "loss_gap": float(loss_gap),
            "grad_gap": max(family_grad_gaps(prog["grads"], ref["grads"]))}


def family_grad_gaps(grads, ref_grads) -> list:
    """Each family's ||g - g_ref||_2 over the larger of ||g_ref||_2 and
    ``GRAD_FLOOR`` times the reference's whole gradient's norm (0 where
    both are 0, infinite where only the reference's is, or not finite)."""
    d = [g.detach().double().cpu() for g in grads]
    r = [g.detach().double().cpu() for g in ref_grads]
    floor = GRAD_FLOOR * float(torch.sqrt(sum((x * x).sum() for x in r)))
    gaps = []
    for x, y in zip(d, r):
        num, den = float((x - y).norm()), max(float(y.norm()), floor)
        gap = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
        gaps.append(gap if gap == gap else float("inf"))
    return gaps


def update_change(cell, rec, dtype=torch.float64, grads=None) -> list:
    """The reference's change of the latents at the checked step, by
    ``fixed_depth.adam_replay`` in ``dtype`` over the job's gradients up to
    it (``grads``, where given, in the checked step's place)."""
    hist = list(rec["grads_history"][: rec["index"] + 1])
    if len(hist) != rec["index"] + 1:
        raise RuntimeError("the record lacks gradients of its job's earlier steps")
    if grads is not None:
        hist[-1] = grads
    before, after = fd.adam_replay(rec["job_start"], hist, cell.config["lr"],
                                   max(int(cell.config["steps"]), 1), dtype)
    return [a - b for a, b in zip(after, before)]


def stored_change(before, change) -> list:
    """``change`` as latents of ``before``'s dtype hold it: from ``before``
    to ``before + change`` rounded to that dtype, in float64."""
    return [(b.double() + c.double()).to(b.dtype).double() - b.double()
            for b, c in zip(before, change)]


def worst_gap(values, ref_values) -> float:
    """The worst family's ||value - ref_value||_2 / ||ref_value||_2 (0
    where both are 0, infinite where only the reference's is)."""
    worst = 0.0
    for d, r in zip(values, ref_values):
        d, r = d.detach().double().cpu(), r.detach().double().cpu()
        num, den = float((d - r).norm()), float(r.norm())
        gap = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def kd_mae(cell, latents, device) -> float:
    """The mean absolute kd error of ``latents`` against the scene file's."""
    true, _ = fd.material_table(os.path.join(cell.root, cell.config["scene"]), device)
    return float(torch.mean(torch.abs(torch.sigmoid(latents[0].to(device)) - true["kd"])))


def judge(cell, measured, seed: int, device: str = "cuda", dtype=None):
    """(compared numbers, checks, diagnostics) of the window's last whole
    step; ``dtype`` below float32 puts the reference computed in it in the
    program's place (the control): its radiance, loss and gradients, and
    the update replayed in it over the program's earlier gradients and its
    own."""
    rec = measured.extra.get("step")
    if rec is None:
        raise RuntimeError("the window holds no whole optimisation step")
    ref = reference(cell, seed, rec["index"], rec["latents"], device)
    prog = rec
    change = [a - b for a, b in zip(rec["after"], rec["latents"])]
    if dtype is not None and dtype != torch.float32:
        prog = reference(cell, seed, rec["index"], rec["latents"], device, dtype)
        change = update_change(cell, rec, dtype, prog["grads"])
    numbers = compare(prog, ref)
    numbers["update_gap"] = worst_gap(
        change, stored_change(rec["latents"], update_change(cell, rec)))
    start, last = kd_mae(cell, rec["job_start"], device), kd_mae(cell, rec["latents"], device)
    numbers["material_error_ratio"] = last / start if start > 0 else float("inf")
    limits = cell.config["check"]["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    finite = bool(torch.isfinite(rec["loss"]).all()) and all(
        bool(torch.isfinite(g).all()) for g in rec["grads"])
    checks["loss_or_grads_not_finite"] = {"value": 0 if finite else 1, "limit": 0}
    n = ref["radiance"][0].shape[0]
    diag = {"step_checked": rec["index"], "rays_checked": 3 * n, "loss": float(rec["loss"]),
            "reference_loss": float(ref["loss"]), "kd_mae_start": start, "kd_mae_checked": last,
            "reference_rays": ref["rays"],
            "grad_gap_by_family": family_grad_gaps(prog["grads"], ref["grads"]),
            "grad_norm_by_family": [float(g.detach().double().norm()) for g in ref["grads"]]}
    return numbers, checks, diag


def control(cell, seed: int, n: int, device: str = "cuda") -> dict:
    """The largest numbers of the bfloat16 reference against the float32
    one over steps 0 .. n - 1, at the CLI's start latents, without the
    program: step i's update replayed over each side's gradients of steps
    0 .. i, in bfloat16 and in float64."""
    c = cell.config
    true, _ = fd.material_table(os.path.join(cell.root, c["scene"]), device)
    latents = fd.start_latents(true, c["perturb"], c["optimize"])
    worst: dict = {}
    hist: dict = {"ref": [], "low": []}
    for i in range(n):
        ref = reference(cell, seed, i, latents, device)
        low = reference(cell, seed, i, latents, device, torch.bfloat16)
        hist["ref"].append(ref["grads"])
        hist["low"].append(low["grads"])
        rec = {"index": i, "job_start": latents}
        numbers = compare(low, ref)
        numbers["update_gap"] = worst_gap(
            update_change(cell, dict(rec, grads_history=hist["low"]), torch.bfloat16),
            update_change(cell, dict(rec, grads_history=hist["ref"])))
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return worst

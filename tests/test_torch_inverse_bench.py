"""The benchmark's inverse-rendering cell on the CPU: its launcher
(benchmark/launchers/inverse.py) and check kind (benchmark/checks/
inverse.py) through ``run.measure``, on the cell cut to 16² and 256 rays a
step.

The window is timed by a stand-in clock that advances one second a read,
so that a window of ``seconds`` holds ``seconds - 1`` steps whatever the
machine's speed. A sound run of 40 steps is ``correct``. Each of these
comes out not correct:

- a program whose Adam update is skipped (its latents never move, so the
  step's change against the replayed Adam's and the kd error's ratio both
  read 1);
- a program whose update moves kd alone (ks, ns and emission frozen): the
  step's own numbers pass, and the change of the three left out reads 1
  against the replayed Adam's (kd, moving alone, drifts off too);
- a program whose Adam runs at twice the learning rate: every other
  number passes, and its change reads 1 against the replayed Adam's;
- a program whose target is rendered from the latents, not the true
  materials (the target's rays are off);
- the bfloat16 reference in the program's place (the control).
"""

import copy
import json
import time

import pytest
import torch

from benchmark import harness, run
from benchmark.launchers import inverse as launcher
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff import inverse

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

CELL = "cornell-256-inverse-fullframe"
SEED = 2**40 + 3


class _Clock:
    """``time`` for the launcher: perf_counter advances one second a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _cell():
    cell = copy.deepcopy(harness.resolve(CELL))
    cell.config.update(width=16, height=16)
    cell.mix.update(rays_per_step=256, trace_skip=1, trace_launches=1)
    return cell


def _measure(monkeypatch, steps):
    monkeypatch.setattr(launcher, "time", _Clock())
    line, checks, diag = run.measure(_cell(), SEED, steps + 1.0, False, device="cpu",
                                     t_start=time.perf_counter())
    out = json.loads(line)
    assert out["attempted"] == diag["launches"] == steps
    assert diag["step_checked"] == steps - 1 and diag["rays_checked"] == 3 * 256
    return out, checks


def test_a_sound_run_is_correct(monkeypatch):
    out, checks = _measure(monkeypatch, 40)
    assert out["correct"] is True, checks
    assert set(checks) == {"radiance_off_share", "loss_gap", "grad_gap", "update_gap",
                           "material_error_ratio", "loss_or_grads_not_finite"}
    assert checks["radiance_off_share"]["value"] == 0.0
    assert checks["update_gap"]["value"] < 1e-4, checks
    assert out["metrics"]["paths_per_s"]["value"] == pytest.approx(40 * 3 * 256 / 41)


def test_a_skipped_update_is_not_correct(monkeypatch):
    make = inverse.make_optimizer

    def skipped(lm, lr):
        opt = make(lm, lr)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(inverse, "make_optimizer", skipped)
    out, checks = _measure(monkeypatch, 5)
    assert out["correct"] is False
    assert checks["update_gap"]["value"] == 1.0
    assert checks["material_error_ratio"]["value"] == 1.0
    assert checks["radiance_off_share"]["value"] == 0.0


def test_an_update_that_leaves_out_ks_ns_and_emission_is_not_correct(monkeypatch):
    make = inverse.make_optimizer

    def kd_alone(lm, lr):
        opt = make(lm, lr)
        step, frozen = opt.step, dgrad.latent_leaves(lm)[1:]

        def kd_step(*a, **k):
            held = [x.detach().clone() for x in frozen]
            step(*a, **k)
            with torch.no_grad():
                for x, h in zip(frozen, held):
                    x.copy_(h)

        opt.step = kd_step
        return opt

    monkeypatch.setattr(inverse, "make_optimizer", kd_alone)
    out, checks = _measure(monkeypatch, 40)
    assert out["correct"] is False
    assert checks["update_gap"]["value"] == 1.0
    for k in ("radiance_off_share", "loss_gap", "grad_gap", "loss_or_grads_not_finite"):
        assert checks[k]["value"] <= checks[k]["limit"], checks


def test_an_update_at_twice_the_learning_rate_is_not_correct(monkeypatch):
    decay = inverse.cosine_decay
    monkeypatch.setattr(inverse, "cosine_decay", lambda *a, **k: 2.0 * decay(*a, **k))
    out, checks = _measure(monkeypatch, 40)
    assert out["correct"] is False
    assert checks["update_gap"]["value"] == pytest.approx(1.0, rel=1e-3)
    assert all(c["value"] <= c["limit"] for k, c in checks.items() if k != "update_gap"), checks


def test_a_target_rendered_from_the_latents_is_not_correct(monkeypatch):
    make, target = inverse.make_optimizer, inverse.target_radiance
    held = {}

    def capture(lm, lr):
        held["lm"] = lm
        return make(lm, lr)

    def from_latents(scene_true, cfg, k_step, ro, rd):
        lm = dgrad.LatentMaterials(*(x.detach() for x in dgrad.latent_leaves(held["lm"])))
        return target(scene_true.with_materials(dgrad.from_latent(lm)), cfg, k_step, ro, rd)

    monkeypatch.setattr(inverse, "make_optimizer", capture)
    monkeypatch.setattr(inverse, "target_radiance", from_latents)
    out, checks = _measure(monkeypatch, 5)
    assert out["correct"] is False
    assert checks["radiance_off_share"]["value"] > checks["radiance_off_share"]["limit"]


def test_the_bfloat16_reference_in_the_programs_place_is_not_correct(monkeypatch):
    monkeypatch.setattr(launcher, "time", _Clock())
    cell = _cell()
    m = run.window_run(cell, SEED, 4.0, False, device="cpu", t_start=time.perf_counter())
    kind = harness.check_module("inverse")
    _, sound, _ = kind.judge(cell, m, SEED, "cpu")
    _, low, _ = kind.judge(cell, m, SEED, "cpu", torch.bfloat16)
    assert all(c["value"] <= c["limit"] for k, c in sound.items()
               if k != "material_error_ratio"), sound
    assert low["radiance_off_share"]["value"] > 10 * low["radiance_off_share"]["limit"], low
    numbers = kind.control(cell, SEED, 1, "cpu")
    assert numbers["radiance_off_share"] > low["radiance_off_share"]["limit"], numbers


def test_a_family_whose_gradient_cancels_is_judged_against_the_floor():
    """grad_gap's floor: a family whose reference gradient cancels to a
    millionth of the whole reads its error against GRAD_FLOOR of the
    whole; a family of ordinary size, or an error as large as the floor,
    still reads as before."""
    kind = harness.check_module("inverse")
    ref = [torch.tensor([8e-4, 1e-4]), torch.tensor([1.5e-4]), torch.tensor([0.0, -2.9e-8]),
           torch.tensor([9e-4])]
    whole = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref)))
    rounding = [ref[0], ref[1], torch.tensor([0.0, -2.6e-8]), ref[3]]
    gaps = kind.family_grad_gaps(rounding, ref)
    assert gaps[2] == pytest.approx(3e-9 / (kind.GRAD_FLOOR * whole), rel=1e-3)
    assert gaps[2] < 0.01 and gaps[0] == gaps[1] == gaps[3] == 0.0
    dropped = [ref[0] * 1.1, ref[1], torch.tensor([0.0, -2.9e-8 + 3 * kind.GRAD_FLOOR * whole]),
               ref[3]]
    gaps = kind.family_grad_gaps(dropped, ref)
    assert gaps[0] == pytest.approx(0.1, rel=1e-4) and gaps[2] == pytest.approx(3.0, rel=1e-4)
    rad = (torch.ones(4, 3),)
    assert kind.compare({"radiance": rad, "loss": torch.tensor(1.0), "grads": dropped},
                        {"radiance": rad, "loss": torch.tensor(1.0), "grads": ref,
                         "loss_abs_mean": 1.0})["grad_gap"] == pytest.approx(3.0, rel=1e-4)

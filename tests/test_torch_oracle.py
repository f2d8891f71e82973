"""The port's wavefront estimators against the independent NumPy/f64
recursive oracle (``monte_carlo_path_tracing_tpu/oracle/scalar.py``): JAX
tests/test_oracle.py on the port's ``render_rays`` on the CPU.

The oracle re-derives the reference's recursive estimators from scratch
(different language, arithmetic and control flow), so agreement of MEANS
with it is evidence about the estimators that does not go through the JAX
package. Streams are not shared; the agreement is statistical: the probe
patch's mean within the JAX tests' own Monte Carlo tolerances (6% MIS,
8% split, 10% BRDF-only) at their probe pixels and sample counts. The
fifth case of tests/test_oracle.py, the blocker queue against the
reference's exact recursion, is
tests/test_torch_blocker.py::test_blocker_queue_matches_reference_oracle.
"""

import numpy as np
import torch

from monte_carlo_path_tracing_tpu.oracle import ScalarOracle
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)
from test_torch_wavefront import _pair

# JAX's probe patch: 8 pixels of the 16x16 cornell view (wall, box faces,
# floor; no directly visible light).
_PIXELS = (17, 60, 100, 120, 137, 200, 230, 150)


def _patch(cornell_scene):
    """(the JAX scene for the oracle, the port's scene, ro, rd) of the patch."""
    js, ts = _pair(cornell_scene, 16)
    ro, rd = generate_rays(ts.camera, torch.tensor(_PIXELS))
    return js, ts, ro, rd


def _wavefront_mean(scene, cfg, ro, rd, spp, reps=100):
    """Mean radiance per pixel over ``spp`` samples, each pass replicating
    every pixel ``reps`` times."""
    n = ro.shape[0]
    roN, rdN = ro.repeat_interleave(reps, 0), rd.repeat_interleave(reps, 0)
    key = rng.base_key(cfg.seed)
    acc = np.zeros((n, 3))
    for s in range(spp // reps):
        lane = rng.lane_keys(rng.sample_key(key, s), torch.arange(n * reps))
        acc += render_rays(scene, cfg, lane, roN, rdN).numpy().reshape(n, reps, 3).sum(axis=1)
    return acc / (spp // reps * reps)


def _assert_patch_close(a, b, tol, what):
    ma, mb = a.mean(), b.mean()
    assert abs(ma - mb) / max(ma, mb) < tol, (what, ma, mb)


def test_mis_default_matches_oracle(cornell_scene):
    """The default MIS (the NEE restructure, mixture pdf, balance weights)
    against the oracle running the same restructure."""
    js, ts, ro, rd = _patch(cornell_scene)
    oracle = ScalarOracle(js, estimator="mis", blocker_recursion=False,
                          ref_mis_weights=False, branch_pdf=False)
    img_o = oracle.trace(np.random.default_rng(0), ro.numpy(), rd.numpy(), 600)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=32, seed=0)
    _assert_patch_close(img_o, _wavefront_mean(ts, cfg, ro, rd, 600), 0.06, "mis default")


def test_mis_ref_weights_and_branch_pdf_match_oracle(cornell_scene):
    """ref_mis_weights and branch_pdf_compat reproduce the reference's
    weighting as the oracle implements it (blocker recursion off)."""
    js, ts, ro, rd = _patch(cornell_scene)
    oracle = ScalarOracle(js, estimator="mis", blocker_recursion=False,
                          ref_mis_weights=True, branch_pdf=True)
    img_o = oracle.trace(np.random.default_rng(1), ro.numpy(), rd.numpy(), 600)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=32, seed=1, ref_mis_weights=True,
                       branch_pdf_compat=True)
    _assert_patch_close(img_o, _wavefront_mean(ts, cfg, ro, rd, 600), 0.06, "mis ref-weights")


def test_split_matches_oracle_both_measures(cornell_scene):
    """The split estimator in both Q3 modes: the measure-correct default and
    the reference's area-form / solid-angle-pdf mix (measure_bug_compat),
    whose heavier tail takes JAX's wider 8%."""
    js, ts, ro, rd = _patch(cornell_scene)
    for bug in (False, True):
        oracle = ScalarOracle(js, estimator="split", branch_pdf=False, measure_bug=bug)
        img_o = oracle.trace(np.random.default_rng(20 + bug), ro.numpy(), rd.numpy(), 800)
        cfg = RenderConfig(spp=1, estimator="split", max_depth=32, seed=2,
                           measure_bug_compat=bug)
        _assert_patch_close(img_o, _wavefront_mean(ts, cfg, ro, rd, 800), 0.08,
                            f"split bug={bug}")


def test_brdf_matches_oracle(cornell_scene):
    js, ts, ro, rd = _patch(cornell_scene)
    oracle = ScalarOracle(js, estimator="brdf", branch_pdf=False)
    img_o = oracle.trace(np.random.default_rng(3), ro.numpy(), rd.numpy(), 800)
    cfg = RenderConfig(spp=1, estimator="brdf", max_depth=32, seed=3)
    _assert_patch_close(img_o, _wavefront_mean(ts, cfg, ro, rd, 800), 0.10, "brdf")

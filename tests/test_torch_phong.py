"""Phong BRDF sampling and evaluation of the port (sampling/phong.py)
against the JAX package on the same streams. Directions and pdfs agree to
f32 round-off (pow is exp(n log x): ulp differences are scaled by n)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu.sampling import phong as jph
from monte_carlo_path_tracing_tpu_torch.core import rng as trng
from monte_carlo_path_tracing_tpu_torch.sampling import phong as tph

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)


def _inputs(n=1000, seed=0):
    g = np.random.default_rng(seed)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    nrm = unit(g.normal(size=(n, 3)))
    wo = unit(nrm + 0.8 * g.normal(size=(n, 3)))
    kd = g.uniform(0, 0.8, (n, 3)).astype(np.float32)
    ks = g.uniform(0, 0.8, (n, 3)).astype(np.float32)
    ks[::5] = 0.0
    ns = g.choice([1.0, 10.0, 100.0, 1000.0], n).astype(np.float32)
    return nrm, wo, kd, ks, ns


@pytest.mark.parametrize("compat", [False, True])
def test_sample_brdf_matches_jax(compat):
    arrs = _inputs()
    ids = np.arange(1000, dtype=np.int32)
    jk = jrng.fold_in(jrng.base_key(2), jnp.asarray(ids))
    tk = trng.fold_in(trng.base_key(2), torch.from_numpy(ids))
    a = jph.sample_brdf(jk, *map(jnp.asarray, arrs), branch_pdf_compat=compat)
    b = tph.sample_brdf(tk, *map(torch.from_numpy, arrs), branch_pdf_compat=compat)
    np.testing.assert_array_equal(np.asarray(a.is_specular), b.is_specular.numpy())
    np.testing.assert_allclose(np.asarray(a.wi), b.wi.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.pdf), b.pdf.numpy(), rtol=2e-3, atol=1e-6)


def test_eval_and_pdf_match_jax():
    nrm, wo, kd, ks, ns = _inputs(seed=1)
    wi = _inputs(seed=2)[1]
    J = [jnp.asarray(x) for x in (nrm, wi, wo, kd, ks, ns)]
    T = [torch.from_numpy(x) for x in (nrm, wi, wo, kd, ks, ns)]
    np.testing.assert_allclose(np.asarray(jph.eval_brdf(*J)), tph.eval_brdf(*T).numpy(),
                               rtol=2e-3, atol=1e-6)
    fj, pj = jph.eval_and_pdf_brdf(*J)
    ft, pt = tph.eval_and_pdf_brdf(*T)
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jph.pdf_brdf(*J)), tph.pdf_brdf(*T).numpy(),
                               rtol=2e-3, atol=1e-6)
    pd_j, _ = jph.lobe_probs(J[3], J[4])
    pd_t, _ = tph.lobe_probs(T[3], T[4])
    np.testing.assert_allclose(np.asarray(pd_j), pd_t.numpy(), rtol=1e-6)

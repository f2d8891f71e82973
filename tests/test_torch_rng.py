"""The port's threefry streams (monte_carlo_path_tracing_tpu_torch/core/rng.py)
against jax's: key words and f32 uniforms must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.core import rng as jrng
from monte_carlo_path_tracing_tpu_torch.core import rng as trng

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**31 - 1, size=n).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 11, 123456789, 2**31 - 1])
def test_base_key_words(seed):
    np.testing.assert_array_equal(_words(jrng.base_key(seed)), trng.base_key(seed).numpy())


@pytest.mark.parametrize("case", ["scalar_scalar", "scalar_batched", "batched_scalar",
                                  "batched_batched"])
def test_fold_in_bit_equal(case):
    d = _ids(64, 1)
    e = _ids(64, 2)
    jk, tk = jrng.base_key(7), trng.base_key(7)
    if case.startswith("batched"):
        jk, tk = jrng.fold_in(jk, jnp.asarray(e)), trng.fold_in(tk, torch.from_numpy(e))
    if case.endswith("scalar"):
        jd, td = 5, 5
    else:
        jd, td = jnp.asarray(d), torch.from_numpy(d)
    np.testing.assert_array_equal(_words(jrng.fold_in(jk, jd)), trng.fold_in(tk, td).numpy())


def test_lane_stream_fold_chain():
    """fold(fold(fold(fold(base, spp0 + sample // n_pix), pixel), depth),
    purpose) as the regen loop builds it (regen.py:761-771, :871)."""
    n_pix, spp0 = 24 * 24, 3
    sample = np.arange(0, 2000, 7, dtype=np.int32)
    pixel = sample % n_pix
    depth = (sample % 5).astype(np.int32)
    jk = jrng.fold_in(jrng.base_key(11), spp0 + jnp.asarray(sample) // n_pix)
    jk = jrng.fold_in(jrng.fold_in(jk, jnp.asarray(pixel)), jnp.asarray(depth))
    tk = trng.fold_in(trng.base_key(11), spp0 + torch.from_numpy(sample).long() // n_pix)
    tk = trng.fold_in(trng.fold_in(tk, torch.from_numpy(pixel)), torch.from_numpy(depth))
    for purpose in (jrng.P_BSDF, jrng.P_LIGHT_SELECT, jrng.P_RR):
        np.testing.assert_array_equal(
            _words(jrng.fold_in(jk, purpose)), trng.fold_in(tk, purpose).numpy())
    np.testing.assert_array_equal(
        _words(jrng.bounce_key(jk, 2, jrng.P_PIXEL_JITTER)),
        trng.bounce_key(tk, 2, trng.P_PIXEL_JITTER).numpy())


@pytest.mark.parametrize("shape,lo,hi,batched", [
    ((7, 5), 0.0, 1.0, False),
    ((1000,), 0.0, 1.0, True),
    ((1000, 2), 0.0, 1.0, True),
    ((1000, 2), -0.5, 0.5, True),
    ((3,), 0.25, 0.75, False),
])
def test_uniform_bit_equal(shape, lo, hi, batched):
    jk, tk = jrng.base_key(3), trng.base_key(3)
    if batched:
        ids = _ids(shape[0], 4)
        jk, tk = jrng.fold_in(jk, jnp.asarray(ids)), trng.fold_in(tk, torch.from_numpy(ids))
    a = np.asarray(jrng.uniform(jk, shape, lo, hi))
    b = trng.uniform(tk, shape, lo, hi).numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("shared", [False, True])
def test_pick_weighted(shared):
    """Same uniforms, same inverse-CDF rule: picks agree except where u *
    total lies within rounding of a CDF boundary (cumsum order differs
    between XLA and torch) — counted, and bounded at 0.5%."""
    n, L = 2000, 40
    gen = np.random.default_rng(5)
    w = gen.random((L,) if shared else (n, L)).astype(np.float32)
    w[w < 0.3] = 0.0
    ids = _ids(n, 6)
    jk = jrng.fold_in(jrng.base_key(9), jnp.asarray(ids))
    tk = trng.fold_in(trng.base_key(9), torch.from_numpy(ids))
    a = np.asarray(jrng.pick_weighted(jk, jnp.asarray(w), n))
    b = trng.pick_weighted(tk, torch.from_numpy(w), n).numpy()
    n_diff = int((a != b).sum())
    assert n_diff <= n // 200, n_diff
    picked = (w if shared else w[np.arange(n)])[..., :]
    pw = picked[b] if shared else picked[np.arange(n), b]
    assert (pw > 0).all()            # zero-weight entries are never picked

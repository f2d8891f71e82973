"""K6, the port's threefry kernel (ops/rng_cuda.py, csrc/rng.cu), on the
CPU: everything its wrapper does in Python before a launch (broadcasting,
flattening, splitting the counts) runs here, and the kernel's plain twin
(``rng_cuda.fold_twin`` / ``bits_twin``) computes the words from the same
normalised arguments, indexing as the kernel does. Held bit for bit
against ``core/rng.py``'s plain version and against ``jax.random``, on
every call shape of the port: a scalar key against [N] data, [N] keys
against a scalar, [N] keys against [N] data, [R, 1] keys against [1, C]
data (the prepass), [N] keys drawing k counts each, and a scalar key
drawing (N, k) from a row offset (past 2**32 too). The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase "rng")."""

import jax
import jax.extend.random as jex_random
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.ops import _build, rng_cuda

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

M32 = 0xFFFFFFFF


def _twin(launch):
    if isinstance(launch, rng_cuda.FoldLaunch):
        return rng_cuda.fold_twin(launch)
    return rng_cuda.bits_twin(launch)


@pytest.fixture
def k6_twin(monkeypatch):
    """core/rng routes CPU keys as it routes CUDA keys, through K6's
    wrapper, and the launch goes to the plain twin."""
    monkeypatch.setattr(rng, "_on_card", lambda key, name: True)
    monkeypatch.setattr(rng_cuda, "threefry", _twin)


def _key_words(n, seed):
    """[n, 2] uint32 key words from a numpy seed, the first rows at the
    edges: (0, 0), (2**32 - 1, 2**32 - 1), (0, 2**32 - 1)."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 2), dtype=np.uint64)
    w[:3] = [[0, 0], [M32, M32], [0, M32]][:n]
    return w.astype(np.uint32)


def _data(n, seed):
    """[n] uint32 data from a numpy seed, with 0 and 2**32 - 1 first."""
    d = np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint64)
    d[:2] = [0, M32][:n]
    return d.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jkeys(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32), impl="threefry2x32")


def _jfold(key_words, data):
    """jax.random.fold_in over the broadcast of key words [..., 2] and
    uint32 data: int64 words [..., 2]."""
    shape = np.broadcast_shapes(key_words.shape[:-1], np.shape(data))
    kw = np.broadcast_to(key_words, shape + (2,)).reshape(-1, 2)
    d = np.broadcast_to(np.asarray(data, np.uint32), shape).reshape(-1)
    out = jax.vmap(jax.random.fold_in)(_jkeys(kw), jnp.asarray(d))
    return np.asarray(jax.random.key_data(out)).astype(np.int64).reshape(shape + (2,))


# The fold call shapes: (key words, data), as numpy arrays; data None: the
# Python int 2**32 - 1 (a purpose tag's shape with the largest word).
N, R, C, K = 257, 3, 40, 2


def _fold_case(name):
    if name == "scalar_key_x_N_data":                 # rng.split, regen.lane_keys
        return _key_words(1, 1)[0], _data(N, 2)
    if name == "N_keys_x_scalar":                     # every purpose fold
        return _key_words(N, 3), None
    if name == "N_keys_x_N_data":                     # lane_keys' pixel fold
        return _key_words(N, 4), _data(N, 5)
    if name == "R1_keys_x_1C_data":                   # the prepass (regen.py)
        return _key_words(R, 6)[:, None, :], _data(C, 7)[None, :]
    raise AssertionError(name)


FOLDS = ["scalar_key_x_N_data", "N_keys_x_scalar", "N_keys_x_N_data", "R1_keys_x_1C_data"]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", FOLDS)
def test_fold_launch_twin_plain_and_jax(case, dtype):
    kw, d = _fold_case(case)
    key = _t(kw)
    if d is None:
        data, jd = M32, np.uint32(M32)
    else:
        # int32 data carries 2**32 - 1 as -1: fold_in takes it mod 2**32.
        data, jd = _t(d).to(dtype), d
    launch = rng_cuda.fold_launch(key, data)
    assert launch.key.data_ptr() == key.data_ptr()      # views: nothing materialised
    if torch.is_tensor(data):
        assert launch.data.data_ptr() == data.data_ptr() and launch.data.dtype == dtype
    words = rng_cuda.fold_twin(launch)
    assert words.dtype == torch.int64 and words.shape == launch.shape + (2,)
    assert torch.equal(words, rng.fold_in_plain(key, data))
    np.testing.assert_array_equal(words.numpy(), _jfold(kw, jd))


def test_fold_launch_broadcasts_by_strides():
    """[R, 1] keys against [1, C] data: stride 0 where an operand is
    broadcast, sizes padded in front to the kernel's four dimensions."""
    kw, d = _fold_case("R1_keys_x_1C_data")
    launch = rng_cuda.fold_launch(_t(kw), _t(d))
    size, ks, ds, kword = launch.args[0:4], launch.args[4:8], launch.args[8:12], launch.args[12]
    assert launch.shape == (R, C) and size == (1, 1, R, C)
    assert ks[3] == 0 and ks[2] == 2 and kword == 1
    assert ds[2] == 0 and ds[3] == 1
    assert launch.total == R * C


@pytest.mark.parametrize("case", FOLDS)
def test_fold_in_through_k6s_wrapper(k6_twin, case):
    """core/rng.fold_in, routed through K6's wrapper (its twin), is the
    plain version's fold."""
    kw, d = _fold_case(case)
    key = _t(kw)
    data = M32 if d is None else _t(d)
    assert torch.equal(rng.fold_in(key, data), rng.fold_in_plain(key, data))


def _jbits(key_words, shape):
    return np.asarray(jax.random.bits(_jkeys(key_words), shape, jnp.uint32)).astype(np.int64)


@pytest.mark.parametrize("draw", ["bits", "uniform", "uniform_range"])
def test_n_keys_draw_k_counts(k6_twin, draw):
    """[N] keys drawing k counts each (phong.sample_brdf's (N, 2),
    light_spherical's (N, 2)): twin = plain = jax.vmap of jax.random."""
    kw = _key_words(N, 8)
    key = _t(kw)
    jk = _jkeys(kw)
    if draw == "bits":
        got = rng.random_bits(key, (K,))
        want = rng.random_bits_plain(key, (K,))
        jw = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (K,), jnp.uint32))(jk))
        jw = jw.astype(np.int64)
    else:
        lo, hi = (0.0, 1.0) if draw == "uniform" else (-0.5, 0.5)
        got = rng.uniform(key, (N, K), lo, hi)
        want = rng.uniform_plain(key, (N, K), lo, hi)
        jw = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (K,), jnp.float32, lo, hi))(jk))
        got, want, jw = got.view(torch.int32), want.view(torch.int32), jw.view(np.int32)
    assert got.shape == (N, K)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jw)


@pytest.mark.parametrize("row_offset", [0, 37, 1 << 31, (1 << 40) + 3])
def test_scalar_key_draws_rows_from_an_offset(k6_twin, row_offset):
    """A scalar key drawing (N, k) from ``row_offset`` (render_rays_sharded):
    counts from row_offset * k; at 2**31 rows and beyond they pass 2**32
    and carry into the high word. Twin = plain = jax's threefry on those
    counts, and = rows of jax.random.bits's global draw where it fits."""
    kw = _key_words(2, 9)[1]                 # (2**32 - 1, 2**32 - 1)
    key = _t(kw)
    launch = rng_cuda.bits_launch(key, (N, K), row_offset)
    assert launch.start == row_offset * K and launch.n == N * K
    bits = rng.random_bits(key, (N, K), row_offset=row_offset)
    assert torch.equal(bits, rng.random_bits_plain(key, (N, K), row_offset=row_offset))
    count = np.arange(N * K, dtype=np.uint64) + np.uint64(row_offset * K)
    hi, lo = (count >> np.uint64(32)).astype(np.uint32), (count & np.uint64(M32)).astype(np.uint32)
    y = np.asarray(jex_random.threefry_2x32((jnp.uint32(kw[0]), jnp.uint32(kw[1])),
                                            jnp.concatenate([jnp.asarray(hi), jnp.asarray(lo)])))
    want = (y[:N * K] ^ y[N * K:]).astype(np.int64).reshape(N, K)
    np.testing.assert_array_equal(bits.numpy(), want)
    if row_offset < 64:
        whole = _jbits(kw, (row_offset + N, K))
        np.testing.assert_array_equal(bits.numpy(), whole[row_offset:])
    for lo_hi in ((0.0, 1.0), (-0.5, 0.5)):
        u = rng.uniform(key, (N, K), *lo_hi, row_offset=row_offset)
        assert torch.equal(u.view(torch.int32),
                           rng.uniform_plain(key, (N, K), *lo_hi,
                                             row_offset=row_offset).view(torch.int32))


@pytest.mark.parametrize("lo_hi", [(0.0, 1.0), (-0.5, 0.5), (0.25, 0.75)])
def test_scalar_key_uniform_matches_jax(k6_twin, lo_hi):
    kw = _key_words(1, 10)[0]
    u = rng.uniform(_t(kw), (N, K), *lo_hi)
    ju = np.asarray(jax.random.uniform(_jkeys(kw), (N, K), jnp.float32, *lo_hi))
    np.testing.assert_array_equal(u.numpy().view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_through_k6s_wrapper(k6_twin, num):
    kw = _key_words(2, 11)[1]
    got = rng.split(_t(kw), num)
    want = np.asarray(jax.random.key_data(jax.random.split(_jkeys(kw), num))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("span", [(0, 100), (0, 1 << 20), (-7, 9)])
def test_randint_through_k6s_wrapper(k6_twin, span):
    kw = _key_words(3, 12)[2]
    got = rng.randint(_t(kw), (N,), *span)
    want = np.asarray(jax.random.randint(_jkeys(kw), (N,), *span, dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bad_arguments_raise():
    key = rng.base_key(1)
    with pytest.raises(TypeError, match="int64"):
        rng_cuda.fold_launch(key.to(torch.int32), 3)
    with pytest.raises(TypeError, match="integer"):
        rng_cuda.fold_launch(key, torch.zeros(3))
    with pytest.raises(ValueError, match="dimensions"):
        rng_cuda.fold_launch(torch.zeros((1, 1, 1, 1, 1, 2), dtype=torch.int64),
                              torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="batched key"):
        rng_cuda.bits_launch(rng.split(key, 4), (3, 2), uniform=(0.0, 1.0))
    with pytest.raises(ValueError, match="not CUDA"):
        rng_cuda.threefry(rng_cuda.fold_launch(key, 3))


def test_cpu_draws_never_load_the_library(monkeypatch):
    """CPU keys take the plain version: nothing builds or loads the CUDA
    library, not even through split or randint."""
    def no_build():
        raise AssertionError("CPU draws reached _build.load")

    monkeypatch.setattr(_build, "load", no_build)
    n0 = rng_cuda.threefry.launches
    key = rng.base_key(3)
    keys = rng.lane_keys(key, torch.arange(16))
    rng.bounce_key(keys, torch.arange(16) % 3, rng.P_RR)
    rng.random_bits(key, (8, 2), row_offset=1 << 31)
    rng.uniform(keys, (16, 2), -0.5, 0.5)
    rng.split(key, 3)
    rng.randint(key, (5,), 0, 10)
    rng.pick_weighted(keys, torch.ones(4), 16)
    assert rng_cuda.threefry.launches == n0


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    """The threefry rounds live in csrc/threefry.cuh, which K6 (rng.cu) and
    the fused vertex (vertex.cu) include: a change to the header changes
    the build's key, so the library is rebuilt, as for a change to a
    source."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    key = _build.build_key()
    header = tmp_path / "threefry.cuh"
    assert b"threefry2x32" in header.read_bytes()
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.build_key() != key

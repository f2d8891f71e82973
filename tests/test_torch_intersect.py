"""The port's intersection (ops/intersect.py, ops/intersect_cuda.py) against
the JAX package: accel build, and the plain versions of K1/K2 against the
Pallas kernels in interpret mode and against intersect_matmul. K1/K2
against their plain versions on a card: tests/test_torch_cuda.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_path_tracing_tpu.ops import intersect as jops
from monte_carlo_path_tracing_tpu.ops import intersect_pallas as jip
from monte_carlo_path_tracing_tpu.ops import intersect_ref as jir
from monte_carlo_path_tracing_tpu.scene import load_scene as jax_load_scene
from monte_carlo_path_tracing_tpu_torch.ops import intersect as tops
from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda as tic
from monte_carlo_path_tracing_tpu_torch.ops import intersect_ref as tir
from monte_carlo_path_tracing_tpu_torch.scene import load_scene

from test_torch_scene import torch_single_thread  # noqa: F401  (autouse)

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _case(T, N, seed=0):
    """Random triangles and rays (numpy, seeded), with every 7th ray
    excluding one triangle id."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-2, 2, (T, 3)).astype(np.float32)
    e1 = g.normal(size=(T, 3)).astype(np.float32)
    e2 = g.normal(size=(T, 3)).astype(np.float32)
    ro = g.uniform(-4, 4, (N, 3)).astype(np.float32)
    rd = g.normal(size=(N, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    excl = np.where(np.arange(N) % 7 == 0, np.arange(N) % T, -1).astype(np.int32)
    tmax = g.uniform(0.5, 6.0, N).astype(np.float32)
    return v0, e1, e2, ro, rd, excl, tmax


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", ["cornell", "veach-mis"])
def test_build_accel_order_and_padding(name):
    """Same Morton order (stable sort) and padding as JAX; W to f32
    round-off (XLA contracts the cross products into FMAs)."""
    path = os.path.join(SCENES, name, f"{name}.obj")
    a = jops.build_accel(jax_load_scene(path))
    b = tops.build_accel(load_scene(path, device="cpu"))
    np.testing.assert_array_equal(np.asarray(a.tri_ids), b.tri_ids.numpy())
    np.testing.assert_allclose(np.asarray(a.W), b.W.numpy(), rtol=1e-5, atol=1e-5)
    n = load_scene(path, device="cpu").num_tris
    assert b.W.shape[0] % tops.TRI_BLOCK == 0 and (b.tri_ids[n:] == -2).all()
    assert b.num_tris == n


def test_nearest_plain_matches_pallas_interpret():
    """nearest_hit_plain vs the JAX Pallas kernel (interpret mode, exact
    f32 'vpu' dots): ids equal, t/u/v to f32 round-off."""
    v0, e1, e2, ro, rd, excl, _ = _case(700, 513)
    ids = np.arange(700, dtype=np.int32)
    W = jir.pack_tri_matrix(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    hj = jip.intersect_pallas(jnp.asarray(ro), jnp.asarray(rd), W, jnp.asarray(ids),
                              exclude_id=jnp.asarray(excl))
    tv0, te1, te2, tro, trd, texcl, tids = _torch(v0, e1, e2, ro, rd, excl, ids)
    g = tir.ray_features(tro, trd)
    ht = tic.nearest_hit_plain(g, tir.pack_tri_matrix(tv0, te1, te2), tids, texcl)
    np.testing.assert_array_equal(np.asarray(hj.tri_id), ht.tri_id.numpy())
    np.testing.assert_array_equal(np.asarray(hj.valid), ht.valid.numpy())
    m = ht.valid.numpy()
    assert 0.2 < m.mean() < 0.98
    for a, b in ((hj.t, ht.t), (hj.u, ht.u), (hj.v, ht.v)):
        np.testing.assert_allclose(np.asarray(a)[m], b.numpy()[m], rtol=1e-4, atol=1e-5)


def test_nearest_plain_matches_intersect_matmul():
    """Against the JAX jnp reference (strict accept rules): the margin
    form differs only on exact-boundary ties — none in a random case."""
    v0, e1, e2, ro, rd, excl, _ = _case(300, 400, seed=1)
    ids = np.arange(300, dtype=np.int32)
    W = jir.pack_tri_matrix(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    hj = jir.intersect_matmul(jnp.asarray(ro), jnp.asarray(rd), W, jnp.asarray(ids),
                              exclude_id=jnp.asarray(excl))
    tv0, te1, te2, tro, trd, texcl, tids = _torch(v0, e1, e2, ro, rd, excl, ids)
    Wt = tir.pack_tri_matrix(tv0, te1, te2)
    ht = tic.nearest_hit_plain(tir.ray_features(tro, trd), Wt, tids, texcl)
    hm = tir.intersect_matmul(tro, trd, Wt, tids, texcl)
    for h in (ht, hm):
        np.testing.assert_array_equal(np.asarray(hj.tri_id), h.tri_id.numpy())
        m = h.valid.numpy()
        np.testing.assert_allclose(np.asarray(hj.t)[m], h.t.numpy()[m], rtol=1e-4, atol=1e-5)


def test_occluded_plain_matches_pallas_interpret():
    v0, e1, e2, ro, rd, excl, tmax = _case(300, 257, seed=2)
    ids = np.arange(300, dtype=np.int32)
    W = jir.pack_tri_matrix(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    scaled = jnp.asarray(tmax) * (1.0 - jops.OCCLUSION_MARGIN)
    bj = np.asarray(jip.occluded_pallas(jnp.asarray(ro), jnp.asarray(rd), W,
                                        jnp.asarray(ids), jnp.asarray(excl), scaled))
    tv0, te1, te2, tro, trd, texcl, tids, ttmax = _torch(v0, e1, e2, ro, rd, excl, ids, tmax)
    accel = tops.TriAccel(W=tir.pack_tri_matrix(tv0, te1, te2), tri_ids=tids)
    bt = tops.occluded(accel, tro, trd, ttmax, texcl).numpy()
    np.testing.assert_array_equal(bj, bt)
    assert 0.05 < bt.mean() < 0.95


def test_occlusion_semantics():
    """Blocker plane at z=1: segment ends before it, past it, and exactly on
    it (kept out by OCCLUSION_MARGIN)."""
    W = tir.pack_tri_matrix(torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([[4.0, 0.0, 0.0]]),
                            torch.tensor([[0.0, 4.0, 0.0]]))
    accel = tops.TriAccel(W=W, tri_ids=torch.tensor([0], dtype=torch.int32))
    ro = torch.tensor([[0.5, 0.5, 0.0]] * 3)
    rd = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    out = tops.occluded(accel, ro, rd, torch.tensor([0.5, 2.0, 1.0])).tolist()
    assert out == [False, True, False]
    h = tops.intersect(accel, ro[:1], rd[:1])
    assert bool(h.valid[0]) and int(h.tri_id[0]) == 0
    torch.testing.assert_close(h.t, torch.tensor([1.0]))
    h = tops.intersect(accel, ro[:1], rd[:1], torch.tensor([0], dtype=torch.int32))
    assert not bool(h.valid[0]) and int(h.tri_id[0]) == -1     # quirk Q8 exclusion


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions: no kernel
    launch is counted."""
    v0, e1, e2, ro, rd, excl, tmax = _case(64, 32, seed=3)
    tv0, te1, te2, tro, trd, texcl, ttmax = _torch(v0, e1, e2, ro, rd, excl, tmax)
    accel = tops.TriAccel(W=tir.pack_tri_matrix(tv0, te1, te2),
                          tri_ids=torch.arange(64, dtype=torch.int32))
    n1, n2 = tic.nearest_hit.launches, tic.occluded.launches
    tops.intersect(accel, tro, trd, texcl)
    tops.occluded(accel, tro, trd, ttmax, texcl)
    assert (tic.nearest_hit.launches, tic.occluded.launches) == (n1, n2)

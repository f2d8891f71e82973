"""The port's inverse rendering (diff/inverse.py, diff/grad.py's latent
step) and its stream twins (core/rng.py split / randint) against the JAX
package and optax on the CPU, and the JAX package's inverse-rendering tests
(tests/test_diff.py) run on the port.

Tolerances: split and randint are integer work and bit-equal; optax computes
the cosine schedule and Adam in f32 with another association of the same
formula, so those agree to rtol 1e-6. Both packages' recover_materials
render the same rays on the same streams, so their losses and latents agree
to f32 round-off carried through three Adam steps (rtol 1e-4 on the losses,
atol 1e-5 on the latents; measured 5e-6 and 4e-7 on kd)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monte_carlo_path_tracing_tpu.diff.inverse import recover_materials as jax_recover
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig as JaxConfig
from monte_carlo_path_tracing_tpu_torch.core import rng
from monte_carlo_path_tracing_tpu_torch.diff import grad as dgrad
from monte_carlo_path_tracing_tpu_torch.diff import inverse
from monte_carlo_path_tracing_tpu_torch.integrator import render_rays
from monte_carlo_path_tracing_tpu_torch.render.camera import generate_rays
from monte_carlo_path_tracing_tpu_torch.scene import Materials, scene_from_arrays
from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

from test_torch_scene import scene_arrays, torch_single_thread  # noqa: F401  (autouse)

SEEDS = (0, 1, 3, 2**31 + 5, 123_456_789)


def _scene(jax_scene, wh):
    return scene_from_arrays(scene_arrays(jax_scene), wh, wh, device="cpu")


def _materials(m) -> Materials:
    return Materials(**{f: torch.from_numpy(np.array(getattr(m, f))) for f in inverse.FAMILIES})


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    for num in (2, 3, 7):
        want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), num)))
        np.testing.assert_array_equal(rng.split(rng.base_key(seed), num).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,shape", [
    (0, 64, (64,)), (0, 65_536, (100,)), (0, 65_537, (33,)), (0, 921_600, (4096,)),
    (-5, 5, (3, 4)), (0, 1, (5,)), (7, 7, (4,)), (0, 2**31 - 1, (20,)),
    (-2**31, 2**31 - 1, (16,)),
])
def test_randint_matches_jax(seed, lo, hi, shape):
    """Bit-equal draws, n_pix ranges (64 = 8^2, 921,600 = 1280x720) among
    them, an empty range (jax returns minval) and the full int32 span."""
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi, dtype=jnp.int32))
    got = rng.randint(rng.base_key(seed), shape, lo, hi)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lr,steps", [(0.1, 100), (0.06, 30), (0.05, 1)])
def test_cosine_schedule_matches_optax(lr, steps):
    sched = optax.cosine_decay_schedule(lr, max(steps, 1), inverse.COSINE_ALPHA)
    for i in range(steps + 3):
        np.testing.assert_allclose(inverse.cosine_decay(lr, max(steps, 1), i),
                                   float(sched(i)), rtol=1e-6, err_msg=str(i))


def test_adam_steps_match_optax():
    """Five Adam steps on fixed gradients under the cosine schedule: the
    port's torch.optim.Adam against optax.adam. optax forms the bias
    corrections 1 - b**t in f32, where 1 - 0.999**t cancels to ~3e-5
    relative error (torch forms them in f64), so each update may differ by
    ~1.5e-5 of its size: atol 5e-6 on these O(1) latents after five
    steps of lr <= 0.06 (measured 1.8e-6)."""
    g = np.random.default_rng(0)
    shapes = {"kd_l": (5, 3), "ks_l": (5, 3), "ns_l": (5,), "emission_l": (5, 3)}
    x0 = {k: g.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (g.normal(size=s) * 10.0 ** g.integers(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lr, steps = 0.06, 30

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, 0.02))
    jx = {k: jnp.asarray(v) for k, v in x0.items()}
    state = opt.init(jx)
    for gr in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jx)
        jx = optax.apply_updates(jx, upd)

    lm = dgrad.LatentMaterials(**{k: torch.from_numpy(v.copy()).requires_grad_(True)
                                  for k, v in x0.items()})
    topt = inverse.make_optimizer(lm, lr)
    for i, gr in enumerate(grads):
        for p, k in zip(dgrad.latent_leaves(lm), shapes):
            p.grad = torch.from_numpy(gr[k])
        for group in topt.param_groups:
            group["lr"] = inverse.cosine_decay(lr, steps, i)
        topt.step()
    for p, k in zip(dgrad.latent_leaves(lm), shapes):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jx[k]), rtol=1e-6, atol=5e-6,
                                   err_msg=k)


def test_make_latent_step_takes_one_adam_step(cornell_scene):
    """make_latent_step: the loss and gradient of latent_loss_and_grad,
    then one optimiser step on the latents in place."""
    ts = _scene(cornell_scene, 8)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=3, seed=0)
    idx = torch.arange(64)
    ro, rd = generate_rays(ts.camera, idx)
    key = rng.lane_keys(rng.base_key(5), idx)
    with torch.no_grad():
        target = render_rays(ts, cfg, rng.lane_keys(rng.base_key(6), idx), ro, rd)
    lm = dgrad.to_latent(ts.materials)
    lm = dgrad.LatentMaterials(*(x.clone().requires_grad_(True) for x in dgrad.latent_leaves(lm)))
    before = [x.detach().clone() for x in dgrad.latent_leaves(lm)]
    loss0, g = dgrad.latent_loss_and_grad(lm, ts, cfg, key, ro, rd, target)
    step = dgrad.make_latent_step(ts, cfg, torch.optim.SGD(dgrad.latent_leaves(lm), lr=0.5))
    loss = step(lm, key, ro, rd, target)
    assert float(loss) == float(loss0) > 0.0
    for x0, x1, gi in zip(before, dgrad.latent_leaves(lm), dgrad.latent_leaves(g)):
        torch.testing.assert_close(x1.detach(), x0 - 0.5 * gi, rtol=0, atol=0)


def test_recover_materials_matches_jax(cornell_scene):
    """Three steps on cornell 8^2 (MIS, depth 3, 64 rays a step, seed 3)
    from the same perturbed materials. (The JAX resume test's BRDF, depth 2
    configuration gives zero losses and gradients at this size.)"""
    js = dataclasses.replace(cornell_scene, camera=dataclasses.replace(
        cornell_scene.camera, width=8, height=8))
    init = dataclasses.replace(js.materials, kd=jnp.clip(js.materials.kd + 0.2, 0.02, 0.95))
    kw = dict(spp=1, estimator="mis", max_depth=3, seed=0)
    a = jax_recover(js, init, JaxConfig(**kw), steps=3, lr=0.1, rays_per_step=64, seed=3)
    b = inverse.recover_materials(_scene(cornell_scene, 8), _materials(init), RenderConfig(**kw),
                                  steps=3, lr=0.1, rays_per_step=64, seed=3)
    assert b.steps == 3 and len(b.losses) == 3 and min(b.losses) > 0.0
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-4)
    want = dgrad.to_latent(_materials(a.materials))
    for f, x, y in zip(inverse.FAMILIES, dgrad.latent_leaves(dgrad.to_latent(b.materials)),
                       dgrad.latent_leaves(want)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-5, err_msg=f)


def test_inverse_rendering_recovers_kd(cornell_scene):
    """tests/test_diff.py's kd recovery on the port: perturb every Kd, then
    100 steps; the error on the visible materials falls below 0.4 of its
    start (measured 0.22)."""
    ts = _scene(cornell_scene, 16)
    cfg = RenderConfig(spp=1, estimator="mis", light_sampler="spherical_triangle",
                       max_depth=3, seed=0)
    true_kd = ts.materials.kd.numpy()
    init = dataclasses.replace(ts.materials, kd=torch.clamp(
        ts.materials.kd + torch.tensor([[0.25, -0.2, 0.15]]), 0.02, 0.95))
    res = inverse.recover_materials(ts, init, cfg, steps=100, lr=0.1, rays_per_step=256, seed=2,
                                    optimize=("kd",))
    vis = ~np.isin(np.arange(true_kd.shape[0]),
                   np.unique(ts.tri_mat_id.numpy()[ts.is_light.numpy()]))
    err0 = np.abs(dgrad.from_latent(dgrad.to_latent(init)).kd.numpy() - true_kd)[vis].mean()
    err1 = np.abs(res.materials.kd.numpy() - true_kd)[vis].mean()
    assert err1 < 0.4 * err0, (err0, err1)
    for f in ("ks", "ns", "emission"):           # frozen families stay put
        torch.testing.assert_close(getattr(res.materials, f),
                                   getattr(dgrad.from_latent(dgrad.to_latent(init)), f))


def test_inverse_checkpoint_resume(cornell_scene, tmp_path):
    """A 6-step run killed after step 3 and resumed from its checkpoint
    reproduces the uninterrupted run bit for bit (tests/test_diff.py's
    pattern, with MIS so that the gradients are not zero, and the run
    stopped by an exception rather than by steps=3, which would change the
    cosine schedule of the first steps)."""
    ts = _scene(cornell_scene, 8)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=3, seed=0)
    init = dataclasses.replace(ts.materials, kd=torch.clamp(ts.materials.kd + 0.2, 0.02, 0.95))
    ck = str(tmp_path / "inv.npz")
    kw = dict(steps=6, lr=0.1, rays_per_step=64, seed=3)
    full = inverse.recover_materials(ts, init, cfg, **kw)

    class Killed(Exception):
        pass

    def kill_at_3(i, loss):
        if i == 3:
            raise Killed

    with pytest.raises(Killed):
        inverse.recover_materials(ts, init, cfg, checkpoint_path=ck, checkpoint_every=1,
                                  progress=kill_at_3, **kw)
    resumed = inverse.recover_materials(ts, init, cfg, checkpoint_path=ck, checkpoint_every=1,
                                        **kw)
    assert len(resumed.losses) == 6 and resumed.losses == full.losses
    for f in inverse.FAMILIES:
        torch.testing.assert_close(getattr(resumed.materials, f), getattr(full.materials, f),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("estimator", ["brdf", "split", "mis"])
def test_grad_matches_finite_difference_expectation(cornell_scene, estimator):
    """tests/test_diff.py's expectation check on the port: over 16 streams
    (one key each, as JAX's test draws them), the mean analytic gradient of
    the rendered sum equals the mean central difference for kd, ks and ns,
    within 12% + 4 standard errors."""
    ts = _scene(cornell_scene, 16)
    cfg = RenderConfig(spp=1, estimator=estimator, light_sampler="spherical_triangle",
                       max_depth=3, seed=0)
    idx = torch.arange(256)
    ro, rd = generate_rays(ts.camera, idx)
    keys = [rng.base_key(100 + i) for i in range(16)]
    mats = ts.materials

    def rsum(m, key):
        with torch.no_grad():
            return float(render_rays(ts.with_materials(m), cfg, key, ro, rd).double().sum())

    grads = [dgrad.pixel_grad(ts, cfg, k, ro, rd, torch.ones(256, 3)) for k in keys]
    for field, coord, eps in [("kd", (0, 0), 1e-2), ("ks", (6, 2), 1e-2), ("ns", (6,), 2.0)]:
        base = getattr(mats, field)
        up, dn = base.clone(), base.clone()
        up[coord] += eps
        dn[coord] -= eps
        m_up = dataclasses.replace(mats, **{field: up})
        m_dn = dataclasses.replace(mats, **{field: dn})
        fds = [(rsum(m_up, k) - rsum(m_dn, k)) / (2 * eps) for k in keys]
        fd = float(np.mean(fds))
        an = float(np.mean([float(getattr(g, field)[coord]) for g in grads]))
        sem = float(np.std(fds) / np.sqrt(len(keys)))
        tol = 0.12 * max(abs(fd), abs(an)) + 4.0 * sem + 2e-2
        assert abs(fd - an) <= tol, (estimator, field, fd, an, sem)


@pytest.mark.slow
def test_inverse_rendering_joint_four_families(cornell_scene, veach_scene):
    """tests/test_diff.py's joint recovery on the port, with its budgets
    and gates: kd + ks + ns + emission optimised together (nothing
    frozen); kd / ks / emission must recover on cornell, ks / ns /
    emission on veach-mis."""

    def joint(jax_scene, wh, steps, rays, lr, clip, seed):
        scene = scene_from_arrays(scene_arrays(jax_scene), wh[0], wh[1], device="cpu")
        cfg = RenderConfig(spp=1, estimator="mis", max_depth=3, seed=0)
        m = scene.materials
        init = dataclasses.replace(
            m,
            kd=torch.clamp(m.kd + 0.15 * (m.kd.sum(-1, keepdim=True) > 0), 0.02, 0.95),
            ks=torch.clamp(m.ks - 0.3 * (m.ks > 0), 0.0, 0.95),
            ns=m.ns * 0.4,
            emission=m.emission * 0.5,
        )
        r = inverse.recover_materials(scene, init, cfg, steps=steps, lr=lr, rays_per_step=rays,
                                      seed=seed, loss_clip=clip).materials
        m, init, r = ({f: getattr(x, f).numpy() for f in inverse.FAMILIES} for x in (m, init, r))
        spec = m["ks"].sum(1) > 0
        lit = m["emission"].sum(1) > 0
        vis = (m["kd"].sum(1) > 0) & ~lit
        mae = lambda a, b, k: float(np.abs(a - b)[k].mean())  # noqa: E731
        return {
            "kd": (mae(init["kd"], m["kd"], vis), mae(r["kd"], m["kd"], vis)),
            "ks": (mae(init["ks"], m["ks"], spec), mae(r["ks"], m["ks"], spec)),
            "ns_log": (float(np.abs(np.log(init["ns"] / m["ns"]))[spec].mean()),
                       float(np.abs(np.log(r["ns"] / m["ns"]))[spec].mean())),
            "em_rel": (0.5, float((np.abs(r["emission"].sum(1) - m["emission"].sum(1))[lit]
                                   / m["emission"].sum(1)[lit]).mean())),
        }

    c = joint(cornell_scene, (32, 32), 250, 512, 0.08, None, 2)
    print("cornell", c)
    assert c["kd"][1] < 0.25 * c["kd"][0], c["kd"]
    assert c["ks"][1] < 0.6 * c["ks"][0], c["ks"]
    assert c["em_rel"][1] < 0.25 * c["em_rel"][0], c["em_rel"]

    v = joint(veach_scene, (48, 27), 300, 648, 0.06, 5.0, 2)
    print("veach", v)
    assert v["ks"][1] < 0.43 * v["ks"][0], v["ks"]
    assert v["ns_log"][1] < 0.45 * v["ns_log"][0], v["ns_log"]
    assert v["em_rel"][1] < 0.34 * v["em_rel"][0], v["em_rel"]

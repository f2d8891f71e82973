"""The regeneration loop's MIS / Arvo vertex on CUDA: three kernels around
K3 and K2 / K5.

Not the counterpart of a Pallas kernel: on the TPU, XLA fused the JAX
package's per-vertex math into a few generated kernels, while the port's
plain version, ``integrator/shading.py::vertex_plain``, runs it as ~700
torch kernels a call. The CUDA source is ``csrc/vertex.cu``; the kernels
compute the plain version's values bit for bit, their 12 draws a vertex
K6's (``csrc/threefry.cuh``). ``shading.vertex`` decides from its inputs
which path a call takes (``shading.takes_fused``) and calls, in order:

1. :func:`emit_rr`: the emission of emissive hits under the balance
   heuristic, Russian roulette, the live mask and K3's uniform;
2. K3 (``arvo_cuda.arvo_select``), then :func:`light_brdf`: the Arvo light
   sample, its shadow ray and masked NEE contribution, and the BRDF
   continuation; the shadow rays added to the ray count;
3. K2 / K5 (``ops.intersect.occluded``), then :func:`nee_add`: the
   unblocked NEE radiance added to L.

Each wrapper takes CUDA tensors only (the plain version is shading's torch
math), checks them, allocates its outputs and counts its launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build

f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool


def _empty(dev: torch.device, *shape, dtype=f32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


class Emitted(NamedTuple):
    """What :func:`emit_rr` leaves."""

    L: torch.Tensor       # [N,3] radiance with the vertex's emission
    tp: torch.Tensor      # [N,3] throughput after Russian roulette
    alive: torch.Tensor   # [N] bool: hit, not a light, survived
    u: torch.Tensor       # [N] K3's uniform
    nrays: torch.Tensor   # int64 scalar: the ray count so far (light_brdf adds to it)


def emit_rr(hit, is_light, light_idx, emission, tp, L, depth, prev_pb, prev_p, prev_ns, prev_w,
            table, keys, nrays, rr_prob: float) -> Emitted:
    """``mis_vertex_emit`` over N lanes: ``keys`` [N,2] the depth-folded
    lane keys, ``depth`` [N] int64, ``table`` the [L,16] light table,
    ``nrays`` the int64 ray count (a device scalar)."""
    n = hit.shape[0]
    L_ = table.shape[0]
    dev = _build.check_tensors(
        "emit_rr", n, hit=(hit, b8, (-1,)), is_light=(is_light, b8, (-1,)),
        light_idx=(light_idx, i32, (-1,)), emission=(emission, f32, (-1, 3)),
        tp=(tp, f32, (-1, 3)), L=(L, f32, (-1, 3)), depth=(depth, i64, (-1,)),
        prev_pb=(prev_pb, f32, (-1,)), prev_p=(prev_p, f32, (-1, 3)),
        prev_ns=(prev_ns, f32, (-1, 3)), prev_w=(prev_w, f32, (-1,)),
        table=(table, f32, (L_, 16)), keys=(keys, i64, (-1, 2)), nrays=(nrays, i64, ()))
    out = Emitted(_empty(dev, n, 3), _empty(dev, n, 3), _empty(dev, n, dtype=b8), _empty(dev, n),
                  _empty(dev, dtype=i64))
    lib = _build.load()
    err = lib.mcpt_vertex_emit(
        hit.data_ptr(), is_light.data_ptr(), light_idx.data_ptr(), emission.data_ptr(),
        tp.data_ptr(), L.data_ptr(), depth.data_ptr(), prev_pb.data_ptr(), prev_p.data_ptr(),
        prev_ns.data_ptr(), prev_w.data_ptr(), table.data_ptr(), L_, keys.data_ptr(),
        nrays.data_ptr(), float(rr_prob), 1.0 / float(rr_prob), n, out.L.data_ptr(),
        out.tp.data_ptr(), out.alive.data_ptr(), out.u.data_ptr(), out.nrays.data_ptr(),
        _build.stream(dev))
    _build.check(err, "emit_rr (mis_vertex_emit)")
    emit_rr.launches += 1
    return out


class Sampled(NamedTuple):
    """What :func:`light_brdf` leaves."""

    wl: torch.Tensor        # [N,3] unit direction of the shadow ray
    dist: torch.Tensor      # [N] its length
    contrib: torch.Tensor   # [N,3] NEE radiance where the shadow ray is unblocked, else 0
    wi: torch.Tensor        # [N,3] the BRDF sample
    pdf: torch.Tensor       # [N] its pdf
    spec: torch.Tensor      # [N] bool: the specular lobe was picked
    alive: torch.Tensor     # [N] bool: the path goes on along wi
    tp: torch.Tensor        # [N,3] throughput of the continuation


def light_brdf(keys, lidx, wsum, p, ns, wo, kd, ks, ns_exp, alive, tp, table, nrays,
               branch_pdf_compat: bool) -> Sampled:
    """``mis_vertex_light_brdf`` over N lanes after K3's pick (``lidx``,
    ``wsum``): ``alive`` and ``tp`` are :func:`emit_rr`'s, and ``nrays``
    its count, to which the live lanes' shadow rays are added in place."""
    n = keys.shape[0]
    L_ = table.shape[0]
    dev = _build.check_tensors(
        "light_brdf", n, keys=(keys, i64, (-1, 2)), lidx=(lidx, i32, (-1,)),
        wsum=(wsum, f32, (-1,)), p=(p, f32, (-1, 3)), ns=(ns, f32, (-1, 3)),
        wo=(wo, f32, (-1, 3)), kd=(kd, f32, (-1, 3)), ks=(ks, f32, (-1, 3)),
        ns_exp=(ns_exp, f32, (-1,)), alive=(alive, b8, (-1,)), tp=(tp, f32, (-1, 3)),
        table=(table, f32, (L_, 16)), nrays=(nrays, i64, ()))
    out = Sampled(_empty(dev, n, 3), _empty(dev, n), _empty(dev, n, 3), _empty(dev, n, 3),
                  _empty(dev, n), _empty(dev, n, dtype=b8), _empty(dev, n, dtype=b8),
                  _empty(dev, n, 3))
    lib = _build.load()
    err = lib.mcpt_vertex_light_brdf(
        keys.data_ptr(), lidx.data_ptr(), wsum.data_ptr(), p.data_ptr(), ns.data_ptr(),
        wo.data_ptr(), kd.data_ptr(), ks.data_ptr(), ns_exp.data_ptr(), alive.data_ptr(),
        tp.data_ptr(), table.data_ptr(), L_, int(bool(branch_pdf_compat)), n,
        *(t.data_ptr() for t in out), nrays.data_ptr(), _build.stream(dev))
    _build.check(err, "light_brdf (mis_vertex_light_brdf)")
    light_brdf.launches += 1
    return out


def nee_add(L, tp, contrib, blocked) -> torch.Tensor:
    """``mis_vertex_nee_add``: L += tp * (blocked ? 0 : contrib), in place
    on :func:`emit_rr`'s L, which it returns."""
    n = L.shape[0]
    dev = _build.check_tensors("nee_add", n, L=(L, f32, (-1, 3)), tp=(tp, f32, (-1, 3)),
                               contrib=(contrib, f32, (-1, 3)), blocked=(blocked, b8, (-1,)))
    lib = _build.load()
    err = lib.mcpt_vertex_nee_add(L.data_ptr(), tp.data_ptr(), contrib.data_ptr(),
                                  blocked.data_ptr(), n, _build.stream(dev))
    _build.check(err, "nee_add (mis_vertex_nee_add)")
    nee_add.launches += 1
    return L


emit_rr.launches = 0
light_brdf.launches = 0
nee_add.launches = 0

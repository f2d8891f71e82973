"""Geometry-preserving scene transforms.

Counterpart of ``monte_carlo_path_tracing_tpu/scene/transform.py``.
:func:`subdivide_scene` midpoint-splits every non-emissive triangle into
four children covering the same surface: the transformed scene renders the
original's image (up to intersection ties on the new shared edges) with
4^levels as many triangles — the instrument for measuring how the
intersection kernels and the grid scale at fixed image. Emissive triangles
stay whole, so the light sampling's cost (it scales with the light count)
does not change.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.scene.types import Scene


def _norm(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def subdivide_scene(scene: Scene, levels: int = 1) -> Scene:
    """Midpoint-subdivide all non-light triangles ``levels`` times
    (T -> L + (T - L) * 4^levels): a host-side numpy transform returning a
    new Scene on the same device, lights first (their ``light_tri_ids``
    retargeted, in the same order) and then the subdivided geometry."""
    dev = scene.device
    np_ = lambda t: t.detach().cpu().numpy()  # noqa: E731
    for _ in range(levels):
        is_light = np_(scene.is_light)
        kid = np.where(is_light)[0]
        sid = np.where(~is_light)[0]
        v0, e1, e2 = np_(scene.tri_v0), np_(scene.tri_e1), np_(scene.tri_e2)
        vn, gn, mat = np_(scene.tri_vn), np_(scene.geo_n), np_(scene.tri_mat_id)

        a, b, c = v0[sid], v0[sid] + e1[sid], v0[sid] + e2[sid]
        mab, mac, mbc = 0.5 * (a + b), 0.5 * (a + c), 0.5 * (b + c)
        na, nb, nc = vn[sid, 0], vn[sid, 1], vn[sid, 2]
        nab, nac, nbc = _norm(na + nb), _norm(na + nc), _norm(nb + nc)

        # Children as (v0, v1, v2) with matching corner normals, wound as
        # the parent, so its geometric normal carries over.
        child_v = [
            (a, mab, mac, na, nab, nac),
            (mab, b, mbc, nab, nb, nbc),
            (mac, mbc, c, nac, nbc, nc),
            (mab, mbc, mac, nab, nbc, nac),
        ]
        cv0, cv1, cv2 = (np.concatenate([t[i] for t in child_v]) for i in range(3))
        cvn = np.stack([np.concatenate([t[i] for t in child_v]) for i in (3, 4, 5)], axis=1)

        nk = kid.shape[0]
        remap = np.full(v0.shape[0], -1, np.int64)
        remap[kid] = np.arange(nk)
        new_light_ids = remap[np_(scene.light_tri_ids)]
        assert (new_light_ids >= 0).all()

        t = lambda x, dt: torch.as_tensor(np.asarray(x, dt), device=dev)  # noqa: E731
        scene = dataclasses.replace(
            scene,
            tri_v0=t(np.concatenate([v0[kid], cv0]), np.float32),
            tri_e1=t(np.concatenate([e1[kid], cv1 - cv0]), np.float32),
            tri_e2=t(np.concatenate([e2[kid], cv2 - cv0]), np.float32),
            tri_vn=t(np.concatenate([vn[kid], cvn]), np.float32),
            geo_n=t(np.concatenate([gn[kid], np.tile(gn[sid], (4, 1))]), np.float32),
            tri_mat_id=t(np.concatenate([mat[kid], np.tile(mat[sid], 4)]), np.int32),
            is_light=t(np.concatenate([np.ones(nk, bool), np.zeros(cv0.shape[0], bool)]), bool),
            light_tri_ids=t(new_light_ids, np.int32),
        )
    return scene

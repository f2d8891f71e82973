"""Build a Scene of tensors from parsed host-side data.

Counterpart of ``monte_carlo_path_tracing_tpu/scene/build.py``: the same
numpy pipeline (OBJ/MTL parse, XML lights, light-triangle gather,
vote-oriented geometric normals), so both packages load equal arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.scene.objparse import ParsedMesh, parse_obj
from monte_carlo_path_tracing_tpu_torch.scene.types import Camera, Materials, Scene
from monte_carlo_path_tracing_tpu_torch.scene.xmlparse import (
    ParsedSceneXML, parse_scene_xml,
)


def _normalize_np(v: np.ndarray, axis=-1) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-20)


def build_scene(
    mesh: ParsedMesh,
    scene_xml: ParsedSceneXML,
    camera: Optional[Camera] = None,
    fov_bug_compat: bool = False,
    device="cuda",
) -> Scene:
    """The Scene of a parsed mesh and scene XML, its tensors on ``device``:
    the card unless the caller names another (``device="cpu"``); without a
    card the default raises."""
    verts = mesh.vertices
    fv = mesh.face_v            # [T,3]
    fvn = mesh.face_vn          # [T,3]
    T = fv.shape[0]
    if T == 0:
        raise ValueError("scene has no triangles")

    a = verts[fv[:, 0]]
    b = verts[fv[:, 1]]
    c = verts[fv[:, 2]]
    e1 = b - a
    e2 = c - a

    # Geometric normal with majority-vote orientation against the vertex
    # normals (reference get_unique_normal_of_facet, Myobj.cpp:680-709).
    gn = _normalize_np(np.cross(e1, e2))

    has_vn = (fvn >= 0).all(axis=1) & (mesh.normals.shape[0] > 0)
    if mesh.normals.shape[0] > 0:
        vn = _normalize_np(mesh.normals[np.clip(fvn, 0, None)])  # [T,3,3]
    else:
        vn = np.repeat(gn[:, None, :], 3, axis=1)
    vn = np.where(has_vn[:, None, None], vn, gn[:, None, :])

    votes = np.sum(np.einsum("tij,tj->ti", vn, gn) > 0.0, axis=1)
    flip = votes < 2
    gn = np.where(flip[:, None], -gn, gn)

    # Material table. Unnamed/missing materials get matte grey defaults.
    mat_names = list(mesh.material_names) if mesh.material_names else [""]
    M = len(mat_names)
    kd = np.zeros((M, 3), np.float32)
    ks = np.zeros((M, 3), np.float32)
    ns = np.ones((M,), np.float32)
    emission = np.zeros((M, 3), np.float32)
    for i, name in enumerate(mat_names):
        pm = mesh.materials.get(name)
        if pm is not None:
            kd[i], ks[i], ns[i] = pm.kd, pm.ks, max(pm.ns, 1.0)
        else:
            kd[i] = (0.5, 0.5, 0.5)
        if name in scene_xml.lights:
            emission[i] = scene_xml.lights[name]

    tri_mat = np.where(mesh.face_mat >= 0, mesh.face_mat, 0).astype(np.int32)

    # Emissive gather (Mylight.cpp:32-100): class = light mtlname, area =
    # half parallelogram area (Mylight.cpp:66-71,80).
    light_class_names = [n for n in mat_names if n in scene_xml.lights]
    class_of_mat = {mat_names.index(n): k for k, n in enumerate(light_class_names)}
    is_light = np.isin(tri_mat, list(class_of_mat.keys()))
    light_ids = np.nonzero(is_light)[0].astype(np.int32)
    light_area = 0.5 * np.linalg.norm(
        np.cross(e1[light_ids], e2[light_ids]), axis=-1
    ).astype(np.float32)
    light_class = np.asarray(
        [class_of_mat[int(m)] for m in tri_mat[light_ids]], dtype=np.int32
    ).reshape(-1)

    t = lambda x: torch.as_tensor(np.array(x, copy=True), device=device)
    if camera is None:
        if scene_xml.camera is None:
            raise ValueError("no camera in scene XML and none supplied")
        pc = scene_xml.camera
        f32 = lambda x: t(np.asarray(x, np.float32))
        camera = Camera(
            eye=f32(pc.eye), lookat=f32(pc.lookat), up=f32(pc.up),
            fovy_deg=f32(pc.fovy), width=pc.width, height=pc.height,
            fov_bug_compat=fov_bug_compat,
        )

    return Scene(
        tri_v0=t(a), tri_e1=t(e1), tri_e2=t(e2), tri_vn=t(vn), geo_n=t(gn),
        tri_mat_id=t(tri_mat),
        materials=Materials(kd=t(kd), ks=t(ks), ns=t(ns), emission=t(emission)),
        is_light=t(is_light), light_tri_ids=t(light_ids),
        light_area=t(light_area), light_class=t(light_class),
        num_classes=t(np.asarray(len(light_class_names), np.int32)),
        camera=camera,
    )


def load_scene(obj_path: str, xml_path: Optional[str] = None, **kw) -> Scene:
    """Load a cg23 scene: ``<name>.obj`` (+``.mtl`` via mtllib) +
    ``<name>.xml``, onto the card; ``device=`` places it elsewhere
    (``device="cpu"``). The OBJ is parsed by the native library
    (``native/libmcpt_loader.so`` through ctypes) when it is built, else in
    Python, as in the JAX package."""
    from monte_carlo_path_tracing_tpu_torch.scene import native_loader

    if xml_path is None:
        xml_path = os.path.splitext(obj_path)[0] + ".xml"
    mesh = (native_loader.parse_obj_native(obj_path) if native_loader.native_available()
            else parse_obj(obj_path))
    return build_scene(mesh, parse_scene_xml(xml_path), **kw)

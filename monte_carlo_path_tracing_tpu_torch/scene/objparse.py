"""Host-side OBJ/MTL ingestion (cg23 scene format).

Own minimal parser — no tinyobjloader (the reference vendors 3.5k lines of it,
tiny_obj_loader.h; we only need the subset the renderer consumes:
v/vn/f/usemtl/mtllib and newmtl/Kd/Ks/Ns, per SURVEY.md §2 C5 and the
material fields read at main.cpp:292). Faces with >3 vertices are fan-
triangulated (tinyobj's default, which the reference relies on since it
indexes ``indices[3*f+v]`` everywhere, Myobj.cpp:94,137,641).

Same parser as ``monte_carlo_path_tracing_tpu/scene/objparse.py``.
``load_scene`` prefers the native ctypes loader (``scene/native_loader.py``)
when its library is built, and parses here otherwise.

Output is plain numpy (device transfer happens in scene.build).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ParsedMesh:
    vertices: np.ndarray      # [V, 3] f32
    normals: np.ndarray       # [VN, 3] f32 (may be empty)
    # per-triangle vertex/normal indices, -1 where absent
    face_v: np.ndarray        # [T, 3] int32
    face_vn: np.ndarray       # [T, 3] int32
    face_mat: np.ndarray      # [T] int32 into material_names
    material_names: List[str]
    materials: Dict[str, "ParsedMaterial"]


@dataclasses.dataclass
class ParsedMaterial:
    name: str
    kd: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 1.0


def parse_mtl(path: str) -> Dict[str, ParsedMaterial]:
    mats: Dict[str, ParsedMaterial] = {}
    cur: Optional[ParsedMaterial] = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = ParsedMaterial(name=tok[1] if len(tok) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif tok[0] == "Kd":
                cur.kd = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif tok[0] == "Ks":
                cur.ks = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif tok[0] == "Ns":
                cur.ns = float(tok[1])
    return mats


def _parse_face_vertex(chunk: str) -> Tuple[int, int]:
    """Return (v_idx, vn_idx) 0-based, vn=-1 if absent. OBJ is 1-based and
    supports negative (relative) indices — both handled by the caller."""
    parts = chunk.split("/")
    v = int(parts[0])
    vn = int(parts[2]) if len(parts) >= 3 and parts[2] != "" else 0
    return v, vn


def parse_obj(path: str) -> ParsedMesh:
    vertices: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    face_v: List[Tuple[int, int, int]] = []
    face_vn: List[Tuple[int, int, int]] = []
    face_mat: List[int] = []
    material_names: List[str] = []
    mat_index: Dict[str, int] = {}
    materials: Dict[str, ParsedMaterial] = {}
    cur_mat = -1

    def resolve(idx: int, n: int) -> int:
        if idx > 0:
            return idx - 1
        if idx < 0:
            return n + idx
        return -1

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            t = tok[0]
            if t == "v":
                vertices.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif t == "vn":
                normals.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif t == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(material_names)
                    material_names.append(name)
                cur_mat = mat_index[name]
            elif t == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path), " ".join(tok[1:]))
                if os.path.exists(mtl_path):
                    materials.update(parse_mtl(mtl_path))
            elif t == "f":
                idx = [_parse_face_vertex(c) for c in tok[1:]]
                nv, nn = len(vertices), len(normals)
                vs = [resolve(v, nv) for v, _ in idx]
                vns = [resolve(vn, nn) for _, vn in idx]
                for k in range(1, len(vs) - 1):  # fan triangulation
                    face_v.append((vs[0], vs[k], vs[k + 1]))
                    face_vn.append((vns[0], vns[k], vns[k + 1]))
                    face_mat.append(cur_mat)

    return ParsedMesh(
        vertices=np.asarray(vertices, dtype=np.float32).reshape(-1, 3),
        normals=np.asarray(normals, dtype=np.float32).reshape(-1, 3),
        face_v=np.asarray(face_v, dtype=np.int32).reshape(-1, 3),
        face_vn=np.asarray(face_vn, dtype=np.int32).reshape(-1, 3),
        face_mat=np.asarray(face_mat, dtype=np.int32),
        material_names=material_names,
        materials=materials,
    )

"""The reference's own reading of a cg23 scene: OBJ/MTL, the scene XML.

Plain Python and NumPy. It reads the raw files that the program under test
reads too and works out everything the renderer needs from them: triangle
vertices and edges, shading normals, the geometric normal oriented by a
vote of the vertex normals (the upstream renderer's
get_unique_normal_of_facet, Myobj.cpp:680-709), the Phong material table,
the emissive triangles named by the XML's <light> elements, and the camera.
"""

from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RefScene:
    """Flat triangle arrays on one device, floats in one dtype."""

    v0: torch.Tensor         # [T, 3]
    e1: torch.Tensor         # [T, 3]  v1 - v0
    e2: torch.Tensor         # [T, 3]  v2 - v0
    vn: torch.Tensor         # [T, 3, 3] unit vertex normals
    gn: torch.Tensor         # [T, 3] vote-oriented unit geometric normal
    kd: torch.Tensor         # [T, 3]
    ks: torch.Tensor         # [T, 3]
    ns: torch.Tensor         # [T]
    emission: torch.Tensor   # [T, 3]
    is_light: torch.Tensor   # [T] bool
    light_tri: torch.Tensor  # [L] int64 triangle id of each light
    tri_light: torch.Tensor  # [T] int64 light index, -1 for other triangles
    eye: torch.Tensor        # [3]
    lookat: torch.Tensor     # [3]
    up: torch.Tensor         # [3]
    fovy_deg: float
    width: int
    height: int

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def _parse_mtl(path):
    mats, cur = {}, None
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = {"kd": (0.0,) * 3, "ks": (0.0,) * 3, "ns": 1.0}
                mats[tok[1] if len(tok) > 1 else ""] = cur
            elif cur is not None and tok[0] in ("Kd", "Ks"):
                cur[tok[0].lower()] = tuple(float(x) for x in tok[1:4])
            elif cur is not None and tok[0] == "Ns":
                cur["ns"] = float(tok[1])
    return mats


def _parse_obj(path):
    """(vertices, normals, face vertex ids, face normal ids (-1: none), face
    material ids (-1: none), material names, materials); polygons are
    fan-triangulated and OBJ's 1-based and negative indices resolved."""
    verts, norms, fv, fvn, fmat, names, mats = [], [], [], [], [], [], {}
    cur = -1

    def resolve(i, n):
        return i - 1 if i > 0 else (n + i if i < 0 else -1)

    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif tok[0] == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in names:
                    names.append(name)
                cur = names.index(name)
            elif tok[0] == "mtllib":
                mtl = os.path.join(os.path.dirname(path), " ".join(tok[1:]))
                if os.path.exists(mtl):
                    mats.update(_parse_mtl(mtl))
            elif tok[0] == "f":
                vs, ns = [], []
                for c in tok[1:]:
                    parts = c.split("/")
                    vs.append(resolve(int(parts[0]), len(verts)))
                    has_n = len(parts) >= 3 and parts[2] != ""
                    ns.append(resolve(int(parts[2]), len(norms)) if has_n else -1)
                for k in range(1, len(vs) - 1):
                    fv.append((vs[0], vs[k], vs[k + 1]))
                    fvn.append((ns[0], ns[k], ns[k + 1]))
                    fmat.append(cur)
    f32 = lambda x: np.asarray(x, np.float32).reshape(-1, 3)  # noqa: E731
    i64 = lambda x: np.asarray(x, np.int64).reshape(-1, 3)  # noqa: E731
    return (f32(verts), f32(norms), i64(fv), i64(fvn),
            np.asarray(fmat, np.int64), names, mats)


def _parse_xml(path):
    """(lights {mtlname: rgb}, camera dict or None). cg23 files are XML
    fragments, so they are wrapped in a root first."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = re.sub(r"<\?xml[^>]*\?>", "", f.read())
    root = ET.fromstring(f"<root>{text}</root>")
    lights = {ln.get("mtlname", ""): tuple(float(x) for x in ln.get("radiance").split(","))
              for ln in root.iter("light")}
    cam = root.find("camera")
    if cam is None:
        return lights, None
    vec = lambda tag: tuple(float(cam.find(tag).get(a, 0)) for a in "xyz")  # noqa: E731
    return lights, {"eye": vec("eye"), "lookat": vec("lookat"), "up": vec("up"),
                    "fovy": float(cam.get("fovy", 45.0)), "width": int(cam.get("width", 1280)),
                    "height": int(cam.get("height", 720))}


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def load(obj_path: str, width: int | None = None, height: int | None = None,
         device="cpu", dtype=torch.float32) -> RefScene:
    """The scene of ``<name>.obj`` and ``<name>.xml`` beside it, its image
    size overridden by ``width`` / ``height`` where given."""
    verts, norms, fv, fvn, fmat, names, mats = _parse_obj(obj_path)
    lights, cam = _parse_xml(os.path.splitext(obj_path)[0] + ".xml")
    a, b, c = verts[fv[:, 0]], verts[fv[:, 1]], verts[fv[:, 2]]
    e1, e2 = b - a, c - a
    gn = _unit(np.cross(e1, e2))
    has_n = (fvn >= 0).all(axis=1) & (norms.shape[0] > 0)
    vn = _unit(norms[np.clip(fvn, 0, None)]) if norms.shape[0] else np.repeat(gn[:, None], 3, 1)
    vn = np.where(has_n[:, None, None], vn, gn[:, None, :])
    flip = ((vn * gn[:, None, :]).sum(-1) > 0.0).sum(axis=1) < 2
    gn = np.where(flip[:, None], -gn, gn)

    names = names or [""]
    kd = np.array([mats[n]["kd"] if n in mats else (0.5,) * 3 for n in names], np.float32)
    ks = np.array([mats[n]["ks"] if n in mats else (0.0,) * 3 for n in names], np.float32)
    ns = np.array([max(mats[n]["ns"], 1.0) if n in mats else 1.0 for n in names], np.float32)
    em = np.array([lights.get(n, (0.0,) * 3) for n in names], np.float32)
    mat = np.where(fmat >= 0, fmat, 0)
    is_light = np.array([n in lights for n in names])[mat]
    light_tri = np.flatnonzero(is_light)
    tri_light = np.full(len(mat), -1, np.int64)
    tri_light[light_tri] = np.arange(len(light_tri))

    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)  # noqa: E731
    i = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    return RefScene(
        v0=f(a), e1=f(e1), e2=f(e2), vn=f(vn), gn=f(gn), kd=f(kd[mat]), ks=f(ks[mat]),
        ns=f(ns[mat]), emission=f(em[mat]), is_light=i(is_light), light_tri=i(light_tri),
        tri_light=i(tri_light), eye=f(cam["eye"]), lookat=f(cam["lookat"]), up=f(cam["up"]),
        fovy_deg=cam["fovy"], width=int(width or cam["width"]),
        height=int(height or cam["height"]))

"""Scene, camera and material records: frozen dataclasses of tensors.

Counterpart of ``monte_carlo_path_tracing_tpu/scene/types.py`` with the
same fields and properties. Triangles are identified by one flat index
``tri_id`` in [0, T); materials live in a table indexed by ``tri_mat_id``.
Every tensor of a scene lies on one device; :meth:`Scene.to` moves it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _to(obj, device):
    kw = {
        f.name: (v.to(device) if torch.is_tensor(v) else
                 _to(v, device) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(obj)
        for v in [getattr(obj, f.name)]
    }
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera in the reference's convention (main.cpp:507-553);
    ``fov_bug_compat`` reproduces quirk Q2 (main.cpp:547)."""

    eye: torch.Tensor        # [3]
    lookat: torch.Tensor     # [3]
    up: torch.Tensor         # [3]
    fovy_deg: torch.Tensor   # scalar, full vertical fov in degrees
    width: int = 1280
    height: int = 720
    fov_bug_compat: bool = False


@dataclasses.dataclass(frozen=True)
class Materials:
    """Phong material table (Kd, Ks, Ns; main.cpp:292,313,331) + emission."""

    kd: torch.Tensor        # [M, 3]
    ks: torch.Tensor        # [M, 3]
    ns: torch.Tensor        # [M]
    emission: torch.Tensor  # [M, 3]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Flat SoA scene. T = #triangles, L = #light triangles, M = #materials."""

    tri_v0: torch.Tensor      # [T, 3]
    tri_e1: torch.Tensor      # [T, 3]  v1 - v0
    tri_e2: torch.Tensor      # [T, 3]  v2 - v0
    tri_vn: torch.Tensor      # [T, 3, 3] per-vertex unit shading normals
    geo_n: torch.Tensor       # [T, 3] unit geometric normal, vote-oriented
    tri_mat_id: torch.Tensor  # [T] int32 into Materials
    materials: Materials
    is_light: torch.Tensor        # [T] bool
    light_tri_ids: torch.Tensor   # [L] int32
    light_area: torch.Tensor      # [L]
    light_class: torch.Tensor     # [L] int32
    num_classes: torch.Tensor     # scalar int32
    camera: Camera

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tri_ids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def tri_emission(self) -> torch.Tensor:
        """[T,3] emitted radiance per triangle (zero for non-lights)."""
        return self.materials.emission[self.tri_mat_id]

    def light_emission(self) -> torch.Tensor:
        """[L,3] emitted radiance per light triangle."""
        return self.tri_emission()[self.light_tri_ids]

    def light_verts(self):
        """([L,3],[L,3],[L,3]) world-space vertices of the light triangles."""
        v0 = self.tri_v0[self.light_tri_ids]
        e1 = self.tri_e1[self.light_tri_ids]
        e2 = self.tri_e2[self.light_tri_ids]
        return v0, v0 + e1, v0 + e2

    def with_materials(self, materials: Materials) -> "Scene":
        return dataclasses.replace(self, materials=materials)

    def to(self, device) -> "Scene":
        """The same scene with every tensor on ``device``."""
        return _to(self, torch.device(device))


#: Field order of :func:`scene_from_arrays`'s ``arrays`` (the JAX Scene's
#: leaves, materials and camera flattened with dotted names).
SCENE_ARRAYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_vn", "geo_n", "tri_mat_id",
    "materials.kd", "materials.ks", "materials.ns", "materials.emission",
    "is_light", "light_tri_ids", "light_area", "light_class", "num_classes",
    "camera.eye", "camera.lookat", "camera.up", "camera.fovy_deg",
)


def scene_from_arrays(
    arrays: dict, width: int, height: int, fov_bug_compat: bool = False,
    device="cuda",
) -> Scene:
    """Build the port's Scene from numpy arrays keyed by :data:`SCENE_ARRAYS`
    — the state carried across from a JAX ``Scene``, so that both packages
    can be handed the very same scene — on the card unless ``device=``
    names another (``device="cpu"``)."""
    missing = [k for k in SCENE_ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays missing {missing}")
    t = {k: torch.as_tensor(np.array(arrays[k], copy=True), device=device) for k in SCENE_ARRAYS}
    return Scene(
        tri_v0=t["tri_v0"], tri_e1=t["tri_e1"], tri_e2=t["tri_e2"],
        tri_vn=t["tri_vn"], geo_n=t["geo_n"], tri_mat_id=t["tri_mat_id"],
        materials=Materials(
            kd=t["materials.kd"], ks=t["materials.ks"], ns=t["materials.ns"],
            emission=t["materials.emission"],
        ),
        is_light=t["is_light"], light_tri_ids=t["light_tri_ids"],
        light_area=t["light_area"], light_class=t["light_class"],
        num_classes=t["num_classes"],
        camera=Camera(
            eye=t["camera.eye"], lookat=t["camera.lookat"], up=t["camera.up"],
            fovy_deg=t["camera.fovy_deg"], width=int(width), height=int(height),
            fov_bug_compat=bool(fov_bug_compat),
        ),
    )

"""ctypes bindings for the native OBJ/MTL loader (``native/loader.cpp``).

Counterpart of ``monte_carlo_path_tracing_tpu/scene/native_loader.py``. The
library is optional: when ``native/libmcpt_loader.so`` has not been built
(``make -C native``) or cannot be loaded, ``load_scene`` parses in Python
(``scene/objparse.py``). With it, :func:`parse_obj_native` gives the
ParsedMesh that ``objparse.parse_obj`` gives (tests/test_torch_loader.py
holds the two equal on the bundled scenes).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from monte_carlo_path_tracing_tpu_torch.scene.objparse import ParsedMaterial, ParsedMesh

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
                         "libmcpt_loader.so")
_lib = None
_checked = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """The library with its signatures declared, or None when it is absent
    or does not load; probed once."""
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.mcpt_obj_open.restype = ctypes.c_void_p
    lib.mcpt_obj_open.argtypes = [ctypes.c_char_p]
    lib.mcpt_obj_error.restype = ctypes.c_char_p
    lib.mcpt_obj_error.argtypes = [ctypes.c_void_p]
    lib.mcpt_obj_counts.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 4
    lib.mcpt_obj_fill.argtypes = [ctypes.c_void_p, f32, f32, i32, i32, i32]
    lib.mcpt_obj_material.restype = ctypes.c_int
    lib.mcpt_obj_material.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32), np.ctypeslib.ndpointer(np.float32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.mcpt_obj_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def parse_obj_native(path: str) -> ParsedMesh:
    """Parse an OBJ (and its MTL) with the native library."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native loader not built (run: make -C native)")
    h = lib.mcpt_obj_open(path.encode())
    try:
        err = lib.mcpt_obj_error(h)
        if err:
            raise IOError(f"native obj parse failed: {err.decode()}: {path}")
        nv, nn, nt, nm = (ctypes.c_int64() for _ in range(4))
        lib.mcpt_obj_counts(h, nv, nn, nt, nm)

        vertices = np.empty((max(nv.value, 1), 3), np.float32)
        normals = np.empty((max(nn.value, 1), 3), np.float32)
        face_v = np.empty((max(nt.value, 1), 3), np.int32)
        face_vn = np.empty((max(nt.value, 1), 3), np.int32)
        face_mat = np.empty((max(nt.value, 1),), np.int32)
        lib.mcpt_obj_fill(h, vertices, normals, face_v, face_vn, face_mat)

        names = []
        materials = {}
        buf = ctypes.create_string_buffer(256)
        kd = np.zeros(3, np.float32)
        ks = np.zeros(3, np.float32)
        ns = ctypes.c_float()
        for i in range(nm.value):
            present = lib.mcpt_obj_material(h, i, buf, kd, ks, ns)
            name = buf.value.decode()
            names.append(name)
            if present:
                materials[name] = ParsedMaterial(name=name, kd=tuple(map(float, kd)),
                                                 ks=tuple(map(float, ks)), ns=float(ns.value))
        return ParsedMesh(
            vertices=vertices[: nv.value].reshape(-1, 3),
            normals=normals[: nn.value].reshape(-1, 3),
            face_v=face_v[: nt.value].reshape(-1, 3),
            face_vn=face_vn[: nt.value].reshape(-1, 3),
            face_mat=face_mat[: nt.value],
            material_names=names,
            materials=materials,
        )
    finally:
        lib.mcpt_obj_close(h)

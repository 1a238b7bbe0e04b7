"""Marching cubes on the host: the port of ``mipsfusion_tpu/mesher/marching.py``.

``marching_cubes(volume, isovalue, truncation) -> (verts, faces)`` calls
``csrc/marching.cpp`` (marching tetrahedra with truncation-aware invalid
voxel rejection and vertex welding), built with the host ``c++`` at first
use by ``ops/_build.marching_lib``. A failed build raises: there is no
quiet return to the Python version.

``marching_cubes_plain`` is the Python version of the same algorithm, the
tests' oracle for the C++ code. It computes in float64, as the C++ does,
so the two give the same vertices and faces (the JAX package's Python
fallback keeps the corner values in float32).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import _build


def marching_cubes(volume: np.ndarray, isovalue: float = 0.0,
                   truncation: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a TSDF volume [nx, ny, nz].

    Voxels with |v| >= truncation or non-finite values are invalid and
    their cubes are skipped. Returns (verts [V,3] float64 in voxel-index
    coords, faces [F,3] int64).
    """
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    lib = _build.marching_lib()
    vp = ctypes.POINTER(ctypes.c_double)()
    fp = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mc_extract(vol.ctypes.data, vol.shape[0], vol.shape[1],
                        vol.shape[2], isovalue, truncation, ctypes.byref(vp),
                        ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf))
    try:
        if rc != 0:
            raise RuntimeError("mc_extract failed (out of memory)")
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3))
        faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int64)
    finally:
        lib.mc_free(ctypes.cast(vp, ctypes.c_void_p))
        lib.mc_free(ctypes.cast(fp, ctypes.c_void_p))
    return verts, faces


_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
_CORNER = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                    for c in range(8)], np.float64)


def marching_cubes_plain(vol: np.ndarray, isovalue: float = 0.0,
                         truncation: float = 1.0):
    """The same extraction in Python (slow; tests only)."""
    vol = np.asarray(vol, np.float32)
    valid = np.isfinite(vol) & (np.abs(vol) < truncation)
    verts = {}
    vlist = []
    faces = []

    def vid(p):
        k = (round(p[0] * 1e5), round(p[1] * 1e5), round(p[2] * 1e5))
        if k not in verts:
            verts[k] = len(vlist)
            vlist.append(p)
        return verts[k]

    xs, ys, zs = np.where(
        valid[:-1, :-1, :-1] & valid[1:, :-1, :-1] & valid[:-1, 1:, :-1]
        & valid[1:, 1:, :-1] & valid[:-1, :-1, 1:] & valid[1:, :-1, 1:]
        & valid[:-1, 1:, 1:] & valid[1:, 1:, 1:])
    for x, y, z in zip(xs, ys, zs):
        cv = np.array([vol[x + int(c[0]), y + int(c[1]), z + int(c[2])]
                       for c in _CORNER], np.float64)
        if (cv < isovalue).all() or (cv >= isovalue).all():
            continue
        cp = _CORNER + np.array([x, y, z], np.float64)
        for tet in _TETS:
            tv, tp = cv[tet], cp[tet]
            inside = tv < isovalue
            n_in = int(inside.sum())
            if n_in in (0, 4):
                continue

            def edge(a, b):
                d = tv[b] - tv[a]
                t = 0.5 if abs(d) < 1e-12 else np.clip(
                    (isovalue - tv[a]) / d, 0, 1)
                return tuple(tp[a] + t * (tp[b] - tp[a]))

            if n_in in (1, 3):
                lone = int(np.argmax(inside if n_in == 1 else ~inside))
                oth = [i for i in range(4) if i != lone]
                tri = [vid(edge(lone, o)) for o in oth]
                if len(set(tri)) == 3:
                    faces.append(tri)
            else:
                ins = np.where(inside)[0]
                out = np.where(~inside)[0]
                q = [vid(edge(ins[0], out[0])), vid(edge(ins[0], out[1])),
                     vid(edge(ins[1], out[1])), vid(edge(ins[1], out[0]))]
                if len({q[0], q[1], q[2]}) == 3:
                    faces.append([q[0], q[1], q[2]])
                if len({q[0], q[2], q[3]}) == 3:
                    faces.append([q[0], q[2], q[3]])
    return (np.asarray(vlist, np.float64).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3))

"""ctypes bindings to the host mesh engine ``fastmesh.cpp``.

The library is built with ``g++`` at first use into ``build/native/`` at the
repository root, named by a hash of the source (an edited source is rebuilt,
a stale library never loaded). Where no ``g++`` is found, every entry point
returns None and the callers in fem/mesh.py take their numpy route, which
gives the same meshes and numbering; a build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastmesh.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libfastmesh-{digest}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _load():
    """The loaded library, built first if needed; None without ``g++``."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    out = library_path()
    if not out.exists():
        if shutil.which("g++") is None:
            from .. import PerformanceWarning

            warnings.warn("fastmesh: no g++ found; the mesh builders take their numpy route",
                          PerformanceWarning)
            return None
        _build(out)
    lib = ctypes.CDLL(str(out))
    i64, f64p, i32p = ctypes.c_int64, np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int32)
    lib.structured_quad_mesh.argtypes = [i64, i64, f64p, f64p, i32p]
    lib.structured_quad_mesh.restype = None
    lib.structured_hex_mesh.argtypes = [i64, i64, i64, f64p, f64p, i32p]
    lib.structured_hex_mesh.restype = None
    lib.unique_edges.argtypes = [i64, i64, i32p, i32p, i32p, i64]
    lib.unique_edges.restype = i64
    lib.unique_faces.argtypes = [i64, i64, i64, i32p, i32p, i32p, i64]
    lib.unique_faces.restype = i64
    _lib = lib
    return _lib


def structured_quad_mesh(nx, ny, p0, p1):
    """``(points ((nx+1)(ny+1), 2), cells (nx ny, 4))`` of a structured
    rectangle, or None without the engine."""
    lib = _load()
    if lib is None:
        return None
    points = np.empty(((nx + 1) * (ny + 1), 2))
    cells = np.empty((nx * ny, 4), dtype=np.int32)
    bounds = np.asarray([p0[0], p0[1], p1[0], p1[1]], dtype=np.float64)
    lib.structured_quad_mesh(nx, ny, bounds, points, cells)
    return points, cells


def structured_hex_mesh(nx, ny, nz, p0, p1):
    """``(points, cells (nx ny nz, 8))`` of a structured box, z fastest, or
    None without the engine."""
    lib = _load()
    if lib is None:
        return None
    points = np.empty(((nx + 1) * (ny + 1) * (nz + 1), 3))
    cells = np.empty((nx * ny * nz, 8), dtype=np.int32)
    bounds = np.asarray([*p0[:3], *p1[:3]], dtype=np.float64)
    lib.structured_hex_mesh(nx, ny, nz, bounds, points, cells)
    return points, cells


def unique_edges(ev):
    """``ev (ncells, nle, 2)`` -> ``(edge_verts (ne, 2) sorted pairs,
    cell_edges (ncells, nle))`` in first-seen order, or None without the
    engine."""
    lib = _load()
    if lib is None:
        return None
    ncells, nle, _ = ev.shape
    ev = np.ascontiguousarray(ev, dtype=np.int32)
    cell_edges = np.empty((ncells, nle), dtype=np.int32)
    cap = ncells * nle
    edge_verts = np.empty((cap, 2), dtype=np.int32)
    n = lib.unique_edges(ncells, nle, ev.reshape(-1), cell_edges.reshape(-1), edge_verts.reshape(-1), cap)
    if n < 0:
        raise RuntimeError("fastmesh.unique_edges: capacity exceeded")
    return edge_verts[:n].copy(), cell_edges


def unique_faces(fv):
    """``fv (ncells, nlf, nfv)`` -> ``(face_verts (nf, nfv) sorted tuples,
    cell_faces (ncells, nlf))`` in first-seen order, or None without the
    engine."""
    lib = _load()
    if lib is None:
        return None
    ncells, nlf, nfv = fv.shape
    fv = np.ascontiguousarray(fv, dtype=np.int32)
    cell_faces = np.empty((ncells, nlf), dtype=np.int32)
    cap = ncells * nlf
    face_verts = np.empty((cap, nfv), dtype=np.int32)
    n = lib.unique_faces(ncells, nlf, nfv, fv.reshape(-1), cell_faces.reshape(-1), face_verts.reshape(-1), cap)
    if n < 0:
        raise RuntimeError("fastmesh.unique_faces: capacity exceeded")
    return face_verts[:n].copy(), cell_faces

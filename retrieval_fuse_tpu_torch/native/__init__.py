"""Host C++ components with ctypes bindings, as in the JAX package's
native/__init__.py: marching cubes (`mc`, the classic lookup-table
triangulation, and `tets`, marching tetrahedra), the exact triangle/box
shell voxelizer and the distance-priority compose paste.

The three sources are byte-for-byte copies of the JAX package's (a test
pins them). They are compiled by g++ on first use, with the JAX package's
flags, into one shared library in `build/retrieval_fuse_tpu_torch/` beside
the package (ignored by git), named by a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded. Nothing is
compiled or loaded at import. A failed build raises with g++'s output:
there is no numpy fallback behind any of these functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "retrieval_fuse_tpu_torch"
SOURCES = ("marching_cubes.cpp", "compose.cpp", "voxelize.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"the native library needs a C++ compiler ({CXX}): {e}") from e
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build the native library:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f_p, i_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.mc_extract.restype = ctypes.c_int
        lib.mc_extract.argtypes = [
            f_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(f_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(i_p), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mc_extract_classic.restype = ctypes.c_int
        lib.mc_extract_classic.argtypes = lib.mc_extract.argtypes
        lib.mc_free.restype = None
        lib.mc_free.argtypes = [f_p, i_p]
        lib.voxelize_mesh.restype = None
        lib.voxelize_mesh.argtypes = [
            f_p, ctypes.c_int64, i_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.compose_paste.restype = None
        lib.compose_paste.argtypes = [
            f_p, f_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f_p, i_p, f_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def marching_cubes(sdf: np.ndarray, level: float, method: str = "mc"):
    """Isosurface of a 3-D float grid at `level` -> (verts (V, 3) float32,
    tris (T, 3) int32), vertices in voxel-index units. method 'mc': the
    classic lookup-table triangulation; 'tets': marching tetrahedra (the
    same isosurface, ~2x finer tessellation). Both are watertight with
    outward normals."""
    sdf = np.ascontiguousarray(sdf, dtype=np.float32)
    if sdf.ndim != 3:
        raise ValueError(f"marching_cubes takes a 3-D grid, got shape {sdf.shape}")
    if method not in ("mc", "tets"):
        raise ValueError(f"method is 'mc' or 'tets', got {method!r}")
    lib = get_lib()
    extract = lib.mc_extract_classic if method == "mc" else lib.mc_extract
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    n_v, n_t = ctypes.c_int(), ctypes.c_int()
    rc = extract(sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 sdf.shape[0], sdf.shape[1], sdf.shape[2], ctypes.c_float(level),
                 ctypes.byref(verts_p), ctypes.byref(n_v), ctypes.byref(tris_p),
                 ctypes.byref(n_t))
    if rc != 0:
        raise RuntimeError(f"mc_extract failed with code {rc}")
    try:
        verts = (np.ctypeslib.as_array(verts_p, shape=(n_v.value, 3)).copy() if n_v.value
                 else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(tris_p, shape=(n_t.value, 3)).copy() if n_t.value
                else np.zeros((0, 3), np.int32))
    finally:
        lib.mc_free(verts_p, tris_p)
    return verts, tris


def export_obj(verts: np.ndarray, tris: np.ndarray, path) -> None:
    """Write an OBJ file: `v x y z` lines (6 decimals), then 1-based `f` lines."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def voxelize_mesh(verts: np.ndarray, tris: np.ndarray, pitch: float,
                  origin_cell: np.ndarray, dims: tuple[int, int, int]) -> np.ndarray:
    """Exact shell voxelization: a (nx, ny, nz) uint8 grid with 1 in every
    cell whose box intersects a triangle. Cell c of the grid is world cell
    origin_cell + c, the box [(origin_cell + c)·pitch, +pitch)."""
    verts = np.ascontiguousarray(
        np.asarray(verts, np.float64) / pitch - np.asarray(origin_cell, np.float64),
        np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    grid = np.zeros(dims, np.uint8)
    if len(tris):
        lib = get_lib()
        lib.voxelize_mesh(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), verts.shape[0],
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), tris.shape[0],
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dims[0], dims[1], dims[2])
    return grid


def compose_paste(volume: np.ndarray, distances: np.ndarray, crops: np.ndarray,
                  extents: np.ndarray, dists: np.ndarray, no_overlap: bool) -> None:
    """In-place distance-priority paste of P crops into a scene volume.

    volume, distances: (X, Y, Z) float32, C-contiguous (mutated); crops
    (P, ps, ps, ps) float32; extents (P, 6) int32 destination boxes inside
    the volume; dists (P,) float32."""
    for name, a in (("volume", volume), ("distances", distances)):
        if a.dtype != np.float32 or not a.flags.c_contiguous or a.ndim != 3:
            raise ValueError(f"compose_paste: {name} must be a C-contiguous 3-D float32 array")
    if distances.shape != volume.shape:
        raise ValueError("compose_paste: volume and distances differ in shape")
    crops = np.ascontiguousarray(crops, np.float32)
    extents = np.ascontiguousarray(extents, np.int32)
    dists = np.ascontiguousarray(dists, np.float32)
    p, ps = crops.shape[0], crops.shape[1]
    if crops.shape != (p, ps, ps, ps) or extents.shape != (p, 6) or dists.shape != (p,):
        raise ValueError(f"compose_paste: crops {crops.shape}, extents {extents.shape}, "
                         f"dists {dists.shape} do not describe {p} cubes")
    lo, hi = extents[:, 0::2], extents[:, 1::2]
    if p and ((lo < 0).any() or (hi > np.array(volume.shape)).any() or (hi - lo != ps).any()):
        raise ValueError("compose_paste: an extent leaves the volume or is not the crop's size")
    lib = get_lib()
    lib.compose_paste(
        volume.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        distances.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        volume.shape[0], volume.shape[1], volume.shape[2],
        crops.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        extents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        p, ps, 1 if no_overlap else 0)

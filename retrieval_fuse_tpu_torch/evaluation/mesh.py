"""Triangle-mesh utilities (load/save, sampling, voxelization, plane
slicing, concatenation) in numpy, as in the JAX package's
evaluation/mesh.py: the subset of trimesh the mesh metrics need.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class Mesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int64).reshape(-1, 3)

    # ----------------------------------------------------------------- io

    @staticmethod
    def load(path) -> "Mesh":
        path = Path(path)
        if path.suffix == ".off":
            return Mesh._load_off(path)
        return Mesh._load_obj(path)

    @staticmethod
    def _load_obj(path) -> "Mesh":
        verts, faces = [], []
        for line in Path(path).read_text().splitlines():
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
        return Mesh(np.array(verts).reshape(-1, 3), np.array(faces, np.int64).reshape(-1, 3))

    @staticmethod
    def _load_off(path) -> "Mesh":
        tokens = Path(path).read_text().split()
        assert tokens[0] in ("OFF", "COFF")
        nv, nf = int(tokens[1]), int(tokens[2])
        i = 4
        verts = np.array(tokens[i:i + 3 * nv], float).reshape(nv, 3)
        i += 3 * nv
        faces = []
        while len(faces) < nf and i < len(tokens):
            k = int(tokens[i])
            poly = [int(t) for t in tokens[i + 1: i + 1 + k]]
            for j in range(1, k - 1):
                faces.append([poly[0], poly[j], poly[j + 1]])
            i += 1 + k
        return Mesh(verts, np.array(faces, np.int64).reshape(-1, 3))

    def export(self, path) -> None:
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for t in self.faces:
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")

    # ------------------------------------------------------------ geometry

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def apply_scale(self, s: float) -> "Mesh":
        self.vertices = self.vertices * s
        return self

    def apply_translation(self, t) -> "Mesh":
        self.vertices = self.vertices + np.asarray(t, np.float64)
        return self

    def face_areas_normals(self):
        tri = self.vertices[self.faces]
        cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        area2 = np.linalg.norm(cross, axis=1)
        normals = cross / np.maximum(area2[:, None], 1e-12)
        return area2 / 2.0, normals

    def sample(self, n: int, return_index: bool = False, seed: int = 0):
        """Area-weighted uniform surface sampling (trimesh.sample semantics)."""
        areas, _ = self.face_areas_normals()
        if areas.sum() <= 0 or len(self.faces) == 0:
            pts = np.zeros((n, 3), np.float32)
            idx = np.zeros(n, np.int64)
            return (pts, idx) if return_index else pts
        rng = np.random.default_rng(seed)
        face_idx = rng.choice(len(self.faces), size=n, p=areas / areas.sum())
        tri = self.vertices[self.faces[face_idx]]
        r1 = np.sqrt(rng.random(n))[:, None]
        r2 = rng.random(n)[:, None]
        pts = tri[:, 0] * (1 - r1) + tri[:, 1] * (r1 * (1 - r2)) + tri[:, 2] * (r1 * r2)
        return (pts.astype(np.float32), face_idx) if return_index else pts.astype(np.float32)

    def voxelize_surface(self, pitch: float, samples_per_area: float = 12.0,
                         exact: bool = True) -> set:
        """Set of voxel coordinates intersected by the surface; cells are
        floor(p / pitch).

        `exact` (default) runs the native separating-axis triangle/box
        voxelizer (native/voxelize.cpp): every intersected cell is marked,
        as trimesh's shell voxelization marks them. It raises when the
        native library cannot be built. Only exact=False samples the
        surface instead (samples_per_area points per pitch², at least 1024,
        at most 2,000,000), which misses the cells the surface only grazes."""
        if len(self.faces) == 0:
            return set()
        if exact:
            from retrieval_fuse_tpu_torch.native import voxelize_mesh
            lo = np.floor(self.vertices.min(0) / pitch).astype(np.int64)
            hi = np.floor(self.vertices.max(0) / pitch).astype(np.int64)
            dims = tuple(int(d) for d in (hi - lo + 1))
            grid = voxelize_mesh(self.vertices, self.faces, pitch, lo, dims)
            return set(map(tuple, (np.argwhere(grid) + lo)))
        areas, _ = self.face_areas_normals()
        total_area = areas.sum()
        if total_area <= 0:
            return set()
        n = max(int(total_area / (pitch * pitch) * samples_per_area), 1024)
        n = min(n, 2_000_000)
        pts = self.sample(n, seed=1)
        cells = np.floor(pts / pitch).astype(np.int64)
        return set(map(tuple, cells))

    @staticmethod
    def concatenate(meshes: list["Mesh"]) -> "Mesh":
        verts, faces, off = [], [], 0
        for m in meshes:
            verts.append(m.vertices)
            faces.append(m.faces + off)
            off += len(m.vertices)
        if not verts:
            return Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        return Mesh(np.concatenate(verts), np.concatenate(faces))

    def is_empty(self) -> bool:
        return len(self.faces) == 0


def slice_faces_plane(mesh: Mesh, plane_normal, plane_origin) -> Mesh:
    """Keep the part of the mesh on the positive side of the plane, clipping
    crossing triangles (Sutherland–Hodgman per face)."""
    n = np.asarray(plane_normal, np.float64)
    o = np.asarray(plane_origin, np.float64)
    d = (mesh.vertices - o) @ n          # signed distance per vertex
    keep_v = d >= 0
    out_faces = []
    out_verts = list(map(tuple, mesh.vertices))

    def vertex_id_cache():
        cache = {}

        def interp(a, b):
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            da, db = d[a], d[b]
            t = da / (da - db)
            p = mesh.vertices[a] + t * (mesh.vertices[b] - mesh.vertices[a])
            out_verts.append(tuple(p))
            idx = len(out_verts) - 1
            cache[key] = idx
            return idx

        return interp

    interp = vertex_id_cache()
    for f in mesh.faces:
        inside = [v for v in f if keep_v[v]]
        if len(inside) == 3:
            out_faces.append(list(f))
            continue
        if len(inside) == 0:
            continue
        # clip polygon against the half-space
        poly = []
        for i in range(3):
            a, b = f[i], f[(i + 1) % 3]
            if keep_v[a]:
                poly.append(a)
                if not keep_v[b]:
                    poly.append(interp(a, b))
            elif keep_v[b]:
                poly.append(interp(a, b))
        for i in range(1, len(poly) - 1):
            out_faces.append([poly[0], poly[i], poly[i + 1]])
    verts = np.array(out_verts).reshape(-1, 3)
    faces = np.array(out_faces, np.int64).reshape(-1, 3)
    # drop vertices no longer referenced (clipped-away corners)
    if len(faces):
        used = np.unique(faces)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        return Mesh(verts[used], remap[faces])
    return Mesh(np.zeros((0, 3)), faces)


def slice_mesh_box(mesh: Mesh, box_min, box_max) -> Mesh:
    """Crop a mesh to an axis-aligned box by slicing against its 6 planes."""
    m = mesh
    box_min = np.asarray(box_min, float)
    box_max = np.asarray(box_max, float)
    for axis in range(3):
        e = np.zeros(3)
        e[axis] = 1.0
        m = slice_faces_plane(m, e, box_min)
        m = slice_faces_plane(m, -e, box_max)
        if m.is_empty():
            break
    return m

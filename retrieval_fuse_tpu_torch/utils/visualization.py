"""Host-side visualization, as in the JAX package's utils/visualization.py:
SDF -> mesh OBJ, voxel boxes, point clouds, float grids and normals as
coloured points, and 3-panel preview renders.

  * marching cubes is the port's native C++ extractor (native/);
  * voxel-box meshes are written directly, one cube per cell;
  * `visualize_float_grid` colours with the port's own copy of matplotlib's
    `jet` segment data, looked up as matplotlib's 256-entry colormap does;
  * previews come from a small numpy z-buffer rasterizer, one 480 x 480
    panel per mesh, hstacked input | pred | gt, written as PNG by the
    standard library's zlib and struct (the JAX package writes JPEG through
    PIL; the pixels are the same, only the file format differs);
  * `trilinear_upsample_2x` runs in torch on the tensor's device.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from retrieval_fuse_tpu_torch.utils.misc import to_point_list

#: the image files render_visualizations_to_image writes
IMAGE_SUFFIX = ".png"


def visualize_sdf_as_mesh(sdf: np.ndarray, output_path, level: float = 0.75,
                          scale_factor: float = 1, method: str = "mc") -> None:
    """TSDF -> OBJ by the native isosurface extraction at `level`, vertices
    divided by `scale_factor`. method 'mc' (default): the classic
    lookup-table triangulation; 'tets': marching tetrahedra."""
    from retrieval_fuse_tpu_torch.native import export_obj, marching_cubes
    vertices, triangles = marching_cubes(np.asarray(sdf, dtype=np.float32), float(level),
                                         method=method)
    export_obj(vertices / scale_factor, triangles, output_path)


_BOX_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float32) - 0.5
_BOX_FACES = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                       [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                       [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], dtype=np.int32)


def _multibox_obj(centers: np.ndarray, output_path, pitch: float = 1.0) -> None:
    """One unit cube per center -> OBJ."""
    with open(output_path, "w") as f:
        for c in centers:
            for v in _BOX_VERTS * pitch + c:
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for i in range(len(centers)):
            base = i * 8 + 1
            for face in _BOX_FACES:
                f.write(f"f {base + face[0]} {base + face[1]} {base + face[2]}\n")


def visualize_sdf_as_voxels(sdf: np.ndarray, output_path, level: float = 0.5) -> None:
    """A cube for every cell with sdf <= level; no file when there is none."""
    point_list = to_point_list(np.asarray(sdf) <= level)
    if point_list.shape[0] > 0:
        _multibox_obj(point_list.astype(np.float32), output_path)


def visualize_grid_as_voxels(grid: np.ndarray, output_path) -> None:
    """A cube for every cell with grid > 0; no file when there is none."""
    point_list = to_point_list(np.asarray(grid) > 0)
    if point_list.shape[0] > 0:
        _multibox_obj(point_list.astype(np.float32), output_path)


def visualize_pointcloud(pointcloud: np.ndarray, output_path) -> None:
    with open(output_path, "w") as f:
        for p in pointcloud:
            f.write(f"v {p[0] + 0.5:.6f} {p[1] + 0.5:.6f} {p[2] + 0.5:.6f} 1 1 1\n")


#: matplotlib's `jet` (matplotlib/_cm.py): (x, y0, y1) segments per channel
JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
JET_N = 256


def _segment_lut(segments, n: int) -> np.ndarray:
    """The n-entry lookup table of one channel's (x, y0, y1) segments,
    linear between the breakpoints, as matplotlib's
    LinearSegmentedColormap builds it."""
    a = np.array(segments, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet(values) -> np.ndarray:
    """RGBA in [0, 1] of `values` (any shape -> shape + (4,)) under the jet
    colormap, as matplotlib's `cm.get_cmap("jet")(values)`: a value v takes
    entry int(v·256) of the table (v = 1 the last), below 0 the first,
    above 1 the last; NaN is transparent black."""
    lut = np.ones((JET_N, 4))
    for c, channel in enumerate(("red", "green", "blue")):
        lut[:, c] = _segment_lut(JET_SEGMENTS[channel], JET_N)
    v = np.asarray(values, dtype=float) * JET_N
    rgba = lut[np.clip(np.nan_to_num(v), 0, JET_N - 1).astype(int)]
    return np.where(np.isnan(v)[..., None], 0.0, rgba)


def visualize_float_grid(grid: np.ndarray, ignore_val: float, minval: float, maxval: float,
                         output_path) -> None:
    """Coloured point dump (jet, minval..maxval) of the cells above ignore_val."""
    norm_grid = (grid - minval) / (maxval - minval)
    coords = np.argwhere(grid > ignore_val)
    with open(output_path, "w") as f:
        for x, y, z in coords:
            c = (jet(norm_grid[x, y, z]) * 255).astype(np.uint8)
            f.write(f"v {x + 0.5} {y + 0.5} {z + 0.5} {c[0]} {c[1]} {c[2]}\n")


def visualize_normals(grid: np.ndarray, output_path) -> None:
    """Coloured point dump of the non-zero normals of a (3, D, H, W) grid in [-1, 1]."""
    g = ((grid * 0.5 + 0.5) * 255).astype(np.uint8)
    with open(output_path, "w") as f:
        for x in range(g.shape[1]):
            for y in range(g.shape[2]):
                for z in range(g.shape[3]):
                    c = g[:, x, y, z]
                    if c[0] != 127 or c[1] != 127 or c[2] != 127:
                        f.write(f"v {x + 0.5} {y + 0.5} {z + 0.5} {c[0]} {c[1]} {c[2]}\n")


def trilinear_upsample_2x(vol: torch.Tensor) -> torch.Tensor:
    """2x trilinear upsampling of a 3-D float tensor, on its device, with
    align-corners semantics: output i of an axis of n samples reads input
    i·(n-1)/(2n-1), a blend of its floor and the next sample. Used before
    marching cubes when fast visualisation is off."""
    out = vol.float()
    for axis in range(3):
        n = out.shape[axis]
        idx = torch.linspace(0.0, n - 1, 2 * n, dtype=torch.float32, device=vol.device)
        lo = torch.floor(idx).long()
        hi = torch.clamp(lo + 1, max=n - 1)
        shape = [1, 1, 1]
        shape[axis] = 2 * n
        w = (idx - lo).reshape(shape)
        out = out.index_select(axis, lo) * (1 - w) + out.index_select(axis, hi) * w
    return out


# ------------------------------------------------------------ soft rasterizer

def _load_obj(path):
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            faces.append([int(p.split("/")[0]) - 1 for p in line.split()[1:4]])
    return np.array(verts, np.float32), np.array(faces, np.int32)


def _render_mesh_panel(verts: np.ndarray, faces: np.ndarray, res: int = 480) -> np.ndarray:
    """Tiny z-buffer rasterizer with Lambert shading (fixed 3/4 view)."""
    img = np.full((res, res, 3), 255, np.uint8)
    if len(verts) == 0 or len(faces) == 0:
        return img
    # normalize to a unit box around the origin
    lo, hi = verts.min(0), verts.max(0)
    center, scale = (lo + hi) / 2, max((hi - lo).max(), 1e-6)
    v = (verts - center) / scale
    # rotate: -55 deg about x, then view down z
    ang = np.deg2rad(-55)
    rx = np.array([[1, 0, 0], [0, np.cos(ang), -np.sin(ang)], [0, np.sin(ang), np.cos(ang)]],
                  np.float32)
    v = v @ rx.T
    xy = ((v[:, :2] * 0.85 + 0.5) * (res - 1))
    z = v[:, 2]
    zbuf = np.full((res, res), -np.inf, np.float32)
    tri = v[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(n_norm, 1e-9)
    light = np.array([0.3, 0.5, 0.81], np.float32)
    shade = (np.abs(n @ light) * 0.75 + 0.25)
    order = np.argsort(tri[..., 2].mean(axis=1))
    for fi in order:
        f = faces[fi]
        p = xy[f]
        zm = z[f].mean()
        mn = np.floor(p.min(0)).astype(int)
        mx = np.ceil(p.max(0)).astype(int)
        mn = np.clip(mn, 0, res - 1)
        mx = np.clip(mx, 0, res - 1)
        if (mx - mn).max() > res // 2:  # degenerate huge triangle guard
            continue
        ys, xs = np.mgrid[mn[1]:mx[1] + 1, mn[0]:mx[0] + 1]
        pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
        d = p[1:] - p[0]
        det = d[0, 0] * d[1, 1] - d[0, 1] * d[1, 0]
        if abs(det) < 1e-9:
            continue
        rel = pts - p[0]
        u = (rel[:, 0] * d[1, 1] - rel[:, 1] * d[1, 0]) / det
        w_ = (rel[:, 1] * d[0, 0] - rel[:, 0] * d[0, 1]) / det
        inside = (u >= 0) & (w_ >= 0) & (u + w_ <= 1)
        if not inside.any():
            continue
        px = pts[inside].astype(int)
        gray = np.uint8(np.clip(shade[fi] * 255, 0, 255))
        better = zm > zbuf[px[:, 1], px[:, 0]]
        sel = px[better]
        zbuf[sel[:, 1], sel[:, 0]] = zm
        img[sel[:, 1], sel[:, 0]] = gray
    return img[::-1]


def write_png(path, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: one zlib stream of the
    rows, each after a filter byte 0."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got {img.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + chunk(b"IEND", b""))


def render_visualizations_to_image(mesh_dir, target_dir) -> None:
    """Per scene: render its _input/_pred/_gt OBJs into one hstacked PNG
    (<scene>.png); a panel that fails to render stays white, with a note
    on the console."""
    mesh_dir, target_dir = Path(mesh_dir), Path(target_dir)
    target_dir.mkdir(exist_ok=True, parents=True)
    scene_names = sorted(set("_".join(x.name.split("_")[:-1])
                             for x in mesh_dir.iterdir() if x.name.endswith(".obj")))
    for scene_name in scene_names:
        panels = []
        for suffix in ["_input.obj", "_pred.obj", "_gt.obj"]:
            try:
                verts, faces = _load_obj(mesh_dir / (scene_name + suffix))
                panels.append(_render_mesh_panel(verts, faces))
            except (OSError, ValueError, IndexError) as e:
                print("[render_visualizations_to_image]:", e)
                panels.append(255 * np.ones((480, 480, 3), np.uint8))
        write_png(target_dir / (scene_name + IMAGE_SUFFIX), np.hstack(panels))

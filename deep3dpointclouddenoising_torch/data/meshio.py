"""Mesh and point-cloud IO and geometry (numpy + scipy).

A copy of what the port needs from
``deep3dpointclouddenoising_tpu/data/meshio.py``: OFF reading and writing,
binary PLY writing, ascii and binary PLY reading, area-weighted and even
surface sampling, and the closest point on a triangle mesh.  Same
arithmetic and the same draws from the generator that is passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree


# --------------------------------------------------------------------------
# Mesh container + OFF IO
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int64

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.faces.copy())

    @property
    def triangles(self) -> np.ndarray:  # (F, 3, 3)
        return self.vertices[self.faces]

    def face_areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)


def load_off(path: str) -> TriMesh:
    """Parse an OFF file (the PCN shape format)."""
    with open(path) as f:
        tokens: List[str] = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if tokens[0].startswith("OFF"):
        rest = tokens[0][3:]
        tokens = ([rest] if rest else []) + tokens[1:]
    nv, nf = int(tokens[0]), int(tokens[1])
    it = iter(tokens[3:])
    verts = np.array([[float(next(it)) for _ in range(3)] for _ in range(nv)])
    faces = []
    for _ in range(nf):
        k = int(next(it))
        poly = [int(next(it)) for _ in range(k)]
        for i in range(1, k - 1):  # fan-triangulate
            faces.append([poly[0], poly[i], poly[i + 1]])
    return TriMesh(verts, np.asarray(faces, dtype=np.int64))


def save_off(path: str, mesh: TriMesh) -> None:
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(mesh.vertices)} {len(mesh.faces)} 0\n")
        for v in mesh.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


# --------------------------------------------------------------------------
# PLY IO (binary little-endian write; ascii and binary read)
# --------------------------------------------------------------------------
def write_ply(path: str, arrays: Sequence[np.ndarray],
              names: Sequence[str]) -> None:
    """Write a PLY of per-vertex properties.

    ``names`` pairs with ``arrays``; the name 'vertex' denotes the (N,3) xyz
    array, every other entry is a scalar (N,) property.
    """
    arrays = [np.asarray(a) for a in arrays]
    n = len(arrays[names.index("vertex")])
    props: List[Tuple[str, np.ndarray]] = []
    for name, arr in zip(names, arrays):
        if name == "vertex":
            xyz = arr.astype("<f4")
            props = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2])] \
                + props
        else:
            if arr.ndim > 1:
                arr = arr.reshape(n, -1)
                for i in range(arr.shape[1]):
                    props.append((f"{name}_{i}", arr[:, i].astype("<f4")))
            else:
                props.append((name, arr.astype("<f4")))
    dtype = np.dtype([(p, "<f4") for p, _ in props])
    rec = np.empty(n, dtype=dtype)
    for p, col in props:
        rec[p] = col
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for p, _ in props:
            f.write(f"property float {p}\n".encode())
        f.write(b"end_header\n")
        rec.tofile(f)


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "ushort": "<u2", "char": "<i1", "uchar": "<u1",
    "int8": "<i1", "uint8": "<u1", "int16": "<i2", "uint16": "<u2",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read per-vertex properties from an ascii or binary_little_endian PLY.

    Returns a dict of property name -> (N,) array, plus 'vertex' -> (N, 3)
    when x/y/z are present.
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        props: List[Tuple[str, str]] = []
        n = 0
        in_vertex = False
        for line in header:
            parts = line.split()
            if parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], _PLY_TYPES[parts[1]]))
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n).reshape(n, len(props))
            out = {p: data[:, i].astype(np.float32)
                   for i, (p, _) in enumerate(props)}
        else:
            dtype = np.dtype([(p, t) for p, t in props])
            rec = np.fromfile(f, dtype=dtype, count=n)
            out = {p: np.asarray(rec[p]) for p, _ in props}
    if all(k in out for k in ("x", "y", "z")):
        out["vertex"] = np.stack(
            [out["x"], out["y"], out["z"]], axis=1).astype(np.float32)
    return out


# --------------------------------------------------------------------------
# Surface sampling
# --------------------------------------------------------------------------
def sample_surface(mesh: TriMesh, count: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform surface sampling -> (points (N,3), face ids)."""
    rng = rng or np.random.default_rng()
    areas = mesh.face_areas()
    probs = areas / areas.sum()
    fids = rng.choice(len(areas), size=count, p=probs)
    t = mesh.triangles[fids]
    # uniform barycentric coordinates
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    pts = (1 - r1)[:, None] * t[:, 0] + (r1 * (1 - r2))[:, None] * t[:, 1] \
        + (r1 * r2)[:, None] * t[:, 2]
    return pts, fids


def sample_surface_even(mesh: TriMesh, count: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Approximately even (blue-noise) surface sampling.

    Oversamples area-weighted, then thins points closer than the expected
    spacing radius, then tops up with plain samples.
    """
    rng = rng or np.random.default_rng()
    pts, fids = sample_surface(mesh, count * 3, rng)
    area = mesh.face_areas().sum()
    radius = np.sqrt(area / (np.pi * count)) * 0.7
    tree = cKDTree(pts)
    keep = np.ones(len(pts), dtype=bool)
    for i, neighbors in enumerate(tree.query_ball_point(pts, radius)):
        if keep[i]:
            for j in neighbors:
                if j != i:
                    keep[j] = False
    kept = np.nonzero(keep)[0]
    if len(kept) >= count:
        kept = kept[:count]
        return pts[kept], fids[kept]
    extra_pts, extra_fids = sample_surface(mesh, count - len(kept), rng)
    return (np.concatenate([pts[kept], extra_pts]),
            np.concatenate([fids[kept], extra_fids]))


# --------------------------------------------------------------------------
# Closest point on mesh
# --------------------------------------------------------------------------
def _closest_point_triangles(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Vectorized closest point on triangles.

    p: (N, 3) query points, tri: (N, K, 3, 3) candidate triangles per query.
    Returns (N, K, 3) closest points.  Standard barycentric region test
    (Ericson, Real-Time Collision Detection, ch. 5.1.5).
    """
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    p = p[:, None, :]
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_bc = (d4 - d3) + (d5 - d6)
    w_bc = np.where(np.abs(denom_bc) > 1e-30, (d4 - d3) / denom_bc, 0.0)

    denom = va + vb + vc
    v = np.where(np.abs(denom) > 1e-30, vb / denom, 0.0)
    w = np.where(np.abs(denom) > 1e-30, vc / denom, 0.0)
    inner = a + v[..., None] * ab + w[..., None] * ac

    t_ab = np.where(np.abs(d1 - d3) > 1e-30, d1 / (d1 - d3 + 1e-30), 0.0)
    t_ab = np.clip(t_ab, 0.0, 1.0)
    t_ac = np.where(np.abs(d2 - d6) > 1e-30, d2 / (d2 - d6 + 1e-30), 0.0)
    t_ac = np.clip(t_ac, 0.0, 1.0)
    w_bc = np.clip(w_bc, 0.0, 1.0)

    out = inner
    # edge BC region
    cond_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    out = np.where(cond_bc[..., None], b + w_bc[..., None] * (c - b), out)
    # edge AC region
    cond_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = np.where(cond_ac[..., None], a + t_ac[..., None] * ac, out)
    # edge AB region
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = np.where(cond_ab[..., None], a + t_ab[..., None] * ab, out)
    # vertex regions
    cond_c = (d6 >= 0) & (d5 <= d6)
    out = np.where(cond_c[..., None], c, out)
    cond_b = (d3 >= 0) & (d4 <= d3)
    out = np.where(cond_b[..., None], b, out)
    cond_a = (d1 <= 0) & (d2 <= 0)
    out = np.where(cond_a[..., None], a, out)
    return out


def closest_point_on_mesh(mesh: TriMesh, points: np.ndarray,
                          k_candidates: int = 16,
                          batch: int = 20000
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Closest surface point (and distance) for each query point.

    A KD-tree over triangle centroids prefilters ``k_candidates`` triangles
    per query and the exact point-triangle projection runs vectorized over
    (batch, k).  Exact as long as the true nearest triangle is among the k
    nearest by centroid.
    """
    tri = mesh.triangles.astype(np.float64)
    centroids = tri.mean(axis=1)
    k = min(k_candidates, len(tri))
    tree = cKDTree(centroids)
    points = np.asarray(points, dtype=np.float64)
    closest = np.empty_like(points)
    dists = np.empty(len(points))
    for s in range(0, len(points), batch):
        p = points[s:s + batch]
        _, cand = tree.query(p, k=k)
        cand = cand.reshape(len(p), k)
        cp = _closest_point_triangles(p, tri[cand])
        d2 = np.sum((cp - p[:, None, :]) ** 2, axis=-1)
        best = np.argmin(d2, axis=1)
        rows = np.arange(len(p))
        closest[s:s + batch] = cp[rows, best]
        dists[s:s + batch] = np.sqrt(d2[rows, best])
    return closest, dists

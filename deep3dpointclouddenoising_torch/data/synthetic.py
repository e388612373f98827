"""Procedural test meshes: spheres, ellipsoids, boxes, cylinders and tori
with enough triangles that closest-point queries behave as on densely
triangulated shapes.

A copy of ``deep3dpointclouddenoising_tpu/data/synthetic.py``.
"""
from __future__ import annotations

import numpy as np

from .meshio import TriMesh


def make_icosphere(subdivisions: int = 3, radius: float = 1.0) -> TriMesh:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = (verts_list[i] + verts_list[j]) / 2.0
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return TriMesh(verts * radius, faces)


def make_ellipsoid(subdivisions: int = 3,
                   radii=(1.0, 0.7, 0.45)) -> TriMesh:
    """Anisotropically scaled icosphere."""
    m = make_icosphere(subdivisions)
    return TriMesh(m.vertices * np.asarray(radii)[None, :], m.faces)


def make_box(n: int = 8, size=(1.0, 0.8, 0.6)) -> TriMesh:
    """Axis-aligned box with each face triangulated on an n x n grid."""
    sx, sy, sz = size
    verts = []
    faces = []

    def add_face(origin, eu, ev):
        base = len(verts)
        for i in range(n + 1):
            for j in range(n + 1):
                verts.append(origin + eu * (i / n) + ev * (j / n))
        for i in range(n):
            for j in range(n):
                a = base + i * (n + 1) + j
                b = a + (n + 1)
                faces.append([a, b, b + 1])
                faces.append([a, b + 1, a + 1])

    o = np.array([-sx, -sy, -sz])
    ex, ey, ez = (np.array([2 * sx, 0, 0]), np.array([0, 2 * sy, 0]),
                  np.array([0, 0, 2 * sz]))
    add_face(o, ex, ey)                 # bottom (z = -sz)
    add_face(o + ez, ey, ex)            # top
    add_face(o, ey, ez)                 # x = -sx
    add_face(o + ex, ez, ey)            # x = +sx
    add_face(o, ez, ex)                 # y = -sy
    add_face(o + ey, ex, ez)            # y = +sy
    return TriMesh(np.asarray(verts, np.float64),
                   np.asarray(faces, np.int64))


def make_cylinder(n_seg: int = 48, n_height: int = 16, radius: float = 0.5,
                  height: float = 2.0, n_cap: int = 6) -> TriMesh:
    """Closed cylinder: triangulated side wall + fan-ring caps."""
    us = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    verts = []
    for h in np.linspace(-height / 2, height / 2, n_height + 1):
        for u in us:
            verts.append([radius * np.cos(u), radius * np.sin(u), h])
    faces = []
    for i in range(n_height):
        for j in range(n_seg):
            a = i * n_seg + j
            b = i * n_seg + (j + 1) % n_seg
            c = (i + 1) * n_seg + (j + 1) % n_seg
            d = (i + 1) * n_seg + j
            faces += [[a, b, c], [a, c, d]]
    # caps: concentric rings down to a center vertex
    for sign, ring0 in ((-1.0, 0), (1.0, n_height * n_seg)):
        prev = list(range(ring0, ring0 + n_seg))
        z = sign * height / 2
        for r_i in range(1, n_cap):
            r = radius * (1.0 - r_i / n_cap)
            base = len(verts)
            for u in us:
                verts.append([r * np.cos(u), r * np.sin(u), z])
            cur = list(range(base, base + n_seg))
            for j in range(n_seg):
                a, b = prev[j], prev[(j + 1) % n_seg]
                c, d = cur[(j + 1) % n_seg], cur[j]
                faces += [[a, b, c], [a, c, d]] if sign > 0 else \
                    [[a, c, b], [a, d, c]]
            prev = cur
        center = len(verts)
        verts.append([0.0, 0.0, z])
        for j in range(n_seg):
            a, b = prev[j], prev[(j + 1) % n_seg]
            faces.append([a, b, center] if sign > 0 else [a, center, b])
    return TriMesh(np.asarray(verts, np.float64),
                   np.asarray(faces, np.int64))


def make_torus(major: float = 1.0, minor: float = 0.35,
               n_major: int = 48, n_minor: int = 24) -> TriMesh:
    us = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    verts = []
    for u in us:
        for v in vs:
            verts.append([(major + minor * np.cos(v)) * np.cos(u),
                          (major + minor * np.cos(v)) * np.sin(u),
                          minor * np.sin(v)])
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = ((i + 1) % n_major) * n_minor + j
            c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            d = i * n_minor + (j + 1) % n_minor
            faces += [[a, b, c], [a, c, d]]
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int64))

"""Procedural test meshes: an icosphere and a torus with enough triangles
that closest-point queries behave as on densely triangulated shapes.

A copy of ``make_icosphere`` and ``make_torus`` from
``deep3dpointclouddenoising_tpu/data/synthetic.py``.
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

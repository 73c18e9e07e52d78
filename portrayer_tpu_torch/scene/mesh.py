"""Triangle meshes and OBJ loading (counterpart of
``portrayer_tpu/scene/mesh.py``, src/primitive/mesh.rs).

``MeshData`` is SoA (positions, normals, tex_coords, triangle index
triples) with its AABB (mesh.rs:63-88); ``load_obj`` reads the first model
of an OBJ file (mesh.rs:57-61) with the JAX package's pure-Python parser:
face corners with distinct v/vt/vn triples become single indices, negative
indices count from the end, polygons are fan-triangulated.  ``Mesh`` pairs
shared data with a shading mode; ``KDMesh`` is the same class (the
reference's kd-tree mesh has identical output, kdmesh.rs:99-166).
"""

from __future__ import annotations

import enum

import numpy as np


class Shading(enum.Enum):
    Flat = 0
    Smooth = 1


class MeshData:
    def __init__(self, positions, triangles, normals=None, tex_coords=None):
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
        self.triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
        self.normals = (np.asarray(normals, dtype=np.float64).reshape(-1, 3)
                        if normals is not None and len(normals) else np.zeros((0, 3)))
        self.tex_coords = (np.asarray(tex_coords, dtype=np.float64).reshape(-1, 2)
                           if tex_coords is not None and len(tex_coords) else np.zeros((0, 2)))
        assert len(self.positions) > 0, "Meshes must have at least one vertex"
        if len(self.tex_coords) and len(self.tex_coords) != len(self.positions):
            raise ValueError(
                "If meshes have texture coordinates, they must have enough for all vertices")
        self.bounds_min = self.positions.min(axis=0)
        self.bounds_max = self.positions.max(axis=0)

    @classmethod
    def load_obj(cls, path) -> "MeshData":
        """The first model of the OBJ file at `path`."""
        positions, tex_coords, normals = [], [], []
        # Unified vertex stream: one index per unique v/vt/vn triple.
        out_pos, out_uv, out_norm = [], [], []
        index_of = {}
        faces = []
        with open(path, "r") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                tag = parts[0]
                if tag == "v":
                    positions.append([float(x) for x in parts[1:4]])
                elif tag == "vt":
                    tex_coords.append([float(x) for x in parts[1:3]])
                elif tag == "vn":
                    normals.append([float(x) for x in parts[1:4]])
                elif tag == "f":
                    corner_ids = []
                    for corner in parts[1:]:
                        if corner not in index_of:
                            fields = corner.split("/")
                            vi = int(fields[0])
                            vi = vi - 1 if vi > 0 else len(positions) + vi
                            ti = ni = None
                            if len(fields) > 1 and fields[1]:
                                ti = int(fields[1])
                                ti = ti - 1 if ti > 0 else len(tex_coords) + ti
                            if len(fields) > 2 and fields[2]:
                                ni = int(fields[2])
                                ni = ni - 1 if ni > 0 else len(normals) + ni
                            index_of[corner] = len(out_pos)
                            out_pos.append(positions[vi])
                            out_uv.append(tex_coords[ti] if ti is not None else None)
                            out_norm.append(normals[ni] if ni is not None else None)
                        corner_ids.append(index_of[corner])
                    for k in range(1, len(corner_ids) - 1):  # fan triangulation
                        faces.append((corner_ids[0], corner_ids[k], corner_ids[k + 1]))
                elif tag in ("o", "g") and faces:
                    break  # first model only (mesh.rs:57-61)
        has_uv = len(out_uv) > 0 and all(uv is not None for uv in out_uv)
        has_norm = len(out_norm) > 0 and all(n is not None for n in out_norm)
        return cls(positions=out_pos, triangles=faces,
                   normals=out_norm if has_norm else None,
                   tex_coords=out_uv if has_uv else None)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class Mesh:
    """A mesh primitive: shared MeshData + shading mode (mesh.rs:118-144)."""

    def __init__(self, data: MeshData, shading: Shading = Shading.Flat):
        if shading == Shading.Smooth and len(data.normals) != len(data.positions):
            raise ValueError(
                "Meshes must have a vertex normal for each vertex for smooth shading")
        self.data = data
        self.shading = shading

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


KDMesh = Mesh


class Triangle:
    """A standalone triangle primitive (src/primitive/triangle.rs:8-27)."""

    def __init__(self, a, b, c, normals=None, tex_coords=None):
        self.a = np.asarray(a, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.c = np.asarray(c, dtype=np.float64)
        self.normals = (tuple(np.asarray(n, dtype=np.float64) for n in normals)
                        if normals is not None else None)
        self.tex_coords = (tuple(np.asarray(t, dtype=np.float64) for t in tex_coords)
                           if tex_coords is not None else None)

    @classmethod
    def flat(cls, a, b, c) -> "Triangle":
        return cls(a, b, c)

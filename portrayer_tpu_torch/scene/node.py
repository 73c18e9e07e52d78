"""Hierarchical scene graph (counterpart of ``portrayer_tpu/scene/node.py``).

``Scene {root, lights, ambient}``; ``SceneNode`` with an affine transform,
optional ``Geometry {primitive, material}`` and shared (instanced)
children; the builders ``scaled / translated / rotated_x|y|z|xzy`` compose
in world space (left-multiply, src/scene.rs:163-199).  Scenes are
descriptions: ``scene.flatten`` lowers them to device tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from .. import math3d as m3
from .material import Material
from .light import Light
from .mesh import Mesh, Triangle


class _MarkerPrimitive:
    """Unit primitives (transformed via the owning node)."""

    def __repr__(self):
        return type(self).__name__


class Sphere(_MarkerPrimitive):
    """Unit sphere at origin, radius 1 (src/primitive/sphere.rs)."""


class Cube(_MarkerPrimitive):
    """Axis-aligned unit cube at origin (src/primitive/cube.rs)."""


class Plane(_MarkerPrimitive):
    """Unit XZ square at y=0, normal +y (src/primitive/plane.rs)."""


class Cylinder(_MarkerPrimitive):
    """r=0.5, h=1, y-axis (src/primitive/cylinder.rs)."""


class Cone(_MarkerPrimitive):
    """r=0.5, h=1, apex up (src/primitive/cone.rs)."""


class Torus:
    """Donut centered at origin, y-axis through the hole."""

    def __init__(self, center_radius: float = 1.0, tube_radius: float = 0.25):
        self.center_radius = float(center_radius)
        self.tube_radius = float(tube_radius)

    def __repr__(self):
        return f"Torus({self.center_radius}, {self.tube_radius})"


Primitive = Union[Sphere, Cube, Plane, Cylinder, Cone, Torus, Mesh, Triangle]


class Geometry:
    def __init__(self, primitive: Primitive, material: Material):
        if isinstance(primitive, type):
            primitive = primitive()
        self.primitive = primitive
        self.material = material


class SceneNode:
    def __init__(
        self,
        source: Union[Geometry, "SceneNode", Sequence["SceneNode"], None] = None,
    ):
        self.geometry: Optional[Geometry] = None
        self.children: List[SceneNode] = []
        self.trans = m3.identity4()
        if source is None:
            pass
        elif isinstance(source, Geometry):
            self.geometry = source
        elif isinstance(source, SceneNode):
            self.children = [source]
        else:
            self.children = list(source)

    def with_child(self, child: "SceneNode") -> "SceneNode":
        self.children.append(child)
        return self

    def with_children(self, children) -> "SceneNode":
        self.children.extend(children)
        return self

    def scaled(self, scale) -> "SceneNode":
        self.trans = m3.scaling(scale) @ self.trans
        return self

    def translated(self, translation) -> "SceneNode":
        self.trans = m3.translation(translation) @ self.trans
        return self

    def rotated_x(self, angle: float) -> "SceneNode":
        self.trans = m3.rotation_x(angle) @ self.trans
        return self

    def rotated_y(self, angle: float) -> "SceneNode":
        self.trans = m3.rotation_y(angle) @ self.trans
        return self

    def rotated_z(self, angle: float) -> "SceneNode":
        self.trans = m3.rotation_z(angle) @ self.trans
        return self

    def rotated_xzy(self, angles) -> "SceneNode":
        x, y, z = angles
        return self.rotated_x(x).rotated_z(z).rotated_y(y)

    def set_transform(self, transform: np.ndarray) -> "SceneNode":
        self.trans = np.asarray(transform, dtype=np.float64).reshape(4, 4)
        return self


class Scene:
    """HierScene equivalent (src/scene.rs:11-18)."""

    def __init__(self, root: SceneNode, lights: Sequence[Light], ambient):
        self.root = root
        self.lights = list(lights)
        ambient = np.asarray(ambient, dtype=np.float64)
        if ambient.ndim == 0:
            ambient = np.full(3, float(ambient))
        self.ambient = ambient

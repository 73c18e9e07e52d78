"""The scenes of this slice (counterparts of ``scenes/common.py``,
``scenes/simple.py`` and ``scenes/big_scene.py``), built from the port's
own description classes, so that nothing here needs JAX."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from .camera import CameraSettings
from .math3d import radians
from .scene import Scene, SceneNode, Geometry, Sphere, Cube, Cone, Cylinder, Material, Light


@dataclasses.dataclass
class SceneSpec:
    scene: Scene
    camera: CameraSettings
    size: Tuple[int, int]          # (width, height)
    background: Callable
    name: str


def sky_background(uv):
    """The gradient used by most examples: (0.2,0.4,0.6)*(1-v) + blue*v."""
    v = uv[..., 1:2]
    top = torch.tensor([0.2, 0.4, 0.6], dtype=uv.dtype, device=uv.device)
    blue = torch.tensor([0.0, 0.0, 1.0], dtype=uv.dtype, device=uv.device)
    return top * (1.0 - v) + blue * v


deg = radians


def simple() -> SceneSpec:
    """examples/simple.rs: five spheres, two point lights."""
    mat1 = Material(diffuse=(0.7, 1.0, 0.7), specular=(0.5, 0.7, 0.5), shininess=25.0)
    mat2 = Material(diffuse=(0.5, 0.5, 0.5), specular=(0.5, 0.7, 0.5), shininess=25.0)
    mat3 = Material(diffuse=(1.0, 0.6, 0.1), specular=(0.5, 0.7, 0.5), shininess=25.0)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Sphere(), mat1)).scaled(100.0).translated((0.0, 0.0, -400.0)),
            SceneNode(Geometry(Sphere(), mat1)).scaled(150.0).translated((200.0, 50.0, -100.0)),
            SceneNode(Geometry(Sphere(), mat2)).scaled(1000.0).translated((0.0, -1200.0, -500.0)),
            SceneNode(Geometry(Sphere(), mat3)).scaled(50.0).translated((-100.0, 25.0, -300.0)),
            SceneNode(Geometry(Sphere(), mat1)).scaled(25.0).translated((0.0, 100.0, -250.0)),
        ]),
        lights=[
            Light(position=(-100.0, 150.0, 400.0), color=(0.9, 0.9, 0.9)),
            Light(position=(400.0, 100.0, 150.0), color=(0.7, 0.0, 0.7)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.0, 0.0, 800.0), center=(0.0, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=deg(50.0))
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="simple")


def big_scene(n: int = 10) -> SceneSpec:
    """examples/big-scene.rs: n^3 random primitives in a cube lattice,
    drawn from the same numpy stream in the same order as the JAX
    package's scene."""
    rng = np.random.RandomState(1234939301 % (2**31))
    materials = [
        Material(diffuse=(rng.rand(), rng.rand(), rng.rand()),
                 specular=(0.3, 0.3, 0.3), shininess=25.0)
        for _ in range(15)
    ]
    prims = [Sphere, Cube, Cone, Cylinder]
    width = length = height = 800.0
    nodes = []
    for i in range(n):
        x = i / (n - 1) * width - width / 2.0
        for j in range(n):
            y = j / (n - 1) * length - length / 2.0
            for k in range(n):
                z = k / (n - 1) * height - height / 2.0
                prim = prims[rng.randint(len(prims))]()
                mat = materials[rng.randint(len(materials))]
                angle = deg(360.0 * rng.rand())
                nodes.append(
                    SceneNode(Geometry(prim, mat))
                    .scaled(30.0 * rng.rand() + 30.0)
                    .rotated_xzy((angle, angle, angle))
                    .translated((x, y + rng.rand() * 50.0, z))
                )
    scene = Scene(
        root=SceneNode(nodes),
        lights=[
            Light(position=(-100.0, 150.0, 400.0), color=(0.9, 0.9, 0.9)),
            Light(position=(100.0, -150.0, 800.0), color=(0.7, 0.7, 0.7)),
            Light(position=(400.0, 100.0, 150.0), color=(0.7, 0.0, 0.7)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.0, 0.0, 1200.0), center=(0.0, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=deg(50.0))
    return SceneSpec(scene=scene, camera=cam, size=(1980, 1020),
                     background=sky_background, name="big-scene")


_REGISTRY = {"simple": simple, "big-scene": big_scene}


def load(name: str) -> SceneSpec:
    return _REGISTRY[name]()

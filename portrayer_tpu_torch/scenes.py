"""The port's scenes (counterparts of ``scenes/common.py``,
``scenes/simple.py``, ``scenes/big_scene.py``, ``scenes/torus_showcase.py``,
``scenes/glossy_reflection.py``, ``scenes/primitives_simple.py``,
``scenes/single_triangle.py`` and ``scenes/four_shapes.py``), built
from the port's own description classes, so that nothing here needs JAX."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .camera import CameraSettings
from .math3d import radians
from .ops.intersect import _vec
from .scene import (
    Scene, SceneNode, Geometry, Sphere, Cube, Cone, Cylinder, Plane, Torus, Triangle, Material,
    Light,
)


@dataclasses.dataclass
class SceneSpec:
    scene: Scene
    camera: CameraSettings
    size: Tuple[int, int]          # (width, height)
    background: Callable
    name: str
    # Per-round bounce-queue capacity hint (RenderConfig.queue_caps); None
    # = auto.
    queue_caps: Optional[Tuple[float, ...]] = None


def sky_background(uv):
    """The gradient used by most examples: (0.2,0.4,0.6)*(1-v) + blue*v."""
    v = uv[..., 1:2]
    # Constants filled on the device: a render captures this in a CUDA
    # graph, which cannot hold a copy from the host.
    top, blue = _vec((0.2, 0.4, 0.6), uv), _vec((0.0, 0.0, 1.0), uv)
    return top * (1.0 - v) + blue * v


def white_background(uv):
    return torch.ones(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)


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


def torus_showcase() -> SceneSpec:
    """Three tori (one a 25% mirror), a sphere and a floor plane; not an
    example of the reference, whose torus is unregistered."""
    gold = Material(diffuse=(0.9, 0.7, 0.2), specular=(0.8, 0.8, 0.6), shininess=40.0)
    teal = Material(diffuse=(0.1, 0.7, 0.7), specular=(0.6, 0.8, 0.8), shininess=30.0,
                    reflectivity=0.25)
    rose = Material(diffuse=(0.9, 0.3, 0.4), specular=(0.7, 0.5, 0.5), shininess=25.0)
    floor = Material(diffuse=(0.4, 0.4, 0.45), specular=(0.2, 0.2, 0.2), shininess=10.0)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Torus(1.0, 0.3), gold)).scaled(3.0).translated((0.0, 0.9, 0.0)),
            SceneNode(Geometry(Torus(1.0, 0.22), teal))
            .scaled(2.2).rotated_x(deg(90.0)).translated((0.0, 2.6, 0.0)),
            SceneNode(Geometry(Torus(0.8, 0.35), rose))
            .scaled(1.6).rotated_z(deg(30.0)).translated((-4.5, 1.4, 1.5)),
            SceneNode(Geometry(Sphere(), gold)).scaled(0.9).translated((0.0, 0.9, 0.0)),
            SceneNode(Geometry(Plane(), floor)).scaled(40.0),
        ]),
        lights=[
            Light(position=(-6.0, 10.0, 9.0), color=(0.9, 0.9, 0.9)),
            Light(position=(8.0, 6.0, 6.0), color=(0.3, 0.3, 0.4)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.0, 4.0, 11.0), center=(-0.5, 1.4, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=deg(45.0))
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="torus-showcase")


def glossy_reflection() -> SceneSpec:
    """examples/glossy-reflection.rs: a plain and a glossy mirror sphere on
    a table (a cube scaled (10, 0.6, 5), packed as an axis-aligned box)."""
    non_glossy = Material(diffuse=(0.146505, 0.314666, 0.170564), specular=(0.3, 0.3, 0.3),
                          shininess=100.0, reflectivity=0.4)
    glossy = Material(diffuse=(0.146505, 0.314666, 0.170564), specular=(0.3, 0.3, 0.3),
                      shininess=100.0, reflectivity=0.4, glossy_side_length=2.0)
    center = Material(diffuse=(0.8, 0.0, 0.023362), specular=(0.3, 0.3, 0.3), shininess=25.0)
    table = Material(diffuse=(1.0, 0.6, 0.1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Sphere(), non_glossy)).translated((-1.1, 1.3, 0.0)),
            SceneNode(Geometry(Sphere(), glossy)).translated((1.1, 1.3, 0.0)),
            SceneNode(Geometry(Sphere(), center)).scaled(0.5).translated((0.0, 0.8, 1.8)),
            SceneNode(Geometry(Cube(), table)).scaled((10.0, 0.6, 5.0)),
        ]),
        lights=[
            Light(position=(0.0, 6.0, 3.0), color=(0.9, 0.9, 0.9)),
            Light(position=(0.0, 1.0, 12.0), color=(0.7, 0.7, 0.7)),
        ],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.0, 2.562834, 8.863271), center=(0.0, -1.083779, -11.817695),
                         up=(0.0, 1.0, 0.0), fovy=deg(20.0))
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="glossy-reflection")


def primitives_simple() -> SceneSpec:
    """examples/primitives-simple.rs: a cylinder, a cone and a floor plane."""
    mat_grass = Material(diffuse=(0.173224, 0.8, 0.226505))
    mat_cylinder = Material(diffuse=(0.139339, 0.435762, 0.8), specular=(0.3, 0.3, 0.3),
                            shininess=25.0)
    mat_cone = Material(diffuse=(0.8, 0.047361, 0.04305), specular=(0.3, 0.3, 0.3),
                        shininess=25.0)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Cylinder(), mat_cylinder)).scaled(2.0).translated((-2.0, 1.0, 0.0)),
            SceneNode(Geometry(Cone(), mat_cone)).scaled(2.0).translated((2.0, 1.0, 0.0)),
            SceneNode(Geometry(Plane(), mat_grass)).scaled(10.0),
        ]),
        lights=[Light(position=(0.0, 10.0, 9.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.760838, 8.095396, 10.50759),
                         center=(-0.41716, -3.477774, -5.761218),
                         up=(0.0, 1.0, 0.0), fovy=deg(25.0))
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="primitives-simple")


def single_triangle() -> SceneSpec:
    """examples/single-triangle.rs: one flat triangle."""
    mat1 = Material(diffuse=(0.541, 0.169, 0.886), specular=(0.5, 0.7, 0.5), shininess=25.0)
    tri = Triangle.flat((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.5, 0.0))
    scene = Scene(
        root=SceneNode([SceneNode(Geometry(tri, mat1))]),
        lights=[Light(position=(1.0, 1.0, 10.0), color=(0.5, 0.5, 0.5))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(eye=(0.0, 0.5, 4.0), center=(0.0, 0.5, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=deg(50.0))
    return SceneSpec(scene=scene, camera=cam, size=(640, 480),
                     background=sky_background, name="single-triangle")


def four_shapes() -> SceneSpec:
    """examples/four-shapes.rs: a sphere, a cube, a cone and a cylinder on
    a white background."""
    base = dict(specular=(0.3, 0.3, 0.3), shininess=100.0)
    mat_sphere = Material(diffuse=(0.8, 0.0, 0.0), **base)
    mat_cube = Material(diffuse=(0.0, 0.158481, 0.8), **base)
    mat_cone = Material(diffuse=(0.064785, 0.8, 0.174433), **base)
    mat_cylinder = Material(diffuse=(0.127564, 0.016029, 0.8), **base)
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Sphere(), mat_sphere)).translated((-4.0, 0.0, 0.0)),
            SceneNode(Geometry(Cube(), mat_cube)).scaled(1.6)
            .rotated_y(deg(-17.5411)).translated((-1.1, 0.0, 0.0)),
            SceneNode(Geometry(Cone(), mat_cone)).scaled(1.8).translated((1.5, 0.2, 0.0)),
            SceneNode(Geometry(Cylinder(), mat_cylinder)).scaled(1.6).translated((4.0, 0.0, 0.0)),
        ]),
        lights=[Light(position=(0.0, 3.0, 11.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.1, 0.1, 0.1),
    )
    cam = CameraSettings(eye=(0.0, 6.473007, 15.607252), center=(0.0, -2.181935, -5.702181),
                         up=(0.0, 1.0, 0.0), fovy=deg(10.0))
    return SceneSpec(scene=scene, camera=cam, size=(1920, 512),
                     background=white_background, name="four-shapes")


_REGISTRY = {
    "simple": simple, "big-scene": big_scene, "torus-showcase": torus_showcase,
    "glossy-reflection": glossy_reflection, "primitives-simple": primitives_simple,
    "single-triangle": single_triangle, "four-shapes": four_shapes,
}


def names():
    return list(_REGISTRY)


def load(name: str) -> SceneSpec:
    return _REGISTRY[name]()

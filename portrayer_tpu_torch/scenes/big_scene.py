"""examples/big-scene.rs (``scenes/big_scene.py``): n^3 random primitives in a cube lattice,
drawn from the same numpy stream in the same order as the JAX
package's scene."""

import numpy as np

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Cone, Cylinder, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg


def build(n: int = 10) -> SceneSpec:
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

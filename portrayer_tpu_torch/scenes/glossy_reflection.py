"""examples/glossy-reflection.rs (``scenes/glossy_reflection.py``):
a plain and a glossy mirror sphere on
a table (a cube scaled (10, 0.6, 5), packed as an axis-aligned box)."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg


def build() -> SceneSpec:
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

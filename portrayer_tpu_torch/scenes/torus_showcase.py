"""``scenes/torus_showcase.py``: Three tori (one a 25% mirror), a sphere and a floor plane; not an
example of the reference, whose torus is unregistered."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Plane, Torus, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg


def build() -> SceneSpec:
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

"""examples/primitives-simple.rs (``scenes/primitives_simple.py``):
a cylinder, a cone and a floor plane."""

from .. import (
    Scene, SceneNode, Geometry, Cylinder, Cone, Plane, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg


def build() -> SceneSpec:
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

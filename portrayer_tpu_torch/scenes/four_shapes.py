"""examples/four-shapes.rs (``scenes/four_shapes.py``): a sphere, a cube, a cone and a cylinder on
a white background."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Cone, Cylinder, Material, Light,
    CameraSettings,
)
from . import SceneSpec
from .common import white_background, deg


def build() -> SceneSpec:
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

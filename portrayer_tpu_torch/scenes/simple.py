"""examples/simple.rs (``scenes/simple.py``): five spheres, two point lights."""

from .. import Scene, SceneNode, Geometry, Sphere, Material, Light, CameraSettings
from . import SceneSpec
from .common import sky_background, deg


def build() -> SceneSpec:
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

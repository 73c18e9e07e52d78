"""examples/single-triangle.rs (``scenes/single_triangle.py``): one flat triangle."""

from .. import Scene, SceneNode, Geometry, Triangle, Material, Light, CameraSettings
from . import SceneSpec
from .common import sky_background, deg


def build() -> SceneSpec:
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

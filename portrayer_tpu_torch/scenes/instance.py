"""examples/instance.rs (``scenes/instance.py``) — shared (instanced) subtrees."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Mesh, MeshData, Shading,
    Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    stone = Material(diffuse=(0.8, 0.7, 0.7))
    grass = Material(diffuse=(0.1, 0.7, 0.1))
    plane = MeshData.load_obj(asset("plane.obj"))

    arc = SceneNode([
        SceneNode(Geometry(Cube(), stone)).scaled((0.8, 4.0, 0.8)).translated((-2.0, 2.0, 0.0)),
        SceneNode(Geometry(Cube(), stone)).scaled((0.8, 4.0, 0.8)).translated((2.0, 2.0, 0.0)),
        SceneNode(Geometry(Sphere(), stone)).scaled((4.0, 0.6, 0.6)).translated((0.0, 4.0, 0.0)),
    ]).translated((0.0, 0.0, -10.0))

    nodes = [
        SceneNode(arc).rotated_y(deg(60.0 * i)) for i in range(1, 7)
    ]
    nodes.append(
        SceneNode(Geometry(Mesh(plane, Shading.Flat), grass)).scaled(30.0)
    )
    nodes.append(SceneNode(Geometry(Sphere(), stone)).scaled(2.5))

    scene = Scene(
        root=SceneNode(nodes).rotated_x(deg(23.0)),
        lights=[Light(position=(200.0, 202.0, 430.0), color=(0.8, 0.8, 0.8))],
        ambient=(0.4, 0.4, 0.4),
    )
    cam = CameraSettings(
        eye=(0.0, 2.0, 30.0), center=(0.0, 2.0, 29.0),
        up=(0.0, 1.0, 0.0), fovy=deg(50.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="instance")

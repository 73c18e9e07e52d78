"""examples/hier.rs (``scenes/hier.py``) — hierarchical transforms test."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Mesh, MeshData, Shading,
    Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    gold = Material(diffuse=(0.9, 0.8, 0.4), specular=(0.8, 0.8, 0.4), shininess=25.0)
    grass = Material(diffuse=(0.1, 0.7, 0.1))
    blue = Material(diffuse=(0.7, 0.6, 1.0), specular=(0.5, 0.4, 0.8), shininess=25.0)

    plane = MeshData.load_obj(asset("plane.obj"))
    dodeca = MeshData.load_obj(asset("dodeca.obj"))

    arc = SceneNode([
        SceneNode(Geometry(Cube(), gold)).scaled((0.8, 4.0, 0.8)).translated((-2.0, 2.0, 0.0)),
        SceneNode(Geometry(Cube(), gold)).scaled((0.8, 4.0, 0.8)).translated((2.0, 2.0, 0.0)),
        SceneNode(Geometry(Sphere(), gold)).scaled((4.0, 0.6, 0.6)).translated((0.0, 4.0, 0.0)),
    ]).translated((0.0, 0.0, -10.0)).rotated_y(deg(60.0))

    floor = SceneNode(Geometry(Mesh(plane, Shading.Flat), grass)).scaled(30.0)
    poly = SceneNode(Geometry(Mesh(dodeca, Shading.Flat), blue)).translated((-2.0, 1.618034, 0.0))

    scene = Scene(
        root=SceneNode([arc, floor, poly])
            .rotated_x(deg(23.0)).translated((6.0, -2.0, -15.0)),
        lights=[
            Light(position=(200.0, 200.0, 400.0), color=(0.8, 0.8, 0.8)),
            Light(position=(0.0, 5.0, -20.0), color=(0.4, 0.4, 0.8)),
        ],
        ambient=(0.4, 0.4, 0.4),
    )
    cam = CameraSettings(
        eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0), fovy=deg(50.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(256, 256),
                     background=sky_background, name="hier")

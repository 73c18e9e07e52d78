"""examples/simple-cows.rs (``scenes/simple_cows.py``) — spherical cows around Stonehenge."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Mesh, MeshData, Shading,
    Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def _stone_grass_hide():
    stone = Material(diffuse=(0.8, 0.7, 0.7))
    grass = Material(diffuse=(0.1, 0.7, 0.1))
    cow_hide = Material(diffuse=(0.84, 0.6, 0.53), specular=(0.3, 0.3, 0.3), shininess=20.0)
    return stone, grass, cow_hide


COW_SPOTS = [
    ((1.0, 1.3, 14.0), 20.0),
    ((5.0, 1.3, -11.0), 180.0),
    ((-5.5, 1.3, -3.0), -60.0),
]


def build() -> SceneSpec:
    stone, grass, cow_hide = _stone_grass_hide()
    plane = MeshData.load_obj(asset("plane.obj"))
    buckyball = MeshData.load_obj(asset("buckyball.obj"))

    # note the reference's order here: translated THEN scaled
    arc = SceneNode([
        SceneNode(Geometry(Cube(), stone)).translated((-1.9, 0.5, 0.1)).scaled((0.8, 4.0, 0.8)),
        SceneNode(Geometry(Cube(), stone)).translated((2.1, 0.5, 0.1)).scaled((0.8, 4.0, 0.8)),
        SceneNode(Geometry(Sphere(), stone)).scaled((4.0, 0.6, 0.6)).translated((0.0, 4.0, 0.0)),
    ]).translated((0.0, 0.0, -10.0))

    nodes = [SceneNode(arc).rotated_y(deg(60.0 * (i - 1))) for i in range(1, 7)]

    cow = SceneNode([
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(1.0),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.6).translated((0.9, 0.3, 0.0)),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.2).translated((-0.94, 0.34, 0.0)),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.3).translated((0.7, -0.7, -0.7)),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.3).translated((-0.7, -0.7, -0.7)),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.3).translated((0.7, -0.7, 0.7)),
        SceneNode(Geometry(Sphere(), cow_hide)).scaled(0.3).translated((-0.7, -0.7, 0.7)),
    ])
    for pos, rot in COW_SPOTS:
        nodes.append(SceneNode(cow).scaled(1.4).rotated_y(deg(rot)).translated(pos))

    nodes.append(SceneNode(Geometry(Mesh(plane, Shading.Flat), grass)).scaled(30.0))
    nodes.append(SceneNode(Geometry(Mesh(buckyball, Shading.Flat), stone)).scaled(1.5))

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
                     background=sky_background, name="simple-cows")

"""examples/water-glass.rs (``scenes/water_glass.py``) — refraction: glass of water with straw."""

from .. import (
    Scene, SceneNode, Geometry, Cube, Plane, Cylinder, Material, Light,
    CameraSettings, Texture, ImageTexture, NormalMap, WATER_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def room():
    brick = Texture(ImageTexture(asset("Brick_Wall_013_COLOR.jpg")))
    brick_normals = NormalMap(asset("Brick_Wall_013_NORM.jpg"))
    mat_wall = Material(
        specular=(0.3, 0.3, 0.3), shininess=25.0,
        texture=brick, normals=brick_normals,
    )
    wood = Texture(ImageTexture(asset("Wood_018_basecolor_cubemap.jpg")))
    wood_normals = NormalMap(asset("Wood_018_normal_cubemap.jpg"))
    mat_table = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0,
        reflectivity=0.2, glossy_side_length=2.0,
        texture=wood, normals=wood_normals,
    )
    return SceneNode([
        SceneNode(Geometry(Plane(), mat_wall)).scaled(10.0)
            .rotated_x(deg(90.0)).translated((0.0, 1.0, -2.0)),
        SceneNode(Geometry(Cube(), mat_table)).scaled((8.0, 0.4, 4.0))
            .translated((0.0, 0.0, -0.2)),
    ])


def drink():
    mat_water = Material(
        diffuse=(0.0, 0.0, 0.1), specular=(0.3, 0.3, 0.3), shininess=25.0,
        reflectivity=0.9, refraction_index=WATER_REFRACTION_INDEX,
    )
    mat_straw = Material(
        diffuse=(0.8, 0.0, 0.0), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    return SceneNode([
        SceneNode(Geometry(Cylinder(), mat_water)).scaled((1.0, 1.4, 1.0))
            .translated((0.0, 0.7, 0.0)),
        SceneNode(Geometry(Cylinder(), mat_straw)).scaled((0.1, 2.0, 0.1))
            .rotated_z(deg(28.4282)).translated((-0.165556, 0.911109, 0.1)),
    ])


def build() -> SceneSpec:
    scene = Scene(
        root=SceneNode([room(), drink().translated((0.0, 0.2, 0.0))]),
        lights=[Light(position=(0.0, 27.0, 5.0), color=(0.5, 0.5, 0.5))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 3.2, 7.151111), center=(0.0, 0.091525, -5.719519),
        up=(0.0, 1.0, 0.0), fovy=deg(23.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="water-glass",
                     # The JAX package's hint: peak live children 1.58x
                     # the primaries at round 1, decaying after.
                     queue_caps=(2.0,))

"""examples/transmission-refraction.rs (``scenes/transmission_refraction.py``):
fish tank behind glass."""

from .. import (
    Scene, SceneNode, Geometry, Cube, Plane, Cylinder, Material, Light,
    CameraSettings, Texture, ImageTexture, NormalMap, MeshData, KDMesh,
    Shading, WATER_REFRACTION_INDEX, WINDOW_GLASS_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def room():
    mat_walls = Material(
        diffuse=(0.607917, 0.8, 0.551884), specular=(0.3, 0.3, 0.3), shininess=25.0,
    )
    wood = Texture(ImageTexture(asset("Wood_018_basecolor_cubemap.jpg")))
    wood_normals = NormalMap(asset("Wood_018_normal_cubemap.jpg"))
    mat_table = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0,
        texture=wood, normals=wood_normals,
    )
    return SceneNode([
        SceneNode(Geometry(Cube(), mat_table)).scaled((20.0, 5.0, 2.5))
            .translated((0.0, -2.0, 1.3)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled((20.0, 1.0, 20.0))
            .rotated_x(deg(90.0)).translated((0.0, 3.0, -10.0)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled((20.0, 1.0, 12.0))
            .rotated_z(deg(90.0)).translated((10.0, 3.0, -6.0)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled((20.0, 1.0, 12.0))
            .rotated_z(deg(-90.0)).translated((-10.0, 3.0, -6.0)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled((12.1, 1.0, 20.0))
            .rotated_x(deg(90.0)).translated((16.0, 3.0, 0.0)),
        SceneNode(Geometry(Plane(), mat_walls)).scaled((12.1, 1.0, 20.0))
            .rotated_x(deg(90.0)).translated((-16.0, 3.0, 0.0)),
    ])


def tank():
    tiles = Texture(ImageTexture(asset("Tiles_017_basecolor_cubemap.jpg")))
    tiles_normals = NormalMap(asset("Tiles_017_normal_cubemap.jpg"))
    mat_tank = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0,
        texture=tiles, normals=tiles_normals,
    )
    nodes = []
    for i in range(4):
        nodes.append(
            SceneNode(Geometry(Cube(), mat_tank)).scaled((5.0, 5.0, 0.2))
            .translated((i * 5.0 - 7.5, -2.0, -10.0))
        )
        nodes.append(
            SceneNode(Geometry(Cube(), mat_tank)).scaled((5.0, 5.0, 0.2))
            .translated((i * 5.0 - 7.5, -2.0, 0.0))
        )
    for i in range(2):
        nodes.append(
            SceneNode(Geometry(Cube(), mat_tank)).scaled((0.2, 5.0, 5.0))
            .translated((-10.0, -2.0, -(i * 5.0 + 2.5)))
        )
        nodes.append(
            SceneNode(Geometry(Cube(), mat_tank)).scaled((0.2, 5.0, 5.0))
            .translated((10.0, -2.0, -(i * 5.0 + 2.5)))
        )
    for x in range(4):
        for y in range(2):
            nodes.append(
                SceneNode(Geometry(Cube(), mat_tank)).scaled((5.0, 0.2, 5.0))
                .translated((x * 5.0 - 7.5, -4.0, -(y * 5.0 + 2.5)))
            )
    return SceneNode(nodes)


def water():
    mat_water = Material(
        diffuse=(0.0, 0.0, 0.1), specular=(0.3, 0.3, 0.3), shininess=25.0,
        reflectivity=0.9, refraction_index=WATER_REFRACTION_INDEX,
    )
    fish_skin = Texture(ImageTexture(asset("fish.png")))
    mat_fish = Material(
        diffuse=(0.8, 0.8, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0,
        texture=fish_skin,
    )
    fish_model = MeshData.load_obj(asset("fish.obj"))
    fish_mesh = KDMesh(fish_model, Shading.Smooth)
    return SceneNode([
        SceneNode(Geometry(Cube(), mat_water)).scaled((19.799999, 3.8, 9.8))
            .translated((0.0, -2.0, -5.0)),
        SceneNode(Geometry(fish_mesh, mat_fish))
            .rotated_xzy((deg(0.0), deg(-71.8181), deg(30.8927)))
            .translated((-4.798946, -0.970323, -5.246493)),
        SceneNode(Geometry(fish_mesh, mat_fish))
            .rotated_xzy((deg(0.0), deg(108.666), deg(-23.084)))
            .translated((3.110451, -2.562474, -6.838645)),
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
            .translated((-7.4, 1.2, 1.2)),
        SceneNode(Geometry(Cylinder(), mat_straw)).scaled((0.1, 2.0, 0.1))
            .rotated_z(deg(28.4282)).translated((-7.565556, 1.411109, 1.1)),
    ])


def build() -> SceneSpec:
    mat_glass = Material(
        diffuse=(0.0, 0.0, 0.0), specular=(0.3, 0.3, 0.3), shininess=25.0,
        reflectivity=1.0, refraction_index=WINDOW_GLASS_REFRACTION_INDEX,
    )
    scene = Scene(
        root=SceneNode([
            SceneNode(Geometry(Cube(), mat_glass)).scaled((20.0, 10.0, 0.2))
                .translated((0.0, 5.0, 0.0)),
            room(), tank(), water(), drink(),
        ]),
        lights=[Light(position=(0.0, 27.0, 5.0), color=(0.5, 0.5, 0.5))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 14.658033, 27.19817), center=(0.0, -6.058867, -24.828854),
        up=(0.0, 1.0, 0.0), fovy=deg(23.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="transmission-refraction")

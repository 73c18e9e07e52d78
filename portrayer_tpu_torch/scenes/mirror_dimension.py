"""examples/entering-the-mirror-dimension.rs (``scenes/mirror_dimension.py``):
recursive mirrors."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Mesh, MeshData, Shading,
    Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def build() -> SceneSpec:
    mat_mirror_frame = Material(diffuse=(0.29, 0.204, 0.145), shininess=1.0)
    mat_mirror = Material(
        diffuse=(0.0, 0.0, 0.0), specular=(0.8, 0.8, 0.8),
        shininess=1000.0, reflectivity=1.0,
    )
    mat_floor = Material(diffuse=(0.016, 0.384, 0.0), specular=(0.8, 0.8, 0.8), shininess=25.0)
    mat_body = Material(diffuse=(0.906, 0.22, 0.282), specular=(0.8, 0.8, 0.8), shininess=25.0)
    mat_head = Material(diffuse=(0.086, 0.671, 0.906), specular=(0.8, 0.8, 0.8), shininess=50.0)
    mat_eyes = Material(
        diffuse=(0.3, 0.3, 0.3), specular=(0.8, 0.8, 0.8),
        shininess=1000.0, reflectivity=0.9,
    )
    mat_arms = Material(diffuse=(0.345, 0.588, 0.906), specular=(0.8, 0.8, 0.8), shininess=1.0)

    monkey = MeshData.load_obj(asset("monkey.obj"))
    plane = MeshData.load_obj(asset("plane.obj"))

    mirror = SceneNode([
        SceneNode(Geometry(Cube(), mat_mirror_frame)).scaled((3.96, 5.5, 0.4))
            .translated((0.0, 2.75, 0.0)),
        SceneNode(Geometry(Cube(), mat_mirror)).scaled((3.6, 5.0, 0.1))
            .translated((0.0, 2.75, 0.2)),
    ]).translated((0.0, 0.0, -1.3))

    head = (
        SceneNode(Geometry(Mesh(monkey, Shading.Flat), mat_head))
        .scaled((1.0, 1.0, 1.0)).rotated_y(deg(180.0)).translated((0.0, 2.7, 0.0))
        .with_children([
            SceneNode(Geometry(Sphere(), mat_eyes)).scaled((0.1, 0.1, 0.05))
                .translated((0.35, 0.24, 0.8)),
            SceneNode(Geometry(Sphere(), mat_eyes)).scaled((0.1, 0.1, 0.05))
                .translated((-0.35, 0.24, 0.8)),
        ])
    )

    monkey_character = SceneNode([
        SceneNode(Geometry(Cube(), mat_body)).scaled((0.545055, 2.6, 0.545055))
            .translated((0.0, 1.3, 0.0)),
        head,
        SceneNode(Geometry(Sphere(), mat_arms)).scaled((0.2, 0.63, 0.2))
            .rotated_xzy((deg(161.156), deg(107.062), deg(-133.944)))
            .translated((-0.388703, 1.715599, -0.2)),
        SceneNode(Geometry(Sphere(), mat_arms)).scaled((0.2, 0.56, 0.2))
            .rotated_xzy((deg(127.221), deg(42.0695), deg(-104.823)))
            .translated((-0.711297, 1.284401, -1.0)),
        SceneNode(Geometry(Sphere(), mat_mirror)).scaled((0.5, 0.5, 0.3))
            .translated((-0.711297, 1.284401, -1.20)),
        SceneNode(Geometry(Sphere(), mat_arms)).scaled((0.2, 0.63, 0.2))
            .rotated_xzy((deg(92.3684), deg(-57.6199), deg(38.2278)))
            .translated((0.581161, 1.984976, -0.2)),
        SceneNode(Geometry(Sphere(), mat_arms)).scaled((0.2, 0.56, 0.2))
            .rotated_xzy((deg(91.5166), deg(-11.239), deg(28.419)))
            .translated((1.118839, 2.015024, -1.0)),
        SceneNode(Geometry(Sphere(), mat_mirror)).scaled((0.5, 0.5, 0.3))
            .translated((1.118839, 2.015024, -1.20)),
    ])

    floor = SceneNode(Geometry(Mesh(plane, Shading.Flat), mat_floor)).scaled(20.0)

    scene = Scene(
        root=SceneNode([mirror, floor, monkey_character]),
        lights=[
            Light(position=(2.5, 3.5, -1.0), color=(0.9, 0.9, 0.9)),
            Light(position=(10.0, 10.0, 0.0), color=(0.9, 0.9, 0.9)),
            Light(position=(-9.0, 4.0, 0.0), color=(0.406471, 0.901283, 1.0)),
        ],
        ambient=(0.2, 0.2, 0.2),
    )
    cam = CameraSettings(
        eye=(5.545485, 2.966984, 1.795613), center=(-4.348584, 2.148794, -3.057839),
        up=(0.0, 1.0, 0.0), fovy=deg(30.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(800, 600),
                     background=sky_background, name="entering-the-mirror-dimension")

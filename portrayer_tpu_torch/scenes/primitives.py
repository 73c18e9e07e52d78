"""examples/primitives.rs (``scenes/primitives.py``) — castle of primitives + trees."""

from .. import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cylinder, Cone,
    Mesh, MeshData, Shading, Material, Light, CameraSettings,
)
from . import SceneSpec
from .common import sky_background, deg, asset


def make_castle():
    mat_dome = Material(
        diffuse=(0.609065, 0.731162, 0.8), specular=(0.5, 0.5, 0.5),
        shininess=1000.0, reflectivity=0.3,
    )
    mat_castle = Material(diffuse=(0.769051, 0.304112, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_tower_top = Material(diffuse=(0.352613, 0.42773, 0.8), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_door = Material(diffuse=(0.176099, 0.115632, 0.054921))
    mat_road = Material(diffuse=(0.121484, 0.024035, 0.0))

    castle_width = 4.0
    castle_length = castle_width
    castle_height = 2.0
    dome_radius = castle_width / 2.0
    tower_height = castle_height * 1.5
    tower_width = 1.5
    tower_roof_height = 2.0
    tower_roof_width = tower_width + 0.1

    nodes = [
        SceneNode(Geometry(Cube(), mat_castle))
            .scaled((castle_width, castle_height, castle_length))
            .translated((0.0, castle_height / 2.0, 0.0)),
        SceneNode(Geometry(Sphere(), mat_dome))
            .scaled((dome_radius, castle_height, dome_radius))
            .translated((0.0, castle_height, 0.0)),
        SceneNode(Geometry(
            Mesh(MeshData.load_obj(asset("prim_castle_door.obj")), Shading.Smooth), mat_door
        )).translated((0.0, 1.1, castle_length / 2.0 + 0.1)),
        SceneNode(Geometry(Cube(), mat_road)).scaled((2.0, 0.01, 4.0))
            .translated((0.0, 0.0, castle_length / 2.0 + 2.0 - 0.3)),
    ]

    tower = SceneNode([
        SceneNode(Geometry(Cylinder(), mat_castle))
            .scaled((tower_width, tower_height, tower_width))
            .translated((0.0, tower_height / 2.0, 0.0)),
        SceneNode(Geometry(Cone(), mat_tower_top))
            .scaled((tower_roof_width, tower_roof_height, tower_roof_width))
            .translated((0.0, tower_height + tower_roof_height / 2.0, 0.0)),
    ])
    for x in (-1.0, 1.0):
        for z in (-1.0, 1.0):
            nodes.append(
                SceneNode(tower).translated(
                    (castle_width / 2.0 * x, 0.0, castle_length / 2.0 * z)
                )
            )
    return SceneNode(nodes)


TREE_POSITIONS = [
    (4.225878, 0.0, 3.695781), (5.225877, 0.0, 2.895781), (4.125877, 0.0, 2.395781),
    (5.125877, 0.0, 1.595781), (6.525877, 0.0, 0.795781), (5.125877, 0.0, 0.395781),
    (5.925876, 0.0, -0.704219), (4.725877, 0.0, -1.30422), (3.425877, 0.0, -0.804219),
    (3.025877, 0.0, -2.204219), (4.225877, 0.0, -2.30422), (5.425877, 0.0, -2.50422),
    (6.525876, 0.0, -2.00422), (6.925876, 0.0, -3.50422), (5.825876, 0.0, -3.90422),
    (4.625876, 0.0, -3.70422), (3.425876, 0.0, -3.40422), (3.625876, 0.0, -4.80422),
    (5.025876, 0.0, -5.10422), (6.825876, 0.0, -5.00422),
    (-3.374122, 0.0, 3.79578), (-4.874123, 0.0, 3.29578), (-2.874123, 0.0, 2.39578),
    (-4.374123, 0.0, 2.19578), (-5.674122, 0.0, 1.79578), (-5.974123, 0.0, 0.195781),
    (-4.674122, 0.0, 0.395781), (-3.574123, 0.0, 1.09578), (-3.274122, 0.0, -0.204219),
    (-4.674122, 0.0, -1.00422), (-5.874123, 0.0, -1.20422), (-5.874123, 0.0, -2.40422),
    (-4.574122, 0.0, -2.40422), (-3.474122, 0.0, -1.70422), (-3.574123, 0.0, -3.30422),
    (-5.374123, 0.0, -3.60422),
]


def make_trees():
    mat_leaves = Material(diffuse=(0.289596, 0.8, 0.308959), specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_trunk = Material(diffuse=(0.8, 0.441708, 0.115746))
    tree = SceneNode([
        SceneNode(Geometry(Cylinder(), mat_trunk)).scaled((0.3, 2.0, 0.3))
            .translated((0.0, 1.0, 0.0)),
        SceneNode(Geometry(Cone(), mat_leaves)).scaled((1.0, 2.0, 1.0))
            .translated((0.0, 2.9, 0.0)),
    ])
    nodes = [SceneNode(tree).translated(p) for p in TREE_POSITIONS]
    nodes.append(
        SceneNode(tree)
        .rotated_xzy((deg(0.0), deg(50.0), deg(-80.0)))
        .translated((2.285154, 0.13965, 2.474418))
    )
    return SceneNode(nodes)


def build() -> SceneSpec:
    mat_grass = Material(diffuse=(0.177353, 0.334328, 0.169638))
    scene = Scene(
        root=SceneNode([
            make_castle().translated((0.0, 0.0, -1.6)),
            make_trees(),
            SceneNode(Geometry(Plane(), mat_grass)).scaled(30.0),
        ]),
        lights=[Light(position=(0.0, 10.0, 9.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(0.0, 4.311144, 17.370693), center=(0.0, 2.133119, -7.534255),
        up=(0.0, 1.0, 0.0), fovy=deg(25.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(910, 512),
                     background=sky_background, name="primitives")

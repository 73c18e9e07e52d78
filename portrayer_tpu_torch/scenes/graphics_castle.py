"""examples/graphics-castle.rs (``scenes/graphics_castle.py``) — "The Computer Graphics Castle".

The flagship scene: 12 KDMeshes (castle body, windows, door, statues,
tapestries, hill, water dirt), a water lake with refraction+glossy, and a
procedurally generated hedge maze of thousands of instanced textured cubes.

Where assets/shrub.png is absent, as the JAX package does, a procedural
leafy-noise texture stands in.  The maze RNG differs from the reference's StdRng, so the
exact maze layout differs; dimensions/density match.
"""

from collections import deque

import numpy as np

from .. import (
    Scene, SceneNode, Geometry, Cube, Cylinder, KDMesh, MeshData,
    Shading, Material, Light, CameraSettings,
    Texture, ImageTexture, NormalMap,
    WATER_REFRACTION_INDEX, WINDOW_GLASS_REFRACTION_INDEX,
)
from . import SceneSpec
from .common import deg, asset
from .robot_alarm_clock import robot_background

_cache = {}


def _load(name):
    path = asset(name)
    if path not in _cache:
        _cache[path] = MeshData.load_obj(path)
    return _cache[path]


def _shrub_texture() -> ImageTexture:
    import os

    path = asset("shrub.png")
    if os.path.exists(path):
        return ImageTexture(path)
    rng = np.random.RandomState(42)
    h = w = 128
    noise = rng.rand(h, w, 1)
    base = np.array([0.05, 0.25, 0.03])
    lit = np.array([0.18, 0.45, 0.10])
    img = base + (lit - base) * noise
    return ImageTexture(data=img)


def castle():
    mat_walls = Material(diffuse=(0.25, 0.25, 0.25))
    wood = Texture(ImageTexture(asset("old_planks_02_diff_1k.png")))
    wood_normals = NormalMap(asset("old_planks_02_nor_1k.png"))
    mat_door = Material(texture=wood, normals=wood_normals)
    mat_window_frames = Material(diffuse=(0.132866,) * 3)
    mat_ceiling_glass = Material(
        diffuse=(0.147337, 0.239555, 0.034547), specular=(0.3, 0.3, 0.3),
        shininess=100.0, reflectivity=0.8,
        refraction_index=WINDOW_GLASS_REFRACTION_INDEX,
    )
    mat_window_glass = Material(
        diffuse=(0.147337, 0.239555, 0.034547), specular=(0.3, 0.3, 0.3),
        shininess=100.0, reflectivity=1.0,
        refraction_index=WINDOW_GLASS_REFRACTION_INDEX,
    )
    mat_stairs = Material(diffuse=(0.132866,) * 3, specular=(0.3, 0.3, 0.3), shininess=25.0)
    mat_tapestry = Material(texture=wood, normals=wood_normals)
    mat_puppet = Material(diffuse=(0.06998,) * 3, specular=(0.3, 0.3, 0.3), shininess=25.0)

    stairs_side = KDMesh(_load("castle_stairs_side.obj"), Shading.Flat)
    tapestry = KDMesh(_load("castle_tapestry.obj"), Shading.Smooth)

    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("castle.obj"), Shading.Flat), mat_walls))
            .translated((0.0, 30.0, -30.0)),
        SceneNode(Geometry(KDMesh(_load("castle_window_frames.obj"), Shading.Flat), mat_window_frames))
            .translated((0.0, 83.5746, -2.25)),
        SceneNode(Geometry(KDMesh(_load("castle_glass_ceilings.obj"), Shading.Flat), mat_ceiling_glass))
            .translated((0.0, 96.0, -23.0)),
        SceneNode(Geometry(Cube(), mat_window_glass)).scaled((9.1, 1.0, 12.7))
            .rotated_x(deg(90.0)).translated((-30.0, 70.7, 12.7)),
        SceneNode(Geometry(Cube(), mat_window_glass)).scaled((9.1, 1.0, 12.7))
            .rotated_x(deg(90.0)).translated((30.0, 70.7, 12.7)),
        SceneNode(Geometry(Cube(), mat_window_glass)).scaled((13.4, 1.0, 18.8))
            .rotated_x(deg(90.0)).translated((0.0, 79.4, -2.9)),
        SceneNode(Geometry(KDMesh(_load("castle_door.obj"), Shading.Flat), mat_door))
            .translated((0.0, 21.739681, 10.0)),
        SceneNode(Geometry(KDMesh(_load("castle_door_arch.obj"), Shading.Flat), mat_door))
            .translated((0.0, 42.0, 9.0)),
        SceneNode(Geometry(stairs_side, mat_stairs)).translated((-11.0, 5.0, 19.0)),
        SceneNode(Geometry(stairs_side, mat_stairs)).translated((11.0, 5.0, 19.0)),
        SceneNode(Geometry(KDMesh(_load("puppet_castle_left_tower.obj"), Shading.Smooth), mat_puppet))
            .translated((30.0, 33.6, 19.0)),
        SceneNode(Geometry(Cylinder(), mat_walls)).scaled(10.0).translated((30.0, 5.0, 20.0)),
        SceneNode(Geometry(KDMesh(_load("puppet_castle_right_tower.obj"), Shading.Smooth), mat_puppet))
            .translated((-30.0, 33.6, 19.0)),
        SceneNode(Geometry(Cylinder(), mat_walls)).scaled(10.0).translated((-30.0, 5.0, 20.0)),
        SceneNode(Geometry(tapestry, mat_tapestry)).translated((60.0, 37.0, 10.0)),
        SceneNode(Geometry(tapestry, mat_tapestry)).translated((-60.0, 37.0, 10.0)),
    ])


def lake():
    mat_water = Material(
        diffuse=(0.0, 0.0, 0.1), specular=(0.5, 0.5, 0.5), shininess=100.0,
        reflectivity=0.9, glossy_side_length=0.5,
        refraction_index=WATER_REFRACTION_INDEX,
    )
    dock = Texture(ImageTexture(asset("Wood_018_basecolor_cubemap.jpg")))
    dock_normals = NormalMap(asset("Wood_018_normal_cubemap.jpg"))
    mat_dock = Material(
        specular=(0.5, 0.5, 0.5), shininess=100.0,
        texture=dock, normals=dock_normals,
    )
    mat_dirt = Material(diffuse=(0.592, 0.671, 0.055))
    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("castle_water_dirt.obj"), Shading.Flat), mat_dirt))
            .translated((0.0, -62.0, 125.0)),
        SceneNode(Geometry(Cube(), mat_water)).scaled((640.0, 125.0, 250.0))
            .translated((0.0, -62.0, 125.0)),
        SceneNode(Geometry(Cube(), mat_dock)).scaled((30.0, 4.0, 36.0))
            .translated((-100.0, 0.0, 18.0)),
    ])


def land():
    mat_grass = Material(diffuse=(0.116971, 0.278894, 0.0))
    return SceneNode([
        SceneNode(Geometry(KDMesh(_load("castle_hill.obj"), Shading.Smooth), mat_grass))
            .translated((0.0, 3.75, -15.75)).scaled(1.4).translated((0.0, 0.0, -229.0)),
        SceneNode(Geometry(Cube(), mat_grass)).scaled((2560.0, 132.0, 1040.0))
            .translated((0.0, -65.0, -520.0)),
    ])


def _generate_maze(rows, cols, reserve, start):
    """Prim-style wall-to-passage maze (graphics-castle.rs:364-473)."""
    WALL, EMPTY = 1, 0
    cells = np.full((rows, cols), WALL, np.int8)
    (r1, c1), (r2, c2) = reserve
    cells[r1:r2 + 1, c1:c2 + 1] = EMPTY

    rng = np.random.RandomState(19392103958 % (2**31))

    def adjacents(r, c):
        out = []
        if r > 1:
            out.append((r - 1, c))
        if r < rows - 2:
            out.append((r + 1, c))
        if c > 1:
            out.append((r, c - 1))
        if c < cols - 2:
            out.append((r, c + 1))
        return out

    def diagonals(r, c):
        out = []
        if r > 1 and c > 1:
            out.append((r - 1, c - 1))
        if r < rows - 2 and c > 1:
            out.append((r + 1, c - 1))
        if r > 1 and c < cols - 2:
            out.append((r - 1, c + 1))
        if r < rows - 2 and c < cols - 2:
            out.append((r + 1, c + 1))
        return out

    walls = deque()
    seen = set()
    sr, sc = start
    cells[sr, sc] = EMPTY
    walls.extend(adjacents(sr, sc))

    while walls:
        r, c = walls.popleft()
        if (r, c) in seen:
            continue
        seen.add((r, c))
        if cells[r, c] == EMPTY:
            continue
        if sum(1 for (ar, ac) in diagonals(r, c) if cells[ar, ac] == EMPTY) > 1:
            continue
        adj = adjacents(r, c)
        if sum(1 for (ar, ac) in adj if cells[ar, ac] == EMPTY) > 1:
            continue
        cells[r, c] = EMPTY
        rng.shuffle(adj)
        adj_walls = [(ar, ac) for (ar, ac) in adj if cells[ar, ac] == WALL]
        if adj_walls:
            walls.appendleft(adj_walls[0])
            walls.extend(adj_walls[1:])
    return cells


def outdoor_maze():
    cell_width = cell_length = 12.0
    maze_width, maze_length, maze_height = 1572.0, 1284.0, 8.0
    maze_pos = (-450.0, maze_height / 2.0 + 1.0, -660.0)
    castle_area_width, castle_area_length = 276.0, 264.0
    castle_pos = (0.0 - maze_pos[0], 0.0, -260.0 - maze_pos[2])
    entrance_x = -100.0 - maze_pos[0]

    maze_cols = int(maze_width / cell_width)
    maze_rows = int(maze_length / cell_length)
    entrance = (maze_rows - 1, int((entrance_x + maze_width / 2.0) / cell_width))
    back = (
        int((castle_pos[2] - castle_area_length / 2.0 + maze_length / 2.0) / cell_length),
        int((castle_pos[0] - castle_area_width / 2.0 + maze_width / 2.0) / cell_width),
    )
    front = (
        int((castle_pos[2] + castle_area_length / 2.0 + maze_length / 2.0) / cell_length),
        int((castle_pos[0] + castle_area_width / 2.0 + maze_width / 2.0) / cell_width),
    )
    cells = _generate_maze(maze_rows, maze_cols, (back, front), entrance)

    mat_maze = Material(
        uv_trans=np.diag([1.0, maze_height, 1.0]),
        texture=Texture(_shrub_texture()),
    )
    nodes = []
    for i in range(maze_rows):
        z = i * cell_length - maze_length / 2.0
        for j in range(maze_cols):
            if not cells[i, j]:
                continue
            x = j * cell_width - maze_width / 2.0
            nodes.append(
                SceneNode(Geometry(Cube(), mat_maze))
                .scaled((cell_width, maze_height, cell_length))
                .translated((x, 0.0, z))
            )
    return SceneNode(nodes).translated(maze_pos)


def build() -> SceneSpec:
    scene = Scene(
        root=SceneNode([
            castle().scaled(1.4).translated((0.0, 0.0, -229.0)),
            lake(),
            land(),
            outdoor_maze(),
        ]),
        lights=[Light(position=(65.0, 130.0, -120.0), color=(0.9, 0.9, 0.9))],
        ambient=(0.3, 0.3, 0.3),
    )
    cam = CameraSettings(
        eye=(110.877441, 30.43659, 373.276886),
        center=(-412.953094, 65.409714, -1390.236328),
        up=(0.0, 1.0, 0.0), fovy=deg(24.0),
    )
    return SceneSpec(scene=scene, camera=cam, size=(1920, 1080),
                     background=robot_background, name="graphics-castle",
                     # The JAX package's hint, from the full frame's live-ray
                     # fractions on the real assets (240x135, uncapped:
                     # 0.58, 0.46, 0.29, then 0.16-0.30 through round 10;
                     # the water and glass keep reflecting), ~1.7-2x
                     # headroom a round.
                     queue_caps=(1.0, 0.8, 0.6))

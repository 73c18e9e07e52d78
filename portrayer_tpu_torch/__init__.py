"""portrayer_tpu_torch — the PyTorch/CUDA port of ``portrayer_tpu``.

A second package beside the JAX one, with the same module names.  It
imports torch and numpy only (never JAX, flax, PIL or ``portrayer_tpu``),
so it runs on a machine with a CUDA card and no JAX.  The scene
description, its lowering to tables and PNG I/O live here for that reason.

It renders scenes of spheres, planes, cubes, cylinders, cones, tori,
triangle meshes and triangles lit by point lights, through the bounce
rounds of mirror, glossy and refractive materials: the nearest-hit and
shadow sweeps of every round go through the hand-written kernel in
``csrc/sweep.cu`` (``accel="cuda"``), whose plain PyTorch version serves
CPU tensors.  Textures, normal maps and area lights are refused with
``NotImplementedError``.  Renders run on the card unless the
``RenderConfig`` names another device.
"""

from .config import (
    RenderConfig, EPSILON, GAMMA, MAX_RECURSION_DEPTH,
    AIR_REFRACTION_INDEX, WATER_REFRACTION_INDEX,
    WINDOW_GLASS_REFRACTION_INDEX, OPTICAL_GLASS_REFRACTION_INDEX,
    DIAMOND_REFRACTION_INDEX,
)
from .camera import Camera, CameraSettings
from .render import Image, render_linear, render_u8, finalize, to_u8
from .scene import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cylinder, Cone, Torus,
    Mesh, KDMesh, MeshData, Shading, Triangle, Material, Light, Falloff, Parallelogram,
    flatten_scene, tables_from_numpy, SceneTables,
)
from . import math3d

__all__ = [
    "RenderConfig", "EPSILON", "GAMMA", "MAX_RECURSION_DEPTH",
    "AIR_REFRACTION_INDEX", "WATER_REFRACTION_INDEX",
    "WINDOW_GLASS_REFRACTION_INDEX", "OPTICAL_GLASS_REFRACTION_INDEX",
    "DIAMOND_REFRACTION_INDEX",
    "Camera", "CameraSettings",
    "Image", "render_linear", "render_u8", "finalize", "to_u8",
    "Scene", "SceneNode", "Geometry",
    "Sphere", "Cube", "Plane", "Cylinder", "Cone", "Torus",
    "Mesh", "KDMesh", "MeshData", "Shading", "Triangle",
    "Material", "Light", "Falloff", "Parallelogram",
    "flatten_scene", "tables_from_numpy", "SceneTables",
    "math3d",
]

"""portrayer_tpu_torch — the PyTorch/CUDA port of ``portrayer_tpu``.

A second package beside the JAX one, with the same module names.  It
imports torch and numpy only (never JAX, flax, PIL or ``portrayer_tpu``),
so it runs on a machine with a CUDA card and no JAX.  The scene
description, its lowering to tables and PNG I/O live here for that reason.

It renders scenes of spheres, planes, cubes, cylinders, cones, tori,
triangle meshes and triangles lit by point and parallelogram area lights,
with image and procedural textures and normal maps, through the bounce
rounds of mirror, glossy and refractive materials: the nearest-hit and
shadow sweeps of every round go through the hand-written kernel in
``csrc/sweep.cu`` (``accel="cuda"``), whose plain PyTorch version serves
CPU tensors.  Renders run on the card unless the ``RenderConfig`` names
another device.

Image textures and normal maps take texels as a uint8 array (``data=``)
or a PNG path.  ``ops.trace.trace`` is differentiable by
``torch.autograd`` with respect to the material, light and transform
tables: give ``SceneTables.replace`` a tensor that requires grad, trace
with the new tables, and call ``backward``.  ``RenderConfig.soft_visibility``
makes silhouettes differentiable too.

``parallel`` splits rays over devices, one process per device joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU or for ranks that
share a card): ``trace_sharded``, ``render_tiles_sharded``,
``render_frame_distributed`` and ``train_step``, whose gradients do not
depend on the world size.  ``accel="beam"`` runs the JAX package's beam
sweep in plain torch ops, its ordered walk a loop on the device (a CUDA
graph WHILE node when captured); ``RenderConfig(dtype=torch.float64,
accel="flat")`` is the float64 check mode.  On the card every accel and
dtype renders and fits through captured CUDA graphs.
``render_bounding_volumes`` renders meshes as their boxes; the render entry points take a
``reporter`` (``reporter.py``) and ``spans`` (``spans.py``: the frame's
host phases and each chunk's and bounce round's device span); ``debug``
holds ``checked_trace`` (the first op that makes a NaN),
``queue_overflow_fraction`` and ``assert_image_finite``.
"""

from .config import (
    RenderConfig, EPSILON, GAMMA, MAX_RECURSION_DEPTH,
    AIR_REFRACTION_INDEX, WATER_REFRACTION_INDEX,
    WINDOW_GLASS_REFRACTION_INDEX, OPTICAL_GLASS_REFRACTION_INDEX,
    DIAMOND_REFRACTION_INDEX,
)
from .camera import Camera, CameraSettings
from .render import Image, render_linear, render_u8, finalize, to_u8
from .reporter import Reporter, RenderProgress, NullProgress
from .spans import Spans
from .scene import (
    Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cylinder, Cone, Torus,
    Mesh, KDMesh, MeshData, Shading, Triangle, Material, Light, Falloff, Parallelogram,
    Texture, ImageTexture, NormalMap, flatten_scene, tables_from_numpy, SceneTables,
)
from . import math3d

__all__ = [
    "RenderConfig", "EPSILON", "GAMMA", "MAX_RECURSION_DEPTH",
    "AIR_REFRACTION_INDEX", "WATER_REFRACTION_INDEX",
    "WINDOW_GLASS_REFRACTION_INDEX", "OPTICAL_GLASS_REFRACTION_INDEX",
    "DIAMOND_REFRACTION_INDEX",
    "Camera", "CameraSettings",
    "Image", "render_linear", "render_u8", "finalize", "to_u8",
    "Reporter", "RenderProgress", "NullProgress", "Spans",
    "Scene", "SceneNode", "Geometry",
    "Sphere", "Cube", "Plane", "Cylinder", "Cone", "Torus",
    "Mesh", "KDMesh", "MeshData", "Shading", "Triangle",
    "Material", "Light", "Falloff", "Parallelogram",
    "Texture", "ImageTexture", "NormalMap",
    "flatten_scene", "tables_from_numpy", "SceneTables",
    "math3d",
]

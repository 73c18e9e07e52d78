"""The reference's own tables, worked out from a configuration's data:
each node's world transform and its inverse (float64 on the host, then
the precision asked for), the material and light tables and the camera.

Kinds are unit primitives in their node's frame, as the upstream's
`src/primitive/*.rs` define them: the sphere of radius 1 at the origin,
the cube [-0.5, 0.5]^3, the cylinder of radius 0.5 and height 1 along y,
the cone of radius 0.5 at y = -0.5 with its apex at y = +0.5.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

KINDS = ("sphere", "cube", "cylinder", "cone")
# Parameters a fit takes gradients for, under the program's table names.
PARAMS = ("mat_diffuse", "mat_specular", "mat_reflectivity", "mat_shininess",
          "light_color", "light_pos", "ambient", "inv")


def _rotation(axis: int, angle: float) -> np.ndarray:
    """A right-handed rotation about x (0), y (1) or z (2)."""
    c, s = math.cos(angle), math.sin(angle)
    i, j = ((1, 2), (2, 0), (0, 1))[axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _step(op: str, v) -> np.ndarray:
    m = np.eye(4)
    if op == "translate":
        m[:3, 3] = v
    elif op == "scale":
        m[0, 0], m[1, 1], m[2, 2] = v
    elif op == "rotate_xzy":  # about x, then z, then y
        x, y, z = v
        m = _rotation(1, y) @ _rotation(2, z) @ _rotation(0, x)
    else:
        raise ValueError(f"unknown transform step {op!r}")
    return m


def world_transform(steps) -> np.ndarray:
    """A node's transform: each step left-multiplied, in the listed order."""
    m = np.eye(4)
    for op, v in steps:
        m = _step(op, v) @ m
    return m


def camera_to_world(eye, center, up) -> np.ndarray:
    """The inverse of the right-handed look-at view matrix."""
    eye, center, up = (np.asarray(x, dtype=np.float64) for x in (eye, center, up))
    f = (center - eye) / np.linalg.norm(center - eye)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    return np.linalg.inv(view)


@dataclasses.dataclass
class Tables:
    """Reference tables: nodes in configuration order."""
    kind_nodes: dict          # kind -> int64 tensor of node ids
    node_kind: torch.Tensor   # [N] int64: the kind's index in KINDS
    node_material: torch.Tensor  # [N] int64
    params: dict              # PARAMS -> tensor (inv [N, 3, 4])
    mat_glossy: torch.Tensor  # [M]
    reflective: bool
    eye: torch.Tensor         # [3]
    cam34: torch.Tensor       # [3, 4] camera -> world
    width: int
    height: int
    fov_factor: float
    dtype: torch.dtype

    def with_params(self, params: dict) -> "Tables":
        return dataclasses.replace(self, params=params)


def tables(data: dict, device, dtype=torch.float32) -> Tables:
    t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)
    nodes = data["nodes"]
    inv = np.stack([np.linalg.inv(world_transform(n["transform"]))[:3, :4] for n in nodes])
    kind_of = [n["primitive"] for n in nodes]
    kind_nodes = {k: torch.tensor([i for i, x in enumerate(kind_of) if x == k],
                                  dtype=torch.int64, device=device)
                  for k in KINDS if k in kind_of}
    mats = data["materials"]
    params = {
        "mat_diffuse": t([m["diffuse"] for m in mats]),
        "mat_specular": t([m["specular"] for m in mats]),
        "mat_reflectivity": t([m["reflectivity"] for m in mats]),
        "mat_shininess": t([m["shininess"] for m in mats]),
        "light_color": t([lt["color"] for lt in data["lights"]]),
        "light_pos": t([lt["position"] for lt in data["lights"]]),
        "ambient": t(data["ambient"]),
        "inv": t(inv),
    }
    cam = data["camera"]
    width, height = data["size"]
    return Tables(
        kind_nodes=kind_nodes,
        node_kind=torch.tensor([KINDS.index(k) for k in kind_of], device=device),
        node_material=torch.tensor([n["material"] for n in nodes], dtype=torch.int64,
                                   device=device),
        params=params, mat_glossy=t([m["glossy_side_length"] for m in mats]),
        reflective=any(m["reflectivity"] > 0.0 for m in mats),
        eye=t(cam["eye"]), cam34=t(camera_to_world(cam["eye"], cam["center"], cam["up"])[:3]),
        width=width, height=height,
        fov_factor=math.tan(math.radians(cam["fovy_deg"]) / 2.0), dtype=dtype)


def sky(uv: torch.Tensor) -> torch.Tensor:
    """(0.2, 0.4, 0.6) * (1 - v) + (0, 0, 1) * v."""
    v = uv[..., 1]
    return torch.stack([0.2 * (1.0 - v), 0.4 * (1.0 - v), 0.6 * (1.0 - v) + v], dim=-1)


BACKGROUNDS = {"sky": sky}

"""A configuration's scene handed to the program through its public
scene classes (the data of ``portbench/configs/<config>.json``)."""

from __future__ import annotations

import math

import torch


def sky(uv: torch.Tensor) -> torch.Tensor:
    """(0.2, 0.4, 0.6) * (1 - v) + (0, 0, 1) * v, from scalar ops alone: a
    captured CUDA graph holds no copy from the host."""
    v = uv[..., 1]
    return torch.stack([0.2 * (1.0 - v), 0.4 * (1.0 - v), 0.6 * (1.0 - v) + v], dim=-1)


BACKGROUNDS = {"sky": sky}


def build(T, data: dict):
    """(Scene, CameraSettings, background) of `data` in the program `T`
    (the ``portrayer_tpu_torch`` module)."""
    mats = [T.Material(diffuse=tuple(m["diffuse"]), specular=tuple(m["specular"]),
                       shininess=m["shininess"], reflectivity=m["reflectivity"],
                       glossy_side_length=m["glossy_side_length"])
            for m in data["materials"]]
    kinds = {"sphere": T.Sphere, "cube": T.Cube, "cylinder": T.Cylinder, "cone": T.Cone}
    nodes = []
    for n in data["nodes"]:
        node = T.SceneNode(T.Geometry(kinds[n["primitive"]](), mats[n["material"]]))
        for op, v in n["transform"]:
            if op == "scale":
                node.scaled(tuple(v))
            elif op == "rotate_xzy":
                node.rotated_xzy(tuple(v))
            elif op == "translate":
                node.translated(tuple(v))
            else:
                raise ValueError(f"unknown transform step {op!r}")
        nodes.append(node)
    scene = T.Scene(root=T.SceneNode(nodes),
                    lights=[T.Light(position=tuple(lt["position"]), color=tuple(lt["color"]))
                            for lt in data["lights"]],
                    ambient=tuple(data["ambient"]))
    cam = data["camera"]
    settings = T.CameraSettings(eye=tuple(cam["eye"]), center=tuple(cam["center"]),
                                up=tuple(cam["up"]), fovy=math.radians(cam["fovy_deg"]))
    return scene, settings, BACKGROUNDS[data["background"]]

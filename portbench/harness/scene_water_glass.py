"""The water-glass family's scene handed to the program through its public
scene classes: planes, cubes and cylinders with their transform steps in
order (rotations in degrees, as the upstream writes them), materials with
a refraction index, image textures and normal maps of the configuration's
stand-in texels (``reference/texels.py``, the arrays the reference samples
too), lights with their falloff, the camera and the background.  The
configuration fixes ``queue_caps`` (null: the program's default)."""

from __future__ import annotations

import math

from reference import texels

from .scene import BACKGROUNDS

STEPS = {"scale": lambda node, v: node.scaled(tuple(v)),
         "translate": lambda node, v: node.translated(tuple(v)),
         "rotate_x": lambda node, v: node.rotated_x(math.radians(v)),
         "rotate_z": lambda node, v: node.rotated_z(math.radians(v))}


def build(T, data: dict):
    """(Scene, CameraSettings, background, RenderConfig overrides) of `data`
    in the program `T` (the ``portrayer_tpu_torch`` module)."""
    maps = texels.make(data["texels"])
    images = {name: T.ImageTexture(data=a) for name, a in maps.items()}
    normal_maps = {name: T.NormalMap(data=a) for name, a in maps.items()}
    mats = [T.Material(diffuse=tuple(m["diffuse"]), specular=tuple(m["specular"]),
                       shininess=m["shininess"], reflectivity=m["reflectivity"],
                       glossy_side_length=m["glossy_side_length"],
                       refraction_index=m["refraction_index"],
                       texture=T.Texture(images[m["texture"]]) if m.get("texture") else None,
                       normals=normal_maps[m["normals"]] if m.get("normals") else None)
            for m in data["materials"]]
    kinds = {"plane": T.Plane, "cube": T.Cube, "cylinder": T.Cylinder}
    nodes = []
    for n in data["nodes"]:
        node = T.SceneNode(T.Geometry(kinds[n["primitive"]](), mats[n["material"]]))
        for op, v in n["transform"]:
            if op not in STEPS:
                raise ValueError(f"unknown transform step {op!r}")
            STEPS[op](node, v)
        nodes.append(node)
    scene = T.Scene(root=T.SceneNode(nodes),
                    lights=[T.Light(position=tuple(lt["position"]), color=tuple(lt["color"]),
                                    falloff=tuple(lt["falloff"]))
                            for lt in data["lights"]],
                    ambient=tuple(data["ambient"]))
    cam = data["camera"]
    settings = T.CameraSettings(eye=tuple(cam["eye"]), center=tuple(cam["center"]),
                                up=tuple(cam["up"]), fovy=math.radians(cam["fovy_deg"]))
    caps = data["queue_caps"]
    return (scene, settings, BACKGROUNDS[data["background"]],
            {"queue_caps": None if caps is None else tuple(caps)})

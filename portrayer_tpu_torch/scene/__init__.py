"""Scene description classes and their lowering to device tables."""

from .node import Scene, SceneNode, Geometry, Sphere, Cube, Plane, Cylinder, Cone, Torus
from .material import Material
from .light import Light, Falloff, Parallelogram
from .mesh import Mesh, KDMesh, MeshData, Shading, Triangle
from .texture import Texture, ImageTexture, NormalMap
from .flatten import flatten_scene, tables_from_numpy, SceneTables

"""Intersection, sweep kernel, shading and the trace loop, with the JAX
package's ops exports.  ``trace`` stays the submodule (the port's code and
tests reach its helpers as ``ops.trace.*``); called, it is its ``trace``
function, as the JAX package's ``ops.trace`` is."""

from .intersect import intersect_scene, occluded, hit_detail, Hit, HitDetail
from .shade import shade_hits
from . import trace

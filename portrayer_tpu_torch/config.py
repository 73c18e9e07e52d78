"""Render configuration (counterpart of ``portrayer_tpu/config.py``).

The reference constants, the ``SAMPLES`` env semantics and the bounce
queues' head slices (``queue_slice_divs``) are the JAX package's.  Its
Pallas block and slab sizes have no meaning here and are gone, as is
``unroll_tail``: a captured render or fit always runs the bounce rounds
of the tail of equal capacity, the last round aside, as one loop (a CUDA
graph WHILE node, the JAX package's ``lax.scan``), which records the
same ops as the unrolled rounds in a fraction of the capture time, and
op by op the rounds are a Python loop.  ``remat_min_lanes`` has the JAX
package's meaning, op by op and captured: which rounds of a
differentiable trace run checkpointed.  ``device`` and ``accel`` choose where and through which
sweep the port runs, ``dtype`` in which precision, ``cuda_graphs``
whether a render or a fit on the card replays captured CUDA graphs,
through any of the three sweeps (the beam sweep's ordered walk a WHILE
node of its own, the JAX package's ``lax.while_loop``), as the JAX
package compiles each of them into one program.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch

# Mirrors EPSILON in the reference (src/math.rs:15).
EPSILON = 1e-5

# Gamma used for encode/decode (src/math.rs:20).
GAMMA = 2.2

# Maximum ray recursion depth (src/material.rs:12).
MAX_RECURSION_DEPTH = 10

# Indices of refraction (src/material.rs:15-23).
AIR_REFRACTION_INDEX = 1.00
WATER_REFRACTION_INDEX = 1.33
WINDOW_GLASS_REFRACTION_INDEX = 1.51
OPTICAL_GLASS_REFRACTION_INDEX = 1.92
DIAMOND_REFRACTION_INDEX = 2.42

ACCELS = ("flat", "cuda", "beam")
DTYPES = (torch.float32, torch.float64)


def _env_samples(default: int = 100) -> int:
    """SAMPLES env var semantics of the reference: positive int or default."""
    val = os.environ.get("SAMPLES")
    if val is not None:
        try:
            parsed = int(val)
            if parsed > 0:
                return parsed
        except ValueError:
            pass
    return default


@dataclasses.dataclass(frozen=True, kw_only=True)
class RenderConfig:
    """Sampling, robustness epsilons, launch shape, device and sweep.

    ``device`` defaults to the card: a caller asks for the CPU by name.
    Nothing falls back: without a card the first CUDA tensor raises.
    """

    device: Union[str, torch.device] = "cuda"

    # Samples per pixel (jittered); None reads SAMPLES, else 100.
    samples: Optional[int] = None

    # Maximum recursion depth for reflect/refract rays.
    max_depth: int = MAX_RECURSION_DEPTH

    # Absolute epsilon for t-range starts (parity with the reference).
    epsilon: float = EPSILON

    # Relative start offset of secondary/shadow rays: max(eps, eps_rel*|p|).
    eps_rel: float = 3e-4

    # Self-intersection guard in the local units of the source node.
    self_eps_local: float = 2e-3

    # Bounce-queue capacity as a multiple of the primary ray count.  None
    # auto-sizes: 4x with refractive materials (both children carry
    # energy), else 1x (reflect-only rounds emit one live child per hit).
    queue_factor: Optional[float] = None

    # Per-round capacity schedule: round r's queue holds queue_caps[r-1] x
    # primary rays (the last entry repeats).  Overflow keeps the
    # highest-throughput children and sends the rest to the background,
    # counted in TraceStats.dropped_w.  None = queue_factor every round.
    queue_caps: Optional[Tuple[float, ...]] = None

    # Head slices of a bounce queue: a round runs on the smallest head of
    # its queue, capacity // div rounded up to a multiple of 2048 lanes,
    # that holds the live rays (they are compacted to the front).  (1,)
    # runs every round at full capacity.
    queue_slice_divs: Tuple[int, ...] = (16, 4, 1)

    # Under autograd, round 0 and every bounce round of at least this many
    # lanes (its head slice) run checkpointed: the round's sweep results
    # are kept and its shading is replayed in backward instead of keeping
    # its temporaries (the JAX package's jax.checkpoint saving only the
    # sweep outputs).  A round on fewer lanes keeps its temporaries and
    # its backward replays nothing: op by op under autograd as usual, in
    # the captured fit (cuda_graphs on the card, fit.py) in residual slots
    # of the program's state slab.  0 (default) = every round.  The JAX
    # package's reason for the default: at 262k lanes the shading
    # temporaries go past HBM, and exempting small rounds went 10 GB past
    # it on castle (un-rematerialised texture gathers inside its tail scan
    # made XLA stack the u8 atlas per iteration).
    remat_min_lanes: int = 0

    # Pixels per render tile (height, width).
    tile: Tuple[int, int] = (128, 128)

    # Max rays per launch; spp are chunked so tile_px * spp_chunk fits.
    max_rays_per_launch: int = 131072

    # RNG seed for the jitter, glossy and area-light draws.
    seed: int = 0

    # Soft-visibility silhouette gradients: when > 0, each hit's
    # contribution is scaled by sigmoid(margin/width - 3) where margin is a
    # differentiable distance-to-silhouette (ops/intersect.HitDetail.margin)
    # and this value is the width in local units; the complementary energy
    # goes to the background.  The render becomes (nearly) continuous in
    # scene parameters, so visibility discontinuities produce usable
    # gradients at the cost of a thin translucent band inside silhouettes.
    # 0 (default) = exact reference semantics.
    soft_visibility: float = 0.0

    # Debug: render every mesh as its AABB cube instead of its triangles,
    # the reference's `render_bounding_volumes` cargo feature
    # (src/primitive/mesh.rs:170-176).  Applied when the renderer is given
    # a Scene (not tables).
    render_bounding_volumes: bool = False

    # "cuda": the hand-written sweep kernel on CUDA tensors (its plain
    # PyTorch version on CPU tensors); "flat": the brute-force oracle;
    # "beam": the ordered warp-beam sweep of ops/beam.py for nearest hits
    # on scenes of at least beam_min_prims nodes + mesh pairs (the flat
    # sweep below that, and for shadow rays through the nearest query).
    accel: str = "cuda"

    # Compute dtype of the ray pipeline.  float64 is the check mode: the
    # same jitter and shading draws (made in float32, then cast) in double
    # precision, to hold the float32 render against.  The sweep kernel is
    # float32 only, so float64 needs accel="flat" or "beam".
    dtype: torch.dtype = torch.float32

    # Beam sweep: rays per warp, candidates per step of a warp's ordered
    # sweep, and the scene size (nodes + mesh pairs) from which
    # accel="beam" uses it.
    warp_size: int = 256
    beam_chunk: int = 64
    beam_min_prims: int = 192

    # On the card, whatever the accel and dtype, a render captures its
    # chunk (round 0 and every bounce round's slices) once as a CUDA graph
    # and replays it for every tile and sample chunk; a differentiable
    # trace captures its forward and backward (fit.py).  False runs the
    # same rounds op by op, as a check of the captured ones.
    cuda_graphs: bool = True

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        if self.accel not in ACCELS:
            raise ValueError(f"accel must be one of {ACCELS}, got {self.accel!r}")
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {self.dtype!r}")
        if self.dtype == torch.float64 and self.accel == "cuda":
            raise ValueError(
                "RenderConfig(dtype=torch.float64): the sweep kernel (accel='cuda') is "
                "float32 only; pass accel='flat' (or 'beam') for the float64 check mode")
        if self.queue_caps is not None and len(self.queue_caps) == 0:
            raise ValueError("queue_caps must be None or non-empty")
        object.__setattr__(self, "queue_slice_divs", tuple(self.queue_slice_divs))
        if not all(isinstance(d, int) and d >= 1 for d in self.queue_slice_divs):
            raise ValueError(f"queue_slice_divs must be positive ints, got "
                             f"{self.queue_slice_divs!r}")

    @property
    def captures(self) -> bool:
        """Whether a render or a differentiable trace replays captured CUDA
        graphs: on the card with cuda_graphs, through any accel."""
        return self.cuda_graphs and self.device.type == "cuda"

    def resolved_samples(self) -> int:
        return self.samples if self.samples is not None else _env_samples()

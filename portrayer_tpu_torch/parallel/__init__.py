"""Rays split over devices, one process per device (torch.distributed)."""

from .sharding import (
    make_mesh, trace_sharded, train_step, split_params, DIFF_FIELDS, RAY_AXIS,
    render_tiles_sharded,
)
from .distributed import (
    initialize, global_mesh, make_global_rays, fetch_replicated,
    render_frame_distributed, frame_rays,
)

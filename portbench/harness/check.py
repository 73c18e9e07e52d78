"""What decides `correct`: the program's frame against the plain
reference's (portbench/reference), channel by channel in u8."""

from __future__ import annotations

import numpy as np
import torch

# A channel counts as off when it is this many u8 levels or more from the
# reference's: one level is the truncation of a sum added in another order.
OFF_LEVELS = 3


def compare_frames(program: np.ndarray, reference: np.ndarray) -> dict:
    """off_share: the share of channels OFF_LEVELS or more apart;
    mean_abs: the mean absolute difference in u8 levels."""
    if program.shape != reference.shape:
        return {"off_share": None, "mean_abs": None}
    diff = np.abs(program.astype(np.int32) - reference.astype(np.int32))
    return {"off_share": float((diff >= OFF_LEVELS).mean()), "mean_abs": float(diff.mean())}


def reference_frame(data: dict, traffic: dict, seed: int, device, dtype=torch.float32):
    from reference import render as R
    from reference import scene as S

    return R.render_u8(data, S.tables(data, device, dtype), seed, traffic["spp"],
                       tile=traffic["tile"], launch=traffic["launch_rays"]).cpu().numpy()

"""What decides `correct`: the program's frame against the plain
reference's (the configuration's family's reference, ``harness/family.py``),
channel by channel in u8, and the numbers the family compares besides."""

from __future__ import annotations

import numpy as np
import torch

from . import family

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
    """The reference's frame of the cell, u8 [H, W, 3] on the host."""
    ref = family.lookup(data).reference
    return ref.reference_frame(data, traffic, seed, device, dtype).cpu().numpy()


def compare(program: np.ndarray, data: dict, traffic: dict, seed: int, device,
            record: dict) -> dict:
    """compare_frames of the program's frame against the reference's, and
    the numbers of the family's ``numbers(record)`` beside them."""
    numbers = compare_frames(program, reference_frame(data, traffic, seed, device))
    more = family.lookup(data).numbers
    if more is not None:
        numbers.update(more(record))
    return numbers

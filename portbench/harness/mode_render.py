"""A render cell: whole frames through the program's ``Image.render`` on
tables flattened once, back to back (a closed loop: the next frame starts
when the last one is on the host), for the window's seconds.

Set-up renders one whole frame (which builds the kernels, warms up and
captures the chunk program that every frame then replays, and runs the
frame's host work once).  A traced run then re-renders `trace_tiles` tiles of
the middle tile row under ``torch.profiler``, with ``stats=`` counting
the chunk replays.  Where the configuration's scene family compares
numbers besides the frame (``harness/family.py``), one more frame is then
rendered with ``stats=`` for them to read."""

from __future__ import annotations

import time

import torch

from . import family
from . import trace as TR


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class RenderCell:
    def __init__(self, T, data: dict, traffic: dict, seed: int, device):
        self.traffic = traffic
        self.width, self.height = data["size"]
        self.spp = traffic["spp"]
        scene, self.camera, self.background, overrides = family.lookup(data).build(T, data)
        self.cfg = T.RenderConfig(device=device, samples=self.spp, seed=seed,
                                  tile=(traffic["tile"], traffic["tile"]),
                                  max_rays_per_launch=traffic["launch_rays"], **overrides)
        self.tables = T.flatten_scene(scene, device)
        self.image = T.Image(None, self.width, self.height)
        self.tile = min(traffic["tile"], self.height), min(traffic["tile"], self.width)

    def _tiles(self, n: int):
        """Origins of n tiles centred in the middle tile row."""
        th, tw = self.tile
        cols = -(-self.width // tw)
        y0 = (-(-self.height // th) - 1) // 2 * th
        c0 = max(0, (cols - n) // 2)
        return [(c * tw, y0) for c in range(c0, min(cols, c0 + n))]

    def _region(self, tiles):
        th, tw = self.tile
        (x0, y0), (x1, _) = tiles[0], tiles[-1]
        return ((x0, y0), (min(x1 + tw, self.width) - 1, min(y0 + th, self.height) - 1))

    def render(self, region=None, stats=None):
        self.image.render(self.tables, self.camera, self.background, self.cfg, region=region,
                          stats=stats)

    def warm(self):
        self.render()
        sync(self.cfg.device)

    def window(self, seconds: float) -> dict:
        """Frames until `seconds` have passed: their count, every primary ray
        (width x height x spp a frame) and the wall from the first frame's
        start to the last one's end."""
        frames = []
        sync(self.cfg.device)
        t0 = time.perf_counter()
        while True:
            self.render()
            sync(self.cfg.device)
            frames.append(time.perf_counter())
            if frames[-1] - t0 >= seconds:
                break
        walls = [b - a for a, b in zip([t0] + frames[:-1], frames)]
        self.last = self.image.buffer.copy()
        return {"seconds": frames[-1] - t0, "frames": len(frames), "frame_s": walls,
                "rays": len(frames) * self.width * self.height * self.spp}

    def traced_sample(self) -> dict:
        """The traced re-render of the middle tiles: its primary rays, chunk
        replays, traced wall and the trace's summary."""
        tiles = self._tiles(self.traffic["trace_tiles"])
        region = self._region(tiles)
        (x0, y0), (x1, y1) = region
        stats = []
        self.render(region=region)  # the same region once untraced: nothing new in the trace
        wall, trace = TR.traced(lambda: self.render(region=region, stats=stats),
                                self.cfg.device)
        summary = TR.summarize(trace)
        return dict(summary, wall_s=wall, chunks=len(stats),
                    rays=(x1 - x0 + 1) * (y1 - y0 + 1) * self.spp)

    def counts(self) -> list:
        """The TraceStats of each chunk of one whole frame, rendered after
        the window (the window's frames are alike: one camera and seed)."""
        stats = []
        self.render(stats=stats)
        return stats

    def frame(self):
        """The window's last frame: u8 [H, W, 3] on the host."""
        return self.last


def run(T, data: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """The cell's run: set-up, the window, with `traced` the traced
    sample, where the family compares more than the frame the counts of
    one more frame ("stats"), and `compare`, which frees the program's
    state and returns the numbers that judge the window's last frame
    against the reference's and the record by the family's numbers
    (harness.check)."""
    from . import check

    cell = RenderCell(T, data, traffic, seed, device)
    cell.warm()
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    window = cell.window(seconds)
    window_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    record = {"setup_s": setup_s, "window": window, "attempted": window["frames"],
              "peak_reserved_bytes": window_peak,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    if traced:
        record["sample"] = cell.traced_sample()
    if family.lookup(data).numbers is not None:
        record["stats"] = cell.counts()
    frame = cell.frame()
    del cell

    def compare():
        return check.compare(frame, data, traffic, seed, device, record)

    record["compare"] = compare
    return record

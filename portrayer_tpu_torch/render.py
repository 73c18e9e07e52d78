"""Render loop — tiled, sample-chunked wavefront rendering (counterpart
of ``portrayer_tpu/render.py``, the reference's src/render.rs).

Per pixel the reference computes: the background gradient at integer pixel
uv (render.rs:31-34), SAMPLES jittered camera rays traced recursively
(render.rs:36-43), their mean, gamma c^(1/2.2), clamp to [0, 1] and u8
truncation (render.rs:45-50,143-147).  Here the image is processed in
pixel tiles x sample chunks; each launch traces tile_px * spp_chunk rays.
Tiles are keyed by their origin, so re-rendering a region reproduces the
full render's samples there (the reference's Image::slice_mut,
render.rs:211-213).  Tiles are traced one after the other on the host: a
`reporter` ticks once per tile, when the host has issued its work (the
device runs behind by the work still queued; the host sets the pace).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import rng
from .camera import Camera, CameraSettings
from .config import RenderConfig, GAMMA
from .image_io import read_png, write_png
from .ops.trace import trace
from .reporter import Reporter, NullProgress
from .scene.flatten import SceneTables, flatten_scene
from .scene.node import Scene, bounding_volume_scene


def default_background(uv):
    """Flat black background (callers usually pass a gradient fn)."""
    return torch.zeros(uv.shape[:-1] + (3,), dtype=uv.dtype, device=uv.device)


def _tile_rays(key, cam: Camera, x0: int, y0: int, sample_offset: int, *,
               cfg: RenderConfig, background, tile_h: int, tile_w: int, spp: int,
               samples: int):
    """One (tile x sample-chunk) wavefront's primary rays: (o [R,3], d [R,3],
    pixel ids [R], background [P,3], throughput [R]), pixel-major."""
    dev, dt = cfg.device, cfg.dtype
    P = tile_h * tile_w
    R = P * spp
    i32 = dict(dtype=torch.int32, device=dev)
    row = torch.arange(tile_h, **i32)[:, None].expand(tile_h, tile_w)
    col = torch.arange(tile_w, **i32)[None, :].expand(tile_h, tile_w)
    px = (col + x0).reshape(-1)
    py = (row + y0).reshape(-1)
    full = lambda v: torch.full((), v, dtype=dt, device=dev)

    # Background at integer-pixel uv (render.rs:31-34).
    bg_uv = torch.stack([px.to(dt) / full(cam.width), py.to(dt) / full(cam.height)], dim=-1)
    bg = background(bg_uv).to(dt)

    # Jittered sample positions x + U[0,1) (render.rs:38-39), pixel-major.
    # Drawn in float32 whatever cfg.dtype, so that the float64 check mode
    # samples the same positions as the float32 render.
    jitter = rng.uniform(rng.fold_in(key, 0), (R, 2), dev).to(dt)
    xs = px.to(dt).repeat_interleave(spp) + jitter[:, 0]
    ys = py.to(dt).repeat_interleave(spp) + jitter[:, 1]
    pix_id = torch.arange(P, **i32).repeat_interleave(spp)
    # Samples beyond the requested count (chunk padding) carry zero weight.
    sample_ix = torch.arange(spp, **i32).repeat(P)
    live = (sample_ix + sample_offset) < samples

    o, d = cam.rays_at(xs, ys)
    return o, d, pix_id, bg, live.to(dt)


def _tile_chunk(key, st: SceneTables, cam: Camera, x0: int, y0: int,
                sample_offset: int, *, cfg: RenderConfig, background,
                tile_h: int, tile_w: int, spp: int, samples: int, stats=None):
    """Trace one (tile x sample-chunk) wavefront; returns acc [P,3].  A list
    `stats` receives the trace's TraceStats."""
    o, d, pix_id, bg, w0 = _tile_rays(
        key, cam, x0, y0, sample_offset, cfg=cfg, background=background,
        tile_h=tile_h, tile_w=tile_w, spp=spp, samples=samples)
    out = trace(rng.fold_in(key, 1), o, d, pix_id, bg, tile_h * tile_w, st, cfg, w0=w0,
                spp_contiguous=spp, with_stats=stats is not None)
    if stats is None:
        return out
    stats.append(out[1])
    return out[0]


def _render_tiles(key, st, cam, grid, *, cfg, background, tile_h, tile_w, spp,
                  n_chunks, samples, as_u8, stats=None, reporter=None):
    """Render every tile of `grid` ((x0, y0) origins): [T, th, tw, 3] mean
    radiance, or with as_u8 the gamma-encoded u8 tiles, on the device.
    `reporter` ticks once per tile."""
    out = []
    n = torch.full((), float(samples), dtype=cfg.dtype, device=cfg.device)
    for x0, y0 in grid:
        # Keyed by tile origin: a region re-render repeats the full render's
        # samples.
        tkey = rng.fold_in(rng.fold_in(key, x0), y0)
        acc = torch.zeros((tile_h * tile_w, 3), dtype=cfg.dtype, device=cfg.device)
        for ci in range(n_chunks):
            acc = acc + _tile_chunk(
                rng.fold_in(tkey, ci), st, cam, x0, y0, ci * spp, cfg=cfg,
                background=background, tile_h=tile_h, tile_w=tile_w, spp=spp,
                samples=samples, stats=stats)
        mean = (acc / n).reshape(tile_h, tile_w, 3)
        if as_u8:
            enc = torch.clamp(torch.clamp(mean, min=0.0) ** (1.0 / GAMMA), 0.0, 1.0)
            mean = (enc * 255.0).to(torch.uint8)
        out.append(mean)
        if reporter is not None:
            reporter.tick()
    return torch.stack(out)


def _render_common(scene_or_tables, camera, size, background, cfg, region, as_u8,
                   stats=None, reporter=None):
    if cfg is None:
        cfg = RenderConfig()
    width, height = size
    if isinstance(scene_or_tables, SceneTables):
        st = scene_or_tables
    else:
        scene = scene_or_tables
        if cfg.render_bounding_volumes:
            scene = bounding_volume_scene(scene)
        st = flatten_scene(scene, cfg.device, dtype=cfg.dtype)
    cam = Camera(camera, (width, height), cfg.device, cfg.dtype)
    samples = cfg.resolved_samples()

    tile_h = min(cfg.tile[0], height)
    tile_w = min(cfg.tile[1], width)
    spp_chunk = max(1, min(samples, cfg.max_rays_per_launch // (tile_h * tile_w)))
    n_chunks = -(-samples // spp_chunk)

    if region is None:
        x_lo, y_lo, x_hi, y_hi = 0, 0, width - 1, height - 1
    else:
        (x_lo, y_lo), (x_hi, y_hi) = region

    # Static tile grid: only tiles intersecting the region.
    grid = []
    for ty in range(-(-height // tile_h)):
        for tx in range(-(-width // tile_w)):
            tx0, ty0 = tx * tile_w, ty * tile_h
            if (tx0 > x_hi or ty0 > y_hi or tx0 + tile_w - 1 < x_lo
                    or ty0 + tile_h - 1 < y_lo):
                continue
            grid.append((tx0, ty0))

    reporter = reporter or NullProgress(0)
    reporter.start(total=len(grid))
    tiles = _render_tiles(
        rng.PRNGKey(cfg.seed), st, cam, grid, cfg=cfg, background=background,
        tile_h=tile_h, tile_w=tile_w, spp=spp_chunk, n_chunks=n_chunks,
        samples=samples, as_u8=as_u8, stats=stats, reporter=reporter).cpu().numpy()
    out_dtype = np.uint8 if as_u8 else np.float64
    out = np.zeros((height, width, 3), dtype=out_dtype)
    for (tx0, ty0), tile in zip(grid, tiles):
        ylim = min(ty0 + tile_h, height)
        xlim = min(tx0 + tile_w, width)
        out[ty0:ylim, tx0:xlim] = tile[: ylim - ty0, : xlim - tx0]
    reporter.finish()
    return out


def render_linear(scene_or_tables, camera: CameraSettings, size: Tuple[int, int],
                  background: Callable = default_background,
                  cfg: Optional[RenderConfig] = None,
                  region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
                  stats: Optional[list] = None,
                  reporter: Optional[Reporter] = None) -> np.ndarray:
    """The linear mean-radiance image [H,W,3] (float64 on the host).

    `region` = ((x1,y1),(x2,y2)) inclusive slice to render (others zero).
    A list `stats` receives the TraceStats of every (tile x sample-chunk)
    trace, at one more host sync per trace.  `reporter` (reporter.py)
    ticks once per tile."""
    return _render_common(scene_or_tables, camera, size, background, cfg, region,
                          as_u8=False, stats=stats, reporter=reporter)


def render_u8(scene_or_tables, camera: CameraSettings, size: Tuple[int, int],
              background: Callable = default_background,
              cfg: Optional[RenderConfig] = None,
              region: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
              stats: Optional[list] = None,
              reporter: Optional[Reporter] = None) -> np.ndarray:
    """The gamma-encoded u8 image [H,W,3] (render.rs:143-147), finalised on
    the device.  `region`, `stats` and `reporter` as in render_linear."""
    return _render_common(scene_or_tables, camera, size, background, cfg, region,
                          as_u8=True, stats=stats, reporter=reporter)


def finalize(linear: np.ndarray) -> np.ndarray:
    """Gamma-encode + clamp (render.rs:47-50). Returns float [H,W,3] 0..1."""
    return np.clip(np.maximum(linear, 0.0) ** (1.0 / GAMMA), 0.0, 1.0)


def to_u8(img01: np.ndarray) -> np.ndarray:
    """u8 quantisation by truncation, like `(c * 255.0) as u8`."""
    return (img01 * 255.0).astype(np.uint8)


class Image:
    """The reference's Image (src/render.rs:154-224): opens an existing PNG
    of matching size (a region re-render keeps the rest), renders scenes,
    saves PNGs."""

    def __init__(self, path, width: int, height: int):
        self.path = path
        self.width = width
        self.height = height
        self.buffer = np.zeros((height, width, 3), dtype=np.uint8)
        if path is not None and os.path.exists(path):
            img = read_png(path)
            if img.shape == self.buffer.shape:
                self.buffer = img

    def render(self, scene: Scene, camera: CameraSettings,
               background: Callable = default_background,
               cfg: Optional[RenderConfig] = None, region=None, stats=None,
               reporter: Optional[Reporter] = None):
        u8 = render_u8(scene, camera, (self.width, self.height), background, cfg,
                       region=region, stats=stats, reporter=reporter)
        if region is None:
            self.buffer = u8
        else:
            (x1, y1), (x2, y2) = region
            self.buffer[y1:y2 + 1, x1:x2 + 1] = u8[y1:y2 + 1, x1:x2 + 1]
        return self

    def slice_render(self, top_left, bottom_right, *args, **kwargs):
        return self.render(*args, region=(top_left, bottom_right), **kwargs)

    def save(self):
        return self.save_as(self.path)

    def save_as(self, path):
        """Write the buffer as a PNG.  The port has no other encoder: a
        path whose suffix is not ``.png`` (in any case) raises."""
        suffix = os.path.splitext(os.fspath(path))[1]
        if suffix.lower() != ".png":
            raise ValueError(f"{path}: only PNG is written, not {suffix or 'no suffix'!r}")
        return write_png(path, self.buffer)

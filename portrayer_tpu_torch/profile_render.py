"""Where the render's time goes on one CUDA device.

    python3 -m portrayer_tpu_torch.profile_render [--scene big-scene] [--out out/profile]
        [--one-shard SPP]

A scene that is not registered goes through ``profile(spec, out)`` with
its ``scenes.SceneSpec``, e.g. the inline procedural-meshes scene:

    python3 -c "import sys; sys.path.insert(0, 'tests'); import _torch_jax as J, \
portrayer_tpu_torch as T; from portrayer_tpu_torch import scenes, profile_render as P; \
s, c, z = J.procedural_meshes(T); P.profile(scenes.SceneSpec(scene=s, camera=c, size=z, \
background=scenes.sky_background, name='procedural-meshes'), 'out/profile')"

Renders the middle tile row of a scene at its published size (a region
re-render, so its samples are the full frame's: for big-scene at
1980x1020, row 3, y = 384..511) at 16 spp, the smoke run's main-path
settings, with 131,072 rays per launch: first untraced, three times, for
the wall time; then once under ``torch.profiler``.  From the trace's
device events it
prints the traced wall time, the device time (the union of kernel, memcpy
and memset intervals), the device's busy share of the traced wall, the
number of kernel launches, the sweep kernels' share, and the kernels that
take the most time.  ``--out`` receives the summary as JSON and the trace
(gzipped Chrome trace format).

``--one-shard SPP`` profiles the whole frame at SPP instead, traced in
one ``trace`` call through ``parallel.render_frame_distributed`` at world
size 1 (one chunk), to set against the tiled render's chunks.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import statistics
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SWEEP_KERNEL = "sweep_kernel"
SPP = 16
REPEATS = 3


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize_trace(trace: dict, wall_ms: float, n_chunks: int, top: int = 12) -> dict:
    """Device-side summary of a Chrome-format torch.profiler trace whose
    traced region took `wall_ms` on the host clock."""
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy_ms = _union_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"] / 1e3
    sweep = [v for k, v in by_name.items() if SWEEP_KERNEL in k]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "traced_wall_ms": wall_ms,
        "device_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms > 0 else 0.0,
        "kernel_launches": len(kernels),
        "kernel_launches_per_chunk": len(kernels) / max(n_chunks, 1),
        "kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
        "sweep_launches": sum(v[0] for v in sweep),
        "sweep_ms": sum(v[1] for v in sweep),
        "chunks": n_chunks,
        "top_kernels": [{"name": k, "launches": v[0], "ms": v[1]} for k, v in ranked],
    }


def profile(spec, out=os.path.join("out", "profile"), one_shard_spp=None) -> dict:
    """Profile the render of SceneSpec `spec` on CUDA device 0 (see the
    module docstring); writes the summary and trace under `out`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from . import RenderConfig, flatten_scene, parallel, render_u8

    if not torch.cuda.is_available():
        raise SystemExit("profile_render: no CUDA device")
    dev = torch.device("cuda", 0)
    w, h = spec.size
    spp = one_shard_spp or SPP
    cfg = RenderConfig(device=dev, samples=spp, max_rays_per_launch=131072)
    th, tw = cfg.tile
    stats = []
    if one_shard_spp:
        y0, region, tiles, chunks = 0, ((0, 0), (w - 1, h - 1)), 1, 1
        st = flatten_scene(spec.scene, dev)
        parallel.initialize(num_processes=1, device=dev)
        mesh = parallel.make_mesh(1, device="cuda")
        render = lambda stats=None: parallel.render_frame_distributed(
            mesh, st, spec.camera, (w, h), spec.background, cfg)
    else:
        y0 = (-(-h // th) - 1) // 2 * th
        region = ((0, y0), (w - 1, min(y0 + th, h) - 1))
        tiles = -(-w // tw)
        chunks = tiles * -(-spp // max(1, cfg.max_rays_per_launch // (th * tw)))
        render = lambda stats=None: render_u8(spec.scene, spec.camera, (w, h),
                                              spec.background, cfg, region=region, stats=stats)

    render(stats)  # builds the kernel, warms the allocator, counts the rounds
    torch.cuda.synchronize()
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if one_shard_spp:
        torch.distributed.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            raw = f.read()
    summary = summarize_trace(json.loads(raw), traced_ms, chunks)
    summary.update(
        scene=spec.name, card=torch.cuda.get_device_name(dev), spp=spp,
        one_shard=bool(one_shard_spp), rows=(y0, region[1][1]),
        untraced_wall_ms=walls, untraced_wall_ms_median=statistics.median(walls),
        untraced_ms_per_chunk=statistics.median(walls) / chunks,
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    if stats:
        summary.update(
            rounds_per_chunk=sum(int((s.live > 0).sum()) for s in stats) / chunks,
            host_syncs_per_chunk=sum(s.syncs for s in stats) / chunks,
            live_per_round=[int(n) for n in sum(s.live for s in stats)])

    os.makedirs(out, exist_ok=True)
    with gzip.open(os.path.join(out, "trace.json.gz"), "wb") as f:
        f.write(raw)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    s = summary
    if one_shard_spp:
        print(f"[profile] {spec.name} {w}x{h} x {spp} spp in one trace ({w * h * spp} rays, "
              f"render_frame_distributed at world size 1) on {s['card']}; peak memory "
              f"{s['peak_gib']:.3f} GiB")
    else:
        print(f"[profile] {spec.name} rows {y0}..{region[1][1]}, {tiles} tiles x {spp} spp = "
              f"{chunks} chunks of {th * tw * min(spp, cfg.max_rays_per_launch // (th * tw))} "
              f"rays on {s['card']}")
    print(f"[profile] untraced wall {', '.join(f'{x:.3f}' for x in walls)} ms "
          f"(median {s['untraced_wall_ms_median']:.3f} ms, {s['untraced_ms_per_chunk']:.3f} "
          f"ms per chunk)")
    print(f"[profile] traced wall {traced_ms:.3f} ms; device busy {s['device_ms']:.3f} ms "
          f"({s['device_busy_share']:.1%} of the traced wall); {s['kernel_launches']} kernel "
          f"launches ({s['kernel_launches_per_chunk']:.1f} per chunk), {s['kernel_ms']:.3f} ms")
    print(f"[profile] sweep kernels: {s['sweep_launches']} launches, {s['sweep_ms']:.3f} ms "
          f"({s['sweep_ms'] / max(s['device_ms'], 1e-9):.1%} of device time)")
    if stats:
        print(f"[profile] bounce rounds {s['rounds_per_chunk']:.2f} and host syncs "
              f"{s['host_syncs_per_chunk']:.2f} per chunk; live rays per round "
              f"{s['live_per_round']}")
    for k in s["top_kernels"]:
        print(f"[profile]   {k['ms']:9.3f} ms {k['launches']:7d} x  {k['name'][:110]}")
    return summary


def main(argv=None):
    from . import scenes

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="big-scene", choices=scenes.names())
    ap.add_argument("--out", default=os.path.join("out", "profile"))
    ap.add_argument("--one-shard", type=int, default=None, metavar="SPP",
                    help="the whole frame at SPP in one trace (see the module docstring)")
    args = ap.parse_args(argv)
    return profile(scenes.load(args.scene), args.out, args.one_shard)


if __name__ == "__main__":
    main()

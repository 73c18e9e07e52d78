"""One rank of the port's multi-process CPU tests (gloo).

Launched by tests/test_torch_parallel.py, once per rank:

    python tests/_torch_parallel_worker.py STORE WORLD RANK IN_NPZ OUT_DIR TASKS

STORE is the path of a file:// rendezvous store shared by the ranks; with
WORLD 1 the rank forms its own one-rank group (initialize(num_processes=1)).
IN_NPZ holds the JAX package's rays (o, d, pix, bg, n_pixels) for the
"trace" task and the 8x8 rays for "train".  TASKS is a comma list of
trace, train, tiles, frame, pad, four; each writes <task>_r<RANK>.npz into
OUT_DIR.  Imports torch and the port only.
"""

import os
import sys


def main():
    store, world, rank, in_npz, out_dir, tasks = sys.argv[1:7]
    world, rank = int(world), int(rank)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import portrayer_tpu_torch as T
    from portrayer_tpu_torch import parallel as par, rng, scenes
    from portrayer_tpu_torch.camera import Camera
    from portrayer_tpu_torch.parallel import distributed as pdist

    if world > 1:
        assert par.initialize(f"file://{store}", world, rank, device="cpu")
    else:
        assert par.initialize() is False and not dist.is_initialized()
        assert par.initialize(num_processes=1, device="cpu") is False
    try:
        mesh = par.make_mesh(world, device="cpu")
        assert mesh.size() == world and mesh.get_local_rank() == rank
        inp = np.load(in_npz)
        simple = scenes.load("simple")
        st = T.flatten_scene(simple.scene, "cpu")
        cfg = T.RenderConfig(device="cpu", samples=2, accel="flat")
        save = lambda task, **arrays: np.savez(os.path.join(out_dir, f"{task}_r{rank}.npz"),
                                               **arrays)
        t = lambda name: torch.from_numpy(inp[name])
        for task in tasks.split(","):
            if task == "trace":
                args = (rng.PRNGKey(7), t("o"), t("d"), t("pix"), t("bg"),
                        int(inp["n_pixels"]), st, cfg)
                acc = par.trace_sharded(mesh, *args)
                parts = par.trace_sharded(mesh, *args, reduce=False)
                save(task, acc=acc.numpy(), parts=parts.numpy())
            elif task == "train":
                n = int(inp["train_n_pixels"])
                loss, grads = par.train_step(
                    mesh, rng.PRNGKey(3), t("train_o"), t("train_d"), t("train_pix"),
                    torch.zeros((n, 3)), n, 2, torch.zeros((n, 3)), st, cfg)
                save(task, loss=loss.numpy(), **{f: g.numpy() for f, g in grads.items()})
            elif task in ("tiles", "frame"):
                # Record every block of rows built, and by whom.
                rows = []
                make = pdist.make_global_rays

                def recording(mesh, make_shard, R, device=None):
                    def shard(lo, hi):
                        out = make_shard(lo, hi)
                        rows.append((lo, hi, R, out[0].shape[0]))
                        return out
                    return make(mesh, shard, R, device)

                pdist.make_global_rays = recording
                if task == "tiles":
                    img = par.render_tiles_sharded(mesh, st, simple.camera, (24, 20),
                                                   simple.background, cfg)
                else:
                    img = par.render_frame_distributed(par.global_mesh(device="cpu"), st,
                                                       simple.camera, (32, 32),
                                                       simple.background, cfg)
                pdist.make_global_rays = make
                save(task, img=img, rows=np.asarray(rows))
            elif task == "pad":
                # 5x3 x 1 spp = 15 rays over 4 ranks: one padding row.
                one = T.RenderConfig(device="cpu", samples=1, accel="flat")
                args = (st, simple.camera, (5, 3), simple.background, one)
                save(task, tiles=par.render_tiles_sharded(mesh, *args),
                     frame=par.render_frame_distributed(mesh, *args))
            elif task == "four":
                spec = scenes.load("four-shapes")
                fst = T.flatten_scene(spec.scene, "cpu")
                tile = 16
                ys, xs = np.mgrid[0:tile, 0:tile]
                cam = Camera(spec.camera, (tile, tile), "cpu")
                o, d = cam.rays_at(torch.tensor(xs.reshape(-1), dtype=torch.float32) + 0.5,
                                   torch.tensor(ys.reshape(-1), dtype=torch.float32) + 0.5)
                pix = torch.arange(tile * tile, dtype=torch.int32)
                bg = torch.zeros((tile * tile, 3))
                accs = {accel: par.trace_sharded(
                    mesh, rng.PRNGKey(11), o, d, pix, bg, tile * tile, fst,
                    T.RenderConfig(device="cpu", samples=1, accel=accel, max_depth=2)).numpy()
                    for accel in ("cuda", "flat")}
                save(task, **accs)
            else:
                raise ValueError(task)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""The fit cell's step: ``parallel.train_step`` of the program at world
size 1, then the benchmark's own Adam update of the returned gradients
into the tables.  Set-up renders the target from the true scene through
``parallel.render_frame_distributed`` and builds the camera rays once
through ``parallel.distributed.make_global_rays``."""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import scene as HS

ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
# Relative size of the start's perturbation of every fitted value.
PERTURB = 0.1


def perturb(data: dict, seed: int) -> dict:
    """The fit's start: `data` with every fitted value moved by a draw of
    `seed`: material colours, shininess and reflectivity, light colours
    and the ambient term scaled by 1 + PERTURB * u, light positions and
    every node shifted by PERTURB * u (node shifts by a tenth of that), u
    uniform in [-1, 1)."""
    rng = np.random.default_rng(seed)
    u = lambda n: rng.uniform(-1.0, 1.0, n)
    out = copy.deepcopy(data)
    for m in out["materials"]:
        m["diffuse"] = list(np.clip(np.asarray(m["diffuse"]) * (1 + PERTURB * u(3)), 0, 1))
        m["specular"] = list(np.asarray(m["specular"]) * (1 + PERTURB * u(3)))
        m["shininess"] = float(m["shininess"] * (1 + PERTURB * u(1)[0]))
        m["reflectivity"] = float(m["reflectivity"] * (1 + PERTURB * u(1)[0]))
    for lt in out["lights"]:
        lt["color"] = list(np.asarray(lt["color"]) * (1 + PERTURB * u(3)))
        lt["position"] = list(np.asarray(lt["position"]) + PERTURB * u(3))
    out["ambient"] = list(np.asarray(out["ambient"]) * (1 + PERTURB * u(3)))
    for n in out["nodes"]:
        n["transform"] = n["transform"] + [["translate", list(0.1 * PERTURB * u(3))]]
    return out


class Fit:
    """The program's fit of `data_start` towards the target rendered from
    `data_true`, one frame of `spp` samples a pixel in one trace."""

    def __init__(self, T, data_true: dict, data_start: dict, seed: int, spp: int, device,
                 accel: str = "cuda"):
        from portrayer_tpu_torch import parallel, rng
        from portrayer_tpu_torch.parallel.distributed import frame_rays, make_global_rays

        self.parallel = parallel
        dev = torch.device(device)
        parallel.initialize(num_processes=1, device=dev)
        self.mesh = parallel.make_mesh(1, device=dev.type)
        self.cfg = T.RenderConfig(device=dev, samples=spp, seed=seed, accel=accel)
        scene, cam, bg = HS.build(T, data_true)
        w, h = data_true["size"]
        self.n_pixels, self.spp = w * h, spp
        true = T.flatten_scene(scene, dev)
        img = parallel.render_frame_distributed(self.mesh, true, cam, (w, h), bg, self.cfg)
        self.target = torch.as_tensor(img.reshape(-1, 3), dtype=torch.float32, device=dev)
        start, _, _ = HS.build(T, data_start)
        self.st = T.flatten_scene(start, dev)
        key = rng.PRNGKey(seed)
        cam_ = T.Camera(cam, (w, h), dev)
        self.o, self.d, self.pix, _ = make_global_rays(
            self.mesh, lambda lo, hi: frame_rays(cam_, spp, key, lo, hi, torch.float32, dev),
            w * h * spp, device=dev)
        self.key = rng.fold_in(key, 1)
        self.bg = bg(torch.stack([torch.arange(w * h, device=dev) % w / w,
                                  torch.arange(w * h, device=dev) // w / h], -1).float())
        self.fields = tuple(parallel.DIFF_FIELDS)
        self.m = {f: torch.zeros_like(getattr(self.st, f)) for f in self.fields}
        self.v = {f: torch.zeros_like(getattr(self.st, f)) for f in self.fields}
        self.t = 0

    def step(self) -> torch.Tensor:
        """One step; returns the loss (a device scalar)."""
        loss, grads = self.parallel.train_step(
            self.mesh, self.key, self.o, self.d, self.pix, self.bg, self.n_pixels, self.spp,
            self.target, self.st, self.cfg, fields=self.fields)
        self.t += 1
        b1, b2 = ADAM["beta1"], ADAM["beta2"]
        new = {}
        for f in self.fields:
            g = grads[f]
            self.m[f].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[f].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[f] / (1.0 - b1 ** self.t)
            v_hat = self.v[f] / (1.0 - b2 ** self.t)
            new[f] = getattr(self.st, f) - ADAM["lr"] * m_hat / (torch.sqrt(v_hat) + ADAM["eps"])
        self.st = self.st.replace(**new)
        return loss

    def first_gradient(self) -> dict:
        """The first step's gradients as the optimizer holds them: m after
        one step over (1 - beta1).  Valid after exactly one step."""
        return {f: m / (1.0 - ADAM["beta1"]) for f, m in self.m.items()}

    def params(self) -> dict:
        return {f: getattr(self.st, f).detach() for f in self.fields}

    def close(self):
        torch.distributed.destroy_process_group()

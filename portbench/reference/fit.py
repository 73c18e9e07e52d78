"""The plain reference of a fit: the frame's rays one sample a pixel (the
program's whole-frame grid by specification: lane i is pixel i // spp,
its jitter `uniform(fold(fold(key, 0), 0))` at positions 2i, 2i + 1, its
rounds keyed `fold(fold(fold(fold(key, 1), 0), r)` and sample id i), the
target traced from the true tables, the MSE of the mean radiance against
it, autograd's gradients, and Adam."""

from __future__ import annotations

import torch

from . import render as R
from . import threefry as tf
from .scene import PARAMS, Tables, tables

ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)


def frame_rays(data: dict, sc: Tables, seed: int, spp: int):
    """(rays, background [P, 3]) of the whole frame."""
    W, H = sc.width, sc.height
    dev, dt = sc.eye.device, sc.dtype
    ids = torch.arange(W * H * spp, dtype=torch.int64, device=dev)
    pix = ids // spp
    base = tf.key(seed, dev)
    jit = tf.uniform_at(tf.fold(tf.fold(base, 0), 0), torch.stack([2 * ids, 2 * ids + 1], -1))
    o, d = R.camera_rays(sc, (pix % W).to(torch.float32) + jit[:, 0],
                         (pix // W).to(torch.float32) + jit[:, 1])
    n = ids.numel()
    rays = R.Rays(o, d, torch.ones((n,), dtype=dt, device=dev), pix,
                  torch.full((n,), R.EPS, dtype=dt, device=dev),
                  torch.full((n,), -1, dtype=torch.int64, device=dev), ids,
                  tf.fold(tf.fold(base, 1), 0).expand(n, 2))
    all_pix = torch.arange(W * H, device=dev)
    return rays, R.background(data, sc, all_pix % W, all_pix // W)


def mean_image(sc: Tables, rays, bg, spp: int):
    return R.trace(sc, rays, sc.width * sc.height, bg) / spp


def loss_and_grads(sc: Tables, rays, bg, spp: int, target, params: dict):
    """(loss, {name: gradient}) at `params`."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = torch.mean((mean_image(sc.with_params(leaves), rays, bg, spp) - target) ** 2)
    grads = torch.autograd.grad(loss, [leaves[k] for k in PARAMS], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(PARAMS, grads)}


class Adam:
    """Plain Adam over a dict of tensors."""

    def __init__(self, params: dict, lr, beta1, beta2, eps):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.lr, self.b1, self.b2, self.eps, self.t = lr, beta1, beta2, eps, 0

    def step(self, grads: dict):
        self.t += 1
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** self.t)
            v_hat = self.v[k] / (1.0 - self.b2 ** self.t)
            self.params[k] = self.params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def follow(data_true: dict, data_start: dict, device, seed: int, spp: int, steps: int,
           dtype=torch.float32):
    """The reference's first `steps` fit steps from the start data against
    the true data's target: (losses, first gradients, start parameters,
    parameters after the steps)."""
    sc_true = tables(data_true, device, dtype)
    sc = tables(data_start, device, dtype)
    rays, bg = frame_rays(data_true, sc, seed, spp)
    with torch.no_grad():
        target = mean_image(sc_true, rays, bg, spp)
    opt = Adam(sc.params, **ADAM)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(sc, rays, bg, spp, target, opt.params)
        losses.append(float(loss))
        first = grads if first is None else first
        opt.step(grads)
    return losses, first, {k: v.detach() for k, v in sc.params.items()}, opt.params


"""A round's lane work as two CUDA kernels (``csrc/round.cu``), on either
side of the any-hit sweep: ``shade_round`` (hit detail, shading, the
draws, the shadow rays and the children) and ``resolve_round`` (the
unoccluded light into acc, the children placed in the next queue).

``ops/trace.py``'s chain of PyTorch ops (``_round_shade``,
``_apply_shadows``, ``_compact`` over ``hit_detail`` and ``shade_pre``)
is their plain version and stays the path wherever a kernel cannot run or
autograd has to see the ops: ``takes_kernels`` picks the route from what
the round's tensors and tables are, before the call.  The fit (whose
captured forward runs some rounds without recording, then replays them
under autograd) keeps the plain chain because its tables require grad,
whether or not autograd records at the moment.

The kernels read the queue, the sweep's hits and the tables where they
lie, and write into buffers allocated here (in a captured graph, from its
pool), or the next queue straight into `out`; nothing is read on the
host.  A bounce round adds to `acc` in place.  ``counts()`` gives the
kernels' launches, counted on the device where they run (a captured
launch at each replay), and the rounds on CUDA tensors that took the
plain chain (``plain_rounds_cuda``), which a render on the card never
takes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, counters, rng
from . import cuda_intersect
from ..scene.flatten import TORUS
from .intersect import intersect_scene, occluded

# The kernels, in the order of csrc/round.cu's counters.
KERNELS = ("shade_round", "resolve_round")
_COUNTERS = counters.Group(KERNELS, host_only=("plain_rounds_cuda",))
COUNTS = _COUNTERS.host
device_counts = _COUNTERS.on
reset_counts = _COUNTERS.reset
counts = _COUNTERS.read


def takes_kernels(device_type: str, dtype, grad_fields, soft_visibility: float, fn_textures,
                  inputs_grad: bool = False) -> bool:
    """Whether a round takes the kernels: on a CUDA float32 queue, over
    tables none of whose fields requires grad (`grad_fields`, trace.py's
    ``grad_fields``) and inputs none of which does, without soft
    silhouettes and without procedural textures (Python callables, which
    no kernel can run).  Anywhere else the plain chain runs."""
    return (device_type == "cuda" and dtype == torch.float32 and not grad_fields
            and not inputs_grad and soft_visibility == 0.0 and not fn_textures)


_P, _LL, _F, _I, _U = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                       ctypes.c_uint)


class _ShadeArgs(ctypes.Structure):
    """csrc/round.cu's ShadeArgs, field for field."""
    _fields_ = [(n, _P) for n in (
        "o", "d", "w", "pix", "t_min", "src_node", "src_tri", "sid", "hit_t", "hit_node",
        "hit_tri", "hit_mask", "rec", "trec", "tex_data", "tex_meta", "nm_data", "nm_meta",
        "light_pos", "light_color", "light_falloff", "light_area_a", "light_area_b", "ambient",
        "bg", "key", "acc", "x", "sh_o", "sh_d", "sh_t", "sh_need", "sh_src_node",
        "sh_src_tri", "lc", "c_o", "c_d", "c_w", "c_pix", "c_t", "c_src_node", "c_src_tri",
        "c_sid", "take", "counts")] + [
        ("key_word", _LL), ("n", _LL), ("k1", _U), ("k2", _U), ("epsilon", _F),
        ("eps_rel", _F), ("self_eps", _F), ("eps_r", _F)] + [(n, _I) for n in (
            "spp_c", "n_lights", "area", "is_last", "flags")]


class _ResolveArgs(ctypes.Structure):
    """csrc/round.cu's ResolveArgs, field for field."""
    _fields_ = [(n, _P) for n in (
        "occ", "lc", "x", "acc", "light", "bg", "pix", "c_o", "c_d", "c_w", "c_pix", "c_t",
        "c_src_node", "c_src_tri", "c_sid", "pos", "q_o", "q_d", "q_w", "q_pix", "q_t",
        "q_src_node", "q_src_tri", "q_sid", "n_live", "dropped", "counts")] + [
        ("n", _LL), ("cap", _LL), ("n_pixels", _LL)] + [(n, _I) for n in (
            "n_lights", "spp_c", "occ_is_int")]


_QUEUE_DTYPES = {"o": torch.float32, "d": torch.float32, "w": torch.float32, "pix": torch.int32,
                 "t_min": torch.float32, "src_node": torch.int32, "src_tri": torch.int32,
                 "sid": torch.int32}
_checked_layout = []


def _lib():
    """The kernel library, its argument layouts checked once against ctypes'."""
    lib = _build.load()
    if not _checked_layout:
        sizes = (ctypes.c_longlong * 2)()
        lib.round_args_sizes(sizes)
        if tuple(sizes) != (ctypes.sizeof(_ShadeArgs), ctypes.sizeof(_ResolveArgs)):
            raise RuntimeError(f"round kernels: argument layouts {tuple(sizes)} differ from "
                               f"the binding's {ctypes.sizeof(_ShadeArgs)}, "
                               f"{ctypes.sizeof(_ResolveArgs)}")
        _checked_layout.append(True)
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _arg(name, x, dtype, shape=None):
    """x, checked: on the card, of `dtype`, of `shape` where given, and
    contiguous; raises otherwise (the kernels read raw pointers)."""
    if not x.is_cuda or x.dtype != dtype:
        raise ValueError(f"round kernel: {name} must be a CUDA {dtype} tensor, got "
                         f"{x.device} {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"round kernel: {name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"round kernel: {name} must be contiguous")
    return x


# The +inf buffers made so far, per device, largest last; never freed, as
# a captured graph may read any of them.
_INF = {}


def _inf(n: int, like):
    """[n] +inf on like's device: a slice of a buffer filled outside every
    capture (a fresh fill where a capture would have to make it)."""
    bufs = _INF.setdefault(like.device, [])
    if not bufs or bufs[-1].shape[0] < n:
        full = torch.full((n,), float("inf"), dtype=like.dtype, device=like.device)
        if torch.cuda.is_current_stream_capturing():
            return full
        bufs.append(full)
    return bufs[-1][:n]


def _nearest(q, st, cfg):
    """The nearest hits of queue q: (t, node, tri, hit mask or None where
    the kernel derives it from t and w)."""
    active = q.w > 0.0
    if cfg.accel == "cuda":
        (t, node, tri), _ = cuda_intersect.sweep_launch(
            q.o, q.d, q.t_min, _inf(q.o.shape[0], q.o), st, cfg, active=active,
            src_node=q.src_node, src_tri=q.src_tri)
        return t, node, tri, None
    hit = intersect_scene(q.o, q.d, q.t_min, float("inf"), st, cfg, active=active,
                          src_node=q.src_node, src_tri=q.src_tri)
    return hit.t.contiguous(), hit.node.contiguous(), hit.tri.contiguous(), hit.hit.contiguous()


def _occluded(sh, st, cfg):
    """The any-hit sweep over the shadow rays: (occlusion [L * R], int32
    or bool)."""
    o, d, t, need, src_node, src_tri = sh
    if cfg.accel == "cuda":
        found, _ = cuda_intersect.sweep_launch(o, d, t, _inf(o.shape[0], o), st, cfg,
                                               active=need, src_node=src_node,
                                               src_tri=src_tri, any_hit=True)
        return found
    return occluded(o, d, t, float("inf"), st, cfg, active=need, src_node=src_node,
                    src_tri=src_tri).contiguous()


def round_(rkey, q, acc, bg, st, cfg, is_last: bool, next_cap, spp_c: int, sweeps,
           n_pixels=None, out=None):
    """ops/trace.py's _round through the kernels: (acc, the next queue or
    None, dropped or None, n_live or None).  acc None (round 0) starts a
    fresh [n_pixels, 3]; otherwise the round adds to it in place.  The
    next queue is `out` where given (a _Queue of next_cap lanes), filled
    in place.  dropped is None where the children cannot outnumber
    next_cap (nothing can be dropped); where they can, trace.py's
    take_flags sets the threshold."""
    from .trace import _Queue, take_flags

    dev = q.o.device
    R = q.o.shape[0]
    L = st.n_lights
    f32, i32 = torch.float32, torch.int32
    for name, x in zip(_Queue._fields, q):
        _arg(name, x, _QUEUE_DTYPES[name], (R, 3) if name in ("o", "d") else (R,))
    _arg("bg", bg, f32)
    _arg("st.rec", st.rec, f32)
    _arg("st.ambient", st.ambient, f32, (3,))
    if st.trec.numel():
        _arg("st.trec", st.trec, f32)
    for name in ("light_pos", "light_color", "light_falloff", "light_area_a", "light_area_b"):
        if L:
            _arg(f"st.{name}", getattr(st, name), f32)
    for kind, on in (("tex", st.any_image_tex), ("nm", st.any_normal_map)):
        if on:
            _arg(f"st.{kind}_data", getattr(st, f"{kind}_data"), torch.uint8)
            _arg(f"st.{kind}_meta", getattr(st, f"{kind}_meta"), i32)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cnt = device_counts(dev).data_ptr()
    key_ptr, key_word, k1, k2, rkey = rng._key_args(rkey, dev)

    t, node, tri, hit_mask = sweeps(lambda: _nearest(q, st, cfg))
    if acc is None:
        acc = (torch.empty if spp_c else torch.zeros)((n_pixels, 3), dtype=f32, device=dev)
    _arg("acc", acc, f32)
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
    # Under deterministic algorithms a bounce round's terms go to acc by
    # index_add_ (in one order) instead of the kernels' atomics.
    det = torch.are_deterministic_algorithms_enabled() and not spp_c
    x = empty(R, 3) if spp_c or det else None
    light = empty(R, 3) if det and L else None
    sh = (empty(L * R, 3), empty(L * R, 3), empty(L * R), empty(L * R, dtype=torch.bool),
          empty(L * R, dtype=i32), empty(L * R, dtype=i32))
    lc = empty(L, R, 3)
    child = None if is_last else _Queue(
        o=empty(2 * R, 3), d=empty(2 * R, 3), w=empty(2 * R), pix=empty(2 * R, dtype=i32),
        t_min=empty(2 * R), src_node=empty(2 * R, dtype=i32), src_tri=empty(2 * R, dtype=i32),
        sid=empty(2 * R, dtype=i32))
    overflow = not is_last and 2 * R > next_cap
    take = None if is_last or overflow else empty(2 * R, dtype=i32)
    flags = ((1 if st.any_reflective else 0) | (2 if st.any_refractive else 0)
             | (4 if st.any_glossy else 0) | (8 if st.any_image_tex else 0)
             | (16 if st.any_normal_map else 0))
    a = _ShadeArgs(
        *(_ptr(x_) for x_ in q), _ptr(t), _ptr(node), _ptr(tri), _ptr(hit_mask),
        _ptr(st.rec), _ptr(st.trec) if st.trec.numel() else None,
        _ptr(st.tex_data) if st.any_image_tex else None,
        _ptr(st.tex_meta) if st.any_image_tex else None,
        _ptr(st.nm_data) if st.any_normal_map else None,
        _ptr(st.nm_meta) if st.any_normal_map else None,
        *(_ptr(getattr(st, f)) if L else None for f in (
            "light_pos", "light_color", "light_falloff", "light_area_a", "light_area_b")),
        _ptr(st.ambient), _ptr(bg), key_ptr, _ptr(acc), _ptr(x), *(_ptr(s) for s in sh),
        _ptr(lc), *((_ptr(c) for c in child) if child is not None else (None,) * 8),
        _ptr(take), cnt,
        key_word, R, k1, k2, cfg.epsilon, cfg.eps_rel or 0.0, cfg.self_eps_local,
        0.5 + cfg.epsilon, spp_c, L, sum(1 << li for li, area in enumerate(st.area_flags)
                                         if area),
        int(is_last), flags)
    has_torus = any(kind == TORUS for kind, _, _ in st.groups)
    _done("shade_round", lib.shade_round(ctypes.byref(a), int(has_torus), stream))

    occ = sweeps(lambda: _occluded(sh, st, cfg)) if L else None
    dropped = n_live = pos = None
    if not is_last:
        if overflow:
            take = take_flags(child.w, next_cap)
            pos = torch.cumsum(take, 0, dtype=i32)
            dropped = None if det else torch.zeros((), dtype=f32, device=dev)
        else:
            pos = torch.cumsum(take, 0, dtype=i32)
        if out is None:
            out = _Queue(o=empty(next_cap, 3), d=empty(next_cap, 3), w=empty(next_cap),
                         pix=empty(next_cap, dtype=i32), t_min=empty(next_cap),
                         src_node=empty(next_cap, dtype=i32),
                         src_tri=empty(next_cap, dtype=i32), sid=empty(next_cap, dtype=i32))
        for name, buf in zip(_Queue._fields, out):
            _arg(f"out.{name}", buf, _QUEUE_DTYPES[name],
                 (next_cap, 3) if name in ("o", "d") else (next_cap,))
        n_live = empty(dtype=torch.int64)
    b = _ResolveArgs(
        _ptr(occ), _ptr(lc), _ptr(x), _ptr(acc), _ptr(light), _ptr(bg),
        _ptr(q.pix if child is None else child.pix),
        *((_ptr(c) for c in child) if child is not None else (None,) * 8), _ptr(pos),
        *((_ptr(c) for c in out) if out is not None else (None,) * 8), _ptr(n_live),
        _ptr(dropped), cnt, R, next_cap or 0, acc.shape[0], L, spp_c,
        int(occ is not None and occ.dtype == i32))
    _done("resolve_round", lib.resolve_round(ctypes.byref(b), stream))
    if det:  # the plain chain's index_adds, in its order
        pix = (q.pix if child is None else child.pix[:R]).long()
        acc.index_add_(0, pix, x)
        if light is not None:
            acc.index_add_(0, pix, light)
        if overflow:
            dropped_w = torch.where(take, 0.0, child.w)
            cpix = child.pix.long()
            acc.index_add_(0, cpix, dropped_w[:, None] * bg[cpix])
            dropped = dropped_w.sum()
    return acc, out if not is_last else None, dropped, n_live


def _done(entry: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"round kernel ({entry}) launch failed: CUDA error {rc}")

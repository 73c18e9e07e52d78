"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles each of ``csrc/*.cu`` (all at once, one
process a source) and links them into one shared library with a plain C
interface under ``build/`` (keyed by a hash of the sources, the headers
``csrc/*.cuh`` they share and the flags), which ctypes then loads.
Nothing is built when a module is imported, and nothing comes from
outside the checkout but the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # Every mul and add rounds on its own, like the plain PyTorch versions.
    "-fmad=false",
    "-Xptxas", "-v",
)

_lib = None
# What the last build did: seconds spent in nvcc (0.0 when the library was
# already built) and the ptxas resource report.
build_info = {"seconds": None, "ptxas": ""}


def ptxas_kernels(report: str):
    """[(entry function, registers, spill store bytes, spill load bytes)]
    from a `-Xptxas -v` report, one per kernel instantiation."""
    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [p] * 15 + [i, i, i, i, f, f, i]
    lib.sweep_nearest.argtypes = common + [p, p, p, p]
    lib.sweep_nearest.restype = i
    lib.sweep_any_hit.argtypes = common + [p, p]
    lib.sweep_any_hit.restype = i
    lib.cond_if_begin.argtypes = [p, p, ctypes.c_longlong, p, p]
    lib.cond_if_begin.restype = i
    lib.cond_if_end.argtypes = [p]
    lib.cond_if_end.restype = i
    ll = ctypes.c_longlong
    lib.cond_while_begin.argtypes = [p, p, ll, p, p, p, p]
    lib.cond_while_begin.restype = i
    lib.cond_while_end.argtypes = [p, ctypes.c_ulonglong, p, ll, p, p]
    lib.cond_while_end.restype = i
    lib.cond_stream_create.argtypes = [p]
    lib.cond_stream_create.restype = i
    lib.stamp_time.argtypes = [p, p, p, ll, ll, p]
    lib.stamp_time.restype = i
    u, lls = ctypes.c_uint, ctypes.POINTER(ll)
    lib.threefry_fold_in.argtypes = [p, ll, u, u, p, i, u, i, lls, lls, lls, ll, p, p, p]
    lib.threefry_fold_in.restype = i
    lib.threefry_uniform.argtypes = [p, ll, u, u, ll, ll, p, p, p]
    lib.threefry_uniform.restype = i
    lib.threefry_draw_lanes.argtypes = [p, ll, u, u, u, p, i, ll, ll, i, p, p, p]
    lib.threefry_draw_lanes.restype = i
    lib.shade_round.argtypes = [p, i, p]
    lib.shade_round.restype = i
    lib.resolve_round.argtypes = [p, p]
    lib.resolve_round.restype = i
    lib.round_args_sizes.argtypes = [p]
    lib.round_args_sizes.restype = i
    return lib


def load():
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(_BUILD_DIR, f"libportrayer_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        reports = [proc.communicate()[1] for proc in procs]
        for proc, src, report in zip(procs, sources, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{report}")
        proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        for obj in objs:
            os.remove(obj)
        build_info["ptxas"] = "".join(reports)
    build_info["seconds"] = time.perf_counter() - t0
    _lib = _bind(ctypes.CDLL(so))
    return _lib

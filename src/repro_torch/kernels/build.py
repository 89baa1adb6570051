"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by one
``nvcc`` call into its own shared library under ``build/kernels/`` at the
root of the checkout, then loaded with ``ctypes``. All sources are
compiled at once, one ``nvcc`` process each. A library's file name
carries a hash of its source and flags, so a changed source rebuilds and
an unchanged one is reused. Nothing here runs at import: the first
launch, or ``build_all()``, builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")

SOURCES = {"cong_update": "cong_update.cu", "lcmp_decide": "lcmp_decide.cu",
           "qsr_int8": "qsr_int8.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the extern "C" launchers (see csrc/*.cu)
# (the fused entries take their run's fixed pointers and parameters as
# a pointer to a host struct, mirrored by a ctypes.Structure in the
# wrapper, then what changes per step; the route's step tensors are a
# second struct, whose fields change only when a tensor does)
ARGTYPES = {
    "cong_update_launch": [_P, _P, _I, _I, _P],
    "monitor_tick_launch": [_P, _P, _I, _I, _P],
    "lcmp_decide_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "route_arrivals_launch": [_P, _P, _I, _P],
    "decide_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
    "decide_pairs_launch": [_P, _I, _I, _P],
    "decide_pick_launch": [_P, _I, _P, _P, _P, _P, _P],
    "switch_route_launch": [_P, _I, _P, _P, _P, _I, _P],
    "qsr_int8_launch": [_LL, _P, _P, _P, _P, _P],
    "qsr_dequant_launch": [_LL, _P, _P, _P, _P],
}
# the launchers each source's library exports
LAUNCHERS = {"cong_update": ("cong_update_launch", "monitor_tick_launch"),
             "lcmp_decide": ("lcmp_decide_launch", "route_arrivals_launch",
                             "decide_launch", "decide_pairs_launch",
                             "decide_pick_launch", "switch_route_launch"),
             "qsr_int8": ("qsr_int8_launch", "qsr_dequant_launch")}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def ptxas_info(log: str) -> Dict[str, int]:
    """Registers and spill bytes from an ``-Xptxas -v`` log: the most
    over the source's kernels."""
    def most(pattern: str) -> int:
        found = [int(v) for v in re.findall(pattern, log)]
        return max(found) if found else -1
    return {"registers": most(r"Used (\d+) registers"),
            "spill_stores": most(r"(\d+) bytes spill stores"),
            "spill_loads": most(r"(\d+) bytes spill loads")}


def build_all(force: bool = False) -> Dict[str, dict]:
    """Compile every source whose library is missing (every source with
    ``force``), one ``nvcc`` each, all started together. Returns per
    kernel: seconds, whether it was cached, and the registers and spills
    ptxas reported."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = _lib_path(name)
        if os.path.exists(lib) and not force:
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log
            continue
        with open(lib + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{log}" for n, log in failed.items()))
    seconds = time.perf_counter() - t0
    out = {}
    for name in SOURCES:
        with open(_lib_path(name) + ".log") as f:
            info = ptxas_info(f.read())
        out[name] = dict(info, cached=name not in procs, seconds=seconds)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        for launcher in LAUNCHERS[name]:
            fn = getattr(lib, launcher)
            fn.argtypes = ARGTYPES[launcher]
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def raw_stream(dev_index: int) -> int:
    """The handle of the current CUDA stream of card ``dev_index``, as the
    launchers take it (what ``torch.cuda.current_stream(dev).cuda_stream``
    gives, without building a ``Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(dev_index)


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")

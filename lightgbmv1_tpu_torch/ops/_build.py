"""Build the port's CUDA sources and load them with ctypes.

At first use every ``csrc/<name>.cu`` the caller asks for is compiled by
``nvcc`` for ``sm_90a`` into ``lightgbmv1_tpu_torch/build/lib<name>_<hash>.so``
(a plain C interface, no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  The hash covers the source, every ``csrc/`` file
it includes, directly or through another (``hist_tile.cuh`` is shared by
``hist.cu`` and, through ``wave_round.cuh``, by ``wave_fused.cu`` and
``wave_loop.cu``, which ``wave_loop_int8.cu`` includes whole) and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.
Sources that are built together start together: one ``nvcc`` per source.

A build or load error raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall of its nvcc, "log": nvcc's output (ptxas
# registers / shared memory / spills per kernel)}
build_log: Dict[str, dict] = {}

# True only while a profiler capture is armed (obs/device.py): then each
# kernel wrapper's launch runs inside a ``record_function("lgbm.<kernel>")``
# scope; otherwise ``kernel_scope`` hands back one shared no-op context
_scopes = False
_NO_SCOPE = contextlib.nullcontext()


def set_kernel_scopes(on: bool) -> None:
    global _scopes
    _scopes = bool(on)


def kernel_scope(name: str):
    """The profiler scope of one kernel launch: ``lgbm.<name>`` while a
    capture is armed, a no-op context otherwise."""
    if not _scopes:
        return _NO_SCOPE
    import torch

    return torch.profiler.record_function("lgbm." + name)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                       "port's CUDA kernels are built from csrc/ at first use")


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header, each once."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                 if (CSRC / inc).exists()]
    return out


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, all ``nvcc``s
    started together; returns {name: seconds}.  Raises on a failed build
    with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    secs = {}
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = {"seconds": secs[name], "log": log}
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)      # atomic: a reader never sees half a .so
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib

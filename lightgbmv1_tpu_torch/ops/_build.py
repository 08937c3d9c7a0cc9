"""Build the port's CUDA sources and load them with ctypes.

At first use every ``csrc/<name>.cu`` the caller asks for is compiled by
``nvcc`` for ``sm_90a`` into ``lightgbmv1_tpu_torch/build/lib<name>_<hash>.so``
(a plain C interface, no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  The hash covers the source, every ``csrc/*.cuh``
header it includes (``hist_tile.cuh`` is shared by ``hist.cu`` and
``wave_fused.cu``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  Sources
that are built together start together: one ``nvcc`` per source.

A build or load error raises; nothing falls back.
"""

from __future__ import annotations

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

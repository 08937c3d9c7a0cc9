"""The native (C++) host components, loaded with ctypes.

The port's copy of lightgbmv1_tpu/native/__init__.py: ``text_parser.cpp``
(``parse_dense_file`` :86, the dense csv / tsv fast path of
``io/parser.load_data_file``) and ``predictor.cpp`` (``build_ensemble_pack``
:150 and ``predict_ensemble`` :212, the threaded bulk predictor behind
``Booster.predict(predict_method="native")`` and ``auto`` on large
batches).  Both are plain C interfaces.

Each source is compiled by ``g++`` at first use into
``lightgbmv1_tpu_torch/build/lib<name>_<hash>.so`` (the hash covers the
source and the flags, so an edited source is rebuilt and a stale library
is never loaded), written under a temporary name and renamed into place.
A failed build raises: the JAX package logs and falls back to Python
there, the port does not.  What the model or the file decides stays as
in the JAX package: a pack that cannot hold a model's categorical sets is
None (the caller walks the host trees), and a ragged or malformed file is
None (the Python parser reports it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    """The library of ``native/<name>.cpp`` under the current flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` if its library is missing; raises
    with the compiler's output when it fails."""
    out = lib_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: native/{name}.cpp is "
                           "built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                          str(_DIR / f"{name}.cpp")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on native/{name}.cpp (exit "
                           f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a .so
    return out


def _load(name: str, declare) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            declare(lib)
            _libs[name] = lib
        return lib


def _declare_parser(lib) -> None:
    c = ctypes
    lib.tp_open.restype = c.c_void_p
    lib.tp_open.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.tp_rows.restype = c.c_long
    lib.tp_rows.argtypes = [c.c_void_p]
    lib.tp_cols.restype = c.c_long
    lib.tp_cols.argtypes = [c.c_void_p]
    lib.tp_fill.restype = c.c_long
    lib.tp_fill.argtypes = [c.c_void_p, c.POINTER(c.c_double), c.c_long]
    lib.tp_close.restype = None
    lib.tp_close.argtypes = [c.c_void_p]


def _declare_predictor(lib) -> None:
    c = ctypes
    # int64 numpy arrays map to int64_t on both sides
    lib.pd_predict.restype = c.c_int64
    lib.pd_predict.argtypes = [
        c.POINTER(c.c_double), c.c_int64, c.c_int64, c.c_int, c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int),
        c.POINTER(c.c_double), c.POINTER(c.c_ubyte), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_double), c.POINTER(c.c_int64),
        c.POINTER(c.c_int), c.POINTER(c.c_uint), c.POINTER(c.c_int),
        c.POINTER(c.c_double), c.c_int,
    ]


def parse_dense_file(path: str, has_header: bool, sep: Optional[str],
                     num_threads: int = 0) -> Optional[np.ndarray]:
    """A dense numeric table parsed natively (JAX :86), (rows, cols)
    float64; None where the Python parser must take the file: it cannot
    be opened, has no rows, or a row is ragged or malformed (the Python
    parser reports it).  ``num_threads`` <= 0 uses every core."""
    lib = _load("text_parser", _declare_parser)
    h = lib.tp_open(str(path).encode(), 1 if has_header else 0,
                    ord(sep) if sep else 0)
    if not h:
        return None
    try:
        rows, cols = lib.tp_rows(h), lib.tp_cols(h)
        if rows <= 0 or cols <= 0:
            return None
        out = np.empty((rows, cols), dtype=np.float64)
        bad = lib.tp_fill(h, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), int(num_threads))
        return None if bad != 0 else out
    finally:
        lib.tp_close(h)


def build_ensemble_pack(trees, K: int):
    """The trees flattened into the predictor's C arrays (JAX :150); None
    when the ensemble is not representable (a categorical node without
    its raw category set, or a category too large for a bitset)."""
    _load("predictor", _declare_predictor)
    node_off, leaf_off = [0], [0]
    feat, thr, flags, lc, rc, lv = [], [], [], [], [], []
    cat_off, cat_len, cat_words = [], [], []
    for t in trees:
        for i in range(max(t.num_leaves - 1, 0)):
            fl = (1 if t.default_left[i] else 0) | (
                int(t.missing_type[i]) << 1)
            co, cl = -1, 0
            if bool(t.is_cat[i]):
                s = t.cat_sets[i]
                if s is None:
                    return None
                s = np.asarray(s, np.int64)
                if len(s) and s.max() >= (1 << 22):
                    return None          # the bitset would be absurdly wide
                fl |= 8
                words = np.zeros((int(s.max()) >> 5) + 1 if len(s) else 1,
                                 np.uint32)
                for cval in s:
                    words[cval >> 5] |= np.uint32(1) << np.uint32(cval & 31)
                co, cl = len(cat_words), len(words)
                cat_words.extend(words.tolist())
            feat.append(int(t.split_feature[i]))
            thr.append(float(t.threshold[i]))
            flags.append(fl)
            lc.append(int(t.left_child[i]))
            rc.append(int(t.right_child[i]))
            cat_off.append(co)
            cat_len.append(cl)
        lv.extend(np.asarray(t.leaf_value[:t.num_leaves],
                             np.float64).tolist())
        node_off.append(len(feat))
        leaf_off.append(len(lv))
    return dict(
        max_feat=max(feat) if feat else -1,
        node_off=np.asarray(node_off, np.int64),
        leaf_off=np.asarray(leaf_off, np.int64),
        feat=np.asarray(feat, np.int32),
        thr=np.asarray(thr, np.float64),
        flags=np.asarray(flags, np.uint8),
        lc=np.asarray(lc, np.int32),
        rc=np.asarray(rc, np.int32),
        leaf_val=np.asarray(lv, np.float64),
        cat_off=np.asarray(cat_off, np.int64),
        cat_len=np.asarray(cat_len, np.int32),
        cat_words=np.asarray(cat_words if cat_words else [0], np.uint32),
        tree_k=np.asarray([i % K for i in range(len(trees))], np.int32),
        T=len(trees), K=K,
    )


def predict_ensemble(X: np.ndarray, pack, num_threads: int = 0
                     ) -> np.ndarray:
    """(n, K) float64 raw scores of ``pack`` on ``X`` (JAX :212): each
    row walks every tree in tree order, rows split across threads
    (``num_threads`` <= 0: every core).  ``X`` must hold every feature
    the pack splits on."""
    lib = _load("predictor", _declare_predictor)
    X = np.ascontiguousarray(X, np.float64)
    n, F = X.shape
    if F <= pack["max_feat"]:
        raise ValueError(f"{F} features, the model splits on feature "
                         f"{pack['max_feat']}")
    out = np.zeros((n, pack["K"]), np.float64)
    c = ctypes

    def p(a, ty):
        return a.ctypes.data_as(c.POINTER(ty))

    rc_ = lib.pd_predict(
        p(X, c.c_double), n, F, pack["T"], pack["K"],
        p(pack["node_off"], c.c_int64), p(pack["leaf_off"], c.c_int64),
        p(pack["feat"], c.c_int), p(pack["thr"], c.c_double),
        p(pack["flags"], c.c_ubyte), p(pack["lc"], c.c_int),
        p(pack["rc"], c.c_int), p(pack["leaf_val"], c.c_double),
        p(pack["cat_off"], c.c_int64), p(pack["cat_len"], c.c_int),
        p(pack["cat_words"], c.c_uint), p(pack["tree_k"], c.c_int),
        p(out, c.c_double), int(num_threads))
    if rc_ != 0:
        raise RuntimeError(f"native predictor returned {rc_}")
    return out

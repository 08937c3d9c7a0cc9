"""Serving walk kernels on the card, their plain versions, and the tile plan.

Counterpart of lightgbmv1_tpu/ops/predict_pallas.py.  Two kernels written
by hand in CUDA C++ for Hopper live in ``csrc/predict_walk.cu`` (its head
note says what bounds them and how the designs answer it):

* ``serving_fused`` (K4) replaces ``predict_pallas._fused_kernel``
  (``serving_fused_pallas``): one launch walks every tree over prebinned
  serving codes and either sums the per-class raw scores (optional
  sigmoid/softmax epilogue) or writes the (N, T_pad) leaf ids.  Each
  block stages its rows' codes and, tile by tile, the trees' node tables
  in shared memory; ``plan_predict_tiles`` prices the tree tile against a
  shared-memory budget where the TPU priced VMEM.
* ``serving_leaf`` (K5) replaces ``predict_pallas._kernel``
  (``serving_leaf_pallas``): (N, F) codes -> (N, T) leaf ids with the
  node tables read from global memory (L2-resident) and neighbouring
  threads writing neighbouring trees of one row.

Beside each wrapper is its plain PyTorch version (``serving_fused_ref``,
``serving_leaf_ref``), which repeats the Pallas kernel's arithmetic step
by step.  A wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches its kernel or raises — there is no fallback.
Each launch adds one to ``launch_counts[name]``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from . import _build

# the tree-tile budget: two 256-row blocks of the fused kernel fit one SM
# (228 KB), so a block is never alone with its tile copies
SMEM_BUDGET = 96 * 1024
# one thread per row: the fused kernel's block size
ROW_TILE = 256
# the leaf kernel's block: 256 threads over (row, tree) pairs
LEAF_THREADS = 256

launch_counts = {"serving_fused": 0, "serving_leaf": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


class WalkTables(NamedTuple):
    """The kernels' view of the stacked serving tables: every node table
    int32 (T, L1), ``num_leaves`` int32 (T,), ``leaf_value`` f32 (T, L),
    all contiguous on one device."""

    num_leaves: torch.Tensor
    split_feature: torch.Tensor
    threshold_bin: torch.Tensor
    zero_bin: torch.Tensor
    default_left: torch.Tensor
    missing_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    leaf_value: torch.Tensor


def walk_tables(arrays) -> WalkTables:
    """ServingArrays (models/predict.py) -> the kernels' int32/f32 tables
    (the casts the Pallas wrappers make at every call, made once)."""
    def i32(a):
        return a.to(torch.int32).contiguous()

    return WalkTables(
        num_leaves=i32(arrays.num_leaves),
        split_feature=i32(arrays.split_feature),
        threshold_bin=i32(arrays.threshold_bin),
        zero_bin=i32(arrays.zero_bin),
        default_left=i32(arrays.default_left),
        missing_type=i32(arrays.missing_type),
        left_child=i32(arrays.left_child),
        right_child=i32(arrays.right_child),
        leaf_value=arrays.leaf_value.to(torch.float32).contiguous(),
    )


def plan_predict_tiles(*, T, L1, L, F, K, depth, has_cat=False,
                       prebin=True, packed=False, code_bytes=1,
                       smem_budget=SMEM_BUDGET):
    """Static shared-memory planner of the fused kernel (the JAX
    package's ``plan_predict_tiles`` contract: decided from shapes and
    knobs only, every refusal one honest reason line).

    Prices one block: the tree tile's tables (seven int32 (Tt, L1) node
    tables, the (Tt, L) f32 leaf values and num_leaves: 8,136 B a tree
    at L = 255), the row tile's codes in their own width (packed: half
    the columns) and, for K > 1, the (K, ROW_TILE) f32 accumulator (K = 1
    sums in a register).  The walk itself lives in registers.
    ``tree_tile`` halves from T until the block fits ``smem_budget``;
    when even one tree does not fit, the plan refuses."""
    Fc = -(-int(F) // 2) if packed else int(F)
    per_tree = (7 * int(L1) + int(L) + 1) * 4
    codes_bytes = ROW_TILE * Fc * (1 if packed else int(code_bytes))
    acc_bytes = ROW_TILE * int(K) * 4 if int(K) > 1 else 0

    def step_bytes(tt):
        return tt * per_tree + codes_bytes + acc_bytes

    tree_tile = max(int(T), 1)
    while tree_tile > 1 and step_bytes(tree_tile) > smem_budget:
        tree_tile = -(-tree_tile // 2)
    n_tiles = -(-max(int(T), 1) // tree_tile)
    plan = dict(eligible=False, reason="", tree_tile=int(tree_tile),
                n_tree_tiles=int(n_tiles), t_pad=int(n_tiles * tree_tile),
                row_tile=ROW_TILE,
                table_tile_bytes=int(tree_tile * per_tree),
                codes_tile_bytes=int(codes_bytes), acc_bytes=int(acc_bytes),
                total_bytes=int(step_bytes(tree_tile)),
                packed=bool(packed), smem_budget=int(smem_budget))
    if not prebin:
        plan["reason"] = ("raw-feature walk: the fused kernel serves "
                          "prebinned serving codes only")
        return plan
    if has_cat:
        plan["reason"] = ("categorical bitset decision stays on the "
                          "staged walk")
        return plan
    if step_bytes(tree_tile) > smem_budget:
        plan["reason"] = (
            f"one tree's tables + the row tile's codes ({step_bytes(1)} B) "
            f"exceed the shared-memory budget ({int(smem_budget)} B)")
        return plan
    plan["eligible"] = True
    return plan


# ---------------------------------------------------------------------------
# plain PyTorch versions (the Pallas kernels' arithmetic, step by step)
# ---------------------------------------------------------------------------


def _walk_ref(tables: WalkTables, codes: torch.Tensor, *, n_steps: int,
              zero_code: int, nan_code: int, packed: bool) -> torch.Tensor:
    """The Pallas walk body over all (row, tree) pairs: the depth-stepped
    walk of models/predict.py on the kernels' tables.  Packed codes are
    unpacked first (every nibble column; the tables index only real
    features)."""
    # models/predict.py imports this module, so its walk is imported here
    from ..models.predict import serving_leaf_binned, unpack_serving_codes
    if packed:
        codes = unpack_serving_codes(codes, 2 * codes.shape[1])
    sm = tables._replace(default_left=tables.default_left != 0)
    return serving_leaf_binned(sm, codes, n_steps, zero_code, nan_code)


def apply_transform(acc: torch.Tensor,
                    transform: Optional[str]) -> torch.Tensor:
    """The objective epilogue (None | 'sigmoid' | 'softmax') on (N, K) f32
    scores, as the Pallas kernel computes it; also what the staged walks
    apply after their score sum."""
    if transform is None:
        return acc
    if transform == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-acc))
    mx = acc.max(dim=1, keepdim=True).values
    e = torch.exp(acc - mx)
    return e / e.sum(dim=1, keepdim=True)


def serving_fused_ref(tables: WalkTables, codes: torch.Tensor, *,
                      n_steps: int, zero_code: int, nan_code: int, K: int,
                      tree_tile: int, mode: str = "scores",
                      packed: bool = False,
                      transform: Optional[str] = None) -> torch.Tensor:
    """Plain version of ``serving_fused``: the walk, then per tree tile
    the leaf-value gather and its class sum (K = 1 a row sum, K > 1 a
    one-hot product with class g % K) added to the (N, K) accumulator,
    then the epilogue — the Pallas ``_fused_kernel`` order."""
    leaf = _walk_ref(tables, codes, n_steps=n_steps, zero_code=zero_code,
                     nan_code=nan_code, packed=packed)
    if mode == "leaf":
        return leaf
    N, T = leaf.shape
    dev = codes.device
    lv = tables.leaf_value
    acc = torch.zeros((N, K), dtype=torch.float32, device=dev)
    for t0 in range(0, T, tree_tile):
        ti = torch.arange(t0, t0 + tree_tile, device=dev)
        vals = lv[ti[None, :], leaf[:, t0:t0 + tree_tile].clamp(min=0).long()]
        if K == 1:
            contrib = vals.sum(dim=1, keepdim=True)
        else:
            onehot = (ti[:, None] % K == torch.arange(K, device=dev)[None, :])
            contrib = vals @ onehot.to(torch.float32)
        acc = acc + contrib
    return apply_transform(acc, transform)


def serving_leaf_ref(tables: WalkTables, codes: torch.Tensor, *,
                     n_steps: int, zero_code: int,
                     nan_code: int) -> torch.Tensor:
    """Plain version of ``serving_leaf``: (N, F) codes -> (N, T) i32."""
    return _walk_ref(tables, codes, n_steps=n_steps, zero_code=zero_code,
                     nan_code=nan_code, packed=False)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_CODE_KIND = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
_PACKED4 = 3
_TRANSFORM = {None: 0, "sigmoid": 1, "softmax": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("predict_walk")
    lib.lgbm_serving_fused.argtypes = ([_P] * 10 + [_I, _P, _P]
                                       + [_I] * 12 + [_P])
    lib.lgbm_serving_fused.restype = _I
    lib.lgbm_serving_leaf.argtypes = [_P] * 9 + [_I, _P] + [_I] * 9 + [_P]
    lib.lgbm_serving_leaf.restype = _I
    return lib


def _check_cuda(tables: WalkTables, codes: torch.Tensor,
                packed: bool) -> int:
    """Device, dtype, shape and contiguity checks; returns the code kind."""
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: expected cpu or cuda")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous (N, F) tensor")
    if codes.dtype not in _CODE_KIND or (packed and codes.dtype != torch.uint8):
        raise ValueError(f"codes dtype {codes.dtype}: expected uint8 / "
                         "uint16 / int32 (packed: uint8)")
    T, L1 = tables.split_feature.shape
    for name, a in tables._asdict().items():
        want = torch.float32 if name == "leaf_value" else torch.int32
        if a.device != codes.device or a.dtype != want \
                or not a.is_contiguous() or a.shape[0] != T:
            raise ValueError(f"table {name}: expected contiguous {want} "
                             f"with {T} trees on {codes.device}")
        if a.dim() == 2 and name != "leaf_value" and a.shape[1] != L1:
            raise ValueError(f"table {name}: expected (T, {L1})")
    if T * max(L1, tables.leaf_value.shape[1]) >= 2 ** 31:
        raise ValueError("tables exceed the kernels' int32 node indexing")
    return _PACKED4 if packed else _CODE_KIND[codes.dtype]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def serving_fused(tables: WalkTables, codes: torch.Tensor, *, n_steps: int,
                  zero_code: int, nan_code: int, K: int, tree_tile: int,
                  mode: str = "scores", packed: bool = False,
                  transform: Optional[str] = None) -> torch.Tensor:
    """K4, the serving megakernel.  ``tables``' tree axis is a multiple of
    ``tree_tile`` (models/tree.pad_tree_axis); ``codes`` is the batch's
    (N, F) serving codes or (N, ceil(F/2)) packed bytes.  Returns (N, K)
    f32 scores or (N, T_pad) int32 leaf ids."""
    T, L1 = tables.split_feature.shape
    L = tables.leaf_value.shape[1]
    if T % tree_tile:
        raise ValueError(f"tree axis {T} not a multiple of the tree tile "
                         f"{tree_tile} (pad with pad_tree_axis)")
    if mode not in ("scores", "leaf"):
        raise ValueError(f"mode={mode!r}: expected scores | leaf")
    if transform not in _TRANSFORM:
        raise ValueError(f"transform={transform!r}: expected None | "
                         "sigmoid | softmax")
    if codes.device.type == "cpu":
        return serving_fused_ref(
            tables, codes, n_steps=n_steps, zero_code=zero_code,
            nan_code=nan_code, K=K, tree_tile=tree_tile, mode=mode,
            packed=packed, transform=transform)
    kind = _check_cuda(tables, codes, packed)
    N, Fc = codes.shape
    scores_mode = mode == "scores"
    if scores_mode:
        out = torch.empty((N, K), dtype=torch.float32, device=codes.device)
        scores_ptr, leaves_ptr = out.data_ptr(), None
    else:
        out = torch.empty((N, T), dtype=torch.int32, device=codes.device)
        scores_ptr, leaves_ptr = None, out.data_ptr()
    if N == 0:
        return out                               # nothing to launch
    lib = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lgbm_serving_fused(
            *(a.data_ptr() for a in tables), codes.data_ptr(), kind,
            scores_ptr, leaves_ptr, N, Fc, T, L1, L, int(K), int(tree_tile),
            max(int(n_steps), 1), int(zero_code), int(nan_code),
            _TRANSFORM[transform], ROW_TILE, stream)
    _raise_on(err, "serving_fused")
    _count("serving_fused")
    return out


def serving_leaf(tables: WalkTables, codes: torch.Tensor, *, n_steps: int,
                 zero_code: int, nan_code: int) -> torch.Tensor:
    """K5: (N, F) serving codes -> (N, T) int32 leaf ids, node tables read
    from global memory; the leaf-value sum happens outside."""
    if codes.device.type == "cpu":
        return serving_leaf_ref(tables, codes, n_steps=n_steps,
                                zero_code=zero_code, nan_code=nan_code)
    kind = _check_cuda(tables, codes, packed=False)
    N, F = codes.shape
    T, L1 = tables.split_feature.shape
    row_bytes = F * codes.element_size()
    # up to 8 rows of codes a block, inside the 48 KB static window
    rows_per_block = max(1, min(8, (48 * 1024) // max(row_bytes, 1)))
    if rows_per_block * row_bytes > 48 * 1024:
        raise ValueError(f"serving_leaf: one row's codes ({row_bytes} B) "
                         "exceed the kernel's 48 KB shared-memory window")
    out = torch.empty((N, T), dtype=torch.int32, device=codes.device)
    if N == 0:
        return out                               # nothing to launch
    lib = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lgbm_serving_leaf(
            *(a.data_ptr() for a in tables[:8]), codes.data_ptr(), kind,
            out.data_ptr(), N, F, T, L1, rows_per_block, LEAF_THREADS,
            max(int(n_steps), 1), int(zero_code), int(nan_code), stream)
    _raise_on(err, "serving_leaf")
    _count("serving_leaf")
    return out

"""Serving walk kernels on the card, their plain versions, and the tile plan.

Counterpart of lightgbmv1_tpu/ops/predict_pallas.py.  Two kernels written
by hand in CUDA C++ for Hopper live in ``csrc/predict_walk.cu`` (its head
note says what bounds them and how the designs answer it):

* ``serving_fused`` (K4) replaces ``predict_pallas._fused_kernel``
  (``serving_fused_pallas``): walks every tree over prebinned serving
  codes and either sums the per-class raw scores (optional
  sigmoid/softmax epilogue) or writes the (N, T_pad) leaf ids.
  ``plan_predict_tiles`` cuts the tree axis into fixed groups of
  ``tree_tile`` trees sized to a shared-memory budget (from the model
  and the card, never the batch); ``node_records`` packs each node into
  one 16-byte record, once a predictor.  The grid splits the tree axis
  over blocks (groups x row chunks, the chunking picked from N by
  ``launch_shape``); each block stages its group's records by
  asynchronous copies and walks four trees a thread at once.  A group's
  partial sums its trees of a class in tree order from 0.f, and the
  combine adds the partials in group order from 0.f, so the raw scores
  have the same bits at every N and launch shape.
* ``serving_leaf`` (K5) replaces ``predict_pallas._kernel``
  (``serving_leaf_pallas``): (N, F) codes -> (N, T) leaf ids from the
  seven node tables as they are, read from global memory through L1.
  ``plan_leaf_walk`` cuts the tree axis into groups (from the model's
  table bytes) and the rows into tiles (from the code width and the
  card's shared memory), never from the batch; a block walks one group
  for one tile of rows, a thread a row, so a warp's 32 lanes walk the
  same tree at the same step and the group's tables stay in L1.  The
  leaf ids leave through a tile in shared memory, each row's group of ids
  as contiguous words.  The decision is K4's device function, read from
  the tables.

Beside each wrapper is its plain PyTorch version (``serving_fused_ref``,
``serving_leaf_ref``): the same decisions and, for K4, the same order of
f32 adds, read from the same records.  A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches its kernel or
raises — there is no fallback.  Both raise when the codes are narrower
than the tables' largest split feature needs.  Each launch adds one to
``launch_counts[name]`` (K4's walk and combine are one call).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from . import _build

# K4's group size: the largest tree count whose block (records, leaf
# values and two code buffers) fits this budget, so four blocks (32
# warps) share an SM's 228 KB; K5's row tile fits it the same way
SMEM_BUDGET = 56 * 1024
# K4's refusal line, the most shared memory a block may have on the card:
# a model whose one-tree block exceeds it takes the staged walk.  A
# one-tree block prices at most twice what the seven-table design priced
# (the code buffers), and that design refused above 96 KiB, so nothing it
# served is refused
SMEM_LIMIT = 227 * 1024
# K4's row tile (one thread a row) and walks in flight a thread; must
# equal kRowTile and kWalks in csrc/predict_walk.cu
ROW_TILE = 256
WALKS = 4
# the node record's split-feature field: bits 0-27 of word 0
_FEAT_BITS = 28
# K5's plan (plan_leaf_walk): a group's seven tables (28 B a node) fill
# at most LEAF_TABLE_BUDGET, which the SM's L1 holds for two groups
# beside the blocks' shared memory (8 trees of 255 leaves); a group holds
# at most LEAF_GROUP_MAX trees (its leaf-id tile); the row tile is at
# most LEAF_ROWS rows (one thread a row; kLeafThreads in
# csrc/predict_walk.cu) and whole warps whose codes and leaf-id tile fit
# SMEM_BUDGET; rows too wide for one warp there take fewer, down to one
# row, within SMEM_LIMIT
LEAF_TABLE_BUDGET = 56 * 1024
LEAF_GROUP_MAX = 32
LEAF_ROWS = 256

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
    all contiguous on one device; ``max_feature`` is the largest split
    feature of any real node (-1: no split), so the codes need
    ``max_feature + 1`` columns."""

    num_leaves: torch.Tensor
    split_feature: torch.Tensor
    threshold_bin: torch.Tensor
    zero_bin: torch.Tensor
    default_left: torch.Tensor
    missing_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    leaf_value: torch.Tensor
    max_feature: int = -1


def walk_tables(arrays) -> WalkTables:
    """ServingArrays (models/predict.py) -> the kernels' int32/f32 tables
    (the casts the Pallas wrappers make at every call, made once) and the
    largest split feature."""
    def i32(a):
        return a.to(torch.int32).contiguous()

    nl, feat = i32(arrays.num_leaves), i32(arrays.split_feature)
    real = (torch.arange(feat.shape[1], device=feat.device)[None, :]
            < (nl - 1)[:, None])
    max_feature = int(torch.where(real, feat, -1).max()) if real.numel() \
        else -1
    return WalkTables(
        num_leaves=nl,
        split_feature=feat,
        threshold_bin=i32(arrays.threshold_bin),
        zero_bin=i32(arrays.zero_bin),
        default_left=i32(arrays.default_left),
        missing_type=i32(arrays.missing_type),
        left_child=i32(arrays.left_child),
        right_child=i32(arrays.right_child),
        leaf_value=arrays.leaf_value.to(torch.float32).contiguous(),
        max_feature=max_feature,
    )


class NodeRecords(NamedTuple):
    """K4's compact tables: one 16-byte record a node, int32 (T_pad, L1,
    4) = {split feature | missing type << 28 | default_left << 30 |
    parked << 31, threshold bin, zero bin, left child & 0xFFFF | right
    child << 16}, where ``parked`` marks node 0 of a tree of <= 1 leaf;
    the leaf values f32 (T_pad, Lp), Lp = L rounded up to 4 so every
    group's rows start 16-byte aligned.  Group g is trees
    [g * tree_tile, (g + 1) * tree_tile), contiguous in both."""

    records: torch.Tensor
    leaf_value: torch.Tensor
    tree_tile: int
    max_feature: int


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 bits -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def node_records(tables: WalkTables, tree_tile: int) -> NodeRecords:
    """Pack the seven node tables into K4's records, once a predictor.
    ``tables``' tree axis must be a multiple of ``tree_tile``
    (models/tree.pad_tree_axis; pad trees have num_leaves = 0 and park)."""
    T, L1 = tables.split_feature.shape
    L = tables.leaf_value.shape[1]
    if T % tree_tile:
        raise ValueError(f"tree axis {T} not a multiple of the tree tile "
                         f"{tree_tile} (pad with pad_tree_axis)")
    # every model the plan accepts fits: its block caps L1 and F far lower
    if tables.max_feature >= 1 << _FEAT_BITS or L1 > 1 << 15 \
            or L > 1 << 15:
        raise ValueError(f"tables too large for 16-byte node records "
                         f"(L1={L1}, L={L}, max feature "
                         f"{tables.max_feature})")
    i64 = torch.int64
    parked = torch.zeros((T, L1), dtype=torch.bool,
                         device=tables.num_leaves.device)
    parked[:, 0] = tables.num_leaves <= 1
    w0 = (tables.split_feature.to(i64)
          | (tables.missing_type.to(i64) << _FEAT_BITS)
          | ((tables.default_left != 0).to(i64) << 30)
          | (parked.to(i64) << 31))
    w3 = ((tables.left_child.to(i64) & 0xFFFF)
          | ((tables.right_child.to(i64) & 0xFFFF) << 16))
    records = torch.stack([_wrap_i32(w0), tables.threshold_bin,
                           tables.zero_bin, _wrap_i32(w3)], dim=2)
    Lp = -(-L // 4) * 4
    lv = torch.nn.functional.pad(tables.leaf_value, (0, Lp - L))
    return NodeRecords(records=records.contiguous(),
                       leaf_value=lv.to(torch.float32).contiguous(),
                       tree_tile=int(tree_tile),
                       max_feature=int(tables.max_feature))


def decode_records(nr: NodeRecords) -> WalkTables:
    """The seven node tables read back from K4's records; ``num_leaves``
    keeps only what the walk reads (2: walk from the root, 0: parked)
    and ``leaf_value`` keeps the records' Lp columns."""
    w0, w3 = nr.records[..., 0], nr.records[..., 3]
    return WalkTables(
        num_leaves=torch.where(w0[:, 0] < 0, 0, 2).to(torch.int32),
        split_feature=w0 & ((1 << _FEAT_BITS) - 1),
        threshold_bin=nr.records[..., 1],
        zero_bin=nr.records[..., 2],
        default_left=(w0 >> 30) & 1,
        missing_type=(w0 >> _FEAT_BITS) & 3,
        left_child=((w3 & 0xFFFF) ^ 0x8000) - 0x8000,
        right_child=w3 >> 16,
        leaf_value=nr.leaf_value,
        max_feature=nr.max_feature)


def plan_predict_tiles(*, T, L1, L, F, K, depth, has_cat=False,
                       prebin=True, packed=False, code_bytes=1,
                       smem_budget=SMEM_BUDGET):
    """Static shared-memory planner of the fused kernel (the JAX
    package's ``plan_predict_tiles`` contract: decided from shapes and
    knobs only, every refusal one honest reason line).

    Prices one K4 block: ``tree_tile`` trees of 16-byte node records and
    their f32 leaf values (16 L1 + 4 Lp bytes a tree: 5,088 B at
    L = 255) and two buffers of a ROW_TILE-row tile of codes in their own
    width (packed: half the columns).  The class partials live in
    registers and a (G, N, K) buffer in device memory, so ``acc_bytes``
    is 0.  ``tree_tile`` is the largest tree count whose block fits
    ``smem_budget``, cut to whole sets of WALKS trees of each class (or
    whole classes) when that leaves more than one group; it depends on
    the model and the card only, never on the batch.  The plan refuses
    only when one tree's block exceeds SMEM_LIMIT."""
    T, K = max(int(T), 1), max(int(K), 1)
    Fc = -(-int(F) // 2) if packed else int(F)
    Lp = -(-int(L) // 4) * 4
    per_tree = 16 * int(L1) + 4 * Lp
    codes_bytes = 2 * ROW_TILE * Fc * (1 if packed else int(code_bytes))

    def block_bytes(tt):
        return tt * per_tree + codes_bytes

    tree_tile = max(1, min(T, (int(smem_budget) - codes_bytes) // per_tree))
    for unit in (WALKS * K, K):
        if unit <= tree_tile < T:
            tree_tile -= tree_tile % unit
            break
    n_tiles = -(-T // tree_tile)
    plan = dict(eligible=False, reason="", tree_tile=int(tree_tile),
                n_tree_tiles=int(n_tiles), t_pad=int(n_tiles * tree_tile),
                row_tile=ROW_TILE, walks=WALKS,
                per_tree_bytes=int(per_tree),
                table_tile_bytes=int(tree_tile * per_tree),
                codes_tile_bytes=int(codes_bytes), acc_bytes=0,
                total_bytes=int(block_bytes(tree_tile)),
                packed=bool(packed), smem_budget=int(smem_budget),
                smem_limit=SMEM_LIMIT)
    if not prebin:
        plan["reason"] = ("raw-feature walk: the fused kernel serves "
                          "prebinned serving codes only")
        return plan
    if has_cat:
        plan["reason"] = ("categorical bitset decision stays on the "
                          "staged walk")
        return plan
    if block_bytes(1) > SMEM_LIMIT:
        plan["reason"] = (
            f"one tree's tables + the row tile's codes ({block_bytes(1)} B) "
            f"exceed the shared-memory budget ({SMEM_LIMIT} B)")
        return plan
    plan["eligible"] = True
    return plan


def plan_leaf_walk(*, T, L1, F, code_bytes, smem_limit=SMEM_LIMIT) -> dict:
    """K5's launch plan, from the model (T trees of L1 node slots, F code
    columns of ``code_bytes`` each) and the card (``smem_limit``), never
    from the batch.

    ``group``: the trees a block walks, the most trees whose seven int32
    tables fit LEAF_TABLE_BUDGET (8 at L1 = 254), within [1,
    LEAF_GROUP_MAX], and at most T; the last group may be shorter (the
    kernel masks it).  ``stride_bytes``: a staged row of codes, rounded
    up to an odd number of words (the lanes' loads of one feature hit 32
    banks).  ``rows``: the row tile, one thread a row, the most whole
    warps up to LEAF_ROWS whose codes and (rows, group + 1) leaf-id tile
    fit SMEM_BUDGET; a row too wide for a warp there takes up to 32 rows
    within ``smem_limit``.  ``threads``: ``rows`` rounded up to whole
    warps.  Raises ValueError only where one row's codes and ids exceed
    ``smem_limit``."""
    T, L1 = max(int(T), 1), max(int(L1), 1)
    row_bytes = int(F) * int(code_bytes)
    group = min(max(LEAF_TABLE_BUDGET // (7 * 4 * L1), 1), LEAF_GROUP_MAX,
                T)
    words = -(-row_bytes // 4)
    stride = 4 * (words | 1)
    per_row = stride + 4 * (group + 1)
    if per_row > smem_limit:
        raise ValueError(f"serving_leaf: one row's codes ({row_bytes} B) "
                         f"and leaf ids exceed the card's {smem_limit} B "
                         "of shared memory a block")
    rows = min(LEAF_ROWS, SMEM_BUDGET // per_row) // 32 * 32
    if rows == 0:
        rows = min(32, smem_limit // per_row)
    return dict(group=int(group), rows=int(rows),
                threads=-(-rows // 32) * 32, stride_bytes=int(stride))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' decisions and order of adds)
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


def serving_fused_ref(records: NodeRecords, codes: torch.Tensor, *,
                      n_steps: int, zero_code: int, nan_code: int, K: int,
                      mode: str = "scores", packed: bool = False,
                      transform: Optional[str] = None) -> torch.Tensor:
    """Plain version of ``serving_fused``, on the tables decoded from the
    same records and in the kernel's order of f32 adds: for each group in
    order, a partial from 0 to which each of its trees, in tree order,
    adds its leaf value to its class column (tree t: class t % K); the
    partial is then added to the accumulator, itself from 0; then the
    epilogue.  Every add is one elementwise f32 add: no reduction whose
    order is left open."""
    tables = decode_records(records)
    leaf = _walk_ref(tables, codes, n_steps=n_steps, zero_code=zero_code,
                     nan_code=nan_code, packed=packed)
    if mode == "leaf":
        return leaf
    N, T = leaf.shape
    lv = tables.leaf_value
    idx = leaf.clamp(min=0).long()
    acc = torch.zeros((N, K), dtype=torch.float32, device=codes.device)
    for g0 in range(0, T, records.tree_tile):
        part = torch.zeros_like(acc)
        for t in range(g0, g0 + records.tree_tile):
            c = t % K
            part[:, c] = part[:, c] + lv[t][idx[:, t]]
        acc = acc + part
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
# K4 launches about this many waves of resident blocks (launch_shape)
LAUNCH_WAVES = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("predict_walk")
    lib.lgbm_serving_fused.argtypes = ([_P] * 3 + [_I] + [_P] * 3
                                       + [_I] * 12 + [_P])
    lib.lgbm_serving_fused.restype = _I
    lib.lgbm_serving_leaf.argtypes = [_P] * 9 + [_I, _P] + [_I] * 11 + [_P]
    lib.lgbm_serving_leaf.restype = _I
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_width(max_feature: int, codes: torch.Tensor, packed: bool,
                 name: str) -> None:
    """The codes must hold every feature the tables split on."""
    need = max_feature + 1
    if packed:
        need = -(-need // 2)
    if codes.dim() != 2 or codes.shape[1] < need:
        raise ValueError(
            f"{name}: codes of shape {tuple(codes.shape)} are too narrow: "
            f"the tables split on feature {max_feature}, which needs "
            f"{need} {'packed ' if packed else ''}columns")


def _check_codes(codes: torch.Tensor, packed: bool) -> int:
    """Device, dtype, shape and contiguity checks; returns the code kind."""
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: expected cpu or cuda")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous (N, F) tensor")
    if codes.dtype not in _CODE_KIND or (packed and codes.dtype != torch.uint8):
        raise ValueError(f"codes dtype {codes.dtype}: expected uint8 / "
                         "uint16 / int32 (packed: uint8)")
    return _PACKED4 if packed else _CODE_KIND[codes.dtype]


def _check_tables(tables: WalkTables, device: torch.device) -> None:
    T, L1 = tables.split_feature.shape
    for name, a in tables._asdict().items():
        if not torch.is_tensor(a):
            continue
        want = torch.float32 if name == "leaf_value" else torch.int32
        if a.device != device or a.dtype != want \
                or not a.is_contiguous() or a.shape[0] != T:
            raise ValueError(f"table {name}: expected contiguous {want} "
                             f"with {T} trees on {device}")
        if a.dim() == 2 and name != "leaf_value" and a.shape[1] != L1:
            raise ValueError(f"table {name}: expected (T, {L1})")
    if T * max(L1, tables.leaf_value.shape[1]) >= 2 ** 31:
        raise ValueError("tables exceed the kernels' int32 node indexing")


def _check_records(nr: NodeRecords, codes: torch.Tensor) -> None:
    rec, lv = nr.records, nr.leaf_value
    T, L1 = rec.shape[:2]
    for name, a, want in (("records", rec, torch.int32),
                          ("leaf_value", lv, torch.float32)):
        if a.device != codes.device or a.dtype != want \
                or not a.is_contiguous() or a.shape[0] != T:
            raise ValueError(f"{name}: expected contiguous {want} with {T} "
                             f"trees on {codes.device}")
    if rec.shape[2] != 4 or lv.shape[1] % 4 or T % nr.tree_tile:
        raise ValueError("records: expected (T_pad, L1, 4) records, leaf "
                         "values of a multiple of 4 columns and whole "
                         "tree groups (node_records)")
    if T * max(L1, lv.shape[1]) >= 2 ** 31:
        raise ValueError("tables exceed the kernels' int32 node indexing")
    for name, a in (("records", rec), ("leaf_value", lv), ("codes", codes)):
        if a.data_ptr() % 16:
            raise ValueError(f"serving_fused: {name} not 16-byte aligned "
                             "(the kernel copies them in 16-byte chunks)")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def fused_smem_bytes(records: NodeRecords, row_bytes: int) -> int:
    """One K4 block's shared memory (csrc/predict_walk.cu
    fused_smem_bytes)."""
    L1, Lp = records.records.shape[1], records.leaf_value.shape[1]
    codes_buf = -(-ROW_TILE * row_bytes // 16) * 16
    return records.tree_tile * (16 * L1 + 4 * Lp) + 2 * codes_buf


def launch_shape(n: int, records: NodeRecords, row_bytes: int,
                 device: torch.device) -> int:
    """Row tiles a K4 block walks: 1 (one block a row tile and group)
    until the grid would exceed LAUNCH_WAVES waves of resident blocks,
    then as many as keep it near that, so a large N reads each group's
    records once a chunk of tiles rather than once a tile.  The bits do
    not depend on it."""
    n_tiles = -(-int(n) // ROW_TILE)
    groups = records.records.shape[0] // records.tree_tile
    smem = fused_smem_bytes(records, row_bytes)
    per_sm = max(1, min(2048 // ROW_TILE, (228 * 1024) // (smem + 1024)))
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    resident = per_sm * _sm_count(index)
    m = max(1, n_tiles * groups // (LAUNCH_WAVES * resident),
            -(-n_tiles // 65535))               # the grid's y limit
    return max(1, min(m, n_tiles))


def serving_fused(records: NodeRecords, codes: torch.Tensor, *,
                  n_steps: int, zero_code: int, nan_code: int, K: int,
                  mode: str = "scores", packed: bool = False,
                  transform: Optional[str] = None,
                  tiles_per_block: Optional[int] = None) -> torch.Tensor:
    """K4, the serving megakernel.  ``records`` come from
    ``node_records``; ``codes`` is the batch's (N, F) serving codes or
    (N, ceil(F/2)) packed bytes.  Returns (N, K) f32 scores or
    (N, T_pad) int32 leaf ids.  ``tiles_per_block`` overrides the launch
    shape ``launch_shape`` picks (the result is the same)."""
    if mode not in ("scores", "leaf"):
        raise ValueError(f"mode={mode!r}: expected scores | leaf")
    if transform not in _TRANSFORM:
        raise ValueError(f"transform={transform!r}: expected None | "
                         "sigmoid | softmax")
    _check_width(records.max_feature, codes, packed, "serving_fused")
    if codes.device.type == "cpu":
        return serving_fused_ref(
            records, codes, n_steps=n_steps, zero_code=zero_code,
            nan_code=nan_code, K=K, mode=mode, packed=packed,
            transform=transform)
    kind = _check_codes(codes, packed)
    _check_records(records, codes)
    N, Fc = codes.shape
    T, L1 = records.records.shape[:2]
    Lp = records.leaf_value.shape[1]
    tt = records.tree_tile
    row_bytes = Fc * codes.element_size()
    if tiles_per_block is None:
        tiles_per_block = launch_shape(N, records, row_bytes, codes.device)
    if int(tiles_per_block) < 1:
        raise ValueError(f"tiles_per_block={tiles_per_block}: expected >= 1")
    dev = codes.device
    partial = None
    if mode == "scores":
        out = torch.empty((N, K), dtype=torch.float32, device=dev)
        partial = torch.empty((T // tt, N, K), dtype=torch.float32,
                              device=dev)
        ptrs = (partial.data_ptr(), out.data_ptr(), None)
    else:
        out = torch.empty((N, T), dtype=torch.int32, device=dev)
        ptrs = (None, None, out.data_ptr())
    if N == 0:
        return out                               # nothing to launch
    lib = _lib()
    with torch.cuda.device(dev), _build.kernel_scope("serving_fused"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lgbm_serving_fused(
            records.records.data_ptr(), records.leaf_value.data_ptr(),
            codes.data_ptr(), kind, *ptrs, N, row_bytes, T, L1, Lp, int(K),
            tt, int(tiles_per_block), max(int(n_steps), 1), int(zero_code),
            int(nan_code), _TRANSFORM[transform], stream)
    _raise_on(err, "serving_fused")
    _count("serving_fused")
    return out


def serving_leaf(tables: WalkTables, codes: torch.Tensor, *, n_steps: int,
                 zero_code: int, nan_code: int,
                 plan: Optional[dict] = None) -> torch.Tensor:
    """K5: (N, F) serving codes -> (N, T) int32 leaf ids, the seven node
    tables read from global memory; the leaf-value sum happens outside.
    ``plan`` (group, rows, threads, stride_bytes) overrides
    ``plan_leaf_walk``'s, as ``tiles_per_block`` overrides K4's launch
    shape: a hook to check and time other plans (the result is the
    same)."""
    _check_width(tables.max_feature, codes, False, "serving_leaf")
    if codes.device.type == "cpu":
        return serving_leaf_ref(tables, codes, n_steps=n_steps,
                                zero_code=zero_code, nan_code=nan_code)
    kind = _check_codes(codes, packed=False)
    _check_tables(tables, codes.device)
    N, F = codes.shape
    T, L1 = tables.split_feature.shape
    if plan is None:
        plan = plan_leaf_walk(T=T, L1=L1, F=F,
                              code_bytes=codes.element_size())
    out = torch.empty((N, T), dtype=torch.int32, device=codes.device)
    if N == 0 or T == 0:
        return out                               # nothing to launch
    lib = _lib()
    with torch.cuda.device(codes.device), _build.kernel_scope("serving_leaf"):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lgbm_serving_leaf(
            *(a.data_ptr() for a in tables[:8]), codes.data_ptr(), kind,
            out.data_ptr(), N, F * codes.element_size(), T, L1,
            plan["group"], plan["rows"], plan["threads"],
            plan["stride_bytes"], max(int(n_steps), 1), int(zero_code),
            int(nan_code), stream)
    _raise_on(err, "serving_leaf")
    _count("serving_leaf")
    return out

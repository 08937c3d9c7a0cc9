"""The training histogram kernel on the card (K1) and its plain version.

Counterpart of lightgbmv1_tpu/ops/hist_pallas.py.  ``hist_leaves``
replaces ``hist_pallas._kernel`` (reached through ``hist_leaves_pallas``):
(F, N) u8 bins, (N, 3) f32 [grad, hess, count] rows and (N,) i32 slot ids
-> (L, F, B, 3) f32 per-slot histograms.  The kernel is written by hand in
CUDA C++ (``csrc/hist.cu``; its head note says what bounds it and how the
design answers it): per-block shared-memory sub-histograms whose cells
each take their rows one add at a time in row order (warp-cooperative
batches: one owner warp a cell, the lowest lane of a cell's lanes adding
its peers in lane order), then a fixed-order merge, so a result is the same
to the bit from run to run.  ``live_slots`` names the slots whose rows add
(a wave round's dead slot is dropped at the load and comes out 0).

Precision keeps the Pallas kernel's semantics: ``bf16x2`` splits each row
value into ``hi = bf16(v)`` (round to nearest even) and
``lo = bf16(v - hi)``, sums the hi and the lo terms apart in f32 and
returns ``sum_hi + sum_lo``; ``bf16`` sums hi alone; ``f32`` sums the
values.  Counts are exact in every mode.  The sums run in another order
than the TPU's, so the two agree to f32 rounding of the cells' absolute
sums, not to the bit.

Two plain PyTorch versions:

* ``hist_leaves_ref``: the same hi/lo values accumulated with one
  ``index_add_`` per part — the tolerance version, and the one a CPU tensor
  takes (a CUDA tensor launches the kernel or raises);
* ``hist_leaves_roworder_ref``: the kernel's own order, stated plainly —
  each (chunk, cell) summed in row order from 0 under ``plan``, the chunks
  merged in chunk order, hi and lo apart — so the kernel equals it bit for
  bit.  Only checks call it.

Each launch adds one to ``launch_counts["hist_leaves"]`` and to
``bucket_launch_counts[(L, precision)]``; each plain call adds one to
``plain_counts`` under its function's name (``hist_leaves`` and
``hist_leaves_roworder`` here, ``hist_leaves_scatter`` for the exact oracle
in ops/histogram.py).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

PRECISIONS = ("f32", "bf16", "bf16x2")
PREC_ID = {"f32": 0, "bf16": 1, "bf16x2": 2}
# the sub-histograms of one block: two 256-thread blocks share an SM
HIST_SMEM_BUDGET = 96 * 1024
# the chunk count targets this many blocks: a fixed number (two resident
# blocks on each of an H100's 132 SMs, two waves), never the card's own
# SM count, so the cross-block summation order depends on the shape alone
TARGET_BLOCKS = 2 * 2 * 132
ROW_TILE = 256

launch_counts = {"hist_leaves": 0}
# the launches of ``launch_counts["hist_leaves"]`` by (slots L, precision)
bucket_launch_counts: dict = {}
plain_counts = {"hist_leaves": 0, "hist_leaves_roworder": 0,
                "hist_leaves_scatter": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for d in (launch_counts, plain_counts):
            for k in d:
                d[k] = 0
        bucket_launch_counts.clear()


def count_plain(name: str) -> None:
    """One call of the plain version ``name`` (a key of ``plain_counts``)."""
    with _count_lock:
        plain_counts[name] += 1


def kernel_width(num_bins: int) -> int:
    """The bin-axis rung the kernel is built for (16, 64 or 256) — the
    JAX package's ``hist_pallas.kernel_width`` ladder.  A narrower bin
    axis runs on its rung and the extra bins are sliced away."""
    if num_bins <= 16:
        return 16
    if num_bins <= 64:
        return 64
    if num_bins <= 256:
        return 256
    raise ValueError("the u8 histogram kernel holds num_bins <= 256")


def split_parts(g3: torch.Tensor, precision: str):
    """The f32 value parts the histogram sums: [g3] (f32), [hi] (bf16) or
    [hi, lo] (bf16x2), each rounded exactly as the kernel rounds."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS}")
    g3 = g3.to(torch.float32)
    if precision == "f32":
        return [g3]
    hi = g3.to(torch.bfloat16).to(torch.float32)
    if precision == "bf16":
        return [hi]
    lo = (g3 - hi).to(torch.bfloat16).to(torch.float32)
    return [hi, lo]


def index_add_hist(binned: torch.Tensor, parts, leaf_id: torch.Tensor,
                   num_leaves: int, num_bins: int,
                   live_slots=None) -> torch.Tensor:
    """(L, F, B, 3) sums of each (N, 3) f32 value part over the rows of
    each slot: one ``index_add_`` a part over the flattened (feature, slot,
    bin) index, the parts' sums added at the end.  Rows with a slot
    outside [0, L) or a bin outside [0, B) land in a sacrificial cell that
    is dropped; the slots from ``live_slots`` on (None: none) are zeroed,
    as if their rows added nothing (they touch no other cell)."""
    F, N = binned.shape
    L, B = int(num_leaves), int(num_bins)
    dev = binned.device
    lid = leaf_id.to(torch.int64)
    bins = binned.to(torch.int64)                              # (F, N)
    ok = ((lid >= 0) & (lid < L))[None, :] & (bins < B)
    cell = (torch.arange(F, device=dev)[:, None] * L + lid[None, :]) * B \
        + bins
    dump = F * L * B
    idx = torch.where(ok, cell, torch.full_like(cell, dump)).reshape(-1)
    out = None
    for part in parts:
        h = torch.zeros((dump + 1, 3), dtype=torch.float32, device=dev)
        h.index_add_(0, idx, part.repeat(F, 1))
        out = h if out is None else out + h
    out = out[:dump].reshape(F, L, B, 3).permute(1, 0, 2, 3).contiguous()
    if live_slots is not None:
        out[int(live_slots):] = 0.0
    return out


def hist_leaves_ref(binned: torch.Tensor, g3: torch.Tensor,
                    leaf_id: torch.Tensor, num_leaves: int, num_bins: int,
                    precision: str = "bf16x2",
                    live_slots=None) -> torch.Tensor:
    """Plain version of ``hist_leaves``: the kernel's hi/lo (or f32)
    value parts summed by ``index_add_hist``."""
    count_plain("hist_leaves")
    return index_add_hist(binned, split_parts(g3, precision), leaf_id,
                          num_leaves, num_bins, live_slots)


def hist_leaves_roworder_ref(binned: torch.Tensor, g3: torch.Tensor,
                             leaf_id: torch.Tensor, num_leaves: int,
                             num_bins: int, precision: str = "bf16x2",
                             live_slots=None) -> torch.Tensor:
    """Plain version of ``hist_leaves`` in the kernel's order: under
    ``plan``'s row chunks, every (chunk, feature, slot, bin) cell sums its
    rows' value parts in row order in f32 from a 0 start, one rounding an
    add; the chunks' cells are then summed in chunk order from 0, hi and lo
    apart, and ``hi + lo`` returned (bf16x2).  Vectorised rank by rank: a
    stable sort of the cell keys gives each row its rank in its cell, and
    step r adds every cell's r-th row (one row a cell a step, so each add
    rounds once).  No pairwise sum anywhere."""
    count_plain("hist_leaves_roworder")
    F, N = binned.shape
    L, B = int(num_leaves), int(num_bins)
    p = plan(N, F, L, B, precision)
    dev = binned.device
    parts = torch.cat(split_parts(g3, precision), dim=1)     # (N, NC)
    nc = parts.shape[1]
    live = L if live_slots is None else min(int(live_slots), L)
    lid = leaf_id.to(torch.int64)
    bins = binned.to(torch.int64)                              # (F, N)
    ok = ((lid >= 0) & (lid < live))[None, :] & (bins < B)
    f_idx, rows = ok.nonzero(as_tuple=True)    # feature-major, rows rising
    cell = (((rows // p["chunk_rows"]) * F + f_idx) * L + lid[rows]) * B \
        + bins[f_idx, rows]
    cell, order = torch.sort(cell, stable=True)  # rows rising in a cell
    vals = parts[rows[order]]
    pos = torch.arange(cell.numel(), device=dev)
    first = torch.ones_like(cell, dtype=torch.bool)
    first[1:] = cell[1:] != cell[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                              dim=0).values
    by_rank = torch.sort(rank, stable=True).indices
    acc = torch.zeros((p["n_chunks"] * F * L * B, nc), dtype=torch.float32,
                      device=dev)
    start = 0
    for n_r in torch.bincount(rank).tolist():
        sel = by_rank[start:start + n_r]
        start += n_r
        idx = cell[sel]
        acc[idx] = acc[idx] + vals[sel]
    acc = acc.view(p["n_chunks"], F, L, B, nc)
    hi = torch.zeros((F, L, B, 3), dtype=torch.float32, device=dev)
    lo = torch.zeros_like(hi)
    for ch in range(p["n_chunks"]):
        hi = hi + acc[ch, ..., :3]
        if nc == 6:
            lo = lo + acc[ch, ..., 3:]
    out = hi + lo if nc == 6 else hi
    return out.permute(1, 0, 2, 3).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hist")
    lib.lgbm_hist_leaves.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    lib.lgbm_hist_leaves.restype = _I
    return lib


def plan(N: int, F: int, L: int, num_bins: int, precision: str) -> dict:
    """The launch plan, decided by the shapes alone: the kernel's bin
    rung, the slots a block holds in ``HIST_SMEM_BUDGET`` and the row
    chunks (a fixed chunk count keeps the merge order, and so the bits,
    the same for a given shape on any card)."""
    nb = kernel_width(num_bins)
    nc = 6 if precision == "bf16x2" else 3
    ls_max = max(1, min(int(L), HIST_SMEM_BUDGET // (nb * nc * 4)))
    groups = -(-int(L) // ls_max)
    tiles = max(1, -(-int(N) // ROW_TILE))
    n_chunks = max(1, min(tiles, -(-TARGET_BLOCKS // max(F * groups, 1))))
    chunk_rows = -(-tiles // n_chunks) * ROW_TILE
    n_chunks = max(1, -(-int(N) // chunk_rows))
    return dict(nb=nb, nc=nc, ls_max=ls_max, groups=groups,
                n_chunks=n_chunks, chunk_rows=chunk_rows)


def hist_leaves(binned: torch.Tensor, g3: torch.Tensor,
                leaf_id: torch.Tensor, num_leaves: int, num_bins: int,
                precision: str = "bf16x2", live_slots=None) -> torch.Tensor:
    """K1: (L, F, num_bins, 3) f32 histograms of the rows of each slot.
    With ``live_slots`` only the rows of slots below it add; the others'
    cells are 0, and the plan (so the live cells' bits) is L's."""
    if binned.device.type == "cpu":
        return hist_leaves_ref(binned, g3, leaf_id, num_leaves, num_bins,
                               precision, live_slots)
    if binned.device.type != "cuda":
        raise ValueError(f"binned on {binned.device}: expected cpu or cuda")
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS}")
    if binned.dtype != torch.uint8 or binned.dim() != 2 \
            or not binned.is_contiguous():
        raise ValueError("binned must be a contiguous (F, N) uint8 tensor")
    F, N = binned.shape
    if g3.dtype != torch.float32 or tuple(g3.shape) != (N, 3) \
            or not g3.is_contiguous() or g3.device != binned.device:
        raise ValueError(f"g3 must be a contiguous ({N}, 3) float32 tensor "
                         f"on {binned.device}")
    if leaf_id.dtype != torch.int32 or tuple(leaf_id.shape) != (N,) \
            or not leaf_id.is_contiguous() or leaf_id.device != binned.device:
        raise ValueError(f"leaf_id must be a contiguous ({N},) int32 tensor "
                         f"on {binned.device}")
    L, B = int(num_leaves), int(num_bins)
    live = L if live_slots is None else int(live_slots)
    if not 0 <= live <= L:
        raise ValueError(f"live_slots={live_slots}: expected 0..{L}")
    p = plan(N, F, L, B, precision)
    if F * max(N, 1) >= 2 ** 31:
        raise ValueError("binned exceeds the kernel's int32 row indexing")
    out = torch.empty((L, F, B, 3), dtype=torch.float32, device=binned.device)
    partial = torch.empty((p["n_chunks"], F, L, p["nb"], p["nc"]),
                          dtype=torch.float32, device=binned.device)
    if L == 0 or F == 0:
        return out.zero_()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        err = _lib().lgbm_hist_leaves(
            binned.data_ptr(), g3.data_ptr(), leaf_id.data_ptr(),
            partial.data_ptr(), out.data_ptr(), N, F, L, live, p["nb"], B,
            p["ls_max"], p["n_chunks"], p["chunk_rows"],
            PREC_ID[precision], stream)
    if err != 0:
        raise RuntimeError(f"hist_leaves: CUDA launch failed (cudaError "
                           f"{err})")
    with _count_lock:
        launch_counts["hist_leaves"] += 1
        key = (L, precision)
        bucket_launch_counts[key] = bucket_launch_counts.get(key, 0) + 1
    return out

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
sums, not to the bit.  ``int8sr`` (``hist_dtype_deep=int8sr``) takes
rows already quantized to exact integers in [-127, 127]
(``ops/quantize.sr_quantize``) and returns their integer histogram,
summed as int32 and rounded to f32 once at the output: exact, the same
in any order, and the Pallas kernel's bits while every cell stays below
2^24 in magnitude (the Pallas kernel adds its tiles' int32 products into
an f32 output).

Two plain PyTorch versions:

* ``hist_leaves_ref``: the same hi/lo values accumulated with one
  ``index_add_`` per part — the tolerance version, and the one a CPU tensor
  takes (a CUDA tensor launches the kernel or raises);
* ``hist_leaves_roworder_ref``: the kernel's own order, stated plainly —
  each (chunk, cell) summed in row order from 0 under ``plan``, the chunks
  merged in chunk order, hi and lo apart — so the kernel equals it bit for
  bit.  Only checks call it.

At ``int8sr`` both sum the integers exactly (int64 ``index_add_``), which
is every order's sum.

``int8`` (``hist_dtype=int8`` / ``hist_dtype_deep=int8``, the Pallas
kernel's ``precision="int8"``) takes the f32 rows, rounds them to nearest
under one scale a row tile of T rows (``ops/quantize.rn_quantize``, the
quantize kernel on the card; ``rows8``, a tree's ``NearestRows``, keeps
each T's rows) and sums each tile's integers exactly, adding
``float(sum) * scale`` into an f32 cell tile after tile, as one fma (the
Pallas kernel as XLA compiles it on the CPU).  T is the Pallas kernel's
own row tile for the call (``hist_row_tile``: the JAX ``_row_tile_for``
at 3 ceil8(L) accumulator rows on the feature block's lanes; 128 to
1024 rows), not the kernel's 256-row tile.  ``plan`` keeps every scale
tile inside one row chunk, and the chunks' f32 partials merge in chunk
order.  ``hist_leaves_ref`` adds every cell's tiles in row order over
all rows (the Pallas kernel's order, bit for bit); the kernel and
``hist_leaves_roworder_ref`` do so within each chunk and add the chunks
in order, so with one chunk they are the Pallas kernel's bits, and else
they differ from it by the association of the chunks' sums
(``int8_hist``, ``fma_f32``).

4-bit packed bins (``packed=True``, ``bin_layout=packed4``): two
features a byte, lo nibble = feature 2p, hi = 2p + 1 (``pack4bit``, the
JAX package's layout byte for byte).  The kernel's packed leg takes the
(ceil(F/2), N) bytes and decodes the nibble at the load; it plans from
the real feature count F (``num_features``), so its cells take the same
rows in the same order as the u8 leg's and its histograms are the u8
leg's bit for bit.  The plain versions unpack (``unpack4bit``) and run
the u8 plain version.

Each launch adds one to ``launch_counts["hist_leaves"]`` (u8) or
``launch_counts["hist_leaves_packed"]`` (packed) and to
``bucket_launch_counts[(L, precision)]`` (u8) or ``[(L, precision,
"packed")]``; each plain call adds one to ``plain_counts`` under its
function's name (``hist_leaves`` and ``hist_leaves_roworder`` here,
``hist_leaves_scatter`` for the exact oracle in ops/histogram.py).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

# the float legs, int8sr's integer one (quantized rows) and int8's
# (rounded under a row tile's scale)
FLOAT_PRECISIONS = ("f32", "bf16", "bf16x2")
PRECISIONS = FLOAT_PRECISIONS + ("int8sr", "int8")
PREC_ID = {"f32": 0, "bf16": 1, "bf16x2": 2, "int8sr": 3, "int8": 4}
# the Pallas kernels' lanes of one feature block (hist_pallas.MAX_LANES)
MAX_LANES = 2048
# the sub-histograms of one block: two 256-thread blocks share an SM
HIST_SMEM_BUDGET = 96 * 1024
# the chunk count targets this many blocks: a fixed number (two resident
# blocks on each of an H100's 132 SMs, two waves), never the card's own
# SM count, so the cross-block summation order depends on the shape alone
TARGET_BLOCKS = 2 * 2 * 132
ROW_TILE = 256

launch_counts = {"hist_leaves": 0, "hist_leaves_packed": 0}
# the launches by (slots L, precision), and (L, precision, "packed")
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
    raise ValueError("the histogram kernel holds num_bins <= 256")


def row_tile_for(m_pad: int, num_lanes: int, num_bins: int) -> int:
    """The Pallas kernels' row tile (JAX ``hist_pallas._row_tile_for``):
    the largest of 1024 (512 on the 256-bin rung), 512, 256 and 128 rows
    whose accumulator of ``m_pad`` rows and one-hot working set fit 8 MiB
    of VMEM.  The int8 leg's scale tile."""
    out_bytes = m_pad * num_lanes * 4
    per_row = 14 * min(num_lanes, 512) + 16 * m_pad
    t0 = 1024 if kernel_width(num_bins) <= 64 else 512
    for t in (1024, 512, 256, 128):
        if t <= t0 and out_bytes + t * per_row <= 8 * 2 ** 20:
            return t
    return 128


def hist_row_tile(num_leaves: int, num_features: int, num_bins: int,
                  packed: bool = False) -> int:
    """K1's int8 scale tile: ``hist_leaves_pallas``'s row tile at L slots
    (3 ceil8(L) accumulator rows) on its feature block's lanes (JAX
    hist_pallas.py:283-310; the packed block counts an even number of
    nibble features)."""
    B = int(num_bins)
    if packed:
        fblk = max(2, min(2 * -(-int(num_features) // 2), MAX_LANES // B)
                   & ~1)
    else:
        fblk = max(1, min(int(num_features), MAX_LANES // B))
    return row_tile_for(3 * (-(-int(num_leaves) // 8) * 8), fblk * B, B)


def round_row_tile(nslots: int, num_features: int, num_bins: int) -> int:
    """K2's and K6's int8 scale tile: ``fused_wave_scan``'s row tile at
    ``nslots`` accumulated slots and the dead one, priced on the unpacked
    feature block's lanes even for packed bins (JAX wave_fused.py:412-413)."""
    B = int(num_bins)
    return row_tile_for(3 * (-(-(int(nslots) + 1) // 8) * 8),
                        max(1, min(int(num_features), MAX_LANES // B)) * B, B)


def pack4bit(binned: torch.Tensor) -> torch.Tensor:
    """(F, N) uint8 bins < 16 -> (ceil(F/2), N) packed bytes, two features
    a byte (lo nibble = feature 2p, hi = 2p + 1; an odd F's last hi nibble
    is 0): the JAX package's ``hist_pallas.pack4bit`` layout."""
    F, N = binned.shape
    if F % 2:
        binned = torch.cat([binned, binned.new_zeros((1, N))])
    return (binned[0::2] | (binned[1::2] << 4)).to(torch.uint8).contiguous()


def unpack4bit(packed: torch.Tensor, num_features: int) -> torch.Tensor:
    """``pack4bit``'s inverse: (ceil(F/2), N) bytes -> (F, N) uint8 bins,
    the phantom hi nibble of an odd F dropped."""
    un = torch.stack([packed & 15, packed >> 4], dim=1)
    return un.reshape(2 * packed.shape[0], packed.shape[1])[
        :int(num_features)].to(torch.uint8).contiguous()


def packed_bins_of_feat(binned: torch.Tensor, feat) -> torch.Tensor:
    """(N,) int32 bins of feature ``feat`` from the packed bytes."""
    byte = binned[feat >> 1].to(torch.int32)
    return (byte >> (4 * (feat & 1))) & 15


def packed_bins_of_rows(binned: torch.Tensor,
                        f_row: torch.Tensor) -> torch.Tensor:
    """(N,) int32 bins of feature ``f_row[r]`` at each row r from the
    packed bytes."""
    f_row = f_row.long()
    byte = torch.gather(binned, 0, (f_row >> 1)[None, :])[0].to(torch.int32)
    return (byte >> (4 * (f_row & 1))) & 15


def bins_of_rows(binned: torch.Tensor, f_row: torch.Tensor,
                 packed: bool = False, bundle=None) -> torch.Tensor:
    """(N,) int32 bins of feature ``f_row[r]`` at each row r, from byte
    bins, (``packed``) from the packed bytes or (``bundle``, the
    ``io.bundle.BundleArrays`` of EFB) decoded from the bundle columns."""
    if packed:
        return packed_bins_of_rows(binned, f_row)
    if bundle is not None:
        from ..io.bundle import bundle_bins_of_rows

        return bundle_bins_of_rows(binned, f_row, bundle).to(torch.int32)
    return torch.gather(binned, 0, f_row.long()[None, :])[0].to(torch.int32)


def bins_of_feat(binned: torch.Tensor, feat, packed: bool = False,
                 bundle=None):
    """(N,) bins of feature ``feat``, from byte bins (uint8),
    (``packed``) from the packed bytes (int32) or (``bundle``) decoded
    from its bundle column (int64)."""
    if packed:
        return packed_bins_of_feat(binned, feat)
    if bundle is not None:
        from ..io.bundle import bundle_bins_of_feat

        return bundle_bins_of_feat(binned, feat, bundle)
    return binned[feat]


def _unpacked(binned: torch.Tensor, packed: bool, num_features):
    """The (F, N) byte bins of a packed matrix (``unpack4bit``), or
    ``binned`` itself."""
    if not packed:
        return binned
    if num_features is None:
        raise ValueError("packed bins need num_features (the real F)")
    return unpack4bit(binned, num_features)


def split_parts(g3: torch.Tensor, precision: str):
    """The value parts the histogram sums: [g3] (f32), [hi] (bf16) or
    [hi, lo] (bf16x2), each rounded exactly as the kernel rounds, or the
    rows as int64 integers (int8sr: the kernel's __float2int_rn).  int8
    sums tiles under scales (``int8_hist``), not parts."""
    if precision not in PRECISIONS or precision == "int8":
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS[:-1]}")
    if precision == "int8sr":
        return [torch.round(g3.to(torch.float32)).to(torch.int64)]
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
    """(L, F, B, 3) f32 sums of each (N, 3) value part over the rows of
    each slot: one ``index_add_`` a part over the flattened (feature, slot,
    bin) index in the part's type (int64 parts sum exactly and round to
    f32 once), the parts' sums added at the end.  Rows with a slot
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
        h = torch.zeros((dump + 1, 3), dtype=part.dtype, device=dev)
        h.index_add_(0, idx, part.repeat(F, 1))
        out = h if out is None else out + h
    out = out[:dump].reshape(F, L, B, 3).permute(1, 0, 2, 3) \
        .to(torch.float32).contiguous()
    if live_slots is not None:
        out[int(live_slots):] = 0.0
    return out


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded to float32 once (an fma), for float32 ``a``,
    ``b``, ``c`` whose product is exact in float64 (``a`` an integer below
    2^24 in magnitude).  The float64 sum ``s`` and its error ``e``
    (``s + e`` is the exact sum) round like the exact sum except where
    ``s`` falls on a float32 midpoint and ``e`` breaks the tie; that case
    takes the neighbour on ``e``'s side."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    fix = (d != 0) & (2 * d == nb.double() - r.double()) & (e * d > 0)
    return torch.where(fix, nb, r)


def int8_rows(g3: torch.Tensor, row_tile: int, rows8=None):
    """The rows rounded under ``row_tile``-row scales, ``(q, scale)``: from
    a tree's ``NearestRows`` when given, else quantized now."""
    if rows8 is not None:
        return rows8(row_tile)
    from .quantize import rn_quantize
    return rn_quantize(g3, row_tile)


def int8_hist(binned: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              row_tile: int, leaf_id: torch.Tensor, num_leaves: int,
              num_bins: int, live_slots=None,
              chunk_rows=None) -> torch.Tensor:
    """(L, F, B, 3) f32 int8 histograms of the rounded rows ``q`` (N, 3)
    under the (ceil(N / T), 3) ``scale`` of their T-row tiles: each cell
    sums a tile's integers exactly and adds ``float(sum) * scale`` into its
    f32 sum, tile after tile (``fma_f32``), within row chunks of
    ``chunk_rows`` (a multiple of T; None: one chunk, the Pallas kernel's
    order), the chunks then added in order from 0.  Rows of slots outside
    [0, live) (``live_slots``, default L) or bins >= B add nothing.
    Vectorised: the (tile, cell) integer sums by one ``index_add_``, then
    step r adds every (chunk, cell)'s r-th tile."""
    F, N = binned.shape
    L, B, T = int(num_leaves), int(num_bins), int(row_tile)
    dev = binned.device
    live = L if live_slots is None else min(int(live_slots), L)
    span = max(N, 1) if chunk_rows is None else int(chunk_rows)
    if span % T and chunk_rows is not None:
        raise ValueError(f"chunk_rows={chunk_rows} splits {T}-row tiles")
    n_chunks = max(1, -(-N // span))
    ncell = F * L * B
    lid = leaf_id.to(torch.int64)
    bins = binned.to(torch.int64)
    ok = ((lid >= 0) & (lid < live))[None, :] & (bins < B)
    f_idx, rows = ok.nonzero(as_tuple=True)
    cell = (f_idx * L + lid[rows]) * B + bins[f_idx, rows]
    tile = rows // T
    ukey, inv = torch.unique(tile * ncell + cell, return_inverse=True)
    sums = torch.zeros((ukey.numel(), 3), dtype=torch.int64, device=dev)
    sums.index_add_(0, inv, q.to(torch.int64)[rows])
    utile, ucell = ukey // ncell, ukey % ncell
    grp = (utile * T // span) * ncell + ucell          # (chunk, cell)
    grp, order = torch.sort(grp, stable=True)          # tiles rising
    utile, sums = utile[order], sums[order]
    pos = torch.arange(grp.numel(), device=dev)
    first = torch.ones_like(grp, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                              dim=0).values
    acc = torch.zeros((n_chunks * ncell, 3), dtype=torch.float32,
                      device=dev)
    if grp.numel():
        by_rank = torch.sort(rank, stable=True).indices
        start = 0
        for n_r in torch.bincount(rank).tolist():
            sel = by_rank[start:start + n_r]
            start += n_r
            idx = grp[sel]
            acc[idx] = fma_f32(sums[sel].to(torch.float32),
                               scale[utile[sel]], acc[idx])
    acc = acc.view(n_chunks, F, L, B, 3)
    out = torch.zeros((F, L, B, 3), dtype=torch.float32, device=dev)
    for ch in range(n_chunks):
        out = out + acc[ch]
    return out.permute(1, 0, 2, 3).contiguous()


def hist_leaves_ref(binned: torch.Tensor, g3: torch.Tensor,
                    leaf_id: torch.Tensor, num_leaves: int, num_bins: int,
                    precision: str = "bf16x2", live_slots=None,
                    packed: bool = False, num_features=None, rows8=None,
                    row_tile=None) -> torch.Tensor:
    """Plain version of ``hist_leaves``: the kernel's hi/lo (or f32)
    value parts summed by ``index_add_hist`` (packed bins unpacked
    first); int8: ``int8_hist`` in the Pallas kernel's order over all
    rows, at T = ``row_tile`` (default ``hist_row_tile``)."""
    count_plain("hist_leaves")
    bins = _unpacked(binned, packed, num_features)
    if precision == "int8":
        T = row_tile or hist_row_tile(num_leaves, bins.shape[0], num_bins,
                                      packed)
        q, scale = int8_rows(g3, T, rows8)
        return int8_hist(bins, q, scale, T, leaf_id, num_leaves, num_bins,
                         live_slots)
    return index_add_hist(bins, split_parts(g3, precision), leaf_id,
                          num_leaves, num_bins, live_slots)


def hist_leaves_roworder_ref(binned: torch.Tensor, g3: torch.Tensor,
                             leaf_id: torch.Tensor, num_leaves: int,
                             num_bins: int, precision: str = "bf16x2",
                             live_slots=None, packed: bool = False,
                             num_features=None, rows8=None,
                             row_tile=None) -> torch.Tensor:
    """Plain version of ``hist_leaves`` in the kernel's order: under
    ``plan``'s row chunks, every (chunk, feature, slot, bin) cell sums its
    rows' value parts in row order in f32 from a 0 start, one rounding an
    add; the chunks' cells are then summed in chunk order from 0, hi and lo
    apart, and ``hi + lo`` returned (bf16x2).  Vectorised rank by rank: a
    stable sort of the cell keys gives each row its rank in its cell, and
    step r adds every cell's r-th row (one row a cell a step, so each add
    rounds once).  No pairwise sum anywhere.  Packed bins are unpacked
    first: the plan is the real F's, as the kernel's.  int8: ``int8_hist``
    within the plan's chunks, at T = ``row_tile`` (default
    ``hist_row_tile``, the packed block's for packed bins)."""
    count_plain("hist_leaves_roworder")
    binned = _unpacked(binned, packed, num_features)
    if precision == "int8sr":     # exact integers: every order's sum
        return index_add_hist(binned, split_parts(g3, precision), leaf_id,
                              num_leaves, num_bins, live_slots)
    F, N = binned.shape
    L, B = int(num_leaves), int(num_bins)
    if precision == "int8":
        T = row_tile or hist_row_tile(L, F, B, packed)
        q, scale = int8_rows(g3, T, rows8)
        return int8_hist(binned, q, scale, T, leaf_id, L, B, live_slots,
                         plan(N, F, L, B, precision, T)["chunk_rows"])
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


def check_bins(binned: torch.Tensor, packed: bool = False,
               num_features=None) -> tuple:
    """The (stored columns, N) of a contiguous 2-D uint8 bins tensor, as
    the kernels take it: (F, N) byte bins, or (``packed``) the (ceil(F/2),
    N) bytes of ``num_features`` = F features.  The kernels index the
    stored bytes with int32."""
    if binned.dtype != torch.uint8 or binned.dim() != 2 \
            or not binned.is_contiguous():
        raise ValueError("binned must be a contiguous 2-D uint8 tensor")
    Fb, N = binned.shape
    if packed and (num_features is None
                   or Fb != -(-int(num_features) // 2)):
        raise ValueError(f"packed bins of num_features={num_features} "
                         f"features are (ceil(F/2), N) bytes, not {Fb} "
                         "columns")
    if Fb * max(N, 1) >= 2 ** 31:
        raise ValueError("binned exceeds the kernel's int32 row indexing")
    return Fb, N


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hist")
    lib.lgbm_hist_leaves.argtypes = [_P] * 5 + [_I] * 11 + [_P, _I, _P]
    lib.lgbm_hist_leaves.restype = _I
    return lib


def cell_words(precision: str) -> int:
    """4-byte words a cell of the shared sub-histograms takes (the
    kernel's ``cell_words``): 6 at bf16x2 (hi and lo) and at int8 (the
    int32 sums of its warp's current scale tile and the f32 sums), else
    3."""
    return 6 if precision in ("bf16x2", "int8") else 3


def plan(N: int, F: int, L: int, num_bins: int, precision: str,
         row_tile=None) -> dict:
    """The launch plan, decided by the shapes alone: the kernel's bin
    rung, the slots a block holds in ``HIST_SMEM_BUDGET`` and the row
    chunks (a fixed chunk count keeps the merge order, and so the bits,
    the same for a given shape on any card).  int8 chunks hold whole
    scale tiles of ``row_tile`` rows (their rows are a multiple of it)."""
    nb = kernel_width(num_bins)
    nc = 6 if precision == "bf16x2" else 3
    ls_max = max(1, min(int(L), HIST_SMEM_BUDGET
                        // (nb * cell_words(precision) * 4)))
    groups = -(-int(L) // ls_max)
    unit = ROW_TILE
    if precision == "int8":
        if row_tile is None:
            raise ValueError("an int8 plan needs its scale tile (row_tile)")
        unit = max(ROW_TILE, int(row_tile))
    tiles = max(1, -(-int(N) // unit))
    n_chunks = max(1, min(tiles, -(-TARGET_BLOCKS // max(F * groups, 1))))
    chunk_rows = -(-tiles // n_chunks) * unit
    n_chunks = max(1, -(-int(N) // chunk_rows))
    return dict(nb=nb, nc=nc, ls_max=ls_max, groups=groups,
                n_chunks=n_chunks, chunk_rows=chunk_rows)


def partial_dtype(precision: str) -> torch.dtype:
    """The partial stage's accumulator type: int32 at int8sr, else f32."""
    return torch.int32 if precision == "int8sr" else torch.float32


def hist_leaves(binned: torch.Tensor, g3: torch.Tensor,
                leaf_id: torch.Tensor, num_leaves: int, num_bins: int,
                precision: str = "bf16x2", live_slots=None,
                packed: bool = False, num_features=None, rows8=None,
                row_tile=None) -> torch.Tensor:
    """K1: (L, F, num_bins, 3) f32 histograms of the rows of each slot.
    With ``live_slots`` only the rows of slots below it add; the others'
    cells are 0, and the plan (so the live cells' bits) is L's.  At
    ``int8sr`` ``g3`` holds quantized rows (exact integers).  At ``int8``
    ``g3`` holds the f32 rows, rounded under scale tiles of ``row_tile``
    rows (default ``hist_row_tile``, the Pallas kernel's) by the quantize
    kernel, or taken from ``rows8`` (a tree's ``quantize.NearestRows``).
    With ``packed`` ``binned`` holds the (ceil(F/2), N) packed bytes of
    ``num_features`` = F features (``pack4bit``, num_bins <= 16)."""
    if binned.device.type == "cpu":
        return hist_leaves_ref(binned, g3, leaf_id, num_leaves, num_bins,
                               precision, live_slots, packed, num_features,
                               rows8, row_tile)
    if binned.device.type != "cuda":
        raise ValueError(f"binned on {binned.device}: expected cpu or cuda")
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS}")
    Fb, N = check_bins(binned, packed, num_features)
    F = int(num_features) if packed else Fb
    if packed and num_bins > 16:
        raise ValueError(f"num_bins={num_bins}: packed bins hold <= 16")
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
    qscale, T = None, 0
    if precision == "int8":
        T = int(row_tile or hist_row_tile(L, F, B, packed))
        g3, qscale = int8_rows(g3, T, rows8)
    p = plan(N, F, L, B, precision, T)
    out = torch.empty((L, F, B, 3), dtype=torch.float32, device=binned.device)
    partial = torch.empty((p["n_chunks"], F, L, p["nb"], p["nc"]),
                          dtype=partial_dtype(precision),
                          device=binned.device)
    if L == 0 or F == 0:
        return out.zero_()
    with torch.cuda.device(binned.device), _build.kernel_scope("hist_leaves"):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        err = _lib().lgbm_hist_leaves(
            binned.data_ptr(), g3.data_ptr(), leaf_id.data_ptr(),
            partial.data_ptr(), out.data_ptr(), N, F, L, live, p["nb"], B,
            p["ls_max"], p["n_chunks"], p["chunk_rows"],
            PREC_ID[precision], int(packed),
            0 if qscale is None else qscale.data_ptr(), T, stream)
    if err != 0:
        raise RuntimeError(f"hist_leaves: CUDA launch failed (cudaError "
                           f"{err})")
    with _count_lock:
        launch_counts["hist_leaves_packed" if packed else "hist_leaves"] += 1
        key = (L, precision, "packed") if packed else (L, precision)
        bucket_launch_counts[key] = bucket_launch_counts.get(key, 0) + 1
    return out

"""Sharded binary block cache: the out-of-core training format.

The port's copy of lightgbmv1_tpu/data/block_cache.py, format for format,
so a cache either package writes loads in the other.  The binned matrix
is written once as fixed-row-count block shards under a directory:

    <dir>/manifest.json     magic, format version, shapes, the stored
                            layout, the block table with each block's
                            SHA-256 digest, the meta shard's digest
    <dir>/meta.npz          bin mappers, feature names, max_bin and the
                            label / weight / group / init_score rows
    <dir>/block_00000.bin   raw C-order bytes of binned[:, a:b], (F, rows)
                            u8 / uint16, or (ceil(F/2), rows) bytes of
                            the 4-bit ``packed4`` layout

Every file goes through ``fileio.atomic_write_bytes`` (a temporary file,
fsync, rename), and readers check every digest before use, so a torn or
corrupt cache raises :class:`BlockCacheError` at load instead of training
on garbage (the reference's Dataset::LoadFromBinFile,
dataset_loader.cpp:273, trusted the file).  Blocks load on their own:
the row-block trainer's device working set is a block's, whatever the
rows.

Format history: v1 / v2 hold unpacked shards and no ``bin_layout``
(they load with a warning, as ``u8``); v3 adds ``bin_layout`` and the
``packed4`` shards (``pack4bit``: two features a byte, bit-equal to
``ops/hist_cuda.pack4bit``).  Digests cover the stored bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Dict, List

import numpy as np

from ..io.dataset import mapper_sections, metadata_sections
from ..utils.fileio import atomic_write_bytes, exists, open_file
from ..utils.log import log_info, log_warning

BLOCK_CACHE_MAGIC = "lightgbmv1_tpu.block_cache"
BLOCK_CACHE_VERSION = 3
BLOCK_CACHE_LEGACY_VERSIONS = (1, 2)
MANIFEST_NAME = "manifest.json"
META_NAME = "meta.npz"


class BlockCacheError(RuntimeError):
    """A torn, corrupt or incompatible block cache, raised at open or
    load.  Each one publishes a ``data.block_cache_error`` event, so the
    crash bundle of a run that died on a damaged cache names the
    damage."""

    def __init__(self, msg: str):
        super().__init__(msg)
        from ..obs import events

        events.publish("data.block_cache_error", str(msg), severity="error")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pack4bit(binned: np.ndarray) -> np.ndarray:
    """(F, N) uint8 bins < 16 -> (ceil(F/2), N) bytes: feature 2p in the
    low nibble, 2p + 1 in the high one, an odd F's last high nibble 0
    (``ops/hist_cuda.pack4bit`` on the host)."""
    F, N = binned.shape
    if F % 2:
        binned = np.concatenate([binned, np.zeros((1, N), binned.dtype)])
    return (binned[0::2] | (binned[1::2] << 4)).astype(np.uint8)


def unpack4bit(packed: np.ndarray, num_features: int) -> np.ndarray:
    """``pack4bit``'s inverse: (ceil(F/2), N) bytes -> (F, N) uint8."""
    un = np.stack([packed & 15, packed >> 4], axis=1)
    return np.ascontiguousarray(
        un.reshape(2 * packed.shape[0], packed.shape[1])[:num_features]
    ).astype(np.uint8)


def packed4_eligible(ds) -> str:
    """Why ``ds`` cannot store ``packed4`` shards, ``""`` when it can:
    every feature must fit a nibble (``num_total_bin <= 16``) of uint8
    bins."""
    if np.dtype(ds.binned.dtype).itemsize > 1:
        return "int16-binned data exceeds the 4-bit nibble"
    if int(ds.num_total_bin) > 16:
        return (f"num_total_bin={ds.num_total_bin} needs more than 4 "
                "bits per bin")
    return ""


def write_block_cache(ds, path: str, block_rows: int = 65536,
                      bin_layout: str = "auto") -> dict:
    """Write ``ds`` (a ``BinnedDataset`` with dense bins) as a block cache
    at the directory ``path``; returns the manifest.

    EFB bundle-only (sparse) datasets are refused: the streaming trainer
    speaks original features.  ``bin_layout``: ``"packed4"`` stores the
    4-bit shards (disk and the trainer's uploads halve) and raises where
    a feature needs more than 4 bits; ``"auto"`` packs exactly when
    eligible; ``"u8"`` never packs."""
    if ds.binned is None:
        raise BlockCacheError(
            "write_block_cache requires a dense-binned dataset (EFB "
            "bundle-only sparse datasets are not streamable); load dense "
            "data or set enable_bundle=false")
    if block_rows < 1:
        raise BlockCacheError(f"block_rows must be >= 1 (got {block_rows})")
    if bin_layout not in ("auto", "u8", "packed4"):
        raise BlockCacheError(
            f"bin_layout={bin_layout!r}: expected auto | u8 | packed4")
    if bin_layout == "packed4":
        reason = packed4_eligible(ds)
        if reason:
            raise BlockCacheError(f"bin_layout=packed4: {reason}")
    elif bin_layout == "auto":
        bin_layout = "u8" if packed4_eligible(ds) else "packed4"
    os.makedirs(path, exist_ok=True)

    buf = io.BytesIO()
    np.savez_compressed(buf, **mapper_sections(ds.bin_mappers),
                        feature_names=np.array(ds.feature_names),
                        max_bin=np.int64(ds.max_bin),
                        **metadata_sections(ds.metadata))
    meta_bytes = buf.getvalue()
    atomic_write_bytes(os.path.join(path, META_NAME), meta_bytes,
                       site="block_cache_meta")

    N = ds.num_data
    binned = np.ascontiguousarray(ds.binned)
    if bin_layout == "packed4":
        # packing pairs feature rows, so a block of the packed matrix is
        # the packed block
        binned = pack4bit(binned)
    blocks: List[dict] = []
    for i, a in enumerate(range(0, N, block_rows)):
        b = min(a + block_rows, N)
        data = np.ascontiguousarray(binned[:, a:b]).tobytes()
        fname = f"block_{i:05d}.bin"
        atomic_write_bytes(os.path.join(path, fname), data,
                           site=f"block_cache_block_{i}")
        blocks.append({"file": fname, "row_begin": int(a),
                       "rows": int(b - a), "sha256": _sha256(data),
                       "nbytes": len(data)})
    manifest = {
        "magic": BLOCK_CACHE_MAGIC,
        "format_version": BLOCK_CACHE_VERSION,
        "num_rows": int(N),
        "num_features": int(ds.num_features),
        "block_rows": int(block_rows),
        "dtype": str(binned.dtype),
        "bin_layout": bin_layout,
        "meta_file": META_NAME,
        "meta_sha256": _sha256(meta_bytes),
        "schema_digest": _sha256(meta_bytes)[:16],
        "blocks": blocks,
    }
    atomic_write_bytes(os.path.join(path, MANIFEST_NAME),
                       json.dumps(manifest, indent=1).encode(),
                       site="block_cache_manifest")
    log_info(f"Wrote block cache to {path}: {N} rows x {ds.num_features} "
             f"features in {len(blocks)} blocks of {block_rows} rows"
             + (" (4-bit packed shards)" if bin_layout == "packed4"
                else ""))
    return manifest


def is_block_cache(path) -> bool:
    """True when ``path`` is a directory holding a block-cache manifest."""
    p = os.path.join(str(path), MANIFEST_NAME)
    if not exists(p):
        return False
    try:
        with open_file(p) as fh:
            return json.load(fh).get("magic") == BLOCK_CACHE_MAGIC
    except (OSError, ValueError, AttributeError):
        return False


def load_manifest(path: str) -> dict:
    """The manifest of the cache at ``path``, checked: magic, version (a
    legacy one warns), fields, layout."""
    mp = os.path.join(str(path), MANIFEST_NAME)
    if not exists(mp):
        raise BlockCacheError(f"{path}: no {MANIFEST_NAME} (not a block "
                              "cache)")
    try:
        with open_file(mp) as fh:
            manifest = json.load(fh)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise BlockCacheError(f"{mp}: torn or corrupt manifest ({e})")
    if manifest.get("magic") != BLOCK_CACHE_MAGIC:
        raise BlockCacheError(f"{mp}: wrong magic "
                              f"{manifest.get('magic')!r}")
    version = int(manifest.get("format_version", -1))
    if version in BLOCK_CACHE_LEGACY_VERSIONS:
        log_warning(
            f"{mp}: legacy block-cache format_version {version} "
            f"(current is {BLOCK_CACHE_VERSION}); unpacked u8 shards — "
            "rewrite with save_block_cache to store 4-bit packed shards "
            "for max_bin <= 15 data")
    elif version != BLOCK_CACHE_VERSION:
        raise BlockCacheError(
            f"{mp}: unsupported format_version {version} (this build "
            f"reads versions {BLOCK_CACHE_LEGACY_VERSIONS} and "
            f"{BLOCK_CACHE_VERSION})")
    for key in ("num_rows", "num_features", "dtype", "blocks",
                "meta_sha256"):
        if key not in manifest:
            raise BlockCacheError(f"{mp}: missing manifest field {key!r}")
    layout = manifest_bin_layout(manifest)
    if layout not in ("u8", "packed4"):
        raise BlockCacheError(f"{mp}: unknown bin_layout {layout!r}")
    if layout == "packed4" and np.dtype(manifest["dtype"]).itemsize != 1:
        raise BlockCacheError(
            f"{mp}: packed4 shards must be uint8 "
            f"(manifest dtype {manifest['dtype']!r})")
    return manifest


def manifest_bin_layout(manifest: dict) -> str:
    """The cache's stored layout (a legacy manifest's is ``u8``)."""
    return str(manifest.get("bin_layout", "u8"))


def validate_block_table(path: str, manifest: dict) -> List[tuple]:
    """The block table's row ranges, checked to be ordered, non-empty,
    gap-free and overlap-free, covering exactly ``num_rows``: an overlap
    would count rows twice in every histogram and a gap drop them."""
    ranges = [(int(e["row_begin"]), int(e["row_begin"]) + int(e["rows"]))
              for e in manifest["blocks"]]
    pos = 0
    for a, b in ranges:
        if b <= a:
            raise BlockCacheError(
                f"{path}: empty or negative block at row {a}")
        if a < pos:
            raise BlockCacheError(
                f"{path}: block table OVERLAPS at row {a} (previous "
                f"block ends at {pos}); rows would be double-read")
        if a > pos:
            raise BlockCacheError(
                f"{path}: block table has a GAP at rows [{pos}, {a}); "
                "rows would be silently dropped")
        pos = b
    n = int(manifest["num_rows"])
    if pos != n:
        raise BlockCacheError(
            f"{path}: block table covers {pos} rows, manifest says {n}")
    return ranges


def shard_blocks(manifest, rank: int, world: int,
                 path: str = "<cache>") -> dict:
    """Rank ``rank`` of ``world``'s host shard: a contiguous run of whole
    blocks, balanced by block count, derived from the manifest alone (so
    every process derives the same partition without talking).  Returns
    ``{"block_lo", "block_hi", "row_begin", "row_end"}``; a rank past the
    blocks gets an empty run (``row_begin == row_end``)."""
    if not 0 <= rank < world:
        raise BlockCacheError(
            f"{path}: shard rank {rank} out of range for world {world}")
    ranges = validate_block_table(path, manifest)
    nb = len(ranges)
    lo = rank * nb // world
    hi = (rank + 1) * nb // world
    row_begin = ranges[lo][0] if lo < hi else int(manifest["num_rows"])
    row_end = ranges[hi - 1][1] if lo < hi else row_begin
    return {"block_lo": lo, "block_hi": hi,
            "row_begin": row_begin, "row_end": row_end}


def read_meta_arrays(path: str, manifest: dict) -> Dict[str, np.ndarray]:
    """The meta shard's arrays, digest-checked."""
    mp = os.path.join(str(path), manifest.get("meta_file", META_NAME))
    with open_file(mp, "rb") as fh:
        raw = fh.read()
    if _sha256(raw) != manifest["meta_sha256"]:
        raise BlockCacheError(f"{mp}: meta shard digest mismatch (torn or "
                              "corrupt cache)")
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def read_block(path: str, manifest: dict, index: int) -> np.ndarray:
    """Block ``index`` as stored, (F, rows) or packed (ceil(F/2), rows),
    digest-checked."""
    blocks = manifest["blocks"]
    if not 0 <= index < len(blocks):
        raise BlockCacheError(f"block index {index} out of range "
                              f"(cache has {len(blocks)} blocks)")
    entry = blocks[index]
    bp = os.path.join(str(path), entry["file"])
    with open_file(bp, "rb") as fh:
        raw = fh.read()
    if len(raw) != int(entry["nbytes"]) or _sha256(raw) != entry["sha256"]:
        raise BlockCacheError(
            f"{bp}: block digest mismatch (torn or corrupt cache); "
            "rebuild with task=save_binary")
    F = int(manifest["num_features"])
    if manifest_bin_layout(manifest) == "packed4":
        F = -(-F // 2)
    return np.frombuffer(raw, dtype=np.dtype(manifest["dtype"])).reshape(
        F, int(entry["rows"]))

"""Data files: CSV, TSV and LibSVM with the format detected; the port's
copy of lightgbmv1_tpu/io/parser.py on its Python path.

``load_data_file`` (JAX :315) keeps the reference loader's conventions
(src/io/parser.cpp, src/io/dataset_loader.cpp): ``#`` comments, an
optional header, the label column (``label_column``, by index or
``name:<column>``, 0 by default), ``weight_column``, ``group_column``
(a query id a row, turned into query sizes) and ``ignore_column``, and
the sibling files ``<file>.weight``, ``<file>.query`` and ``<file>.init``
(or ``initscore_filename``).  ``load_two_round`` (JAX :128) streams a
dense file twice: a reservoir sample of ``bin_construct_sample_cnt``
rows for the bin mappers, then the rows binned chunk by chunk, so the
float64 matrix never exists.

A dense file (csv, tsv, whitespace) on local disk goes through the
native C++ parser first (``native/text_parser.cpp``, threaded), as in the
JAX package (:389-396); this Python parser is its semantics reference and
takes the files the native one hands back: libsvm, remote paths, and
ragged or malformed rows, which it reports.

``load_data_file(rank=, num_machines=)`` (JAX :315-425) parses only this
rank's contiguous shard of the data lines (``shard_rows``, JAX :119, the
reference loader's pre-partition, dataset_loader.cpp:167), on the Python
parser, with the sibling weight and init-score files cut alike.  As in
the JAX package a libsvm file cannot be loaded by shards (a shard's
largest feature index need not be another's); query data cannot either
(a query would straddle two ranks), where the JAX package warns.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils import fileio
from ..utils.log import log_fatal, log_info, log_warning

# missing-value spellings of the reference's Atof
_MISS_TOKENS = frozenset(("", "na", "nan", "NA", "NaN", "null"))


def _fval(tok: str) -> float:
    return float(tok) if tok not in _MISS_TOKENS else np.nan


def _detect_format(sample_lines: List[str]) -> str:
    """libsvm where a token past the first is ``<int>:<value>``, else tsv
    or csv by the first line's separator, else whitespace (reference
    Parser::CreateParser)."""
    for line in sample_lines:
        if ":" in line.split("#", 1)[0]:
            for tok in line.split()[1:]:
                if ":" in tok:
                    try:
                        int(tok.split(":", 1)[0])
                        return "libsvm"
                    except ValueError:
                        break
    first = sample_lines[0] if sample_lines else ""
    if "\t" in first:
        return "tsv"
    if "," in first:
        return "csv"
    return "tsv"


def _parse_dense(lines: List[str], sep: Optional[str]) -> np.ndarray:
    rows = []
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if line:
            parts = line.split(sep) if sep else line.split()
            rows.append([_fval(p) for p in parts])
    return np.asarray(rows, dtype=np.float64)


def _parse_libsvm(lines: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    labels, entries, max_idx = [], [], -1
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        labels.append(float(toks[0]))
        row = len(labels) - 1
        for tok in toks[1:]:
            if ":" in tok:
                i, v = tok.split(":", 1)
                max_idx = max(max_idx, int(i))
                entries.append((row, int(i), float(v)))
    X = np.zeros((len(labels), max_idx + 1), dtype=np.float64)
    for r, c, v in entries:
        X[r, c] = v
    return X, np.asarray(labels)


class DataFile:
    """A parsed file: features, label, weight, query sizes, init scores
    and the header's feature names."""

    def __init__(self, X, label=None, weight=None, group=None,
                 feature_names=None, init_score=None):
        self.X = X
        self.label = label
        self.weight = weight
        self.group = group
        self.feature_names = feature_names
        self.init_score = init_score


def _resolve_column(spec: str, header_names: Optional[List[str]],
                    what: str) -> Optional[int]:
    """A column spec: an index, or ``name:<column>`` with a header."""
    if spec == "":
        return None
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names:
            log_fatal(f"{what} column by name requires header=true")
        if name not in header_names:
            log_fatal(f"{what} column {name} not found in header")
        return header_names.index(name)
    return int(spec)


def shard_rows(num_rows: int, rank: int, world: int):
    """Rank ``rank``'s contiguous ``[lo, hi)`` of ``num_rows`` rows cut in
    ``world`` shards of ceil(rows / world) (JAX :119; the last shorter)."""
    per = -(-num_rows // world)
    lo = min(rank * per, num_rows)
    return lo, min(lo + per, num_rows)


def _head(path: str, has_header: bool):
    """The header's names and the first data lines (format detection)."""
    if not fileio.exists(path):
        log_fatal(f"Data file {path} does not exist")
    with fileio.open_file(path) as fh:
        head = [fh.readline().rstrip("\n") for _ in range(24)]
    header_names, head_data = None, list(head)
    if has_header and head:
        first = head[0]
        sep = "\t" if "\t" in first else ("," if "," in first else None)
        header_names = first.split(sep) if sep else first.split()
        head_data = head[1:]
    fmt = _detect_format([ln for ln in head_data if ln.strip()][:20])
    first_data = next((ln for ln in head_data if ln.strip()), "")
    sep = "\t" if fmt == "tsv" and "\t" in first_data else (
        "," if fmt == "csv" else None)
    return header_names, fmt, sep


def _meta_columns(header_names, label_column, weight_column, group_column,
                  ignore_column, default_label):
    label_idx = _resolve_column(label_column, header_names, "label")
    if label_idx is None:
        label_idx = default_label
    weight_idx = _resolve_column(weight_column, header_names, "weight")
    group_idx = _resolve_column(group_column, header_names, "group")
    ignore = set()
    for tok in (ignore_column.split(",") if ignore_column else []):
        idx = _resolve_column(tok, header_names, "ignore")
        if idx is not None:
            ignore.add(idx)
    return label_idx, weight_idx, group_idx, ignore


def _query_sizes(qid: np.ndarray) -> np.ndarray:
    """A query id a row -> the sizes of the runs of equal ids."""
    change = np.flatnonzero(np.diff(qid) != 0)
    return np.diff(np.concatenate([[0], change + 1, [len(qid)]]))


def load_two_round(path: str, config, categorical_features=None):
    """The two-pass loader of ``two_round=true`` (JAX :128; reference
    dataset_loader.cpp:208-235): the bin mappers from a reservoir sample
    of the first pass, the (F, N) bins from chunks of the second.  Returns
    a ``BinnedDataset``, or None for libsvm (no streaming path: the caller
    loads the file in memory).  ``categorical_features``: the indices of
    the categorical feature columns (after the metadata columns)."""
    from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper,
                          get_forced_bins)
    from .dataset import BinnedDataset, Metadata

    categorical = set(categorical_features or [])
    header_names, fmt, sep = _head(path, config.header)
    if fmt == "libsvm":
        log_warning("two_round loading has no libsvm streaming path; "
                    "falling back to the in-memory loader")
        return None
    label_idx, weight_idx, group_idx, ignore = _meta_columns(
        header_names, config.label_column, config.weight_column,
        config.group_column, config.ignore_column, 0)

    def rows_of(fh):
        if config.header:
            fh.readline()
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                yield line.split(sep) if sep else line.split()

    # pass 1: the metadata columns and a reservoir sample for the bins
    rng = np.random.RandomState(config.data_random_seed)
    cap = max(1, config.bin_construct_sample_cnt)
    sample_rows: List[list] = []
    label_l, weight_l, group_l = [], [], []
    n_rows = 0
    with fileio.open_file(path) as fh:
        for parts in rows_of(fh):
            label_l.append(_fval(parts[label_idx]))
            if weight_idx is not None:
                weight_l.append(_fval(parts[weight_idx]))
            if group_idx is not None:
                group_l.append(_fval(parts[group_idx]))
            if n_rows < cap:
                sample_rows.append([_fval(p) for p in parts])
            else:
                j = rng.randint(0, n_rows + 1)
                if j < cap:
                    sample_rows[j] = [_fval(p) for p in parts]
            n_rows += 1
    if n_rows == 0:
        log_fatal(f"Data file {path} is empty")
    meta_cols = {c for c in (label_idx, weight_idx, group_idx)
                 if c is not None}
    keep = [c for c in range(len(sample_rows[0]))
            if c not in meta_cols and c not in ignore]
    num_features = len(keep)
    feature_names = ([header_names[c] for c in keep] if header_names
                     else None)
    sample_mat = np.asarray(sample_rows, np.float64)[:, keep]
    sample_cnt = sample_mat.shape[0]
    max_bins = (list(config.max_bin_by_feature)
                or [config.max_bin] * num_features)
    if len(max_bins) != num_features:
        log_fatal("max_bin_by_feature length must equal number of features")
    forced = get_forced_bins(config.forcedbins_filename, num_features,
                             categorical)
    mappers = [BinMapper.find_bin(
        sample_mat[:, j], total_sample_cnt=sample_cnt, max_bin=max_bins[j],
        min_data_in_bin=config.min_data_in_bin,
        bin_type=BIN_CATEGORICAL if j in categorical else BIN_NUMERICAL,
        use_missing=config.use_missing,
        zero_as_missing=config.zero_as_missing, forced_bounds=forced[j],
        pre_filter=config.feature_pre_filter,
        filter_cnt=int(config.min_data_in_leaf * sample_cnt
                       / max(n_rows, 1)))
        for j in range(num_features)]

    # pass 2: chunks of rows binned in place
    max_nb = max(m.num_bin for m in mappers) if mappers else 2
    dtype = np.uint8 if max_nb <= 256 else np.int16
    binned = np.empty((num_features, n_rows), dtype=dtype)
    chunk_rows, lo, buf = 65536, 0, []

    def flush():
        nonlocal lo
        if buf:
            chunk = np.asarray(buf, np.float64)[:, keep]
            for j, m in enumerate(mappers):
                binned[j, lo:lo + len(buf)] = m.value_to_bin(
                    chunk[:, j]).astype(dtype)
            lo += len(buf)
            buf.clear()

    with fileio.open_file(path) as fh:
        for parts in rows_of(fh):
            buf.append([_fval(p) for p in parts])
            if len(buf) >= chunk_rows:
                flush()
        flush()

    meta = Metadata()
    meta.label = np.asarray(label_l, np.float32)
    if weight_idx is not None:
        meta.weight = np.asarray(weight_l, np.float32)
    if meta.weight is None and os.path.exists(path + ".weight"):
        meta.weight = np.loadtxt(path + ".weight", dtype=np.float64,
                                 ndmin=1).astype(np.float32)
    group = (_query_sizes(np.asarray(group_l)) if group_idx is not None
             else None)
    if group is None and os.path.exists(path + ".query"):
        group = np.loadtxt(path + ".query", dtype=np.int64, ndmin=1)
    meta.set_group(group)
    ifile = config.initscore_filename or (path + ".init")
    if os.path.exists(ifile):
        meta.init_score = np.loadtxt(ifile, dtype=np.float64)
    ds = BinnedDataset(binned, mappers, meta, feature_names,
                       max_bin=config.max_bin)
    log_info(f"two_round: streamed {n_rows} rows x {num_features} features "
             f"in two passes ({binned.nbytes >> 20} MB binned)")
    return ds


def load_data_file(path: str, *, has_header: bool = False,
                   label_column: str = "", weight_column: str = "",
                   group_column: str = "", ignore_column: str = "",
                   is_predict: bool = False, num_threads: int = 0,
                   init_score_file: str = "", rank: Optional[int] = None,
                   num_machines: int = 1) -> DataFile:
    """A training or prediction file with the reference loader's
    conventions (JAX :315; reference DatasetLoader::LoadFromFile,
    dataset_loader.cpp:167).  ``is_predict``: no label column unless
    one is named; ``num_threads`` caps the native parser's threads (<= 0:
    every core).  ``rank`` / ``num_machines``: only that rank's shard of
    the data lines is parsed (``shard_rows``)."""
    header_names, fmt, sep = _head(path, has_header)
    sharded = rank is not None and num_machines > 1
    shard = [0, None]

    def all_lines():
        with fileio.open_file(path) as fh:
            lines = fh.read().splitlines()
        lines = lines[1:] if has_header and lines else lines
        if sharded:
            data_idx = [i for i, ln in enumerate(lines)
                        if ln.split("#", 1)[0].strip()]
            shard[0], shard[1] = shard_rows(len(data_idx), rank,
                                            num_machines)
            lines = [lines[i] for i in data_idx[shard[0]:shard[1]]]
        return lines

    label = weight = group = None
    feature_names = None
    if fmt == "libsvm":
        if sharded:
            log_fatal("rank-sharded loading of libsvm files is not "
                      "supported; use a dense format or pre-partitioned "
                      "files")
        X, label = _parse_libsvm(all_lines())
    else:
        from ..native import parse_dense_file

        data = (None if sharded or fileio.is_remote_path(path) else
                parse_dense_file(path, has_header, sep, num_threads))
        if data is None:
            data = _parse_dense(all_lines(), sep)
        label_idx, weight_idx, group_idx, ignore = _meta_columns(
            header_names, label_column, weight_column, group_column,
            ignore_column, None if is_predict else 0)
        meta_cols = {c for c in (label_idx, weight_idx, group_idx)
                     if c is not None}
        keep = [c for c in range(data.shape[1])
                if c not in meta_cols and c not in ignore]
        X = data[:, keep]
        if header_names:
            feature_names = [header_names[c] for c in keep]
        if label_idx is not None:
            label = data[:, label_idx]
        if weight_idx is not None:
            weight = data[:, weight_idx]
        if group_idx is not None:
            if sharded:
                log_fatal("group_column with rank-sharded loading: a query "
                          "would straddle two ranks (query-aligned "
                          "sharding is not implemented)")
            group = _query_sizes(data[:, group_idx])
    wfile, qfile = path + ".weight", path + ".query"
    if weight is None and os.path.exists(wfile):
        weight = np.loadtxt(wfile, dtype=np.float64, ndmin=1)
        if sharded:
            weight = weight[shard[0]:shard[1]]
        log_info(f"Loading weights from {wfile}")
    if group is None and os.path.exists(qfile):
        if sharded:
            log_fatal(f"{qfile} with rank-sharded loading: a query would "
                      "straddle two ranks (query-aligned sharding is not "
                      "implemented)")
        group = np.loadtxt(qfile, dtype=np.int64, ndmin=1)
        log_info(f"Loading query boundaries from {qfile}")
    ifile = init_score_file or (path + ".init")
    init_score = None
    if os.path.exists(ifile):
        init_score = np.loadtxt(ifile, dtype=np.float64)
        if sharded:
            init_score = init_score[shard[0]:shard[1]]
        log_info(f"Loading initial scores from {ifile}")
    return DataFile(X, label, weight, group, feature_names, init_score)

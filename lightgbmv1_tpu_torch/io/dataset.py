"""Binned dataset: the training representation (host numpy).

Port of lightgbmv1_tpu/io/dataset.py ``Metadata`` (:46, with the query
groups of ``set_group`` :60) and ``BinnedDataset`` (``from_numpy`` :159,
``from_csr`` :255, ``train_matrix`` :104, ``bundle_features`` :109,
``padded_bundle_bin`` :132, ``_build_feature_meta`` :137) for numerical
features: a bin-mapper per feature found on a seeded row sample (with
``max_bin_by_feature`` and the forced bounds of ``forcedbins_filename``),
the (F, N) uint8 bin matrix (int16 past 256 bins a feature) and the
per-feature bin metadata the split scan reads.  At ``enable_bundle``
(the default) exclusive features share bundle columns (io/bundle.py): the
(BF, N) ``bundled`` matrix is what the trainer moves to the device, and a
valid set takes its reference's layout.  Sparse (CSR) input bins the
non-zero entries only and builds the bundle matrix straight from them,
never the dense (F, N) matrix (``binned`` is None then, unless no bundle
forms and the identity layout's matrix is the plain one).  Categorical
features (``categorical_features``, JAX :167, :267) take categorical
mappers (io/binning.py), and bundle as any feature does.

The binned dataset cache (``save_binary`` / ``is_binary_file`` /
``load_binary``, JAX :414-606; reference Dataset::SaveBinaryFile,
DatasetLoader::LoadFromBinFile) keeps the JAX package's npz layout, magic
and format version 2 with its per-section SHA-256 digests, so a ``.bin``
either package writes loads in the other.
"""

from __future__ import annotations

import hashlib
import io
import zipfile
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import Config
from ..utils.fileio import atomic_write_bytes, exists, open_file
from ..utils.log import LightGBMError, log_fatal, log_info, log_warning
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


@dataclass
class Metadata:
    """Labels, weights, query groups and init scores (reference Metadata,
    dataset.h:40-248)."""

    label: Optional[np.ndarray] = None
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None              # per-query sizes
    query_boundaries: Optional[np.ndarray] = None   # cumulative, Q + 1
    init_score: Optional[np.ndarray] = None

    def set_group(self, group: Optional[np.ndarray]) -> None:
        if group is None:
            self.group = self.query_boundaries = None
            return
        self.group = np.asarray(group, dtype=np.int64).ravel()
        self.query_boundaries = np.concatenate([[0],
                                                np.cumsum(self.group)])


def _sample_rows(num_data: int, config: Config) -> np.ndarray:
    """The rows the bin mappers are found on (reference
    bin_construct_sample_cnt, dataset_loader.cpp:823), drawn as the JAX
    package draws them."""
    sample_cnt = min(num_data, config.bin_construct_sample_cnt)
    rng = np.random.RandomState(config.data_random_seed)
    if sample_cnt < num_data:
        return rng.choice(num_data, size=sample_cnt, replace=False)
    return np.arange(num_data)


def _find_mappers(samples, sample_cnt: int, num_data: int,
                  config: Config, categorical=()) -> List[BinMapper]:
    """One bin mapper a feature on its sampled values, each at its
    ``max_bin_by_feature`` (or ``max_bin``) with its forced bounds; the
    features of ``categorical`` take categorical mappers."""
    from .binning import get_forced_bins

    num_features = len(samples)
    categorical = set(categorical or ())
    max_bins = (list(config.max_bin_by_feature)
                or [config.max_bin] * num_features)
    if len(max_bins) != num_features:
        log_fatal("max_bin_by_feature length must equal number of features")
    forced = get_forced_bins(config.forcedbins_filename, num_features,
                             categorical)
    filter_cnt = int(config.min_data_in_leaf * sample_cnt
                     / max(num_data, 1))
    return [BinMapper.find_bin(
        samples[j], total_sample_cnt=sample_cnt, max_bin=max_bins[j],
        min_data_in_bin=config.min_data_in_bin,
        bin_type=BIN_CATEGORICAL if j in categorical else BIN_NUMERICAL,
        use_missing=config.use_missing,
        zero_as_missing=config.zero_as_missing, forced_bounds=forced[j],
        pre_filter=config.feature_pre_filter, filter_cnt=filter_cnt)
        for j in range(num_features)]


def _metadata(num_data, label, weight, init_score, group) -> Metadata:
    meta = Metadata()
    if label is not None:
        meta.label = np.asarray(label, dtype=np.float32).ravel()
        if len(meta.label) != num_data:
            raise ValueError("label length mismatch")
    if weight is not None:
        meta.weight = np.asarray(weight, dtype=np.float32).ravel()
    if init_score is not None:
        meta.init_score = np.asarray(init_score, dtype=np.float64)
    meta.set_group(group)
    if group is not None and meta.query_boundaries[-1] != num_data:
        raise ValueError(f"query sizes sum to "
                         f"{int(meta.query_boundaries[-1])}, not the "
                         f"{num_data} rows")
    return meta


def mapper_sections(bin_mappers: List[BinMapper]) -> dict:
    """The bin mappers as the flat arrays both dataset caches store (the
    ``.bin`` cache and the block cache's ``meta.npz``, JAX
    data/block_cache.py ``_mapper_arrays``)."""
    ubounds = [np.asarray(m.bin_upper_bound, np.float64) for m in bin_mappers]
    cats = [np.asarray(m.bin_2_categorical, np.int64) for m in bin_mappers]
    return dict(
        mapper_scalars=np.array(
            [[m.num_bin, m.missing_type, m.bin_type, int(m.is_trivial)]
             for m in bin_mappers], dtype=np.int64),
        mapper_floats=np.array(
            [[m.sparse_rate, m.min_value, m.max_value]
             for m in bin_mappers], dtype=np.float64),
        ubound_flat=np.concatenate(ubounds) if ubounds else np.zeros(0),
        ubound_offsets=np.cumsum([0] + [len(u) for u in ubounds]),
        cat_flat=np.concatenate(cats) if cats else np.zeros(0, np.int64),
        cat_offsets=np.cumsum([0] + [len(c) for c in cats]))


def metadata_sections(meta: Metadata) -> dict:
    """The metadata as the caches store it (an absent field empty)."""
    return dict(
        label=meta.label if meta.label is not None else np.zeros(0),
        weight=meta.weight if meta.weight is not None else np.zeros(0),
        group=(meta.group if meta.group is not None
               else np.zeros(0, np.int64)),
        init_score=(meta.init_score if meta.init_score is not None
                    else np.zeros(0)))


def mappers_from_sections(z) -> List[BinMapper]:
    """``mapper_sections``' inverse, from a loaded npz (or dict)."""
    sc, fl = z["mapper_scalars"], z["mapper_floats"]
    uoff, coff = z["ubound_offsets"], z["cat_offsets"]
    mappers = []
    for j in range(sc.shape[0]):
        cats = [int(c) for c in z["cat_flat"][coff[j]:coff[j + 1]]]
        mappers.append(BinMapper(
            bin_upper_bound=np.asarray(
                z["ubound_flat"][uoff[j]:uoff[j + 1]], np.float64),
            num_bin=int(sc[j, 0]), missing_type=int(sc[j, 1]),
            bin_type=int(sc[j, 2]), is_trivial=bool(sc[j, 3]),
            sparse_rate=float(fl[j, 0]), min_value=float(fl[j, 1]),
            max_value=float(fl[j, 2]), bin_2_categorical=cats,
            categorical_2_bin={c: i for i, c in enumerate(cats)}))
    return mappers


class BinnedDataset:
    """Feature-binned training data + metadata; ``binned`` is (F, N)
    uint8, or int16 past 256 bins a feature (None for sparse input that
    bundled); ``bundled`` the (BF, N) EFB matrix under ``bundle_layout``,
    or None."""

    def __init__(self, binned: Optional[np.ndarray],
                 bin_mappers: List[BinMapper], metadata: Metadata,
                 feature_names: Optional[List[str]] = None,
                 max_bin: int = 255, num_data: Optional[int] = None):
        self.binned = binned
        self.bundled = None
        self.bundle_layout = None
        self.bin_mappers = bin_mappers
        self.metadata = metadata
        self.num_features = len(bin_mappers)
        self.num_data = binned.shape[1] if binned is not None else num_data
        self.max_bin = max_bin
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(self.num_features)]
        self._build_feature_meta()

    @property
    def train_matrix(self) -> np.ndarray:
        """The matrix the trainer uploads: the bundle columns where EFB
        applied, else the plain (F, N) bins."""
        return self.bundled if self.bundled is not None else self.binned

    def bundle_features(self, config: Config,
                        reference: Optional["BinnedDataset"] = None) -> None:
        """EFB on the dense bins (JAX :109; reference Dataset::Construct
        -> FindGroups, src/io/dataset.cpp:97-315): a valid set takes its
        reference's layout, a training set bundles where it pays."""
        from .bundle import apply_bundles_dense, maybe_bundle

        if self.binned is None:
            return                  # sparse input bundled at construction
        if reference is not None:
            if reference.bundle_layout is not None:
                self.bundle_layout = reference.bundle_layout
                self.bundled = apply_bundles_dense(
                    self.binned, self.zero_bins, self.bundle_layout)
            return
        bundled, layout = maybe_bundle(
            self.binned, self.zero_bins, self.num_bins,
            max_conflict_rate=config.max_conflict_rate)
        if layout is not None:
            self.bundled, self.bundle_layout = bundled, layout

    @property
    def padded_bundle_bin(self) -> int:
        """The histograms' bin axis over the bundle columns."""
        assert self.bundle_layout is not None
        return max(8, _next_pow2(int(self.bundle_layout.bundle_nbins.max())))

    def _build_feature_meta(self) -> None:
        ms = self.bin_mappers
        self.num_bins = np.array([m.num_bin for m in ms], dtype=np.int32)
        self.missing_types = np.array([m.missing_type for m in ms],
                                      dtype=np.int32)
        self.nan_bins = np.array([m.nan_bin for m in ms], dtype=np.int32)
        self.zero_bins = np.array([m.zero_bin for m in ms], dtype=np.int32)
        self.default_bins = np.array([m.default_bin for m in ms],
                                     dtype=np.int32)
        self.is_categorical = np.array(
            [m.bin_type == BIN_CATEGORICAL for m in ms], dtype=bool)
        self.is_trivial = np.array([m.is_trivial for m in ms], dtype=bool)
        max_nb = int(self.num_bins.max()) if len(ms) else 2
        self.num_total_bin = max(2, max_nb)
        # padded bin axis of the histograms (JAX io/dataset.py:155)
        self.padded_bin = max(8, _next_pow2(self.num_total_bin))

    def feature_infos(self) -> List[str]:
        return [m.feature_info_str() for m in self.bin_mappers]

    # the JAX package's cache identity (JAX :414-419): a version-1 cache
    # (no digests) loads with a warning, a newer version is refused
    BINARY_MAGIC = "lightgbmv1_tpu.dataset.v1"
    BINARY_FORMAT_VERSION = 2

    @staticmethod
    def _section_digest(arr: np.ndarray) -> str:
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()
                              ).hexdigest()

    def save_binary(self, path: str) -> None:
        """Write the binned cache to ``path`` atomically (JAX :428): the
        bins (or, for sparse input that bundled, the bundle matrix; a
        dense set's bundle matrix is derived again at load), the bundle
        layout, the mappers as flat arrays, the metadata, each section
        under its digest."""
        meta, bl = self.metadata, self.bundle_layout
        sections = dict(
            magic=np.frombuffer(self.BINARY_MAGIC.encode(), dtype=np.uint8),
            binned=(self.binned if self.binned is not None
                    else np.zeros((0, 0), np.uint8)),
            bundled=(self.bundled
                     if self.bundled is not None and self.binned is None
                     else np.zeros((0, 0), np.uint8)),
            bundle_of=(bl.bundle_of if bl is not None
                       else np.zeros(0, np.int32)),
            bundle_offset=(bl.offset if bl is not None
                           else np.zeros(0, np.int32)),
            bundle_is_bundled=(bl.is_bundled if bl is not None
                               else np.zeros(0, bool)),
            bundle_nbins=(bl.bundle_nbins if bl is not None
                          else np.zeros(0, np.int32)),
            num_data=np.int64(self.num_data),
            max_bin=np.int64(self.max_bin),
            feature_names=np.array(self.feature_names),
            **mapper_sections(self.bin_mappers),
            **metadata_sections(meta),
        )
        digest_keys = sorted(k for k in sections if k != "magic")
        fh = io.BytesIO()       # savez appends .npz to a bare string path
        np.savez_compressed(
            fh, format_version=np.int64(self.BINARY_FORMAT_VERSION),
            digest_keys=np.array(digest_keys),
            digest_values=np.array([self._section_digest(sections[k])
                                    for k in digest_keys]),
            **sections)
        atomic_write_bytes(path, fh.getvalue())
        log_info(f"Saved binary dataset cache to {path} (format "
                 f"v{self.BINARY_FORMAT_VERSION}, {len(digest_keys)} "
                 "digest-pinned sections)")

    @classmethod
    def is_binary_file(cls, path: str) -> bool:
        """A zip whose ``magic`` member is the cache's (JAX :501)."""
        if not exists(path):
            return False
        try:
            with open_file(path, "rb") as fh:
                if not zipfile.is_zipfile(fh):
                    return False
                fh.seek(0)
                with np.load(fh, allow_pickle=False) as z:
                    return ("magic" in z and bytes(z["magic"]).decode()
                            == cls.BINARY_MAGIC)
        except Exception:               # any unreadable file is not one
            return False

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        """The dataset a cache holds (JAX :519); a torn, corrupt or newer
        cache is fatal."""
        try:
            return cls._load_binary(path)
        except LightGBMError:
            raise
        except (zipfile.BadZipFile, ValueError, OSError, KeyError,
                EOFError) as e:
            log_fatal(f"{path}: torn or corrupt binary dataset cache "
                      f"({type(e).__name__}: {e}); re-create it with "
                      "save_binary")

    @classmethod
    def _load_binary(cls, path: str) -> "BinnedDataset":
        from .bundle import BundleLayout, apply_bundles_dense

        with open_file(path, "rb") as fh, \
                np.load(fh, allow_pickle=False) as z:
            if bytes(z["magic"]).decode() != cls.BINARY_MAGIC:
                log_fatal(f"{path} is not a lightgbmv1_tpu binary dataset")
            version = (int(z["format_version"]) if "format_version" in z
                       else 1)
            if version > cls.BINARY_FORMAT_VERSION:
                log_fatal(f"{path}: binary cache format v{version} is "
                          "newer than this build reads "
                          f"(v{cls.BINARY_FORMAT_VERSION}); re-create it "
                          "with save_binary")
            if version >= 2:
                for k, want in zip(z["digest_keys"], z["digest_values"]):
                    k = str(k)
                    if k not in z or cls._section_digest(z[k]) != str(want):
                        log_fatal(f"{path}: binary cache section {k!r} "
                                  "digest mismatch — torn or corrupt "
                                  "cache; re-create it with save_binary")
            else:
                log_warning(f"{path}: legacy v1 binary cache (no section "
                            "digests); re-save to enable corruption "
                            "detection")
            mappers = mappers_from_sections(z)
            meta = Metadata()
            if z["label"].size:
                meta.label = z["label"].astype(np.float32)
            if z["weight"].size:
                meta.weight = z["weight"].astype(np.float32)
            if z["group"].size:
                meta.set_group(z["group"])
            if z["init_score"].size:
                meta.init_score = z["init_score"]
            ds = cls(z["binned"] if z["binned"].size else None, mappers,
                     meta, feature_names=[str(s)
                                          for s in z["feature_names"]],
                     max_bin=int(z["max_bin"]),
                     num_data=(int(z["num_data"]) if "num_data" in z
                               else z["binned"].shape[1]))
            if "bundle_of" in z and z["bundle_of"].size:
                ds.bundle_layout = BundleLayout(
                    bundle_of=z["bundle_of"], offset=z["bundle_offset"],
                    is_bundled=z["bundle_is_bundled"],
                    bundle_nbins=z["bundle_nbins"])
                ds.bundled = (z["bundled"] if z["bundled"].size
                              else apply_bundles_dense(
                                  ds.binned, ds.zero_bins,
                                  ds.bundle_layout))
        log_info(f"Loaded binary dataset cache from {path}: "
                 f"{ds.num_data} rows, {ds.num_features} features")
        return ds

    @classmethod
    def from_numpy(cls, X: np.ndarray, label: Optional[np.ndarray] = None,
                   weight: Optional[np.ndarray] = None,
                   init_score: Optional[np.ndarray] = None,
                   group: Optional[np.ndarray] = None,
                   config: Optional[Config] = None,
                   feature_names: Optional[List[str]] = None,
                   reference: Optional["BinnedDataset"] = None,
                   categorical_features=None,
                   bin_finder=None) -> "BinnedDataset":
        """Bin a dense (rows, features) float matrix.  ``reference``
        reuses another dataset's bin mappers (a valid set shares the
        training bins); ``group`` holds the query sizes of a ranking
        set, in row order; ``categorical_features`` the indices of the
        categorical columns.  ``bin_finder(samples, sample_cnt, max_bins,
        categorical, config, num_data) -> mappers`` (JAX :170) finds the
        mappers instead: the distributed loader's, which agrees them
        across the ranks (``parallel/dist_data.find_bins_distributed``)."""
        config = config or Config()
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (rows, features)")
        num_data, num_features = X.shape
        if reference is not None:
            mappers = reference.bin_mappers
            feature_names = feature_names or reference.feature_names
            if len(mappers) != num_features:
                raise ValueError(f"{num_features} features against the "
                                 f"reference's {len(mappers)}")
        else:
            sample_idx = _sample_rows(num_data, config)
            samples = [np.asarray(X[sample_idx, j], dtype=np.float64)
                       for j in range(num_features)]
            if bin_finder is not None:
                max_bins = (list(config.max_bin_by_feature)
                            or [config.max_bin] * num_features)
                mappers = bin_finder(samples, len(sample_idx), max_bins,
                                     set(categorical_features or ()),
                                     config, num_data)
            else:
                mappers = _find_mappers(samples, len(sample_idx), num_data,
                                        config, categorical_features)
        max_nb = max(m.num_bin for m in mappers) if mappers else 2
        # the reference's DenseBin<uint8_t> / DenseBin<uint16_t> family
        # (JAX :228): int16 bins past 256 bins a feature
        dtype = np.uint8 if max_nb <= 256 else np.int16
        binned = np.empty((num_features, num_data), dtype=dtype)
        for j, m in enumerate(mappers):
            binned[j] = m.value_to_bin(X[:, j]).astype(dtype)
        ds = cls(binned, mappers,
                 _metadata(num_data, label, weight, init_score, group),
                 feature_names, max_bin=config.max_bin)
        log_info(f"Constructed binned dataset: {num_data} rows, "
                 f"{num_features} features "
                 f"({int((~ds.is_trivial).sum())} informative), max "
                 f"{ds.num_total_bin} bins")
        if config.enable_bundle:
            ds.bundle_features(config, reference=reference)
        return ds

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray,
                 values: np.ndarray, num_data: int, num_features: int,
                 label=None, weight=None, group=None, init_score=None,
                 config: Optional[Config] = None,
                 feature_names: Optional[List[str]] = None,
                 reference: Optional["BinnedDataset"] = None,
                 categorical_features=None) -> "BinnedDataset":
        """Bin CSR triplets without the dense (F, N) matrix (JAX :255;
        reference LGBM_DatasetCreateFromCSR): the mappers from the sampled
        rows' entries (an absent entry an implicit zero), the non-zero
        entries binned, the bundle matrix built from them
        (``apply_bundles_csr``) under the layout the sampled non-zero
        pattern gives (or the reference's; identity bundles where none
        forms, and then the matrix is the plain ``binned``)."""
        from .bundle import BundleLayout, apply_bundles_csr, find_bundles

        config = config or Config()
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int32)
        values = np.asarray(values, np.float64)
        rows = np.repeat(np.arange(num_data), np.diff(indptr))
        if reference is not None:
            mappers = reference.bin_mappers
            feature_names = feature_names or reference.feature_names
        else:
            samp = _sample_rows(num_data, config)
            in_sample = np.zeros(num_data, bool)
            in_sample[samp] = True
            sel = in_sample[rows]
            f_sel, v_sel = indices[sel], values[sel]
            order = np.argsort(f_sel, kind="stable")
            v_sorted = v_sel[order]
            starts = np.searchsorted(f_sel[order],
                                     np.arange(num_features + 1))
            mappers = _find_mappers(
                [v_sorted[starts[j]:starts[j + 1]]
                 for j in range(num_features)], len(samp), num_data, config,
                categorical_features)
        ds = cls(None, mappers,
                 _metadata(num_data, label, weight, init_score, group),
                 feature_names, max_bin=config.max_bin, num_data=num_data)
        # the non-zero entries binned a feature at a time (one stable sort
        # of the entries, not F passes)
        bin_values = np.zeros(len(values), np.int32)
        order_all = np.argsort(indices, kind="stable")
        starts_all = np.searchsorted(indices[order_all],
                                     np.arange(num_features + 1))
        for j in range(num_features):
            seg = order_all[starts_all[j]:starts_all[j + 1]]
            if len(seg):
                bin_values[seg] = mappers[j].value_to_bin(values[seg])
        if reference is not None:
            layout = (reference.bundle_layout
                      or BundleLayout.identity(ds.num_bins))
        else:
            layout = None
            if config.enable_bundle:
                # conflict masks from the sampled non-zero pattern
                sample_cnt = min(num_data, 32768)
                rng = np.random.RandomState(config.data_random_seed + 1)
                samp2 = (rng.choice(num_data, size=sample_cnt,
                                    replace=False)
                         if sample_cnt < num_data else np.arange(num_data))
                pos = np.full(num_data, -1, np.int64)
                pos[samp2] = np.arange(len(samp2))
                masks = np.zeros((num_features, len(samp2)), bool)
                r_pos = pos[rows]
                hit = (r_pos >= 0) & (bin_values != ds.zero_bins[indices])
                masks[indices[hit], r_pos[hit]] = True
                layout = find_bundles(masks, ds.num_bins,
                                      config.max_conflict_rate)
            layout = layout or BundleLayout.identity(ds.num_bins)
        built = apply_bundles_csr(indptr, indices, bin_values, num_data,
                                  ds.zero_bins, layout)
        if not layout.is_bundled.any():
            # identity bundles: bundle bins are the original bins, so this
            # is the plain matrix (no decode on the trainer's path)
            ds.binned = built
        else:
            ds.bundle_layout, ds.bundled = layout, built
        log_info(f"Constructed sparse binned dataset: {num_data} rows, "
                 f"{num_features} features -> {layout.num_bundles} bundle "
                 f"columns ({len(values)} non-zeros)")
        return ds

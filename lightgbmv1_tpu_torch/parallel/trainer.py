"""Tree-learner construction: the serial learner over its grower, and the
data, voting and feature learners over a ``torch.distributed`` group.

Port of lightgbmv1_tpu/parallel/trainer.py ``resolve_deep_dtype`` (:269),
``select_bin_layout`` (:286) and ``build_trainer`` (:334; the serial
growers :542-560, :628-636, :733-743; the parallel branches :757-1430):
resolve the histogram
method and the two precisions, and pick the grower as the JAX package
does — ``tree_growth=levelwise`` the level-wise grower over
``hist_frontier``; ``leafwise`` the wave grower over ``hist_wave``, with
the ``deep`` precision on the sustained rounds of a big wave, unless the
auto wave size is 1 (``num_leaves <= 7``); that case and every other
``tree_growth`` (``leafwise_masked``: rows masked, not partitioned) the
sequential grower over ``hist_one_leaf``.  An explicit
``leafwise_wave_size >= 1`` keeps ``leafwise`` on the wave grower.

``hist_method=fused`` is the fused dispatch of the JAX ``build_trainer``
(:591-646): the wave rounds run ``ops/wave_fused.make_fused_round`` (K2
on the card, K3 for the valid sets), the root pass the base method
``pallas`` (K1).  With ``wave_loop_rounds > 1`` (JAX :647-722) they run
as segments of the persistent loop ``make_fused_wave_loop`` (K6), where
its plan (``plan_wave_loop``) is eligible.  Where the JAX package logs an
ineligible configuration and falls back to the staged path or to the
single round, the port raises ``NotImplementedError`` with the JAX
reason: nothing silently trains something else.

4-bit packed bins (``bin_layout=packed4``, which ``auto`` picks where
every feature fits 16 bins on the kernel's method, so at ``max_bin <=
15`` on the card) train through the kernels' packed legs on every grower;
``build_trainer(packed=True)`` hands them the real feature count.

``hist_dtype_deep=int8sr`` (JAX :440-480, :1408) quantizes the wave
grower's sustained and 16-slot ramp buckets (``hist_wave_quant``, the
fused round's and the loop's ``quant_key`` / ``quant_buckets``); the
other rounds, and the sequential and level-wise growers, train at
``hist_dtype`` (int8sr sets the deep precision to it), and ``gpu_use_dp``
turns the mode off with the JAX package's warning.

Monotone constraints resolve their mode as the JAX package does (JAX
:535-561, with its warnings): ``advanced`` runs as ``intermediate``;
``intermediate`` takes the wave grower at any leaf count (``num_leaves
<= 7`` too, at a wave of 1) and, on the level-wise grower, falls back to
``basic``.  These decide the trees, so they are reproduced, not refused.

``hist_dtype=int8`` and ``hist_dtype_deep=int8`` (round to nearest under
one scale a row tile) run the kernels' int8 legs on every grower; the
deep rounds of ``hist_dtype=int8`` are int8 too (``resolve_deep_dtype``),
``gpu_use_dp`` maps ``hist_dtype=int8`` to f32 in the config (JAX
config.py:945), and the persistent loop keeps the JAX planner's refusals
(a deep-precision drop, int8sr buckets beside an int8 base).

Sampling (bagging, ``feature_fraction``, ``feature_fraction_bynode``) is
the boosting loop's and the growers' (models/gbdt.py, models/grower.py,
models/grower_wave.py); the trainer hands the growers
``feature_fraction_bynode``.

The histogram method (``resolve_hist_method``, JAX :353-393):
``default_hist_method``'s static pick (K1 on the card, the one-hot
product for int16 bins, the scatter oracle on the CPU), or under
``hist_method=bench`` (and ``auto`` on the card past 256 byte-bin
features) the fastest candidate timed on the training bins;
``force_col_wise`` / ``force_row_wise`` map to scatter / onehot in the
config and join an explicit bench's candidates.  EFB (``bundle``, JAX
:481-500): the histograms run over the bundle columns at
``bundle_num_bins`` bins (K1 at its 256-bin rung on the card), every
grower expands them to the original features before the split scan
(``io/bundle.expand_bundle_hist``; a quantized round's histograms
dequantized first, JAX :928-930) and decodes each decision from the
bundle columns (the growers' partitions, K3's bundle leg for the valid
sets); the fused family refuses EFB with the JAX reason.  int16 bins train on
every grower (the one-hot product, the split-scan kernel's wide leg and
K3's 16-bit leg); extra_trees reaches the growers' scans through
``params`` and each scan's uids.

Constraints and penalties (JAX :174-268, :516-585): interaction
constraints (``parse_interaction_constraints``, a (G, F) group matrix)
mask every grower's nodes; CEGB (``cegb_penalty_split``, ``_coupled``,
``_lazy``; ``_cegb_coupled`` / ``_cegb_lazy`` check their sizes, a wrong
one fatal) sends leaf-wise growth to the sequential grower, as the JAX
package does (its penalties depend on the features earlier splits of the
tree used), and the lazy penalty to its masked variant; the level-wise
grower drops the lazy penalty with the JAX warning.  Forced splits
(``parse_forced_splits``, the JSON of ``forcedsplits_filename`` in BFS
order) run on the sequential grower (leaf-wise) and the level-wise one;
intermediate monotone constraints fall back to basic there with the JAX
warning.  Categorical features ride the meta
(``meta.is_categorical``): every staged grower splits them.

The parallel learners (JAX :757-1430): the JAX package runs each grower
inside ``shard_map`` over a device mesh; here each rank of the group
(``cluster.make_mesh``: every rank, ``num_shards`` 0 or the world size)
runs the same grower with the learner's histogram callables,
``split_fn`` and ``sums_fn`` (``_learner_hooks``), whose collectives
(``parallel/collectives.Group``) reduce and elect across the ranks:

* ``data``: each rank's rows (``models/gbdt.RowShard``, the JAX cut of
  ceil(N / D) rows a rank); K1's histograms reduced a round, under
  ``data_parallel_collective=reduce_scatter`` (JAX :1021-1118) each rank
  keeping its F/D columns (the feature axis padded to a multiple of D; a
  zeros-elsewhere full-width array, so the pool, the subtraction and the
  scan keep their shapes), its scan masked to them and the winner elected
  across the ranks (``sync_best_split``: the packed SplitInfo
  all-gathered, the lowest feature in the ``tie_tol`` band, JAX :151);
  under ``allreduce`` (JAX :1123-1145) the whole sum on every rank and the
  scan replicated.  The root sums are all-reduced (JAX :1126).
* ``voting`` (JAX :770-990): each rank's rows, its own histograms and
  pool; a child's scan takes each rank's local top-k features by
  ``per_feature_best_gain``, all-reduces the votes, elects the top 2k
  (ties to the lower feature, a stable sort where JAX has ``lax.top_k``)
  and reduces only their histograms (reduce-scatter over the padded 2k,
  then the election; or all-reduce).
* ``feature`` (JAX :1205-1430): every rank every row; K1 on its
  contiguous slice of ceil(F / D) features (a view of the (F, N) bins),
  placed in a zeros-elsewhere array over the padded features (``pad_meta``,
  JAX :1209-1230), its scan masked to the slice and elected across the
  ranks; each rank routes its rows with the winning feature, which it
  holds.

Every rank makes the same decisions from the same reduced values, so each
issues the same collectives in the same order and writes the same model.
The sequential grower of a row-sharded learner takes the masked passes
(a partition would pick the smaller child by the rank's own rows).
Where the JAX package warns and trains something else the port raises
with its reason (``parallel_refusal``): ``hist_method=fused`` with data /
voting (JAX :609-611), voting with level-wise growth (:760-762), forced
splits with voting / feature (:765-767) and with data under
``reduce_scatter`` (:995-1004), lazy CEGB costs (:194-215), and
``hist_method=bench`` across processes (:366-370).  The quantized legs
(int8 / int8sr histograms) and the two-level mesh are ROADMAP queue 1
item 14.2b (``config.PARALLEL_LEGS``), as is the fused round per
feature slice.

What the JAX package routes elsewhere raises here, with its reason:
``hist_method=fused`` on the sequential or level-wise grower (CEGB and
forced splits included) and with categorical features, the persistent
loop under monotone constraints (JAX :669-672), interaction constraints
(:662-665) or per-node feature sampling (JAX grower_wave.py:881-884
keeps the loop off there).
"""

from __future__ import annotations

import json
import re
from typing import Callable

import numpy as np
import torch

from ..config import PARALLEL_LEGS, Config, not_ported
from ..models import grower_wave
from ..models.grower import make_leafwise_grower, make_levelwise_grower
from ..models.grower_wave import (auto_wave_size, make_wave_grower,
                                  quant_buckets_for, slot_buckets_for)
from ..obs.metrics import comm_table_per_round, publish_comm_metrics
from ..ops.histogram import (benchmark_hist_methods, default_hist_method,
                             hist_frontier, hist_one_leaf, hist_wave,
                             hist_wave_quant, root_sums)
from ..ops.split import (FeatureMeta, SplitParams, SplitResult,
                         bitset_words, find_best_split, leaf_gain,
                         per_feature_best_gain, tie_tol, with_tables)
from ..ops.wave_fused import (fused_ineligible_reason, make_fused_round,
                              make_fused_wave_loop)
from ..utils.log import log_fatal, log_info, log_warning
from .cluster import make_mesh
from .collectives import Group

PARALLEL_LEARNERS = ("data", "voting", "feature")
# the learners whose ranks hold row shards (feature: every rank all rows)
ROW_SHARDED = ("data", "voting")


def parse_interaction_constraints(spec, num_features: int):
    """``'[0,1,2],[2,3]'`` -> the (G, F) bool group matrix, or None when
    unset (JAX :174; reference config.h:517)."""
    if not spec:
        return None
    groups = []
    for m in re.findall(r"\[([\d,\s]*)\]", str(spec)):
        idx = [int(x) for x in m.replace(",", " ").split()]
        row = np.zeros(num_features, bool)
        row[[i for i in idx if i < num_features]] = True
        groups.append(row)
    if not groups:
        return None
    return np.stack(groups)


def _cegb_lazy(config: Config, num_features: int, levelwise: bool):
    """``cegb_penalty_feature_lazy`` checked -> (F,) or None (JAX :194):
    a wrong size is fatal; the level-wise grower drops it with the JAX
    warning (the per-row marks need the sequential grower)."""
    pen = config.cegb_penalty_feature_lazy
    if not pen:
        return None
    if len(pen) != num_features:
        log_fatal("cegb_penalty_feature_lazy should be the same size as "
                  f"feature number ({len(pen)} vs {num_features})")
    if levelwise:
        log_warning("cegb_penalty_feature_lazy requires the serial "
                    "leaf-wise learner; lazy feature costs are ignored for "
                    "tree_learner=serial, tree_growth=levelwise")
        return None
    return np.asarray(pen, np.float64)


def _cegb_coupled(config: Config, num_features: int):
    """``cegb_penalty_feature_coupled`` checked -> (F,) or None (JAX
    :217); a wrong size is fatal."""
    pen = config.cegb_penalty_feature_coupled
    if not pen:
        return None
    if len(pen) != num_features:
        log_fatal("cegb_penalty_feature_coupled should be the same size as "
                  f"feature number ({len(pen)} vs {num_features})")
    return np.asarray(pen, np.float64)


def parse_forced_splits(filename: str, bin_mappers, num_leaves: int):
    """``forcedsplits_filename``'s JSON (``{"feature": f, "threshold": t,
    "default_left": ..., "left": {...}, "right": {...}}``) -> the (S, 6)
    int steps [parent step, side, feature, bin, default_left, depth] in
    BFS order, or None (JAX :228; reference
    SerialTreeLearner::ForceSplits, serial_tree_learner.cpp:427-539).  A
    step names its parent step (-1: the root) and the side it splits, so
    the grower resolves the leaf a skipped step leaves unmade."""
    if not filename:
        return None
    from ..utils.fileio import open_file

    with open_file(filename) as fh:
        spec = json.load(fh)
    if not spec:
        return None
    out = []
    queue = [(spec, -1, 0)]
    while queue and len(out) < num_leaves - 1:
        node, pstep, side = queue.pop(0)
        f = int(node["feature"])
        b = int(bin_mappers[f].value_to_bin(
            np.asarray([float(node["threshold"])]))[0])
        depth = 0 if pstep < 0 else int(out[pstep][5]) + 1
        out.append([pstep, side, f, b,
                    int(bool(node.get("default_left", False))), depth])
        step = len(out) - 1
        if node.get("left"):
            queue.append((node["left"], step, 0))
        if node.get("right"):
            queue.append((node["right"], step, 1))
    return np.asarray(out, np.int64) if out else None


def pack_split(res: SplitResult, W: int) -> torch.Tensor:
    """The (C, 11 + W) f32 SplitInfo rows of the cross-rank election (JAX
    ``_pack_split`` :124; reference SplitInfo::CopyTo): [gain, feature,
    threshold, default_left, is_cat], the left and right sums, and the
    categorical bitset's W words bit for bit (an int32 -> f32 view; zeros
    without categorical features)."""
    C = res.gain.shape[0]
    f32 = torch.float32
    bits = (res.cat_bitset if res.cat_bitset is not None
            else torch.zeros((C, W), dtype=torch.int32,
                             device=res.gain.device))
    is_cat = (res.is_cat if res.is_cat is not None
              else torch.zeros(C, dtype=torch.bool, device=res.gain.device))
    return torch.cat([
        torch.stack([res.gain.to(f32), res.feature.to(f32),
                     res.threshold_bin.to(f32), res.default_left.to(f32),
                     is_cat.to(f32)], dim=1),
        res.left_sum.to(f32), res.right_sum.to(f32),
        bits.to(torch.int32).contiguous().view(f32)], dim=1)


def unpack_split(v: torch.Tensor, has_cat: bool) -> SplitResult:
    """``pack_split``'s rows back to a ``SplitResult`` (JAX :137);
    ``has_cat``: the meta has categorical features (else ``is_cat`` and
    ``cat_bitset`` stay None, as the serial scan leaves them)."""
    return SplitResult(
        gain=v[:, 0].contiguous(), feature=v[:, 1].long(),
        threshold_bin=v[:, 2].long(), default_left=v[:, 3] > 0.5,
        left_sum=v[:, 5:8].contiguous(), right_sum=v[:, 8:11].contiguous(),
        is_cat=(v[:, 4] > 0.5) if has_cat else None,
        cat_bitset=(v[:, 11:].contiguous().view(torch.int32) if has_cat
                    else None))


def sync_best_split(local: SplitResult, parent_sum: torch.Tensor,
                    params: SplitParams, group: Group, num_bins: int,
                    has_cat: bool) -> SplitResult:
    """The global best split of each of C children from the ranks' local
    bests (JAX ``_sync_best_split`` :151; reference
    SyncUpGlobalBestSplit, parallel_tree_learner.h:190-213): the packed
    rows all-gathered, and per child the candidates within ``tie_tol`` of
    the best gain (the band the serial scan ties in) resolved to the
    lowest feature id, the rank order breaking what is left, so the
    winner does not depend on how the ranks split the sums.  Every rank
    elects from the same gathered rows."""
    packed = pack_split(local, bitset_words(num_bins))
    allp = group.all_gather(packed, part="split_sync")    # (D, C, 11 + W)
    g = allp[:, :, 0]
    m = g.max(dim=0).values
    scale = leaf_gain(parent_sum[:, 0], parent_sum[:, 1], params)
    in_band = g >= m - tie_tol(m, scale)
    feat = torch.where(in_band, allp[:, :, 1],
                       torch.full_like(g, float("inf")))
    win = torch.argmin(feat, dim=0)                      # first on ties
    rows = allp[win, torch.arange(allp.shape[1], device=allp.device)]
    return unpack_split(rows, has_cat)


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of each row's ``k`` largest values, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` orders no ties): a
    stable sort of ``-x``."""
    return torch.sort(-x, dim=1, stable=True).indices[:, :k]


def pad_meta(meta: FeatureMeta, F_pad: int) -> FeatureMeta:
    """``meta`` over ``F_pad`` features, the padding ones unusable (one
    bin, no missing value: JAX :1209-1230), with its tables."""
    pad = F_pad - meta.num_bins.shape[0]

    def p(t, value):
        if t is None:
            return None
        return torch.cat([t, torch.full((pad,), value, dtype=t.dtype,
                                        device=t.device)])

    return with_tables(meta._replace(
        num_bins=p(meta.num_bins, 1), missing_type=p(meta.missing_type, 0),
        nan_bin=p(meta.nan_bin, -1), zero_bin=p(meta.zero_bin, 0),
        usable=p(meta.usable, False),
        monotone_type=p(meta.monotone_type, 0), contri=p(meta.contri, 1.0),
        is_categorical=p(meta.is_categorical, False)))


def parallel_refusal(config: Config, learner: str, *, levelwise: bool,
                     forced, world: int) -> None:
    """Raise where the JAX ``build_trainer`` warns about a parallel
    configuration and trains another one (JAX :609-611, :760-767,
    :995-1004, trainer.py :194-215), with its reason; and the
    configurations ROADMAP item 14.2b will port."""
    if config.hist_method == "fused":
        if learner in ROW_SHARDED:
            raise NotImplementedError(
                f"hist_method=fused: tree_learner={learner} reduces "
                "histograms across row shards (the collective needs the "
                "explicit histogram)")
        raise not_ported("hist_method=fused with tree_learner=feature "
                         "(the fused round per feature slice)",
                         PARALLEL_LEGS)
    if learner == "voting" and levelwise:
        raise NotImplementedError(
            "tree_learner=voting requires the leaf-wise grower "
            "(tree_growth=levelwise); the JAX package trains "
            "tree_learner=data instead")
    if forced is not None and learner in ("voting", "feature"):
        raise NotImplementedError(
            f"forcedsplits_filename is not supported with "
            f"tree_learner={learner}")
    if forced is not None and learner == "data" \
            and config.data_parallel_collective == "reduce_scatter":
        raise NotImplementedError(
            "forcedsplits_filename requires full histograms on every "
            "shard; set data_parallel_collective=allreduce (the JAX "
            "package falls back to it)")
    if config.cegb_penalty_feature_lazy:
        raise NotImplementedError(
            "cegb_penalty_feature_lazy requires the serial leaf-wise "
            f"learner; lazy feature costs are ignored for "
            f"tree_learner={learner}")
    if config.hist_method == "bench" and world > 1:
        raise NotImplementedError(
            "hist_method=bench: multi-process run takes the static method "
            "pick (a per-host timed choice could diverge across ranks)")


def resolve_deep_dtype(requested: str, precision: str, backend: str) -> str:
    """``hist_dtype_deep``: ``"auto"`` is int8sr on a TPU and bf16x2
    elsewhere (so bf16x2 on the card); ``""`` drops bf16x2 to single-pass
    bf16 on sustained rounds and keeps any other ``hist_dtype``."""
    if requested == "auto":
        requested = "int8sr" if backend == "tpu" else "bf16x2"
    return requested or ("bf16" if precision == "bf16x2" else precision)


def select_bin_layout(config: Config, *, num_total_bin: int,
                      device: torch.device, bin_dtype=torch.uint8,
                      bundled: bool = False) -> str:
    """``bin_layout`` resolved to the layout the trainer stores (``"u8"``
    or ``"packed4"``), with the JAX package's eligibility checks in its
    order and its log lines: every feature in 4 bits (``num_total_bin <=
    16``) of uint8 bins, no EFB bundle, the kernel's method (``pallas``,
    from ``default_hist_method``: so ``auto`` packs on the card and not on
    the CPU, as the JAX package packs on a TPU), not ``tree_learner=
    feature`` and not ``gpu_use_dp``.  ``auto`` packs exactly when
    eligible and is silent otherwise; an explicit ``packed4`` that is
    refused warns and stores u8."""
    if config.bin_layout == "u8":
        return "u8"
    method = default_hist_method(config.hist_method, device, bin_dtype)
    reason = ""
    if torch.iinfo(bin_dtype).bits > 8:
        reason = "int16-binned data exceeds the 4-bit nibble"
    elif num_total_bin > 16:
        reason = (f"num_total_bin={num_total_bin} needs more than 4 bits "
                  "per bin")
    elif bundled:
        reason = "EFB bundle offsets address unpacked byte bins"
    elif method != "pallas":
        reason = (f"hist method {method!r} gathers unpacked bins "
                  "(pallas-family kernels unpack nibbles at the load)")
    elif config.tree_learner == "feature":
        reason = "tree_learner=feature shards features, not byte pairs"
    elif config.gpu_use_dp:
        reason = ("gpu_use_dp requests the widest histogram datapath; "
                  "packed bins narrow the read stream")
    if reason:
        if config.bin_layout == "packed4":
            log_warning(f"bin_layout=packed4: {reason}; storing u8 bins")
        return "u8"
    log_info("bin_layout=packed4: 4-bit packed bins engaged — two bins "
             "per byte, the (F, N) binned read halves "
             "(ops/hist_cuda.pack4bit)")
    return "packed4"


def resolve_hist_method(config: Config, device: torch.device,
                        bin_dtype=torch.uint8, binned=None,
                        num_bins: int = 0, packed: bool = False,
                        num_features: int = 0, times_out=None) -> str:
    """The histogram method the passes run (JAX :353-393): the static
    pick (``default_hist_method``), or the fastest of the candidates
    timed on ``binned`` (``benchmark_hist_methods``) under
    ``hist_method=bench`` and under ``auto`` on the card with byte bins
    and more than 256 features, where the static choice is ambiguous.  A
    forced strategy (``force_col_wise`` scatter, ``force_row_wise``
    onehot) joins an explicit bench's candidates."""
    method = default_hist_method(config.hist_method, device, bin_dtype)
    wants_bench = config.hist_method == "bench" or (
        config.hist_method == "auto"
        and torch.device(device).type == "cuda"
        and torch.iinfo(bin_dtype).bits == 8 and num_features > 256)
    if not wants_bench:
        return method
    if binned is None:
        raise ValueError("hist_method=bench times the methods on the "
                         "training bins: build_trainer needs them")
    forced = ("scatter" if config.force_col_wise
              else "onehot" if config.force_row_wise else None)
    return benchmark_hist_methods(
        binned, num_bins, config.hist_dtype, packed, num_features,
        must_include=forced if config.hist_method == "bench" else None,
        times_out=times_out)


def build_trainer(config: Config, meta: FeatureMeta, params: SplitParams,
                  num_bins: int, device: torch.device,
                  bin_dtype: torch.dtype = torch.uint8,
                  num_data: int = 0, packed: bool = False,
                  binned=None, bundle=None,
                  bundle_num_bins=None, bin_mappers=None,
                  group: Group = None, bucket_rows: int = None) -> Callable:
    """The serial learner's ``grow(binned, g3, base_mask, ...)`` for the
    configured growth over ``num_data`` rows of ``bin_dtype`` bins: the
    wave grower's ``grow(..., valids)`` routes the valid sets too
    (``grow.routes_valids``), the others' return no valid leaf ids.
    ``packed``: the bins are the 4-bit packed bytes of the F =
    ``meta.num_bins.shape[0]`` features (JAX :497-507).  ``binned``: the
    training bins on ``device``, which ``hist_method=bench`` times the
    methods on (``resolve_hist_method``; the pick and the candidates'
    times are ``grow.hist_method`` and ``grow.bench_times``).
    ``bundle`` (``io.bundle.BundleArrays``): ``binned`` holds the EFB
    bundle columns, whose histograms have ``bundle_num_bins`` bins.
    ``bin_mappers``: the training set's, which bin the forced splits'
    thresholds (``parse_forced_splits``).  ``group``: the ranks of a
    parallel learner (``tree_learner`` data / voting / feature; None:
    ``cluster.make_mesh``'s), ``bucket_rows`` the slot-bucket ladder's
    rows (a row shard's, equal on every rank)."""
    F = meta.num_bins.shape[0]
    # the histograms' bin axis and columns (the bundles' under EFB)
    Bh = bundle_num_bins if bundle is not None else num_bins
    FH = bundle.num_bundles if bundle is not None else F
    learner = config.tree_learner or "serial"
    if learner not in ("serial",) + PARALLEL_LEARNERS:
        log_fatal(f"Unknown tree_learner: {learner}")
    par = learner in PARALLEL_LEARNERS
    if par:
        group = make_mesh(config.num_shards, group)
    bench_times: dict = {}
    if par and group.world > 1 and config.hist_method == "auto":
        # one static pick for every rank (JAX :366-370)
        method = default_hist_method(config.hist_method, device, bin_dtype)
    else:
        method = resolve_hist_method(config, device, bin_dtype, binned,
                                     Bh, packed, FH, bench_times)
    bins = dict(packed=packed, num_features=F)
    precision = config.hist_dtype
    deep_precision = resolve_deep_dtype(config.hist_dtype_deep, precision,
                                        torch.device(device).type)
    # int8sr: the quantized buckets run hist_wave_quant; every other
    # round, and the other growers, keep full precision (JAX :455-463)
    use_int8sr = deep_precision == "int8sr"
    if use_int8sr and config.gpu_use_dp:
        log_warning("hist_dtype_deep=int8sr conflicts with gpu_use_dp "
                    "(double-precision histograms requested); int8sr "
                    "disabled, deep rounds run f32")
        use_int8sr = False
        deep_precision = "f32"
    elif use_int8sr:
        deep_precision = precision

    levelwise = config.tree_growth == "levelwise"
    bynode = config.feature_fraction_bynode
    groups = parse_interaction_constraints(config.interaction_constraints, F)
    coupled = _cegb_coupled(config, F)
    lazy = _cegb_lazy(config, F, levelwise)
    # CEGB needs the sequential grower's exact split order (its penalties
    # depend on the features earlier splits of the tree used; JAX :516)
    use_cegb = (config.cegb_tradeoff * config.cegb_penalty_split > 0
                or coupled is not None or lazy is not None)
    forced = None
    if config.forcedsplits_filename:
        if bin_mappers is None:
            log_warning("forcedsplits_filename requires bin mappers; "
                        "ignored")
        else:
            forced = parse_forced_splits(config.forcedsplits_filename,
                                         bin_mappers, config.num_leaves)
    wave_size = config.leafwise_wave_size
    if wave_size == 0:
        # auto: num_leaves // 4; K = 1 (num_leaves <= 7) is the sequential
        # grower's exact best-first order
        wave_size = auto_wave_size(config.num_leaves)
    if wave_size > 128:
        log_warning(f"leafwise_wave_size={wave_size} capped to 128")
        wave_size = 128
    mono_mode = config.monotone_constraints_method or "basic"
    has_mono = any(config.monotone_constraints)
    if has_mono and mono_mode == "advanced":
        log_warning("monotone_constraints_method=advanced (slow constraint "
                    "recomputation) is approximated by 'intermediate'")
        mono_mode = "intermediate"
    # intermediate-mode monotonicity runs on the wave grower, so it takes
    # it at any wave size (JAX :548-551)
    wants_inter = has_mono and mono_mode == "intermediate"
    use_wave = config.tree_growth == "leafwise" and not use_cegb and (
        config.leafwise_wave_size >= 1 or wave_size > 1 or wants_inter)
    if wants_inter and (not use_wave or forced is not None):
        # forced splits route leaf-wise growth to the sequential grower
        log_warning("monotone_constraints_method=intermediate is "
                    "implemented by the wave-batched leaf-wise grower; "
                    "falling back to 'basic' for this configuration "
                    f"(tree_growth={config.tree_growth}"
                    + (", forced splits" if forced is not None else "")
                    + ")")
        mono_mode = "basic"
    if forced is not None:
        use_wave = False
    if par:
        parallel_refusal(config, learner, levelwise=levelwise,
                         forced=forced, world=group.world)

    def local_wave(binned, g3, label, nslots, deep=False, rows8=None):
        return hist_wave(binned, g3, label, nslots, Bh, method=method,
                         precision=deep_precision if deep else precision,
                         rows8=rows8, **bins)

    def local_wave_quant(binned, zq, label, nslots, key):
        return hist_wave_quant(binned, zq, label, nslots, Bh, key,
                               method=method, **bins)

    # ---- hist_method=fused: the routed fused round (K2, K3) -------------
    fused_fn = fused_loop = None
    if config.hist_method == "fused":
        reason = fused_ineligible_reason(bin_dtype=bin_dtype,
                                         num_bins=num_bins, params=params,
                                         bundled=bundle is not None,
                                         meta=meta)
        if not reason and not use_wave:
            reason = ("the fused kernel is a wave-round kernel; this config "
                      "routes to the " + ("level-wise" if levelwise
                                          else "sequential") + " grower")
        if reason:
            raise NotImplementedError(f"hist_method=fused: {reason}")
        fused_fn = make_fused_round(meta=meta, params=params,
                                    num_bins=num_bins, precision=precision,
                                    deep_precision=deep_precision,
                                    packed=packed)
        if config.wave_loop_rounds > 1 and groups is not None:
            raise NotImplementedError(
                f"wave_loop_rounds={config.wave_loop_rounds}: interaction "
                "constraints re-mask features per split; the loop kernel "
                "freezes the round-0 mask")
        if config.wave_loop_rounds > 1 and has_mono:
            raise NotImplementedError(
                f"wave_loop_rounds={config.wave_loop_rounds}: monotone "
                "constraints propagate child bounds between rounds outside "
                "the kernel")
        if config.wave_loop_rounds > 1 and bynode < 1.0:
            raise NotImplementedError(
                f"wave_loop_rounds={config.wave_loop_rounds}: "
                f"feature_fraction_bynode={bynode} draws each child's "
                "feature mask between rounds, outside the kernel")
        if config.wave_loop_rounds > 1:
            # ---- the persistent wave loop (K6), planned at this shape ---
            fused_loop = make_fused_wave_loop(
                meta=meta, params=params, num_bins=num_bins,
                precision=precision, deep_precision=deep_precision,
                rounds=config.wave_loop_rounds, packed=packed)
            L = config.num_leaves
            K = max(1, min(wave_size, max(L - 1, 1)))
            ladder = slot_buckets_for(K, num_data)
            plan = fused_loop.plan(
                N=num_data, F=F, K=K, L=L,
                use_sub=(L * F * num_bins * 3 * 4
                         <= grower_wave._SUB_STATE_CAP_BYTES),
                slot_buckets=ladder, device=device,
                quant_buckets=(quant_buckets_for(ladder, K) if use_int8sr
                               else ()))
            if not plan["eligible"]:
                raise NotImplementedError(
                    f"wave_loop_rounds={config.wave_loop_rounds}: "
                    f"{plan['reason']}")

    def local_frontier(binned, g3, label, L, live_slots=None, rows8=None):
        return hist_frontier(binned, g3, label, L, Bh, method=method,
                             precision=precision, live_slots=live_slots,
                             rows8=rows8, **bins)

    def local_hist(binned, g3, leaf_id, target):
        return hist_one_leaf(binned, g3, leaf_id, target, Bh,
                             method=method, precision=precision, **bins)

    common = dict(num_leaves=config.num_leaves, num_bins=num_bins, meta=meta,
                  params=params, max_depth=config.max_depth,
                  feature_fraction_bynode=bynode, bundle=bundle,
                  interaction_groups=groups)
    hooks = dict(wave=local_wave, frontier=local_frontier, one=local_hist,
                 split_fn=None, sums_fn=None)
    pad_mask = None
    if par:
        hooks, pad_mask, coupled = _learner_hooks(
            config, learner, group, hooks, common, meta=meta, F=F, FH=FH,
            Bh=Bh, num_bins=num_bins, bundle=bundle, wave_size=wave_size,
            method=method, precision=precision,
            deep_precision=deep_precision, coupled=coupled)
    hook_kw = dict(split_fn=hooks["split_fn"], sums_fn=hooks["sums_fn"])
    if levelwise:
        grow = make_levelwise_grower(hist_frontier_fn=hooks["frontier"],
                                     packed=packed, forced_splits=forced,
                                     cegb_coupled=coupled, **hook_kw,
                                     **common)
    elif not use_wave:
        # per-row lazy costs need the masked variant's leaf ids; a row
        # shard's partition decides its smaller child by its own rows, so
        # the row-sharded learners take the masked passes too
        grow = make_leafwise_grower(
            hist_fn=hooks["one"],
            partition=(config.tree_growth != "leafwise_masked"
                       and lazy is None and learner not in ROW_SHARDED),
            hist_pool_mb=config.histogram_pool_size, packed=packed,
            forced_splits=forced, cegb_coupled=coupled, cegb_lazy=lazy,
            **hook_kw, **common)
    else:
        grow = make_wave_grower(
            wave_size=wave_size, hist_wave_fn=hooks["wave"],
            fused_round_fn=fused_fn, fused_loop_fn=fused_loop,
            hist_wave_quant_fn=local_wave_quant if use_int8sr else None,
            packed=packed, monotone_mode=mono_mode,
            bucket_rows=bucket_rows, **hook_kw, **common)
    if pad_mask is not None:
        grow = pad_mask(grow)
    grow.hist_method = method
    grow.bench_times = bench_times
    grow.learner = learner
    return grow


def _learner_hooks(config: Config, learner: str, group: Group, local: dict,
                   common: dict, *, meta: FeatureMeta, F: int, FH: int,
                   Bh: int, num_bins: int, bundle, wave_size: int,
                   method: str, precision: str, deep_precision: str,
                   coupled):
    """``(hooks, pad_mask, coupled)``: the growers' histogram callables,
    ``split_fn`` and ``sums_fn`` of a parallel learner over ``group``'s D
    ranks (JAX :770-1430), from the serial learner's ``local`` ones; for
    the feature learner a wrapper padding the tree's (F,) masks to its
    padded width (else None) and its padded coupled costs.  ``common``
    (the growers' keyword arguments) takes the feature learner's padded
    meta and interaction groups."""
    D, rank = group.world, group.rank
    collective = config.data_parallel_collective
    has_cat = meta.is_categorical is not None

    def sums_fn(g3):
        # the root's [g, h, c] totals (JAX :1126, psum of g3.sum(axis=0))
        return group.all_reduce(root_sums(g3), part="g3")

    def sync(local_res, parent_sum, params_):
        return sync_best_split(local_res, parent_sum, params_, group,
                               num_bins, has_cat)

    if learner == "data":
        use_rs = collective == "reduce_scatter" and D > 1
        FH_pad = -(-FH // D) * D
        FH_loc = FH_pad // D
        lo = rank * FH_loc
        log_info(f"Data-parallel training over {D} ranks ({collective} "
                 "collective)")
        table = comm_table_per_round("data", collective, k=wave_size,
                                     F=FH, B=Bh, ndev=D)
        log_info(f"comm/round (analytic, K={wave_size} wave): {table}")
        publish_comm_metrics("data", table)

        def reduce_hist(h):
            """The reference's ReduceScatter of histogram blocks (JAX
            ``_scatter_keep`` :1021-1076): the rank keeps its FH_loc
            columns, placed in a zeros-elsewhere full-width array; or,
            under allreduce, the whole sum (JAX :1123-1145)."""
            if not use_rs:
                return group.all_reduce(h, part="hist")
            nb = h.dim() - 3
            hp = torch.nn.functional.pad(h, (0, 0, 0, 0, 0, FH_pad - FH))
            sl = group.reduce_scatter(hp, dim=nb, part="hist")
            full = torch.zeros_like(hp)
            full.narrow(nb, lo, FH_loc).copy_(sl)
            return full.narrow(nb, 0, FH).contiguous() if FH_pad > FH \
                else full

        col = (bundle.bundle_of if bundle is not None
               else torch.arange(F, device=meta.num_bins.device))
        in_shard = ((col >= lo) & (col < lo + FH_loc))[None, :]

        def split_sharded(hist, parent_sum, meta_, mask, params_, **kw):
            """The best split over this rank's columns, then the SplitInfo
            election (JAX ``_split_sharded`` :1090-1118)."""
            res = find_best_split(hist, parent_sum, meta_, mask & in_shard,
                                  params_, **kw)
            return sync(res, parent_sum, params_)

        hooks = dict(
            wave=lambda *a, **k: reduce_hist(local["wave"](*a, **k)),
            frontier=lambda *a, **k: reduce_hist(local["frontier"](*a, **k)),
            one=lambda *a, **k: reduce_hist(local["one"](*a, **k)),
            split_fn=split_sharded if use_rs else None, sums_fn=sums_fn)
        return hooks, None, coupled

    if learner == "voting":
        top_k = max(1, min(config.top_k, F))
        sel_k = min(2 * top_k, F)
        use_rs = collective == "reduce_scatter" and D > 1
        sel_pad = -(-sel_k // D) * D
        sel_loc = sel_pad // D
        lo = rank * sel_loc
        log_info(f"Voting-parallel training over {D} ranks (top_k={top_k}, "
                 f"{sel_k} features reduced per split, {collective} "
                 "selective reduce)")
        table = comm_table_per_round("voting", collective, k=wave_size,
                                     F=F, B=num_bins, ndev=D, sel_k=sel_k)
        log_info(f"comm/round (analytic, K={wave_size} wave): {table}")
        publish_comm_metrics("voting", table)

        def split_vote(hist, parent_sum, meta_, mask, params_,
                       parent_output=None, cegb=None, **kw):
            """PV-Tree's split (JAX :854-919; reference GlobalVoting,
            voting_parallel_tree_learner.cpp:152-180): each rank's top-k
            features by its local gain, the votes summed, the top 2k
            elected (ties to the lower feature), and only their
            histograms reduced before the search."""
            C, Fh, B, _ = hist.shape
            dev = hist.device
            local_parent = hist[:, 0].sum(dim=1)
            gains = per_feature_best_gain(hist, local_parent, meta_, mask,
                                          params_, parent_output)
            if cegb is not None:
                gains = torch.where(torch.isfinite(gains), gains - cegb,
                                    gains)
            local_top = topk_stable(gains, top_k)
            votes = torch.zeros((C, Fh), dtype=torch.float32, device=dev)
            votes.scatter_add_(1, local_top, torch.isfinite(
                gains.gather(1, local_top)).to(torch.float32))
            votes = group.all_reduce(votes, part="vote")
            order = votes * (Fh + 1) - torch.arange(
                Fh, dtype=torch.float32, device=dev)
            selected = topk_stable(order, sel_k)           # (C, sel_k)
            ci = torch.arange(C, device=dev)[:, None]
            wire = hist[ci, selected]                      # (C, sel_k, B, 3)
            full = torch.zeros((C, Fh + 1, B, 3), dtype=torch.float32,
                               device=dev)
            sel_mask = torch.zeros((C, Fh + 1), dtype=torch.bool,
                                   device=dev)
            if use_rs:
                wire = torch.nn.functional.pad(
                    wire, (0, 0, 0, 0, 0, sel_pad - sel_k))
                sl = group.reduce_scatter(wire, dim=1, part="hist")
                sel_p = torch.nn.functional.pad(selected,
                                                (0, sel_pad - sel_k),
                                                value=Fh)  # Fh: drop slot
                mine = sel_p[:, lo:lo + sel_loc]
                full[ci, mine] = sl
                sel_mask[ci, mine] = True
            else:
                full[ci, selected] = group.all_reduce(wire, part="hist")
                sel_mask[ci, selected] = True
            res = find_best_split(full[:, :Fh], parent_sum, meta_,
                                  mask & sel_mask[:, :Fh], params_,
                                  parent_output=parent_output, cegb=cegb,
                                  **kw)
            return sync(res, parent_sum, params_) if use_rs else res

        return dict(local, split_fn=split_vote, sums_fn=sums_fn), None, \
            coupled

    # ---- feature: every rank all rows, K1 on its F/D feature slice -------
    F_pad = -(-F // D) * D
    F_loc = F_pad // D
    lo = rank * F_loc
    hi = min(lo + F_loc, F)
    meta_p = pad_meta(meta, F_pad) if F_pad > F else meta
    common["meta"] = meta_p
    if common["interaction_groups"] is not None:
        common["interaction_groups"] = parse_interaction_constraints(
            config.interaction_constraints, F_pad)
    if coupled is not None:
        coupled = np.pad(coupled, (0, F_pad - F))
    log_info(f"Feature-parallel training over {D} ranks ({F_loc} "
             "features/rank)")
    table = comm_table_per_round("feature", "allreduce", k=wave_size, F=F,
                                 B=num_bins, ndev=D)
    log_info(f"comm/round (analytic, K={wave_size} wave): {table}")
    publish_comm_metrics("feature", table)

    def on_slice(fn, nslot_axis):
        """``fn`` on this rank's features ``binned[lo:hi]`` (a view: the
        rows of a contiguous (F, N) tensor), placed at their offset of a
        zeros-elsewhere (.., F_pad, B, 3) array (JAX :1232-1290)."""
        def run(binned, g3, label, *a, **k):
            h = fn(binned[lo:hi], g3, label, *a, **k) if hi > lo else None
            lead = (a[0],) if nslot_axis else ()
            out = torch.zeros(lead + (F_pad, Bh, 3), dtype=torch.float32,
                              device=g3.device)
            if h is not None:
                out[..., lo:hi, :, :] = h
            return out
        return run

    def slice_wave(binned, g3, label, nslots, deep=False, rows8=None):
        return hist_wave(binned, g3, label, nslots, Bh, method=method,
                         precision=deep_precision if deep else precision,
                         rows8=rows8)

    def slice_frontier(binned, g3, label, L, live_slots=None, rows8=None):
        return hist_frontier(binned, g3, label, L, Bh, method=method,
                             precision=precision, live_slots=live_slots,
                             rows8=rows8)

    def slice_one(binned, g3, leaf_id, target):
        return hist_one_leaf(binned, g3, leaf_id, target, Bh,
                             method=method, precision=precision)

    in_shard = torch.zeros((1, F_pad), dtype=torch.bool,
                           device=meta.num_bins.device)
    in_shard[:, lo:lo + F_loc] = True

    def split_fp(hist, parent_sum, meta_, mask, params_, **kw):
        """This rank's features searched, then the SplitInfo election
        (JAX :1266-1283)."""
        res = find_best_split(hist, parent_sum, meta_, mask & in_shard,
                              params_, **kw)
        return sync(res, parent_sum, params_)

    def pad_mask(grow):
        def grow_fp(binned, g3, base_mask, *a, cegb_used=None, **k):
            z = torch.zeros(F_pad - F, dtype=torch.bool,
                            device=base_mask.device)
            if cegb_used is not None:
                k["cegb_used"] = torch.cat([cegb_used, z])
            return grow(binned, g3, torch.cat([base_mask, z]), *a, **k)
        grow_fp.__dict__.update(grow.__dict__)
        return grow_fp

    hooks = dict(wave=on_slice(slice_wave, True),
                 frontier=on_slice(slice_frontier, True),
                 one=on_slice(slice_one, False),
                 split_fn=split_fp, sums_fn=None)
    return hooks, pad_mask, coupled


"""Tree-learner construction: the serial learner over its grower.

Port of lightgbmv1_tpu/parallel/trainer.py ``resolve_deep_dtype`` (:269),
``select_bin_layout`` (:286) and the serial branch of ``build_trainer``
(:334; the growers :542-560, :628-636, :733-743): resolve the histogram
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
config and join an explicit bench's candidates.  int16 bins train on
every grower (the one-hot product, the split-scan kernel's wide leg and
K3's 16-bit leg); extra_trees reaches the growers' scans through
``params`` and each scan's uids.

What the JAX package routes elsewhere raises here, with its reason:
``hist_method=fused`` on the sequential or level-wise grower, the
persistent loop under monotone constraints (JAX :669-672) or under
per-node feature sampling (JAX grower_wave.py:881-884 keeps the loop off
there).  The loop's other JAX fallback (interaction constraints) is
refused before, by ``config.unported_reason``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import Config
from ..models import grower_wave
from ..models.grower import make_leafwise_grower, make_levelwise_grower
from ..models.grower_wave import (auto_wave_size, make_wave_grower,
                                  quant_buckets_for, slot_buckets_for)
from ..ops.histogram import (benchmark_hist_methods, default_hist_method,
                             hist_frontier, hist_one_leaf, hist_wave,
                             hist_wave_quant)
from ..ops.split import FeatureMeta, SplitParams
from ..ops.wave_fused import (fused_ineligible_reason, make_fused_round,
                              make_fused_wave_loop)
from ..utils.log import log_info, log_warning


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
                  binned=None) -> Callable:
    """The serial learner's ``grow(binned, g3, base_mask, ...)`` for the
    configured growth over ``num_data`` rows of ``bin_dtype`` bins: the
    wave grower's ``grow(..., valids)`` routes the valid sets too
    (``grow.routes_valids``), the others' return no valid leaf ids.
    ``packed``: the bins are the 4-bit packed bytes of the F =
    ``meta.num_bins.shape[0]`` features (JAX :497-507).  ``binned``: the
    training bins on ``device``, which ``hist_method=bench`` times the
    methods on (``resolve_hist_method``; the pick and the candidates'
    times are ``grow.hist_method`` and ``grow.bench_times``)."""
    F = meta.num_bins.shape[0]
    bench_times: dict = {}
    method = resolve_hist_method(config, device, bin_dtype, binned,
                                 num_bins, packed, F, bench_times)
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
    use_wave = config.tree_growth == "leafwise" and (
        config.leafwise_wave_size >= 1 or wave_size > 1 or wants_inter)
    if wants_inter and not use_wave:
        log_warning("monotone_constraints_method=intermediate is "
                    "implemented by the wave-batched leaf-wise grower; "
                    "falling back to 'basic' for this configuration "
                    f"(tree_growth={config.tree_growth})")
        mono_mode = "basic"

    def local_wave(binned, g3, label, nslots, deep=False, rows8=None):
        return hist_wave(binned, g3, label, nslots, num_bins, method=method,
                         precision=deep_precision if deep else precision,
                         rows8=rows8, **bins)

    def local_wave_quant(binned, zq, label, nslots, key):
        return hist_wave_quant(binned, zq, label, nslots, num_bins, key,
                               method=method, **bins)

    # ---- hist_method=fused: the routed fused round (K2, K3) -------------
    fused_fn = fused_loop = None
    if config.hist_method == "fused":
        reason = fused_ineligible_reason(bin_dtype=bin_dtype,
                                         num_bins=num_bins, params=params)
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

    common = dict(num_leaves=config.num_leaves, num_bins=num_bins, meta=meta,
                  params=params, max_depth=config.max_depth,
                  feature_fraction_bynode=bynode)
    if levelwise:
        def local_frontier(binned, g3, label, L, live_slots=None,
                           rows8=None):
            return hist_frontier(binned, g3, label, L, num_bins,
                                 method=method, precision=precision,
                                 live_slots=live_slots, rows8=rows8, **bins)

        grow = make_levelwise_grower(hist_frontier_fn=local_frontier,
                                     packed=packed, **common)
    elif not use_wave:
        def local_hist(binned, g3, leaf_id, target):
            return hist_one_leaf(binned, g3, leaf_id, target, num_bins,
                                 method=method, precision=precision, **bins)

        grow = make_leafwise_grower(
            hist_fn=local_hist,
            partition=config.tree_growth != "leafwise_masked",
            hist_pool_mb=config.histogram_pool_size, packed=packed,
            **common)
    else:
        grow = make_wave_grower(
            wave_size=wave_size, hist_wave_fn=local_wave,
            fused_round_fn=fused_fn, fused_loop_fn=fused_loop,
            hist_wave_quant_fn=local_wave_quant if use_int8sr else None,
            packed=packed, monotone_mode=mono_mode, **common)
    grow.hist_method = method
    grow.bench_times = bench_times
    return grow


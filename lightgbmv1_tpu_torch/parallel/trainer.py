"""Tree-learner construction: the serial learner over the wave grower.

Port of lightgbmv1_tpu/parallel/trainer.py ``resolve_deep_dtype`` (:269),
``select_bin_layout`` (:286) and the serial branch of ``build_trainer``
(:334; the wave branch :629-731): resolve the histogram method and the
two precisions, and wire ``hist_wave`` into the wave grower, with the
``deep`` precision on the sustained rounds of a big wave.

``hist_method=fused`` is the fused dispatch of the JAX ``build_trainer``
(:591-646): the wave rounds run ``ops/wave_fused.make_fused_round`` (K2
on the card, K3 for the valid sets), the root pass the base method
``pallas`` (K1).  With ``wave_loop_rounds > 1`` (JAX :647-722) they run
as segments of the persistent loop ``make_fused_wave_loop`` (K6), where
its plan (``plan_wave_loop``) is eligible.  Where the JAX package logs an
ineligible configuration and falls back to the staged path or to the
single round, the port raises ``NotImplementedError`` with the JAX
reason: nothing silently trains something else.

What the JAX package routes elsewhere raises here, naming its ROADMAP
item: the sequential grower (auto ``leafwise_wave_size`` at
``num_leaves <= 7``; an explicit ``leafwise_wave_size >= 1`` forces the
wave grower, as there), the level-wise grower, ``packed4`` bins (which
``auto`` picks on the card at ``max_bin <= 15``) and the int8 / int8sr
precisions.  The loop's other JAX fallbacks (interaction constraints,
``feature_fraction_bynode``, monotone constraints) are refused before,
by ``config.unported_reason``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import GROWERS, INT8, PACKED4, Config, not_ported
from ..models import grower_wave
from ..models.grower_wave import (auto_wave_size, make_wave_grower,
                                  slot_buckets_for)
from ..ops.histogram import default_hist_method, hist_wave
from ..ops.split import FeatureMeta, SplitParams
from ..ops.wave_fused import (fused_ineligible_reason, make_fused_round,
                              make_fused_wave_loop)
from ..utils.log import log_warning


def resolve_deep_dtype(requested: str, precision: str, backend: str) -> str:
    """``hist_dtype_deep``: ``"auto"`` is int8sr on a TPU and bf16x2
    elsewhere (so bf16x2 on the card); ``""`` drops bf16x2 to single-pass
    bf16 on sustained rounds and keeps any other ``hist_dtype``."""
    if requested == "auto":
        requested = "int8sr" if backend == "tpu" else "bf16x2"
    return requested or ("bf16" if precision == "bf16x2" else precision)


def select_bin_layout(config: Config, *, num_total_bin: int,
                      device: torch.device) -> str:
    """``bin_layout``: ``u8``, or ``packed4`` where the JAX package would
    pack (``auto`` with every feature in 4 bits on the kernel's method);
    packed bins are not ported, so that case raises.  ``gpu_use_dp`` asks
    for the widest histogram datapath and keeps byte bins, as there (an
    explicit ``packed4`` warns)."""
    if config.bin_layout == "u8":
        return "u8"
    if config.gpu_use_dp:
        if config.bin_layout == "packed4":
            log_warning("bin_layout=packed4: gpu_use_dp requests the widest "
                        "histogram datapath; packed bins narrow the read "
                        "stream; storing u8 bins")
        return "u8"
    method = default_hist_method(config.hist_method, device)
    if config.bin_layout == "packed4" or (num_total_bin <= 16
                                          and method == "pallas"):
        raise not_ported(f"bin_layout=packed4 (max {num_total_bin} bins a "
                         "feature; pass bin_layout=u8 to train on byte "
                         "bins)", PACKED4)
    return "u8"


def build_trainer(config: Config, meta: FeatureMeta, params: SplitParams,
                  num_bins: int, device: torch.device,
                  bin_dtype: torch.dtype = torch.uint8,
                  num_data: int = 0) -> Callable:
    """The serial learner's ``grow(binned, g3, base_mask, valids)``
    for the configured growth (models/grower_wave.make_wave_grower) over
    ``num_data`` rows of ``bin_dtype`` bins."""
    method = default_hist_method(config.hist_method, device)
    precision = config.hist_dtype
    if precision not in ("f32", "bf16", "bf16x2"):
        raise not_ported(f"hist_dtype={precision}", INT8)
    deep_precision = resolve_deep_dtype(config.hist_dtype_deep, precision,
                                        torch.device(device).type)
    if deep_precision == "int8sr" and config.gpu_use_dp:
        log_warning("hist_dtype_deep=int8sr conflicts with gpu_use_dp "
                    "(double-precision histograms requested); int8sr "
                    "disabled, deep rounds run f32")
        deep_precision = "f32"
    if deep_precision in ("int8", "int8sr"):
        raise not_ported(f"hist_dtype_deep={deep_precision}", INT8)

    if config.tree_growth != "leafwise":
        raise not_ported(f"tree_growth={config.tree_growth}", GROWERS)
    wave_size = config.leafwise_wave_size
    if wave_size == 0:
        # auto: num_leaves // 4; K = 1 (num_leaves <= 7) routes the JAX
        # package to its sequential grower
        wave_size = auto_wave_size(config.num_leaves)
        if wave_size <= 1:
            raise not_ported(
                f"the sequential grower (auto leafwise_wave_size at "
                f"num_leaves={config.num_leaves} <= 7; set "
                "leafwise_wave_size >= 1 for the wave grower)", GROWERS)
    if wave_size > 128:
        log_warning(f"leafwise_wave_size={wave_size} capped to 128")
        wave_size = 128

    def local_wave(binned, g3, label, nslots, deep=False):
        return hist_wave(binned, g3, label, nslots, num_bins, method=method,
                         precision=deep_precision if deep else precision)

    # ---- hist_method=fused: the routed fused round (K2, K3) -------------
    fused_fn = fused_loop = None
    if config.hist_method == "fused":
        reason = fused_ineligible_reason(bin_dtype=bin_dtype,
                                         num_bins=num_bins)
        if reason:
            raise NotImplementedError(f"hist_method=fused: {reason}")
        fused_fn = make_fused_round(meta=meta, params=params,
                                    num_bins=num_bins, precision=precision,
                                    deep_precision=deep_precision)
        if config.wave_loop_rounds > 1:
            # ---- the persistent wave loop (K6), planned at this shape ---
            fused_loop = make_fused_wave_loop(
                meta=meta, params=params, num_bins=num_bins,
                precision=precision, deep_precision=deep_precision,
                rounds=config.wave_loop_rounds)
            L, F = config.num_leaves, meta.num_bins.shape[0]
            K = max(1, min(wave_size, max(L - 1, 1)))
            plan = fused_loop.plan(
                N=num_data, F=F, K=K, L=L,
                use_sub=(L * F * num_bins * 3 * 4
                         <= grower_wave._SUB_STATE_CAP_BYTES),
                slot_buckets=slot_buckets_for(K, num_data), device=device)
            if not plan["eligible"]:
                raise NotImplementedError(
                    f"wave_loop_rounds={config.wave_loop_rounds}: "
                    f"{plan['reason']}")

    return make_wave_grower(num_leaves=config.num_leaves, num_bins=num_bins,
                            meta=meta, params=params,
                            max_depth=config.max_depth, wave_size=wave_size,
                            hist_wave_fn=local_wave,
                            fused_round_fn=fused_fn,
                            fused_loop_fn=fused_loop)


#!/usr/bin/env python3
"""The int8 legs of K1 and K2 of two checkouts of the port, timed on one
NVIDIA card in the order A, B, B, A
(``ab_driver.py``).

    python3 int8_ab.py A_ROOT B_ROOT [--iters 50] [--train-rows 1048576]

Each checkout runs in a process of its own, its package first on the
path, with its own ``chip_smoke.py`` helpers: phase 8's rows
(``make_data``), then the staged and the fused int8 trainings of phase 35
(``INT8_RUNS``: the headline configuration at ``hist_dtype=int8``),
``--iters`` iterations each.  On the staged training's last K1 inputs at
its largest int8 bucket (L = 64 at the headline) K1 is timed at int8
(its own scale tile, and T = 128, two scale tiles a 256-row tile), at
int8sr (the rows stochastically quantized) and at bf16x2; on the fused
training's last K2 inputs at its largest int8 bucket, K2 at int8, int8sr
and bf16x2.  The legs of one set run in turns, five rounds, the order
reversed every other round; each time is ``chip_smoke.time_ms`` over 10
launches, and the medians and the int8 leg's ratios are printed.  Where
the checkout's ``check_k1_int8`` takes a scale tile (this tree's), K1's
int8 leg is also held bit for bit to its row-order plain version at every
scale tile, and K2's to its plain version on rounds whose listed rows are
spaced so that a warp batch crosses scale tiles.  Each process prints one
JSON line; the last line is the summary, each number the two runs of a
checkout side by side, with the card's name and power limit.  Exits 1
if a check failed or a checkout's staged text differs from its fused
text, 2 without a card.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import sys
import time

import ab_driver

LIBS = ["hist", "wave_fused", "quantize", "split_scan"]
ROUNDS = 5


def child(root: str, iters: int, rows: int) -> dict:
    """One checkout's trainings, int8 checks and K1 / K2 times."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lightgbmv1_tpu_torch import Dataset, train
    from lightgbmv1_tpu_torch.ops import _build
    from lightgbmv1_tpu_torch.ops import fused_cuda as fc
    from lightgbmv1_tpu_torch.ops import hist_cuda as hc
    from lightgbmv1_tpu_torch.ops import quantize as qz

    _build.build(LIBS)
    X, y = cs.make_data(rows, 0)
    ds = Dataset(X, label=y, params=cs.TRAIN_PARAMS)
    ds.construct()
    out, recs = {"root": root}, {}
    for name, params in cs.INT8_RUNS[:2]:          # staged, fused
        with cs.HistRecorder() as hrec, cs.FusedRecorder() as frec:
            t0 = time.perf_counter()
            booster = train(params, ds, iters, device="cuda")
            torch.cuda.synchronize()
            out[f"{name}_s_per_iter"] = (time.perf_counter() - t0) / iters
        out[f"{name}_sha256"] = hashlib.sha256(
            booster.model_to_string().encode()).hexdigest()
        recs[name] = (hrec, frec)

    def turns(fns):
        runs = {k: [] for k in fns}
        order = list(fns)
        for i in range(ROUNDS):
            for k in (order if i % 2 == 0 else order[::-1]):
                runs[k].append(cs.time_ms(fns[k], 10))
        med = {k: float(np.median(v)) for k, v in runs.items()}
        return {**med, **{f"int8/{k}": med["int8"] / med[k]
                          for k in order[1:]}}

    def largest(last, prec="int8"):
        return max(((k, v) for k, v in last.items() if k[1] == prec),
                   key=lambda kv: kv[0][0])

    hrec = recs["staged"][0]
    (L, _), (binned, g3, lid, B, live) = largest(hrec.last)
    rows8 = hrec.rows8[(L, "int8")] or qz.NearestRows(g3)
    q3 = qz.sr_quantize(qz.prequantize_rows(g3)[0], cs.CHECK_KEY)
    T = hc.hist_row_tile(L, binned.shape[0], B)
    out["k1"] = {"L": L, "T": T, "live_rows": int(
        ((lid >= 0) & (lid < (L if live is None else live))).sum())}
    out["k1"]["own_tile"] = turns({
        "int8": lambda: hc.hist_leaves(binned, g3, lid, L, B, "int8", live,
                                       rows8=rows8),
        "int8sr": lambda: hc.hist_leaves(binned, q3, lid, L, B, "int8sr",
                                         live),
        "bf16x2": lambda: hc.hist_leaves(binned, g3, lid, L, B, "bf16x2",
                                         live)})
    out["k1"]["T128"] = turns({
        "int8": lambda: hc.hist_leaves(binned, g3, lid, L, B, "int8", live,
                                       rows8=rows8, row_tile=128),
        "int8sr": lambda: hc.hist_leaves(binned, q3, lid, L, B, "int8sr",
                                         live)})
    fails = []
    if "T" in inspect.signature(cs.check_k1_int8).parameters:
        cs.check = lambda cond, what: None if cond else fails.append(what)
        for t in qz.ROW_TILES:
            cs.check_k1_int8(f"last inputs T={t}", binned, g3, lid, L, B,
                             live=live, T=t)
    (ns, _, mode), (binned, g3, kw) = largest(recs["fused"][1].last)
    kw = dict(kw, rows8=kw.get("rows8") or qz.NearestRows(g3))
    label = fc.fused_round(binned, g3, **kw)[3]
    q3 = qz.sr_quantize(qz.prequantize_rows(g3)[0], cs.CHECK_KEY)
    skw = dict(kw, precision="int8sr", scale=torch.ones(
        (ns, 3), dtype=torch.float32, device=binned.device))
    bkw = dict(kw, precision="bf16x2")
    out["k2"] = {"nslots": ns, "mode": mode,
                 "live_rows": int((label < ns).sum()),
                 **turns({"int8": lambda: fc.fused_round(binned, g3, **kw),
                          "int8sr": lambda: fc.fused_round(binned, q3, **skw),
                          "bf16x2": lambda: fc.fused_round(binned, g3,
                                                           **bkw)})}
    if "T" in inspect.signature(cs.check_k1_int8).parameters:
        rng = np.random.RandomState(0)
        meta = cs.make_feature_meta(ds._binned, binned.device)
        N = binned.shape[1]
        for stride in (37, 613):
            oleaf = np.zeros(N, np.int64)
            oleaf[stride // 2::stride] = 1
            gk, k2kw = cs.round_inputs(binned, meta, 16, 1, False, "int8",
                                       rng, oleaf=oleaf, leafs=[1])
            cs.check_k2_int8(f"spaced every {stride} rows", binned, gk, k2kw)
        out["checked"] = True
    out["fails"] = fails
    return out


def add_args(ap) -> None:
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--train-rows", type=int, default=1 << 20)


def summarize(res, pair):
    """Each leg's times; ok: no check failed and each staged text equals
    its fused text."""
    ok = all(not r["fails"] and r["staged_sha256"] == r["fused_sha256"]
             for r in res)
    keys = {}
    for leg, names in (("k1", ("own_tile", "T128")), ("k2", (None,))):
        for key in names:
            pick = (lambda r: r[leg][key]) if key else (lambda r: r[leg])
            keys[f"{leg}{'_' + key if key else ''}"] = {
                k: pair(lambda r: pick(r)[k])
                for k in pick(res[0]) if k.startswith("int8")
                or k in ("bf16x2",)}
    return keys, ok


if __name__ == "__main__":
    sys.exit(ab_driver.main(
        __file__, __doc__, "the int8 legs",
        lambda root, args: child(root, args.iters, args.train_rows),
        summarize, add_args))

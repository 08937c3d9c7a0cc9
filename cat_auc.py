#!/usr/bin/env python3
"""Held-out AUC of chip_smoke.py phase 47's categorical training, by the
JAX package and by the port on the CPU.

    JAX_PLATFORMS=cpu python3 cat_auc.py [--rows 262144] [--iters 20]
                                         [--package jax|port|both]

The data is chip_smoke.py's ``make_cat_data`` (``--rows`` training rows,
131,072 valid rows: the 28 features of bench.py:42 make_data beside four
categorical columns of 3, 24, 60 and 500 categories); the configuration
is chip_smoke's CAT_PARAMS with the four columns categorical, then the
same columns taken as numeric, at ``hist_method=auto`` (on the CPU both
packages' f32 scatter; the card runs K1 at bf16x2).  Prints one line a training: package,
mode, valid AUC after ``--iters`` iterations, train AUC, seconds.  It is
the reference for phase 47's AUC gate (``JAX_CAT_AUC``): on this data
the categorical splits fit the training rows closer and the valid rows
less well than the numeric ones, in the JAX package as in the port.
"""

import argparse
import time

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=cs.CAT_ROWS)
    ap.add_argument("--iters", type=int, default=cs.CAT_ITERS)
    ap.add_argument("--package", default="both",
                    choices=("jax", "port", "both"))
    args = ap.parse_args()
    X, y = cs.make_cat_data(args.rows, 50)
    Xv, yv = cs.make_cat_data(cs.VALID_ROWS, 51)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    params = dict(cs.CAT_PARAMS, hist_method="auto")
    for package in packages:
        for mode, cats in (("categorical", cs.CAT_COLS), ("numeric", [])):
            ev = {}
            t0 = time.perf_counter()
            if package == "jax":
                import lightgbmv1_tpu as lj
                ds = lj.Dataset(X, label=y, categorical_feature=cats or "auto")
                b = lj.train(params, ds, args.iters,
                             valid_sets=[lj.Dataset(Xv, label=yv,
                                                    reference=ds)],
                             evals_result=ev, verbose_eval=False)
            else:
                ds = cs.Dataset(X, label=y, categorical_feature=cats or "auto")
                b = cs.train(params, ds, args.iters,
                             valid_sets=[cs.Dataset(Xv, label=yv,
                                                    reference=ds)],
                             evals_result=ev, device="cpu")
            from sklearn.metrics import roc_auc_score
            tr = roc_auc_score(y, b.predict(X))
            print(f"{package} {mode} valid AUC {ev['valid_0']['auc'][-1]:.6f}"
                  f" train AUC {tr:.6f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Held-out AUC of the headline configuration at plain int8 histograms,
trained by the JAX package and by the port on the CPU: the reference for
chip_smoke.py phase 35's AUC gate.

    JAX_PLATFORMS=cpu python3 int8_auc.py [--rows 65536] [--iters 50]
                                          [--package jax|port|both]
                                          [--precisions bf16x2,int8]

The data is chip_smoke.py's copy of bench.py:42 make_data (``--rows``
training rows, 131,072 valid rows); the configuration is chip_smoke's
TRAIN_PARAMS with ``hist_method=pallas`` (the JAX package runs its Pallas
kernel in interpret mode on the CPU; its ``scatter`` method, the CPU's
default, sums f32 rows at every precision), at ``hist_dtype=bf16x2`` and
at ``hist_dtype=int8``.  Prints one line a training: package, precision,
valid AUC after ``--iters`` iterations, seconds.  Plain int8 rounds every
row tile's gradients to 255 levels, which costs accuracy by design (the
JAX package measured about -0.007 AUC after 500 iterations,
lightgbmv1_tpu/config.py:360-361); the interpreted Pallas kernel bounds
the rows this can run at on a CPU.
"""

import argparse
import time

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--package", default="both",
                    choices=("jax", "port", "both"))
    ap.add_argument("--precisions", default="bf16x2,int8")
    args = ap.parse_args()
    X, y = cs.make_data(args.rows, 0)
    Xv, yv = cs.make_data(cs.VALID_ROWS, 1)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    for package in packages:
        for prec in args.precisions.split(","):
            p = dict(cs.TRAIN_PARAMS, hist_method="pallas", hist_dtype=prec)
            ev = {}
            t0 = time.perf_counter()
            if package == "jax":
                import lightgbmv1_tpu as lj
                lj.train(p, lj.Dataset(X, label=y), args.iters,
                         valid_sets=[lj.Dataset(Xv, label=yv)],
                         evals_result=ev, verbose_eval=False)
            else:
                cs.train(p, cs.Dataset(X, label=y), args.iters,
                         valid_sets=[cs.Dataset(Xv, label=yv)],
                         evals_result=ev, device="cpu")
            print(f"{package} {prec} valid AUC {ev['valid_0']['auc'][-1]:.6f}"
                  f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()

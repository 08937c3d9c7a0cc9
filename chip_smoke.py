#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--requests 500]
                          [--train-rows 1048576] [--iters 50]

Phases (any failure exits non-zero with no ``ok`` line):

1. device   — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build    — nvcc builds ``lightgbmv1_tpu_torch/csrc/*.cu`` (one process
              per source, all started together); build seconds and the
              ptxas register/shared-memory lines.
3. model    — a synthetic full-width model from ``--seed``: binary, 500
              trees of 255 leaves grown leaf-wise by splitting random
              leaves, 28 features, thresholds from a fixed 63-value grid
              per feature, mixed missing types and default_left, small
              leaf values, no threshold inside +-kZeroThreshold.  Written
              as v3 model text by the port's ``model_to_string`` and
              loaded with ``Booster(model_file=...)`` on ``cuda``.
4. kernels  — each kernel against its plain PyTorch version on the card:
              K4 on the full-width model A (u8 codes, and the same codes
              as uint16 and int32), on model B (packed codes: <= 13
              thresholds a feature) and on model C (K = 3, softmax, 60
              trees), each at 131,072, 1,000 (ragged) and 256 rows: raw
              scores bit for bit (the plain version adds in K4's order),
              sigmoid/softmax within 1e-6, leaf ids exact.  Then K4's
              raw scores bitwise equal at every row-tiles-a-block the
              wrapper picks for the buckets 256 ... 131,072 and at the
              extremes, and for rows scored as a 256-row bucket or
              inside the 131,072-row chunk.  K5's leaf ids exact at
              u8, u16 and i32 codes at 131,072, 1,001 and 256 rows on
              each model, on the headline model cut to 499 trees with
              three of one leaf (a ragged last group), on rows of 29 B
              and of 48 KB, and at other launch plans.
5. bulk     — the main path, launch counts reset first:
              ``Booster.predict(X, predict_method="fused", raw_score=True)``
              on ``--rows`` rows with NaNs and zeros, ``pred_leaf`` on a
              16,384-row subset, and ``predict_method="pallas"``; checked
              against the numpy HostTree oracle on a subset.
6. server   — ``Server`` with predict_method=fused answers ``--requests``
              requests of 1-256 rows from 8 threads, with one publish and
              one rollback in mid-traffic; every answer equal bit for bit
              to ``Booster.predict`` of the version it names.
7. launches — both kernels' counts moved in phases 5-6, the fused plan is
              eligible; then each kernel is timed (CUDA events) at the
              main path's chunk shape beside its plain version and its
              bound, and K4 also at 256, 512 and 1,024 rows, each size
              with its device time by torch.profiler (walk and combine),
              the walks' load bound (walk_loads), K4's own shared-memory
              words and its lane efficiency (thread steps over 32 x warp
              steps under its mapping, from the per-walk step counts);
              K5 at the same sizes beside K4's leaf mode, with its device
              time and the lane efficiency of its mapping.
8. data     — ``--train-rows`` x 28 training rows and 131,072 valid rows
              from the port's copy of bench.py:42 make_data, binned at
              max_bin=63 (B = 64) by ``Dataset.construct``.
9. K1       — the histogram kernel against its plain versions on the card
              at F = 28, N = --train-rows, B = 64, L in {2, 5, 17, 64}
              (the headline wave's slot counts), 1 (the sequential
              grower's), 65 and 128 (the level-wise grower's) and 256
              (four slot groups at bf16x2) on signed, varied rows, and at
              N = 4,096, L = 64, in each of
              bf16x2 / bf16 / f32: bit for bit the row-order version
              (``hist_leaves_roworder_ref``: each chunk's cell summed in
              row order from 0, the chunks in order, hi and lo apart);
              against the index_add_ version counts exact and every cell
              of n rows within 2 (n + 1) 2^-24 of its absolute sum
              (+1e-6; the f32 bound of a sum of n terms, for each side);
              two launches on the same input bitwise equal; with the last
              slot dead (``live_slots = L - 1``) the other slots' cells
              bitwise the all-live ones and the dead slot +0.0.  Each case
              names the pairs of precisions the tolerance tells apart;
              the small case must tell all three apart.
10. train   — the training main path, launch counts reset first:
              ``train`` on the headline configuration (binary, 255 leaves,
              max_bin 63, defaults) for ``--iters`` iterations with the
              valid set; K1 launched (its launches by slot count and
              precision add up), K3 once a tree (the valid set routed
              through all of a tree's rounds in one launch) and no plain
              version; s/iter,
              M row-trees/s, the held-out AUC (> 0.90) and the model
              text's sha256 and length.  Then K1 is held to its plain
              versions, as in phase 9, on the inputs of the path's last
              call at each slot count (with the call's live slots).  The
              saved model text is loaded by ``Booster(model_file=...)``
              and serves the valid rows through K4 within the serving
              tolerance of the trainer's own valid scores.
11. parity  — 65,536 x 28 rows, 63 leaves in waves of 32 (slot buckets
              {4, 16, 32}, deep rounds), hist_dtype=f32, 5 iterations, on
              the card and on the CPU (plain versions): split features
              and threshold bins identical at every node of every tree.
12. timing  — K1 at each slot bucket of the main path (its own last
              inputs, recorded in phase 10) beside its plain version, one
              ``index_add_`` and its bound.
13. profile — five headline iterations under torch.profiler: device time
              by kernel and the device's busy share.
14. K2/K3   — the fused round K2 and the valid routing K3 against their
              plain versions on the card, on phase 8's bins with signed,
              varied rows: S in {4, 16, 63} in subtraction mode and S = 63
              pool-free, each in bf16x2 / bf16 / f32.  New leaf ids,
              labels and K3 at one round exact (K3 also equal to K2's own
              new leaf ids); hsmall bitwise equal to K1 on the emitted
              label; the
              residue against the plain scan run on the CPU on the same
              histograms (bitwise equality reported) and against the
              plain version on the card: picks identical outside ties,
              values within four tie bands; two launches bitwise equal;
              the pick kernel on K2's residue (``scan_cuda.split_pick``)
              bit for bit ``pick_pack`` run on the CPU on the same
              residue.  Then sparse-live rounds (S = 4, one split of leaf 1): one
              live row, the live rows of one row chunk, none, and every
              row (a root-sized round), each held as above and to its
              live-row count.  Then K3 on synthetic trees grown in rounds
              on 131,072 and 1,001 of the rows: one of 2,295 splits in 16
              rounds, whose tables pass a block's shared memory (read
              from device memory), and one of 10 rounds of up to 63:
              leaf ids bitwise its plain version round after round, R
              single-round launches and the tree walk
              (``tree_leaf_index_binned``).
15. fused   — the fused training main path, launch counts reset first:
              ``train`` at the headline configuration with
              ``hist_method=fused`` for ``--iters`` iterations with the
              valid set.  K2 launched once a non-root round (its launches
              by bucket add up), the pick kernel once a round, K1, K3 and
              the split-scan kernel once a tree, no plain version
              called; s/iter, M
              row-trees/s, AUC > 0.90 and within 2e-3 of phase 10's, the
              model text's sha256 and length, which must be phase 10's
              (the staged scan is the split-scan kernel, K2's scan stage:
              one model text); the saved model served through K4.  Then the same training
              again, untimed, counting each K2 launch's live rows (label
              below nslots; its model text must be the timed run's),
              printed per bucket as the mean live share and its
              distribution.  K2 held to its plain version on the path's
              last inputs.
16. parity  — phase 11's configuration on the card, ``hist_method=fused``
              against ``pallas``: the same split feature and threshold at
              every node of every tree; the largest leaf-value difference.
17. timing  — K2 at each slot bucket and K3 on the main path's last
              inputs (K3: the last tree's valid routing), beside their
              plain versions and bounds (K2: the all-rows bound and the
              live-row bound, from the inputs' live rows; K3: each row's
              leaf id read and written and a bin byte for each round its
              leaf splits in, counted on this run's rows); K3 there held
              at 131,072 and 1,001 rows to its plain version, R
              single-round launches and the tree walk of the trained
              tree; then the pick kernel on K2's residue at each
              bucket, by events and on the device, with the device
              kernels a pick runs (profiler), beside K2 with its pick and
              K2 alone, its plain version and its bound by bytes.
18. profile — five fused headline iterations, as phase 13.
19. K6      — the persistent wave loop's plan at the headline shape
              (eligible), then K6 on the headline bins and phase 14's
              signed, varied rows from a frontier captured after the root
              and two single rounds of a headline tree grown on them,
              R = 4, subtraction and pool-free, bf16x2 and f32:
              against R launches of K2 with the PyTorch pick and replay
              (packed rows, leaf ids, pool and split counts bitwise, and
              two launches bitwise equal) and against its plain version
              on the card (split counts exact; picks identical outside the
              tie band; gains and sums within phase 14's bounds; leaf ids
              exact while the picks agree); then the same frontier with
              rows parked in an unused leaf: one live row, one chunk's
              rows, none, and every row in the first split, each leaf's
              sums and pool rebuilt from the rows it holds, at
              lambda_l2 = 1.
20. looped  — the looped training main path, launch counts reset first:
              ``train`` at the headline configuration with
              ``hist_method=fused, hist_dtype_deep=bf16x2,
              wave_loop_rounds=4`` for ``--iters`` iterations with the
              valid set.  K6 launched once a segment (at least once a
              tree), K2 never, K3 and K1 once a tree, no
              plain version; the model text byte-identical to the single
              round's with the same knobs, trained in the same phase (one
              run each: s/iter, M row-trees/s); AUC > 0.90; the model
              text's sha256 and length; the model served through K4.
              Then both trainings again, untimed, with the probes (model
              texts the timed runs'): every K6 launch takes a debug buffer
              (block 0's stamps after each grid barrier, each round's live
              rows), and the single round counts K2's live rows; K6's
              list counts equal K2's round by round, printed as live
              shares per bucket.
21. timing  — K6's stage split from phase 20's stamped run (median us of
              route, list, partials, scan, pick + boundary, a round, at
              each bucket); K6 on the main path's last inputs beside its
              plain version, R K2 rounds on the same inputs, its all-rows
              and live-row bounds, and one round alone against K2 alone
              on that round's inputs; five looped iterations profiled, as
              phase 13.
22. regression — the sequential grower's main path, launch counts reset
              first: phase 8's rows with a continuous target (make_data's
              logit plus noise), binned on phase 8's bins; ``train`` with
              NO objective (the default, regression: l2 from the label
              mean) and 7 leaves, where the auto wave size 1 routes to
              the sequential grower, for --reg-iters iterations with the
              valid set: K1 launched, at one slot only (the root over
              every row, then each split's smaller child gathered from
              its segment), no plain version; s/iteration, s/tree, K1
              launches a tree, the valid l2, the model text's hash, the
              model served through K4.  Then K1 against its plain
              versions on the path's last inputs and timed there; five
              iterations profiled; and the path in f32 on the card and on
              the CPU on 65,536 of the rows, the CPU's K1 the row-order
              plain version (``card_vs_cpu`` says why): every split
              identical, leaves within 2e-3 of max(1, |leaf|).
23. level-wise — phase 22's steps for ``tree_growth=levelwise`` at the
              headline configuration on phase 8's data, --level-iters
              iterations: K1 at each level (the root, then the last
              level's splits' smaller children with a dead slot); valid
              AUC beside the JAX package's level-wise 0.91267.
24. multiclass — the bench parity config (bench.py:2854-2861): the port's
              copy of make_multiclass_data, 250,000 x 28 rows, 5 classes,
              127 leaves, max_bin 63, --mc-iters iterations, a valid set
              of 50,000; phase 22's steps, multi_logloss beside the JAX
              package's 0.85144 and the reference C++'s 0.830193; the
              model served through K4, held to its plain version (phase
              4's checks) and to the port's CPU predict (raw within the
              serving tolerance, softmax within 1e-6).
25. lambdarank — the bench parity config (bench.py:2906-2913): the port's
              copy of make_rank_data, 2,000 queries x 100 documents x 64
              features, 63 leaves, --rank-iters iterations, ndcg@10 on a
              valid set of 400 queries beside the JAX package's 0.61497
              and the reference C++'s 0.613977; phase 24's steps.
26. packed  — 4-bit packed bins (bin_layout=packed4): phase 8's rows
              binned at max_bin=15 (a 16-bin axis) and packed two
              features a byte (14 x N bytes).  K1's packed leg against its
              u8 leg and the row-order plain version bit for bit (so the
              u8 leg at B = 16 too) at L in {1, 2, 5, 17, 64} in bf16x2 /
              bf16 / f32, at F = 28 and at F = 27 (odd: the phantom hi
              nibble); K2 and K3's packed legs bit for bit their u8 legs
              and, against their plain versions, leaf ids and labels
              exact, hsmall the row-order plain histogram of the label
              and the residue the CPU plain scan's, at S = 4 / 16 / 63 in
              each precision, S = 63 pool-free and phase 14's sparse-live
              rounds; K6 at R = 4 from a frontier grown on these bins: its
              u8 leg against R K2 rounds and its plain version (phase
              19's checks) and its packed leg bit for bit the u8 leg.
27. packed training — the slice's main path, launch counts reset first:
              the headline configuration at max_bin=15 with the default
              bin_layout (auto packs on the card): staged for --iters
              iterations, ``hist_method=fused`` and the looped fused path
              (``hist_dtype_deep=bf16x2, wave_loop_rounds=4``) for 20
              each; each stores a (14, N) matrix, launches only the
              packed legs (K1 and K3; K2 and K3; K6 and K3) and no plain
              version, and writes the model text of the same training
              with bin_layout=u8 byte for byte (s/iteration of both
              printed); the staged model's AUC > 0.90 and served through
              K4.  Then each packed leg timed on the path's last inputs
              beside its u8 leg, its plain version, the unpack alone and
              (K1) one ``index_add_`` on the unpacked bins, with its
              bound (the bins stream at ceil(F/2) bytes a row); K3's
              packed leg on the fused run's last tree held at 131,072 and
              1,001 rows to its u8 leg, its plain version, R single-round
              launches and the tree walk.
28. int8sr  — stochastic-rounded int8 histograms
              (hist_dtype_deep=int8sr) against their plain versions: the
              quantize kernel bit for bit its plain version on the card
              and on the CPU (and the prequantized rows and scales the
              CPU's) at --train-rows rows and an odd count with weighted
              counts and a zero hessian column; K1's int8sr leg exact
              (integer plain versions) at L in {1, 17, 64}, byte bins and
              a packed 16-bin axis, every cell below 2^24; K2's at S = 16
              and 63 (subtraction: apply_scale) and 63 pool-free
              (child_scale), and phase 14's sparse-live rounds: leaf ids,
              labels and K3 exact, hsmall K1's int8sr histogram, the
              residue the CPU plain scan's of the plain dequantization;
              K6 at R = 4 on a segment of a headline int8sr tree whose
              rounds mix bf16x2 and int8sr, subtraction and pool-free, and
              a sparse-live segment: bit for bit R K2 rounds (each
              quantized by the quantize kernel), the rows K6 drew for its
              last quantized round the quantize kernel's for that key.
29. int8sr training — the headline configuration with
              hist_dtype_deep=int8sr for --iters iterations, staged,
              fused and looped (wave_loop_rounds=4), launch counts reset
              around each: the int8sr legs launch only at the 16- and
              63-slot buckets (K1 at L = 17, 64 with one quantize launch
              each; K2 at nslots 16, 63 likewise; K6 with the quantized
              ladder and no quantize launch), no plain version; the
              looped model text its single round's (the fused one) byte
              for byte, the staged text the fused one, a second staged
              training the same; AUC > 0.90; each model served through
              K4.  Then each int8sr leg
              timed on the path's last inputs beside its bf16x2 / bf16
              leg, its plain version and (K1) one index_add_ of the
              integer rows, and the quantize kernel beside its plain
              version, with bounds.
30. int8sr parity — phase 11's card-against-CPU check on 65,536 of the
              rows with hist_dtype_deep=int8sr (f32 otherwise): every split
              identical, leaves within 2e-3 of max(1, |leaf|); then phase
              16's fused-against-staged check on the card (its 63 leaves
              in waves of 32) with hist_dtype_deep=int8sr, each run
              through its int8sr legs: every split identical, leaves
              within 2e-3 of max(1, |leaf|).
31. scan    — the split-scan kernel (``ops/scan_cuda.split_scan_pick``,
              ``csrc/split_scan.cu``: one launch a ``find_best_split``,
              K2's scan stage ``scan_child`` a warp a feature, then K6's
              pick ``pick_child``, on staged histograms): its packed rows
              bit for bit ``pick_pack`` on the plain scan run on the CPU
              on the same inputs, and its residue (``split_scan``) bit
              for bit the plain scan: on a real round of a monotone
              training (its bounds bind), then at C in {1, 2, 8, 32, 126},
              B in {16, 64, 256}, F = 28 and 27, NaN- and zero-missing
              features, with no option, each option alone (monotone
              bounds — the real round's —, monotone_penalty=1.0 at depths
              1-8, contri, path_smooth=1.0, max_delta_step=0.7) and all
              of them, with int8sr scales, and with every option but no
              bounds or parent outputs (the kernel's NO_CONSTRAINT and 0);
              at C = 2, B = 16 with 37 features more than a block's
              shared memory holds (the residue in global memory).
              K2's constrained legs at S = 4 / 16 / 63 (subtraction;
              S = 63 pool-free and each option alone; S = 4 with null
              bounds and parent outputs) and phase 14's
              sparse-live rounds: leaf ids, labels and K3 exact, hsmall
              K1's, the residue bit for bit the CPU plain scan of the
              children with the same legs, the pick kernel on it bit for
              bit the CPU ``pick_pack``.  K6
              with contri / smooth / max output on a segment of a
              headline tree grown with them (R = 4, subtraction and
              pool-free) and a sparse-live segment: bit for bit R K2
              rounds, each round's residue and pick the CPU plain scan's.
              Then on phase 10's last inputs at C = 1 / 8 / 32 / 126 the
              whole ``find_best_split`` and the kernel's wrapper timed by
              events, the kernel's device time and the device kernels a
              ``find_best_split`` runs (profiler), beside its plain
              version and its bound by bytes, with its launches a tree on
              phases 10, 15, 20 and 22-25.
32. constrained training — the slice's main path, launch counts reset
              around each training: the headline configuration with
              monotone_constraints = [1, -1, 0, 0, 1] + [0] * 23 (the
              generator's logit rises in X0 and X4, falls in X1) in
              ``basic`` and in ``intermediate`` mode, staged and fused,
              and with feature_contri (0.5 on features 5-27),
              path_smooth=1.0 and max_delta_step=0.7 staged, fused and
              looped (wave_loop_rounds=4), --iters iterations each: each
              set's model texts one, byte for byte; the split scan at the
              run's options and K2 / K6 at theirs launched, no plain
              version; the monotone models' AUC above MONO_AUC_MIN and,
              served through K4, monotone on grids of 64 points along X0,
              X1 and X4 at 64 probe rows.  Then K2's and K6's
              constrained legs timed on these runs' last inputs beside
              the same launches unconstrained.
33. constrained parity — phase 11's card-against-CPU check (65,536 rows,
              f32, 5 iterations) with intermediate monotone constraints,
              monotone_penalty=1.0, feature_contri, path_smooth=1.0 and
              max_delta_step=0.7, the CPU training taking the card's
              gradients and root sums (``CardRounding``: the two f32
              roundings outside the kernels that differ by device, which
              a monotone bound's strict compare turns into another
              split): every split identical, leaves within 2e-3 of
              max(1, |leaf|).
34. int8 kernels — the round-to-nearest quantize kernel bit for bit
              its plain version on the card and the CPU at every scale
              tile (128, 256, 512, 1024 rows; out-of-bag zero rows, an
              all-zero tile, an odd N, and N = 1, 3, T - 1, T + 1 and
              4T + 3, the tails its 16-byte loads mask); K1's int8 leg
              (L = 2, 17, 64; byte
              bins, and 16-bin byte and packed bins; L = 64 at every
              scale tile) bit for bit its row-order plain version, counts
              exact and values within the order bound of the Pallas
              kernel's order, the packed leg the u8 leg; K2's (S = 16,
              63, pool-free, sparse-live, listed rows spaced 37 and 613
              rows apart so that a warp batch crosses scale tiles, and
              the 16-bin packed leg the u8 leg) with hsmall the row-order
              int8 histogram of its label and the residue the CPU plain
              scan's; K6's (R = 4 on an int8 tree's segment, subtraction
              and pool-free, and a packed 16-bin tree's) bit for bit R K2
              rounds.
35. int8 training — the headline at hist_dtype=int8 staged, fused
              and looped, and hist_dtype_deep=int8 staged and fused, each
              with its launch counts reset: only int8 legs (at int8 deep,
              only at the sustained 63-slot bucket); looped text = fused
              = staged, deep staged = deep fused, a second staged
              training the same text; valid AUC above INT8_AUC_MIN beside
              the JAX package's figure (int8_auc.py); each model's max
              |leaf| beside phase 10's bf16x2 model's; each model served
              through K4.  Then each int8 leg timed beside its int8sr and
              bf16 / bf16x2 legs on the same inputs, in turns, five
              rounds (medians and the int8 leg's ratios), and the
              quantize kernel at T = 512 and 128 by events and on the
              device beside its plain version.
36. sampling training — bagging 0.8 every 5 iterations, feature
              fraction 0.9 and feature_fraction_bynode 0.8, staged =
              fused byte for byte; bagging with the per-tree mask looped
              = fused byte for byte; the card's bag masks the CPU's bit
              for bit; AUC > 0.90.
37. int8 and sampled parity — phase 33's card-against-CPU replay at
              hist_dtype=int8 (the CPU in K1's order) and with the
              sampling of phase 36 (f32): every split identical.
38. new legs — the split-scan kernel's extra_trees leg on phase 10's
              last inputs (each child count, two extra_seeds) and on
              synthetic children (B = 64, 256; no options, all; int8sr
              scales): packed rows and residue bit for bit the CPU plain
              scan, the thresholds it drew exactly
              ``split.extra_rand_bins``; its wide leg at B = 512 and
              1,024 (options, rand, int8sr scales, a residue in global
              memory) bit for bit, and at B = 64 the 256-bin leg's
              residue; K3's 16-bit leg on phase 8's bins as int16 (its u8
              leg's ids) and on 512-value int16 bins, two synthetic trees
              each (tables in shared and in device memory), bitwise its
              plain version, R single rounds and the tree walk.  Each
              leg's device time (L2 cleared) beside its u8 /
              unrandomized leg and its bound.
39. extra_trees — the headline staged with extra_trees, 50 iterations
              (counts reset): every scan with the rand leg, no plain
              version, K3 a tree; a second training the same text; f32
              card against CPU (the card's gradients and root sums)
              splits identical at 65,536 rows; hist_method=fused raises
              the JAX reason.  s/iteration, AUC, scans a tree.
40. callbacks — staged headline training of up to 100 iterations with
              early_stopping_rounds=5, record_evaluation and a
              reset_parameter learning-rate schedule: best_iteration the
              JAX rule's on the recorded metrics, predict and
              model_to_string defaulting to it, each tree's rate the
              schedule's, the trees not a constant rate's.
41. onehot, bench, int16 — staged onehot training (bf16x2, 50
              iterations): AUC > 0.90, the one-hot histograms of the
              path's last inputs within the scatter's and K1's
              tolerance, their time beside K1's (a torch.matmul path, not
              a kernel); hist_method=bench's pick trains the text of that
              method chosen directly, the candidates' times printed;
              phase 8's rows at max_bin=511 (int16 bins, binning time),
              50 staged iterations through onehot, the wide scan and
              K3's 16-bit leg: AUC > 0.90, K3 launches = trees x valid
              sets, hist_method=fused raising the JAX reason, f32 card
              against CPU splits identical at 65,536 rows.
              Then the ``kernels`` line (K1, K2, K3, K6, the two quantize
              kernels, the split-scan kernel, the pick kernel, the
              split scan's extra_trees and wide legs, K3's 16-bit leg,
              K4, K5) is printed; K1's row carries phases 22-25's K1
              shapes too (``paths``) and phase 41's one-hot path beside
              it (``onehot``), K1, K2, K3 and K6 a ``packed`` record, K1,
              K2 and K6 an ``int8sr`` one and an ``int8`` one, and K2
              and K6 a ``constrained`` one.

At the default arguments every model text named in ``TEXT_SHA`` must
keep its sha256 (a gate: the kernels claim the same bits).  The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from lightgbmv1_tpu_torch import Booster, Dataset, objectives, train
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.binning import (K_ZERO_THRESHOLD, MISSING_NAN,
                                             MISSING_ZERO)
from lightgbmv1_tpu_torch.io.model_text import model_to_string
from lightgbmv1_tpu_torch.models import grower_wave
from lightgbmv1_tpu_torch.models.predict import BatchPredictor
from lightgbmv1_tpu_torch.models.tree import (HostTree, empty_tree,
                                              tree_leaf_index_binned)
from lightgbmv1_tpu_torch.ops import _build, hist_cuda as hc
from lightgbmv1_tpu_torch.ops import histogram as hg
from lightgbmv1_tpu_torch.ops import fused_cuda as fc
from lightgbmv1_tpu_torch.ops import loop_cuda as lc
from lightgbmv1_tpu_torch.ops import predict_cuda as pc
from lightgbmv1_tpu_torch.ops import quantize as qz
from lightgbmv1_tpu_torch.ops import scan_cuda as sc
from lightgbmv1_tpu_torch.ops import wave_fused as wf
from lightgbmv1_tpu_torch.ops.split import (NO_CONSTRAINT, TIE_RTOL,
                                            FeatureMeta, RandLeg, SplitParams,
                                            child_leaf_output, extra_rand_bins,
                                            find_best_split, gain_shift,
                                            go_left_rule, make_feature_meta,
                                            pick_pack, scan_direction_gains,
                                            scan_inputs, scan_left_sums,
                                            scan_residue, with_tables)
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer
from lightgbmv1_tpu_torch.serve import ServeConfig, Server
from lightgbmv1_tpu_torch.utils import prng

F = 28                      # features of the bench headline model
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# 4-byte shared-memory / L1 gathers a second: 132 SMs x 32 banks x
# 1.98 GHz boost clock (Hopper: 32 banks of 4 B per SM per clock)
GATHERS_PER_S = 132 * 32 * 1.98e9
SRC = "lightgbmv1_tpu_torch/csrc/predict_walk.cu"
HIST_SRC = "lightgbmv1_tpu_torch/csrc/hist.cu"
FUSED_SRC = "lightgbmv1_tpu_torch/csrc/wave_fused.cu"
LOOP_SRC = "lightgbmv1_tpu_torch/csrc/wave_loop.cu"
# the bench headline training configuration (root PERF.md "Headline"):
# binary, 255 leaves (waves of 63, slot buckets {4, 16, 63}), max_bin 63
# (a 64-bin axis), every other knob at its default
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                "metric": "auc,binary_logloss", "verbosity": -1}
FUSED_PARAMS = dict(TRAIN_PARAMS, hist_method="fused")
VALID_ROWS = 131072


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading also gets the run's seconds so far."""
    if msg.startswith("== phase"):
        msg += f" [{time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# synthetic model
# ---------------------------------------------------------------------------


def child_pointers(split_leafs, n_leaves):
    """The child pointers of a tree whose node j splits leaf
    ``split_leafs[j]`` (the split leaf keeps its index on the left, the
    new leaf j + 1 goes right — the reference's numbering; a leaf is
    ~leaf): ``(left, right, leaf_parent)``."""
    n_nodes = len(split_leafs)
    lc = np.zeros(n_nodes, np.int32)
    rc = np.zeros(n_nodes, np.int32)
    parent = np.full(n_leaves, -1, np.int64)   # node holding each leaf
    is_right = np.zeros(n_leaves, bool)
    for node, leaf in enumerate(split_leafs):
        p = parent[leaf]
        if p >= 0:
            (rc if is_right[leaf] else lc)[p] = node
        lc[node], rc[node] = ~leaf, ~(node + 1)
        parent[leaf], is_right[leaf] = node, False
        parent[node + 1], is_right[node + 1] = node, True
    return lc, rc, parent


def make_trees(rng, n_trees, n_leaves, n_features, grid):
    """Trees grown leaf-wise by splitting a random existing leaf
    (``child_pointers``); features, grid thresholds, missing types and
    default_left drawn at random."""
    trees = []
    n_nodes = n_leaves - 1
    for _ in range(n_trees):
        # leaves 0..node exist when node splits
        lc, rc, parent = child_pointers(
            [rng.randint(node + 1) for node in range(n_nodes)], n_leaves)
        feat = rng.randint(n_features, size=n_nodes).astype(np.int32)
        thr = grid[feat, rng.randint(grid.shape[1], size=n_nodes)]
        leaf_count = rng.randint(1, 1000, size=n_leaves)
        trees.append(HostTree(
            n_leaves, split_feature=feat, threshold=thr,
            default_left=rng.rand(n_nodes) < 0.5,
            missing_type=rng.randint(3, size=n_nodes).astype(np.int32),
            left_child=lc, right_child=rc,
            split_gain=rng.rand(n_nodes) * 10.0,
            internal_value=rng.randn(n_nodes) * 0.02,
            internal_weight=rng.rand(n_nodes) * 100.0,
            internal_count=rng.randint(2, 2000, size=n_nodes),
            leaf_value=rng.randn(n_leaves) * 0.02,
            leaf_weight=rng.rand(n_leaves) * 50.0,
            leaf_count=leaf_count, leaf_parent=parent.astype(np.int32)))
    return trees


def make_model(seed, n_trees=500, n_leaves=255, n_grid=63, num_class=1):
    """v3 model text of a synthetic ensemble (binary, or multiclass with
    ``num_class`` trees an iteration) and its trees."""
    rng = np.random.RandomState(seed)
    grid = np.sort(rng.standard_normal((F, n_grid)), axis=1)
    check((np.abs(grid) > K_ZERO_THRESHOLD).all(), "threshold in the zero band")
    trees = make_trees(rng, n_trees, n_leaves, F, grid)
    objective = ("binary sigmoid:1" if num_class == 1
                 else f"multiclass num_class:{num_class}")
    text = model_to_string(
        trees, objective_string=objective, num_class=num_class,
        num_tree_per_iteration=num_class,
        feature_names=[f"Column_{i}" for i in range(F)],
        feature_infos=["[-5:5]"] * F)
    return text, trees


def make_rows(rng, n, n_features=F):
    X = rng.standard_normal((n, n_features))
    X[rng.rand(n, n_features) < 0.10] = np.nan
    X[rng.rand(n, n_features) < 0.05] = 0.0
    return X


def raw_tol(trees) -> float:
    return 1e-6 * sum(float(np.abs(t.leaf_value).max()) for t in trees) + 1e-7


def leaf_depths(trees, L):
    """(T, L) decisions from the root to each leaf."""
    out = np.zeros((len(trees), L), np.int64)
    for ti, t in enumerate(trees):
        stack = [(0, 0)] if t.num_leaves > 1 else []
        while stack:
            nd, d = stack.pop()
            for c in (int(t.left_child[nd]), int(t.right_child[nd])):
                if c >= 0:
                    stack.append((c, d + 1))
                else:
                    out[ti, ~c] = d + 1
    return out


def walk_counts(tables, codes, n_steps, zero_code, nan_code,
                chunk=16384):
    """Leaf ids (N, T), and the steps and extra loads of every (row, tree)
    walk of ``codes`` (each (N, T) int16), counted as the decision needs
    them: each step loads the split feature, the row's code, the threshold
    bin (default_left in its place for a missing value) and the child it
    takes; a NaN or zero code also the missing type, and where it is not
    missing the zero bin (the extra loads)."""
    T, L1 = tables.split_feature.shape
    off = torch.arange(T, device=codes.device)[None, :] * L1
    feat, tbin, zbin, dl, mt, lc, rc = (a.reshape(-1) for a in tables[1:8])
    root = (tables.num_leaves > 1).long() - 1          # 0, or -1: leaf 0
    leaves, steps, extras = [], [], []
    for lo in range(0, codes.shape[0], chunk):
        c = codes[lo: lo + chunk].long()
        node = root.expand(c.shape[0], T)
        st = torch.zeros(node.shape, dtype=torch.int16, device=c.device)
        ex = torch.zeros_like(st)
        for _ in range(max(int(n_steps), 1)):
            act = node >= 0
            i = node.clamp(min=0) + off
            b = torch.gather(c, 1, feat[i].long())
            is_nan = b == nan_code
            special = is_nan | (b == zero_code)
            m = mt[i]
            missing = torch.where(m == MISSING_NAN, is_nan,
                                  (m == MISSING_ZERO) & special)
            left = torch.where(missing, dl[i] != 0,
                               torch.where(special, zbin[i], b) <= tbin[i])
            st += act.to(torch.int16)
            ex += (act & special).to(torch.int16)
            ex += (act & ~missing & special).to(torch.int16)
            node = torch.where(act, torch.where(left, lc[i], rc[i]).long(),
                               node)
        leaves.append((-node - 1).to(torch.int32))
        steps.append(st)
        extras.append(ex)
    return torch.cat(leaves), torch.cat(steps), torch.cat(extras)


def load_count(steps, extra) -> int:
    """Four-byte table and code loads of the walks walk_counts counted: 4
    a step and the extra loads of NaN and zero codes."""
    return 4 * int(steps.sum()) + int(extra.sum())


def walk_loads(tables, codes, n_steps, zero_code, nan_code,
               chunk=16384):
    """Leaf ids, steps and four-byte table/code loads of every (row, tree)
    walk of ``codes`` (walk_counts, load_count): 4 loads a step, 5 where a
    NaN or zero code is missing at the node, 6 where it is not."""
    leaf, steps, extra = walk_counts(tables, codes, n_steps, zero_code,
                                     nan_code, chunk)
    return leaf, int(steps.sum()), load_count(steps, extra)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def k4_shapes(nr, n, row_bytes, dev) -> list:
    """Every row-tiles-a-block the wrapper picks for the BatchPredictor's
    buckets (256 ... n rows), and the extremes: one tile a block and all
    of n's tiles in one block."""
    picks = {pc.launch_shape(b, nr, row_bytes, dev)
             for b in (1 << i for i in range(8, 18)) if b <= n}
    return sorted(picks | {1, 2, 3, -(-n // pc.ROW_TILE)})


def phase_kernels(models, dev, n_rows, rng, n_features=F) -> dict:
    """Each kernel against its plain version on the same card inputs: K4's
    raw scores bit for bit (its plain version adds in the kernel's
    order), at n_rows, 1,000 (ragged) and 256 rows, on every code width,
    and at every launch shape; returns the max abs error per kernel."""
    err = {"serving_fused": 0.0, "serving_leaf": 0.0}
    X = make_rows(rng, n_rows, n_features)
    for name, (text, trees, K, method_kw) in models.items():
        bp = BatchPredictor(trees, K, n_features, method="fused", device=dev,
                            **method_kw)
        check(bp.fused_plan["eligible"], f"{name}: fused plan refused "
              f"({bp.fused_plan['reason']})")
        nr = bp._fused_tables
        codes = torch.from_numpy(bp.encode(X)).to(dev)
        kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
                  nan_code=bp.binner.nan_code, K=K, packed=bp.packed)
        transforms = [None, "sigmoid"] if K == 1 else [None, "softmax"]
        widths = [codes] if bp.packed else [
            codes, codes.to(torch.uint16), codes.to(torch.int32)]
        for wide in widths:
            tag = (f"{name} {str(wide.dtype)[6:]}"
                   f"{' packed' if bp.packed else ''}")
            for n in (n_rows, 1000, 256):
                part = wide[:n]
                for tr in transforms:
                    got = pc.serving_fused(nr, part, transform=tr, **kw)
                    want = pc.serving_fused_ref(nr, part, transform=tr, **kw)
                    e = max_err(got, want)
                    err["serving_fused"] = max(err["serving_fused"], e)
                    if tr is None:
                        check(same_bits(got, want), f"K4 {tag} raw at {n} "
                              f"rows: not bitwise its plain version ({e})")
                    else:
                        check(e <= 1e-6, f"K4 {tag} {tr} at {n}: {e}")
                got = pc.serving_fused(nr, part, mode="leaf", **kw)
                want = pc.serving_fused_ref(nr, part, mode="leaf", **kw)
                check(torch.equal(got, want), f"K4 {tag} leaf ids at {n}")
            log(f"  K4 {tag}: raw bitwise, {transforms[1]} within 1e-6, "
                f"leaf ids exact at {n_rows}, 1000 and 256 rows")
        # the bits do not follow the launch shape: every tiling the wrapper
        # picks, and rows scored as a 256-row bucket or inside the chunk
        row_bytes = codes.shape[1] * codes.element_size()
        base = pc.serving_fused(nr, codes, **kw)
        shapes = k4_shapes(nr, n_rows, row_bytes, dev)
        for m in shapes:
            check(same_bits(pc.serving_fused(nr, codes, tiles_per_block=m,
                                             **kw), base),
                  f"K4 {name}: {m} row tiles a block changed the bits")
        for lo in (0, 256, n_rows - 256):
            bucket = codes[lo: lo + 256].clone()
            check(same_bits(pc.serving_fused(nr, bucket, **kw),
                            base[lo: lo + 256]),
                  f"K4 {name}: rows {lo}.. as a 256-row bucket differ")
        log(f"  K4 {name}: bitwise equal at row tiles a block {shapes} and "
            "as 256-row buckets")
        unpacked = torch.from_numpy(bp.binner.prebin(X)).to(dev)
        leaf_tables = pc.walk_tables(bp.arrays)
        kw5 = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
                   nan_code=bp.binner.nan_code)
        check_k5(name, leaf_tables, unpacked, kw5)
    return err


def check_k5(name, tables, codes, kw, sizes=(None, 1001, 256)) -> None:
    """K5's leaf ids exactly its plain version's on the same card inputs:
    u8, u16 and i32 codes (the plain version once, on the u8 codes), at
    every row count of ``sizes`` (None: all rows)."""
    want = pc.serving_leaf_ref(tables, codes, **kw)
    n_rows = codes.shape[0]
    for dtype in (torch.uint8, torch.uint16, torch.int32):
        wide = codes.to(dtype)
        for n in sizes:
            n = n_rows if n is None else n
            got = pc.serving_leaf(tables, wide[:n], **kw)
            check(torch.equal(got, want[:n]), f"K5 {name} "
                  f"{str(dtype)[6:]} at {n} rows: leaf ids differ")
    plan = pc.plan_leaf_walk(T=tables.split_feature.shape[0],
                             L1=tables.split_feature.shape[1],
                             F=codes.shape[1], code_bytes=1)
    log(f"  K5 {name} leaf ids exact at u8 / u16 / i32, "
        f"{sorted({n_rows if n is None else n for n in sizes})} rows "
        f"(group {plan['group']} of {tables.split_feature.shape[0]} trees, "
        f"{plan['rows']} rows a block)")


def phase_leaf_shapes(bp, dev, rng) -> None:
    """K5 on shapes the headline model does not give it, each exactly its
    plain version: trees of one leaf (parked at the root, their node rows
    zeroed as a pad tree's) in a model of 499 trees, so the last group is
    shorter than the others; codes rows of an odd byte width
    (staged a byte at a time) and rows of 48 KB of int32 codes (four rows
    a block, in dynamic shared memory past 48 KB); and other launch plans
    (the group, the row tile and the threads given), which must not change
    a leaf id."""
    X = make_rows(rng, 4096)
    codes = torch.from_numpy(bp.binner.prebin(X)).to(dev)
    kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
              nan_code=bp.binner.nan_code)
    full = pc.walk_tables(bp.arrays)
    T = full.split_feature.shape[0] - 1
    one = [0, T // 2, T - 1]
    parts = {}
    for key, a in full._asdict().items():
        if torch.is_tensor(a):
            a = a[:T].clone()
            if key == "num_leaves":
                a[one] = 1
            elif key != "leaf_value":
                a[one] = 0
        parts[key] = a
    tables = pc.WalkTables(**parts)
    check_k5(f"one-leaf trees, T = {T}", tables, codes, kw,
             sizes=(None, 1001, 256, 1))
    ref = pc.serving_leaf_ref(full, codes[:300], **kw)
    cases = {"u8 rows of 29 B": torch.cat(
        [codes[:300], torch.zeros((300, 1), dtype=torch.uint8,
                                  device=dev)], 1)}
    wide = torch.zeros((300, 12 * 1024), dtype=torch.int32, device=dev)
    wide[:, : codes.shape[1]] = codes[:300]
    cases["i32 rows of 48 KB"] = wide
    for name, c in cases.items():
        plan = pc.plan_leaf_walk(T=T + 1, L1=full.split_feature.shape[1],
                                 F=c.shape[1], code_bytes=c.element_size())
        check(torch.equal(pc.serving_leaf(full, c, **kw), ref),
              f"K5 {name}: leaf ids differ ({plan})")
        smem = plan["rows"] * (plan["stride_bytes"] + 4 * (plan["group"] + 1))
        log(f"  K5 {name}: exact ({plan['rows']} rows a block, {smem} B of "
            "shared memory)")
    u8 = codes[:1001]
    want = pc.serving_leaf_ref(full, u8, **kw)
    stride = 4 * ((-(-u8.shape[1] // 4)) | 1)
    for group, rows, threads in ((4, 256, 256), (16, 128, 128),
                                 (32, 32, 32), (5, 7, 32), (3, 64, 96)):
        plan = dict(group=group, rows=rows, threads=threads,
                    stride_bytes=stride)
        check(torch.equal(pc.serving_leaf(full, u8, plan=plan, **kw), want),
              f"K5 at plan {plan}: leaf ids differ")
    log("  K5 exact at groups 4 / 16 / 32 / 5 / 3 and row tiles 256 / 128 / "
        "32 / 7 / 64")


def phase_bulk(booster, trees, n_rows, rng) -> dict:
    X = make_rows(rng, n_rows)
    out = {}
    # the serving tables are built once a predictor (a publish's work);
    # the timed predicts below are the steady state
    for method in ("fused", "pallas"):
        t0 = time.perf_counter()
        bp = booster._device_predictor(trees, 1, 0, method, {})
        out[f"build_{method}_s"] = time.perf_counter() - t0
        log(f"  BatchPredictor({method}) built in "
            f"{out[f'build_{method}_s']:.3f} s")
    # the host's share: the float64 prebin every chunk goes through
    t0 = time.perf_counter()
    for lo in range(0, n_rows, bp.chunk_rows):
        bp.encode(X[lo: lo + bp.chunk_rows])
    out["encode_s"] = time.perf_counter() - t0
    log(f"  host prebin of {n_rows} rows: {out['encode_s']:.3f} s")
    for method in ("fused", "pallas"):
        t0 = time.perf_counter()
        raw = booster.predict(X, predict_method=method, raw_score=True)
        secs = time.perf_counter() - t0
        check(raw.shape == (n_rows,) and np.isfinite(raw).all(),
              f"{method}: bad output {raw.shape}")
        out[method] = {"rows_per_s": n_rows / secs, "seconds": secs,
                       "raw": raw}
        log(f"  Booster.predict(method={method}, raw) {n_rows} rows: "
            f"{secs:.3f} s, {n_rows / secs:.0f} rows/s")
    n_leaf = min(16384, n_rows)
    leaf = booster.predict(X[:n_leaf], predict_method="fused", pred_leaf=True)
    check(leaf.shape == (n_leaf, len(trees)), f"pred_leaf {leaf.shape}")
    # the numpy HostTree oracle on a subset
    n_sub = min(4096, n_rows)
    sub = X[:n_sub]
    host_raw = booster.predict(sub, raw_score=True)        # host walk, f64
    host_leaf = np.stack([t.predict_leaf_index(sub) for t in trees], axis=1)
    check(np.array_equal(leaf[:n_sub], host_leaf), "fused leaf ids != host")
    tol = raw_tol(trees)
    for method in ("fused", "pallas"):
        e = float(np.abs(out[method]["raw"][:n_sub] - host_raw).max())
        log(f"  {method} raw vs host oracle: max_abs_err={e:.3e} "
            f"(tol {tol:.3e})")
        check(e <= tol, f"{method} raw vs host: {e} > {tol}")
    f64 = booster.predict(sub, predict_method="fused", raw_score=True,
                          predict_f64_scores=True)
    check(np.array_equal(f64, host_raw), "f64 lane not bit-identical")
    prob = booster.predict(sub, predict_method="fused")
    check(np.abs(prob - 1 / (1 + np.exp(-host_raw))).max() <= 1e-6,
          "converted output differs")
    log("  leaves exact, f64 lane bit-identical, converted output ok")
    return out


def phase_server(booster_a, booster_b, n_requests, rng, dev) -> dict:
    """8 threads of 1-256-row requests; one publish (model B) and one
    rollback (back to A) in mid-traffic."""
    server = Server(booster_a, ServeConfig(
        max_batch_rows=1024, max_batch_delay_ms=2.0, queue_depth_rows=1 << 16,
        predictor_kwargs={"method": "fused"}), device=dev)
    seeds = rng.randint(1 << 30, size=8)
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(seed):
        r = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = make_rows(r, r.randint(1, 257))
                res = server.submit(rows)
                with lock:
                    results.append((rows, res))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    def more(n):
        """Wait until ``n`` more requests have been answered."""
        goal = len(results) + n
        while len(results) < goal and not errors:
            time.sleep(0.001)

    # a third of the traffic on A, a third on B, a third on A again; the
    # publish and the rollback happen while the workers keep submitting
    more(n_requests // 3)
    tag_b = server.publish(booster_b)
    more(n_requests // 3)
    tag_a = server.rollback()
    mark, t_mark = len(results), time.perf_counter()
    more(n_requests - 2 * (n_requests // 3))
    stop.set()
    t_end = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    snap = server.metrics_snapshot()
    server.close()
    check(not errors, f"server errors: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(len(results) >= n_requests, f"{len(results)} answers")
    by_tag = {tag_a: booster_a, tag_b: booster_b}
    tags = {res.version for _, res in results}
    check(tags <= set(by_tag) and len(tags) == 2, f"versions seen: {tags}")
    for tag, booster in by_tag.items():
        mine = [(rows, res) for rows, res in results if res.version == tag]
        X = np.concatenate([rows for rows, _ in mine])
        want = booster.predict(X, predict_method="fused", raw_score=True)
        got = np.concatenate([res.values[:, 0] for _, res in mine])
        e = float(np.abs(got - want).max())
        check(np.array_equal(got, want),
              f"server answers of {tag} differ from Booster.predict by {e}")
        log(f"  {len(mine)} answers tagged {tag}: max_abs_err vs "
            f"Booster.predict = {e:.3e}")
    log(f"  {len(results)} requests in {secs:.2f} s; server qps="
        f"{snap['qps']} p50_ms={snap['p50_ms']:.3f} "
        f"p99_ms={snap['p99_ms']:.3f} batches={snap['batches']} "
        f"occupancy={snap['batch_occupancy']}")
    # the steady window: from the rollback's return to the stop, with no
    # publish building tables on the host beside the dispatcher
    steady = [res for _, res in results[mark:]]
    lat = sorted(res.latency_ms for res in steady)
    snap["steady"] = {
        "requests": len(lat), "qps": len(lat) / (t_end - t_mark),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
        # a request's wait for its batch, and its batch's predict leg
        "mean_queue_ms": float(np.mean([r.queue_ms for r in steady])),
        "mean_walk_ms": float(np.mean([r.walk_ms for r in steady])),
        "mean_batch_rows": float(np.mean([r.batch_rows for r in steady]))}
    log(f"  steady window: {json.dumps(snap['steady'])}")
    return snap


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches after one warm-up, by
    CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_steps(tables, steps: torch.Tensor, t_pad: int) -> torch.Tensor:
    """(N, t_pad) steps K4 takes on each walk, from walk_counts' steps:
    a tree of <= 1 leaf, or a pad tree, takes one (its first step reads
    the parked flag)."""
    out = torch.ones((steps.shape[0], t_pad), dtype=torch.int16,
                     device=steps.device)
    out[:, : steps.shape[1]] = torch.where(tables.num_leaves > 1, steps, 1)
    return out


def lane_efficiency(steps: torch.Tensor, tree_tile: int, K: int) -> float:
    """Thread steps over 32 x warp steps under K4's mapping: a warp is 32
    neighbouring rows, and each of its lanes walks WALKS trees of one
    class of a group at once (trees j, j + K, ...), so a warp runs as
    many iterations as its deepest (lane, tree) walk of the set, each
    iteration WALKS step slots a lane."""
    N, t_pad = steps.shape
    n32 = -(-N // 32) * 32
    s = torch.zeros((n32, t_pad), dtype=torch.int16, device=steps.device)
    s[:N] = steps
    s = s.view(n32 // 32, 32, t_pad)
    slots = 0
    for g0 in range(0, t_pad, tree_tile):
        for c in range(K):
            trees = list(range(g0 + (c - g0) % K, g0 + tree_tile, K))
            for q in range(0, len(trees), pc.WALKS):
                it = s[:, :, trees[q: q + pc.WALKS]].amax(dim=(1, 2))
                slots += int(it.sum()) * 32 * pc.WALKS
    return int(steps.sum()) / slots


PROFILE_TRIES = 3    # a profiler run now and then sees no device work


def kernel_name(mangled: str) -> str:
    """``name<template ints>`` of a mangled kernel symbol: its last
    nested name that is not an anonymous namespace (the symbol as is if
    it does not parse)."""
    i = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while True:
        d = re.match(r"\d+", mangled[i:])
        if not d:
            break
        j = i + d.end()
        parts.append(mangled[j: j + int(d.group())])
        i = j + int(d.group())
    names = [p for p in parts if not p.startswith("_GLOBAL__N")]
    if not mangled.startswith("_Z") or not names:
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    return names[-1] + ("<" + ",".join(re.findall(
        r"L[ib](\d+)E", args.group(1))) + ">" if args else "")


def ptxas_kernels(log: str) -> list:
    """Each function of nvcc's ``-Xptxas -v`` output: ``{"kernel",
    "registers", "spill_stores", "spill_loads", "stack"}`` (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"kernel": kernel_name(m.group(1))}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def kernel_device_ms(fn, names, reps: int = 20) -> dict:
    """The device time a call of the kernels whose names hold each of
    ``names``, by torch.profiler over ``reps`` calls after a warm-up (CUDA
    events around a small call also count the host's launch gaps); a
    profile that saw none of them is taken again, up to PROFILE_TRIES."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            for name in names:
                if name in e.key:
                    out[name] += us / reps / 1e3
                    break
        if any(out.values()):
            break
    return out


L2_FLUSH_BYTES = 256 << 20     # five times the H100's 50 MB L2


def cold_device_ms(fn, names, reps: int = 20) -> dict:
    """``kernel_device_ms`` with the L2 cleared before each call of
    ``fn``: a write of L2_FLUSH_BYTES on the same stream, whose kernel is
    not among ``names``, so each call reads its inputs from HBM."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        return fn()
    return kernel_device_ms(flushed, names, reps)


def k4_device_ms(fn, reps: int = 20) -> dict:
    """K4's device time a call: its walk and combine kernels apart."""
    d = kernel_device_ms(fn, ("serving_fused_kernel", "serving_combine"),
                         reps)
    out = {"walk_device_ms": d["serving_fused_kernel"],
           "combine_device_ms": d["serving_combine"]}
    out["device_ms"] = out["walk_device_ms"] + out["combine_device_ms"]
    if out["device_ms"] == 0.0:
        out = {k: None for k in out}        # the profiler saw no kernel
    return out


def k5_device_ms(fn, reps: int = 20):
    """K5's device time a call by torch.profiler (None: the profiler saw
    no kernel)."""
    ms = kernel_device_ms(fn, ("serving_leaf_kernel",), reps)
    return ms["serving_leaf_kernel"] or None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def leaf_lane_efficiency(steps: torch.Tensor) -> float:
    """Thread steps over 32 x warp steps under K5's mapping: a warp is 32
    neighbouring rows of a row tile (whole warps at the headline), walking
    one tree at a time until its deepest lane is done; a tree of one leaf
    takes no step."""
    N, T = steps.shape
    n32 = -(-N // 32) * 32
    s = torch.zeros((n32, T), dtype=steps.dtype, device=steps.device)
    s[:N] = steps
    return int(steps.sum()) / (32 * int(s.view(-1, 32, T).amax(1).sum()))


def phase_timing(booster, trees, dev, launches, errs, rng) -> list:
    """Each kernel at the main path's chunk shape (131,072 rows of u8
    codes of the 500-tree model) beside its plain version and bound; K4
    and K5 also at the server's 256-, 512- and 1,024-row buckets, each
    size with its walk_loads bound, its device time and the lane
    efficiency of its mapping (K4 also its own shared-memory words, K5
    K4's leaf mode beside it)."""
    bp = booster._device_predictor(trees, 1, 0, "fused", {})
    n = bp.chunk_rows
    codes = torch.from_numpy(bp.encode(make_rows(rng, n))).to(dev)
    kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
              nan_code=bp.binner.nan_code)
    tables = bp._fused_tables
    leaf_tables = pc.walk_tables(bp.arrays)
    T, L = len(trees), bp.arrays.leaf_value.shape[1]
    L1 = bp.arrays.split_feature.shape[1]
    t_pad, tree_tile = bp.fused_plan["t_pad"], bp.fused_plan["tree_tile"]
    # the work this run's data needs, counted from the walks themselves
    leaf, steps, walk = walk_loads(leaf_tables, codes, **kw)
    check(torch.equal(leaf, pc.serving_leaf(leaf_tables, codes, **kw)),
          "load count walked other leaves than the kernel")
    fkw = dict(kw, K=1)
    rows = []
    specs = [
        ("serving_fused", "lightgbmv1_tpu/ops/predict_pallas.py:202",
         lambda: pc.serving_fused(tables, codes, **fkw),
         lambda: pc.serving_fused_ref(tables, codes, **fkw),
         # the seven-table walk's formula: codes in, the seven tables +
         # leaf values + num_leaves in, (N, 1) f32 out; a leaf-value
         # gather a walk on top of the steps' loads
         n * F + t_pad * (7 * L1 + L + 1) * 4 + n * 4,
         walk + n * T),
        ("serving_leaf", "lightgbmv1_tpu/ops/predict_pallas.py:55",
         lambda: pc.serving_leaf(leaf_tables, codes, **kw),
         lambda: pc.serving_leaf_ref(leaf_tables, codes, **kw),
         n * F + T * (7 * L1 + 1) * 4 + n * T * 4,
         walk),
    ]
    for name, replaces, kern, plain, nbytes, gathers in specs:
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = gathers / GATHERS_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": SRC,
               "replaces": replaces, "launches": int(launches[name]),
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None, "rows": n, "walk_steps": steps,
               "gathers": gathers, "bytes": nbytes}
        log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, "
            f"{n / ms * 1e3:.3e} rows/s)")
        rows.append(row)
    # K4 at the server's buckets and the bulk chunk: the seven-table
    # walk's bound formula (walk_loads) beside K4's own words a step (a
    # 16-byte record and the code; a leaf value a walk) and its lanes'
    # use of the steps; K5 at the same sizes beside K4's leaf mode, each
    # with its device time and the lane efficiency of its mapping
    leaf_plan = pc.plan_leaf_walk(T=T, L1=L1, F=codes.shape[1],
                                  code_bytes=codes.element_size())
    sizes, leaf_sizes = [], []
    for m in (256, 512, 1024, n):
        sub = codes[:m]
        reps = 10 if m == n else 50
        _, st, ex = walk_counts(leaf_tables, sub, **kw)
        m_steps = int(st.sum())
        m_walk = load_count(st, ex)
        per_walk = kernel_steps(leaf_tables, st, t_pad)
        k_steps = int(per_walk.sum())
        ms = time_ms(lambda: pc.serving_fused(tables, sub, **fkw), reps)
        rec = {"rows": m, "ms": ms,
               "bound_ms": (m_walk + m * T) / GATHERS_PER_S * 1e3,
               "walk_loads": m_walk, "walk_steps": m_steps,
               "kernel_steps": k_steps, "smem_words_per_step": 5,
               "kernel_smem_words": 5 * k_steps + m * t_pad,
               "lane_efficiency": lane_efficiency(per_walk, tree_tile, 1),
               "tiles_per_block": pc.launch_shape(
                   m, tables, codes.shape[1] * codes.element_size(), dev)}
        rec.update(k4_device_ms(lambda: pc.serving_fused(tables, sub, **fkw)))
        dms = ("not measured" if rec["device_ms"] is None else
               f"{rec['device_ms']:.4f} ms on the device (walk "
               f"{rec['walk_device_ms']:.4f}, combine "
               f"{rec['combine_device_ms']:.4f})")
        log(f"  serving_fused at {m} rows: {ms:.4f} ms a call, {dms}, "
            f"bound {rec['bound_ms']:.4f} ms, lane efficiency "
            f"{rec['lane_efficiency']:.3f}, {rec['tiles_per_block']} row "
            "tiles a block")
        sizes.append(rec)
        rows[0][f"ms_at_{m}_rows"] = ms
        k5 = functools.partial(pc.serving_leaf, leaf_tables, sub, **kw)
        k4_leaf = functools.partial(pc.serving_fused, tables, sub,
                                    mode="leaf", **fkw)
        lrec = {"rows": m, "ms": time_ms(k5, reps),
                "k4_leaf_ms": time_ms(k4_leaf, reps),
                "bound_ms": m_walk / GATHERS_PER_S * 1e3,
                "walk_loads": m_walk, "walk_steps": m_steps,
                "lane_efficiency": leaf_lane_efficiency(st)}
        lrec["device_ms"] = k5_device_ms(k5)
        lrec["k4_leaf_device_ms"] = k4_device_ms(k4_leaf)["device_ms"]
        log(f"  serving_leaf at {m} rows: {lrec['ms']:.4f} ms a call, "
            f"{fmt_ms(lrec['device_ms'])} on the device; K4's leaf mode "
            f"{lrec['k4_leaf_ms']:.4f} ms, {fmt_ms(lrec['k4_leaf_device_ms'])}"
            f" on the device; bound {lrec['bound_ms']:.4f} ms, lane "
            f"efficiency {lrec['lane_efficiency']:.3f}")
        leaf_sizes.append(lrec)
        rows[1][f"ms_at_{m}_rows"] = lrec["ms"]
    rows[0]["sizes"] = sizes
    rows[0]["lane_efficiency"] = sizes[-1]["lane_efficiency"]
    rows[1]["sizes"] = leaf_sizes
    rows[1]["device_ms"] = leaf_sizes[-1]["device_ms"]
    rows[1]["lane_efficiency"] = leaf_sizes[-1]["lane_efficiency"]
    rows[1]["plan"] = leaf_plan
    rows[0]["plan"] = bp.fused_plan
    return rows


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def headline_logit(X):
    """bench.py:42 make_data's logit of six of the 28 features."""
    return (X[:, 0] * 1.2 - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
            + 0.4 * X[:, 4] + 0.3 * np.sin(3.0 * X[:, 5]))


def make_data(n, seed):
    """The JAX package's bench.py:42 make_data, copied: 28 standard-normal
    f32 features and a label from a noisy logit of six of them."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    y = (headline_logit(X) + rng.randn(n).astype(np.float32) > 0) \
        .astype(np.float64)
    return X, y


def k1_tol(absum: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """K1 against its plain version: both sum the same rounded parts in
    f32, in other orders (the plain version's index_add_ in atomic
    order).  A recursive f32 sum of n terms is off by at most n * 2^-24
    of the terms' absolute sum, so a cell of n rows agrees within twice
    that (+1e-6); a constant column (the first iteration's hessians) does
    drift that way, by its rounding bias."""
    return 2.0 * (count + 1.0) * 2.0 ** -24 * absum + 1e-6


def signed_rows(rng, n, dev) -> torch.Tensor:
    """(n, 3) f32 rows with signed normal grads, varied positive hessians
    and a count of 1 (tests/test_torch_hist.py's inputs, count aside)."""
    g3 = rng.randn(n, 3).astype(np.float32)
    g3[:, 1] = np.abs(g3[:, 1]) * 0.25
    g3[:, 2] = 1.0
    return torch.from_numpy(g3).to(dev).contiguous()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_k1(tag, binned, g3, lid, L, B=64, live=None) -> dict:
    """K1 against its plain versions on one input in all three precisions
    (``live``: the slots whose rows add, as the call gave it): bit for bit
    the row-order version (the kernel's order), and against the
    index_add_ version counts exact and every cell within ``k1_tol``; two
    launches bitwise equal; and the dead-slot limit — K1 with the last
    slot dead gives the all-live cells of the other slots bit for bit and
    a +0.0 dead slot.  Also names the pairs of precisions whose plain
    versions differ past the tolerance in some cell: on such an input the
    check would catch a kernel that computed the other precision."""
    absum = hc.index_add_hist(binned, [g3.abs()], lid, L, B, live)
    tol = k1_tol(absum, absum[..., 2:3])       # the count column is >= 0
    wants, err, rel_max = {}, 0.0, 0.0
    for prec in hc.FLOAT_PRECISIONS:
        got = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        again = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        want = wants[prec] = hc.hist_leaves_ref(binned, g3, lid, L, B, prec,
                                                live)
        row = hc.hist_leaves_roworder_ref(binned, g3, lid, L, B, prec, live)
        check(same_bits(got, row), f"K1 {tag} {prec}: not bitwise the "
              f"row-order version ({int((got != row).sum())} cells differ)")
        check(torch.equal(got[..., 2], want[..., 2]),
              f"K1 {tag} {prec}: counts differ")
        diff = (got - want).abs()
        over = int((diff > tol).sum())
        check(over == 0, f"K1 {tag} {prec}: {over} cells off tolerance")
        check(same_bits(got, again), f"K1 {tag} {prec}: two launches "
              "differ")
        full = hc.hist_leaves(binned, g3, lid, L, B, prec)
        dead = hc.hist_leaves(binned, g3, lid, L, B, prec, L - 1)
        check(same_bits(dead[:L - 1], full[:L - 1])
              and not bool(dead[L - 1].view(torch.int32).any()),
              f"K1 {tag} {prec}: the dead slot's rows changed a live cell "
              "or the dead slot is not 0")
        err = max(err, float(diff.max()))
        rel_max = max(rel_max, float((diff / (absum + 1e-30)).max()))
    seps = [f"{p}|{q}" for i, p in enumerate(hc.FLOAT_PRECISIONS)
            for q in hc.FLOAT_PRECISIONS[i + 1:]
            if bool(((wants[p] - wants[q]).abs() > tol).any())]
    log(f"  K1 {tag}: bitwise the row-order version, dead slot 0 and live "
        f"cells unchanged, counts exact, bitwise repeatable; vs index_add_ "
        f"max_abs_err={err:.3e}, max err/abs-sum {rel_max:.2e}; separates "
        f"{', '.join(seps) or 'no pair of precisions'}")
    return {"case": tag, "max_abs_err": err, "max_err_over_abs_sum": rel_max,
            "separates": seps, "bitwise_roworder": True,
            "dead_slot_ok": True}


def phase_hist_kernel(binned, dev, rng) -> list:
    """K1 against its plain version on the card at the main path's shape
    (the headline bins, random slots, signed varied rows) at each slot
    count of the path, and on the first 4,096 rows at 64 slots, where a
    cell holds a row or two: there the tolerance must tell every pair of
    precisions apart."""
    N = binned.shape[1]
    out = []
    # the headline wave's slot counts, then the sequential grower's one
    # slot and the level-wise grower's 65 (parents + the dead slot) and
    # 128 (a whole level), and 256: more than one slot group (64 slots a
    # block at bf16x2, 128 at bf16 and f32)
    for L in (2, 5, 17, 64, 1, 65, 128, 256):
        lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32)).to(dev)
        out.append(check_k1(f"N={N} L={L} signed rows", binned,
                            signed_rows(rng, N, dev), lid, L))
    n = 4096
    small = binned[:, :n].contiguous()
    lid = torch.from_numpy(rng.randint(0, 64, n).astype(np.int32)).to(dev)
    out.append(check_k1(f"N={n} L=64 signed rows", small,
                        signed_rows(rng, n, dev), lid, 64))
    check(len(out[-1]["separates"]) == 3, "the small K1 case does not tell "
          f"every pair of precisions apart: {out[-1]['separates']}")
    return out


class HistRecorder:
    """Keeps the inputs of the last K1 call at each (slots, precision) of a
    run: the main path's own shapes and data, at its latest iteration, for
    the checks and the timing after it.  It counts nothing; the wrapper
    counts its launches."""

    def __init__(self):
        self.last = {}
        # the packed leg's calls: (binned, g3, leaf_id, num_bins,
        # live_slots, num_features)
        self.packed_last = {}
        # an int8 call's rounded rows (the tree's quantize.NearestRows)
        self.rows8 = {}

    def __enter__(self):
        self._orig = hc.hist_leaves

        def wrapped(binned, g3, leaf_id, num_leaves, num_bins,
                    precision="bf16x2", live_slots=None, packed=False,
                    num_features=None, rows8=None, row_tile=None):
            key = (int(num_leaves), precision)
            if packed:
                self.packed_last[key] = (binned, g3, leaf_id, num_bins,
                                         live_slots, num_features)
            else:
                self.last[key] = (binned, g3, leaf_id, num_bins, live_slots)
            if precision == "int8":
                self.rows8[key] = rows8
            return self._orig(binned, g3, leaf_id, num_leaves, num_bins,
                              precision, live_slots, packed, num_features,
                              rows8, row_tile)

        hc.hist_leaves = wrapped
        return self

    def __exit__(self, *exc):
        hc.hist_leaves = self._orig


def phase_hist_main_inputs(rec: HistRecorder) -> list:
    """K1 against its plain versions on the main path's own inputs at each
    of its (slots, precision) keys, as its last iteration gave them (the
    live slots too)."""
    out = []
    for (L, prec), (binned, g3, label, B, live) in sorted(rec.last.items()):
        out.append(check_k1(f"main path L={L} live={live} ({prec} on the "
                            "path)", binned, g3, label, L, B, live))
    return out


def _on(dev) -> dict:
    """The entry points' own default is the card; name any other device."""
    return {} if torch.device(dev).type == "cuda" else {"device": dev}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_train(ds, dv, Xv, iters, dev):
    """The training main path (counts reset before, read after), then the
    saved model served through K4.  Returns its numbers and the K1 call
    record."""
    reset_counts()
    ev = {}
    with HistRecorder() as rec, ScanRecorder() as srec:
        t0 = time.perf_counter()
        booster = train(TRAIN_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    rec.scan_last = srec.last           # phase 31 times the split scan here
    launches = hc.launch_counts["hist_leaves"]
    buckets = {f"{L}:{prec}": v for (L, prec), v
               in sorted(hc.bucket_launch_counts.items())}
    plain = {**dict(hc.plain_counts),
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()}}
    k3 = fc.launch_counts["route_rows"]
    log(f"  K1 launches on the training path: {launches} "
        f"({json.dumps(buckets)}), K3 {k3}; plain-version calls: {plain}")
    want_k3 = k3_expected(booster, 1)
    check(k3 == want_k3, f"K3 launched {k3} times for {want_k3} trees of "
          "more than one leaf (one valid set)")
    check(launches > 0, "K1 never launched on the training path")
    check(sum(buckets.values()) == launches,
          "K1's launches by bucket do not add up to its launches")
    check(set(rec.last) == set(hc.bucket_launch_counts),
          f"K1 was called at {sorted(rec.last)} but launched at "
          f"{sorted(hc.bucket_launch_counts)}")
    check(not any(plain.values()),
          "a plain version ran on the training path")
    n = ds.num_data()
    trees = booster.num_trees()
    auc = ev["valid_0"]["auc"][-1]
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6,
           "valid_auc": auc, "valid_logloss": ev["valid_0"]["binary_logloss"][-1],
           "trees": trees, "leaves": [int(t.num_leaves) for t in
                                      booster._gbdt._device_trees[:3]],
           "k1_launches": launches, "k1_launches_by_bucket": buckets,
           "k3_launches": k3}
    log(f"  {iters} iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; valid AUC {auc:.5f} logloss "
        f"{out['valid_logloss']:.5f}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    out["split_scan"] = scan_launches(trees)
    log(f"  split-scan launches: {out['split_scan']['launches']} "
        f"({out['split_scan']['per_tree']:.2f} a tree)")
    out.update(text_hash(booster.model_to_string(), "staged"))
    out["max_abs_leaf"] = max_abs_leaf(booster)
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "trained_model.txt")
    return out, rec


def max_abs_leaf(booster) -> float:
    """The largest |leaf value| of a booster's trees."""
    return max(float(np.abs(t.leaf_value).max())
               for t in booster._all_trees())


# The model texts' sha256 (first 8 hex digits) a run at the default
# arguments writes, since the int8 legs' chunk count moved the int8 ones
# (lightgbmv1_tpu_torch/PERF.md §6): a kernel change that claims the same
# bits must keep every one.  main() gates on them at its defaults only.
TEXT_SHA = {
    "staged": "2f70fd68", "fused": "2f70fd68", "looped": "ab555744",
    **{f"int8sr {p}": "9cb41f19" for p in ("staged", "fused", "looped")},
    "packed staged": "2d313420", "packed fused": "3879b939",
    "packed looped": "cd0e138f", "regression": "edfe5496",
    "levelwise": "c8964080", "multiclass": "897fdf12",
    "lambdarank": "bbde5513",
    **{f"basic {p}": "466d723f" for p in ("staged", "fused")},
    **{f"intermediate {p}": "a97a6b24" for p in ("staged", "fused")},
    **{f"contri+smooth+max_output {p}": "94cb7dfb"
       for p in ("staged", "fused", "looped")},
    **{f"int8 {p}": "72e55fbf" for p in ("staged", "fused", "looped")},
    **{f"int8 deep {p}": "7d766b41" for p in ("staged", "fused")},
    **{f"sampled {p}": "394caec2" for p in ("staged", "fused")},
    **{f"sampled bag+tree {p}": "bba170e4" for p in ("fused", "looped")},
    "extra_trees staged": "63a2d740", "callbacks staged": "e3d3bfd1",
    "onehot staged": "9016f2fc", "int16 staged": "7bef7e87",
}
GATE_TEXT_SHA = False       # main() sets it at its default arguments


def text_hash(text: str, tag: str) -> dict:
    """The sha256 and length of a model text: the same bits from another
    build of the kernels give the same hash.  Under ``GATE_TEXT_SHA`` a
    text of ``TEXT_SHA`` must keep its hash."""
    out = {"model_text_sha256": hashlib.sha256(text.encode()).hexdigest(),
           "model_text_bytes": len(text)}
    log(f"  {tag} model text: sha256 {out['model_text_sha256']}, "
        f"{out['model_text_bytes']} bytes")
    want = TEXT_SHA.get(tag)
    if GATE_TEXT_SHA and want is not None:
        check(out["model_text_sha256"].startswith(want),
              f"the {tag} model text's sha256 moved from {want}...")
        out["model_text_sha256_kept"] = True
    return out


def serve_trained(booster, Xv, dev, name) -> float:
    """The trained model's text, loaded by ``Booster(model_file=...)``,
    serves the valid rows through K4 within the serving tolerance of the
    trainer's own (N, K) valid scores; returns the largest difference."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, name)
    booster.save_model(path)
    served = Booster(model_file=path, **_on(dev))
    check(served.num_trees() == booster.num_trees(), "saved model lost trees")
    raw = served.predict(Xv, predict_method="fused", raw_score=True)
    want = booster._gbdt._valid_scores[0].score.cpu().numpy()
    tol = raw_tol(served._all_trees())
    e = float(np.abs(raw.reshape(want.shape) - want).max())
    log(f"  saved model served through K4: max_abs_err vs the trainer's "
        f"valid scores {e:.3e} (tol {tol:.3e})")
    check(e <= tol, f"served model differs from the trainer by {e}")
    return e


PARITY_PARAMS = dict(TRAIN_PARAMS, num_leaves=63, leafwise_wave_size=32,
                     hist_dtype="f32", hist_method="pallas", metric="auc")


def phase_parity(seed, dev, n=65536) -> dict:
    """f32 trees on the card and on the CPU must split identically."""
    return same_splits(seed, n, {"card": (PARITY_PARAMS, dev),
                                 "CPU": (PARITY_PARAMS, "cpu")})


def same_splits(seed, n, runs) -> dict:
    """Two 5-iteration f32 trainings of ``n`` rows (``runs``: two labels
    -> (params, device)) must split identically at every node."""
    X, y = make_data(n, seed + 7)
    return split_parity(X, y, runs)


@contextlib.contextmanager
def roworder_plain():
    """K1's plain version on the CPU in the kernel's own order
    (``hist_leaves_roworder_ref``, which K1 equals bit for bit) instead
    of the index_add_ one."""
    saved = hc.hist_leaves_ref
    hc.hist_leaves_ref = hc.hist_leaves_roworder_ref
    try:
        yield
    finally:
        hc.hist_leaves_ref = saved


def split_parity(X, y, runs, iters=5, group=None, leaf_tol=None,
                 roworder=False) -> dict:
    """Two f32 trainings of the same rows (``runs``: two labels ->
    (params, device)) must split identically at every node of every tree;
    with ``leaf_tol`` every leaf value within ``leaf_tol`` of
    max(1, |leaf|) of the other's; with ``roworder`` a CPU run sums its
    histograms in K1's order (``roworder_plain``)."""
    saved = grower_wave._BUCKET_MIN_N
    grower_wave._BUCKET_MIN_N = 1
    boosters = []
    try:
        for p, d in runs.values():
            on_cpu = torch.device(d).type == "cpu"
            with (roworder_plain() if roworder and on_cpu
                  else contextlib.nullcontext()):
                boosters.append(train(p, Dataset(X, label=y, group=group),
                                      iters, device=d))
    finally:
        grower_wave._BUCKET_MIN_N = saved
    return compare_splits("parity", *boosters, tuple(runs), leaf_tol)


def compare_splits(tag, a, b, names, leaf_tol=None) -> dict:
    """Two boosters' trees split identically at every node; with
    ``leaf_tol`` every leaf value within ``leaf_tol`` of max(1, |leaf|)
    of the other's."""
    nodes, leaf_err, leaf_rel = 0, 0.0, 0.0
    trees = list(zip(a._all_trees(), b._all_trees()))
    for tg, tc in trees:
        n = tc.num_leaves - 1
        check(tg.num_leaves == tc.num_leaves, f"{tag}: leaf counts differ")
        check(np.array_equal(tg.split_feature, tc.split_feature)
              and np.array_equal(tg.threshold_bin, tc.threshold_bin),
              f"{tag}: split features / threshold bins differ")
        nodes += n
        d = np.abs(tg.leaf_value - tc.leaf_value)
        leaf_err = max(leaf_err, float(d.max()))
        leaf_rel = max(leaf_rel, float((d / np.maximum(
            1.0, np.abs(tc.leaf_value))).max()))
    log(f"  f32 trees, {' vs '.join(names)}: {nodes} nodes of {len(trees)} "
        f"trees identical (features, threshold bins); max leaf-value diff "
        f"{leaf_err:.3e} ({leaf_rel:.3e} of max(1, |leaf|))")
    if leaf_tol is not None:
        check(leaf_rel <= leaf_tol, f"{tag}: leaf values {leaf_rel:.3e} "
              f"of max(1, |leaf|) apart, past {leaf_tol}")
    return {"nodes": nodes, "trees": len(trees), "max_leaf_diff": leaf_err,
            "max_leaf_diff_rel": leaf_rel}


def phase_hist_timing(rec: HistRecorder, trained: dict, checks: list
                      ) -> dict:
    """K1 at each slot bucket of the main path, on the inputs of its last
    call there, beside its plain version, one ``index_add_`` and its
    bound; returns the kernels-line row (top level: the largest
    bucket)."""
    buckets = []
    n_trees = trained["trees"]
    for (L, prec), (binned, g3, label, B, live_slots) in sorted(
            rec.last.items()):
        Fn, N = binned.shape
        ms = time_ms(lambda: hc.hist_leaves(binned, g3, label, L, B, prec,
                                            live_slots), 10)
        plain_ms = time_ms(lambda: hc.hist_leaves_ref(
            binned, g3, label, L, B, prec, live_slots), 2)
        flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
                 + label.long()[None, :]) * B + binned.long()).reshape(-1)
        vals = g3.repeat(Fn, 1)
        acc = torch.zeros((Fn * L * B, 3), dtype=torch.float32,
                          device=binned.device)
        library_ms = time_ms(lambda: acc.index_add_(0, flat, vals), 5)
        # the live rows: those of the slots below live_slots (a wave
        # round's last slot is its dead one, hist_wave)
        lim = L if live_slots is None else int(live_slots)
        live = int(((label >= 0) & (label < lim)).sum())
        nbytes = Fn * N + N * 12 + N * 4 + L * Fn * B * 3 * 4
        ops = (2 if prec == "bf16x2" else 1) * 3 * live * Fn
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        b = {"slots": lim, "L": L, "N": N, "precision": prec, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops,
             "launches": trained["k1_launches_by_bucket"].get(f"{L}:{prec}",
                                                              0)}
        b["launches_per_tree"] = b["launches"] / n_trees
        buckets.append(b)
        log(f"  K1 L={L} ({prec}): {ms:.3f} ms (plain {plain_ms:.1f} ms, "
            f"index_add_ {library_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"by {b['bound_by']}), {b['launches_per_tree']:.2f} launches "
            f"a tree")
    top = max(buckets, key=lambda b: b["L"])
    return {"name": "hist_leaves", "route": "cuda", "source": HIST_SRC,
            "replaces": "lightgbmv1_tpu/ops/hist_pallas.py:95",
            "launches": int(trained["k1_launches"]),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_err_over_abs_sum": max(c["max_err_over_abs_sum"]
                                        for c in checks),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": f"L={top['L']} "
            f"{top['precision']}", "buckets": buckets, "checks": checks}

def phase_profile(ds, iters, dev, params=TRAIN_PARAMS) -> dict:
    """Where an iteration's time goes: ``iters`` headline iterations
    under torch.profiler (after one warm-up), device time by kernel and
    the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    booster = Booster(params, train_set=ds, **_on(dev))
    booster.update()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        _sync(dev)
        wall = time.perf_counter() - t0

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # the kernels themselves (the ops that launched them carry the same
    # device time again)
    kern = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and dev_us(e) > 0), key=lambda r: -r[1])
    total_us = sum(us for _, us, _ in kern)
    out = {"iters": iters, "wall_ms_per_iter": wall / iters * 1e3,
           "device_ms_per_iter": total_us / iters / 1e3,
           "device_busy_share": (total_us / 1e6 / wall) if kern else None,
           "top": [{"kernel": k[:80], "ms_per_iter": us / iters / 1e3,
                    "calls_per_iter": c / iters} for k, us, c in kern[:10]]}
    if not kern:
        log("  the profiler recorded no device time: not measured")
        return out
    log(f"  {iters} iterations profiled: {out['wall_ms_per_iter']:.1f} ms "
        f"wall, {out['device_ms_per_iter']:.1f} ms device an iteration "
        f"(busy {out['device_busy_share']:.1%})")
    for r in out["top"]:
        log(f"    {r['ms_per_iter']:8.3f} ms  {r['calls_per_iter']:7.1f}x  "
            f"{r['kernel']}")
    return out


# ---------------------------------------------------------------------------
# the fused round (K2) and the valid routing (K3)
# ---------------------------------------------------------------------------


def round_inputs(binned, meta, S, n_live, sub, prec, rng, oleaf=None,
                 leafs=None, B=64):
    """One wave round's inputs at ``S`` slots (``n_live`` splits, the rest
    dead): rows spread over ``2S + 7`` current leaves (or ``oleaf``),
    random splits (of the leaves ``leafs``) on the dataset's own features
    (real missing types), signed varied rows, the children's exact sums
    and, in subtraction mode, the parents' histograms.  Returns the
    keyword arguments of ``fc.fused_round`` on the (F, N) byte bins
    ``binned`` of a ``B``-bin axis."""
    F, N = binned.shape
    dev = binned.device
    n_cur = 2 * S + 7
    L = n_cur + S                     # dead slots carry leaf L: no row's

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    oleaf = t(rng.randint(0, n_cur, N) if oleaf is None else oleaf)
    nb = meta.num_bins.cpu().numpy()
    feats = rng.randint(0, F, n_live)
    thrs = np.array([rng.randint(0, max(int(nb[f]) - 1, 1)) for f in feats])

    def pad(v, fill):
        return np.concatenate([v, np.full(S - n_live, fill, v.dtype)])

    feats_s = t(pad(feats, 0))
    rmeta = wf.pack_route_meta(
        feats_s, t(pad(thrs, 0)), t(pad(rng.rand(n_live) < 0.5, False),
                                    torch.bool),
        t(pad(rng.choice(n_cur, n_live, replace=False) if leafs is None
              else np.asarray(leafs), L)),
        t(pad(n_cur + np.arange(n_live), 0)), meta,
        sml=t(pad(rng.rand(n_live) < 0.5, False), torch.bool))
    route = {"oleaf": oleaf, "feats": feats_s, "rmeta": rmeta,
             "num_leaves": L}
    g3 = signed_rows(rng, N, dev)
    dbin = wf.decision_bins(binned, oleaf, feats_s, rmeta[:, 0], L)
    _, child = wf.route_tile(dbin, oleaf, rmeta, nslots=2 * S, sub=False)
    csums = torch.zeros((2 * S + 1, 3), dtype=torch.float32,
                        device=dev).index_add_(0, child.long(), g3)[:2 * S]
    live_c = torch.arange(2 * S, device=dev) < 2 * n_live
    csums[~live_c] = 1.0
    kw = dict(nslots=S if sub else 2 * S, num_bins=B, precision=prec,
              meta=meta, params=SplitParams(min_data_in_leaf=20.0),
              mask=live_c[:, None].expand(2 * S, F).contiguous(),
              csums=csums, route=route)
    if sub:
        # each live slot's parent: the histogram of its leaf's rows
        slot_of = torch.full((n_cur + 1,), S, dtype=torch.int32, device=dev)
        slot_of[rmeta[:n_live, 0].long()] = torch.arange(
            n_live, dtype=torch.int32, device=dev)
        kw["parent"] = hc.index_add_hist(binned, [g3], slot_of[oleaf.long()],
                                         S + 1, B)[:S].contiguous()
        kw["sml"] = rmeta[:, 7] != 0
    return g3, kw


def same_value(a, b) -> torch.Tensor:
    """Elementwise: equal, or both NaN."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def gain_bound(left2, csums, gains, shift, lbound, params) -> torch.Tensor:
    """(C, F) bound on a gain's difference between two scans whose left
    sums differ by at most ``lbound`` (C, F, 3): over the feature's valid
    candidates, the gain's derivative in the left grad and hessian sums
    times that, plus eight f32 roundings of its terms on each side."""
    L = left2.double()                                   # (C, 2, F, B, 3)
    R = csums.double()[:, None, None, None, :] - L
    hl = L[..., 1] + params.lambda_l2
    hr = R[..., 1] + params.lambda_l2
    ql, qr = L[..., 0].abs() / hl, R[..., 0].abs() / hr
    dg = lbound.double()[:, None, :, None, 0]
    dh = lbound.double()[:, None, :, None, 1]
    b = (2 * (ql + qr) * dg + (ql * ql + qr * qr) * dh
         + 8 * 2.0 ** -24 * (ql * L[..., 0].abs() + qr * R[..., 0].abs()
                             + shift.double().abs()[:, None, None, None]))
    b = torch.where(torch.isfinite(gains), b, torch.zeros_like(b))
    return b.amax(dim=(1, 3)) + 1e-6


def check_pick(tag, res, kw) -> int:
    """The pick kernel on a K2 round's residue ``res`` bit for bit its
    plain version (``pick_pack``) run on the CPU on the same residue, and
    two launches bitwise equal; returns the children with a finite
    gain."""
    pkw = dict(meta=kw["meta"], params=kw["params"],
               parent_output=kw.get("parent_output"),
               num_bins=kw["num_bins"])
    got = sc.split_pick(res, kw["csums"], **pkw)
    again = sc.split_pick(res, kw["csums"], **pkw)
    check(bool(same_value(got, again).all()),
          f"pick {tag}: two launches differ")
    want = sc.pick_ref(res.cpu(), kw["csums"].cpu(), **to_cpu(pkw))
    bad = int((~same_value(got.cpu(), want)).sum())
    check(bad == 0, f"pick {tag}: {bad} packed values differ from the CPU "
          "pick_pack")
    return int(torch.isfinite(want[:, 0]).sum())


def check_k2(tag, binned, g3, kw) -> dict:
    """K2 (and K3 on the same rows) against the plain versions on one
    round's inputs, and the pick kernel on K2's residue bit for bit the
    CPU pick; returns what was measured."""
    S = kw["nslots"] if kw.get("parent") is not None else kw["nslots"] // 2
    C, F, B = 2 * S, binned.shape[0], kw["num_bins"]
    prec, meta, params = kw["precision"], kw["meta"], kw["params"]
    got = fc.fused_round(binned, g3, **kw)
    again = fc.fused_round(binned, g3, **kw)
    want = fc.fused_round_ref(binned, g3, **kw)
    res, hsm, nleaf, label = got
    for a, b, what in zip(got, again, ("residue", "hsmall", "new leaf ids",
                                       "label")):
        check(a is None or bool(same_value(a, b).all()),
              f"K2 {tag}: two launches differ in {what}")
    check(torch.equal(nleaf, want[2]), f"K2 {tag}: new leaf ids differ")
    check(torch.equal(label, want[3]), f"K2 {tag}: labels differ")
    route = kw["route"]
    k3 = fc.route_rows(binned, route["oleaf"], route["feats"],
                       route["rmeta"], route["num_leaves"])
    check(torch.equal(k3, nleaf), f"K3 {tag}: differs from K2's leaf ids")
    check(torch.equal(k3, fc.route_rows_ref(
        binned, route["oleaf"], route["feats"], route["rmeta"],
        route["num_leaves"])), f"K3 {tag}: differs from its plain version")
    # K2's histograms are K1's on the emitted label, bit for bit
    k1 = hc.hist_leaves(binned, g3, label, kw["nslots"] + 1, B,
                        prec)[:kw["nslots"]]
    if hsm is not None:
        check(torch.equal(hsm, k1), f"K2 {tag}: hsmall differs from K1")
        children = wf.subtract_children(hsm, kw["parent"], kw["sml"])
    else:
        children = k1
    # the plain scan on the CPU, on the same histograms
    res_cpu = scan_residue(children.cpu(), kw["mask"].cpu(),
                           kw["csums"].cpu(), meta=to_cpu(meta),
                           params=params).to(binned.device)
    bitwise_cpu = bool(same_value(res, res_cpu).all())
    # the plain version on the card: picks outside ties, values in bound
    left2 = scan_left_sums(children, meta)
    gains, shift = scan_direction_gains(left2, kw["csums"], meta,
                                        kw["mask"], params)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)
    pres = want[0]
    fbest_p = pres[..., 0]
    band = TIE_RTOL * (shift.abs()[:, None] + torch.where(
        torch.isfinite(fbest_p), fbest_p.abs(), torch.zeros_like(fbest_p)))
    sel_k, sel_p = res[..., 2].long(), pres[..., 2].long()
    g_at_k = torch.gather(gains_f, 2, sel_k[..., None])[..., 0]
    pick_off = (sel_k != sel_p) & ~(g_at_k >= fbest_p - 2 * band)
    check(not bool(pick_off.any()), f"K2 {tag}: {int(pick_off.sum())} "
          "picks differ from the plain version outside the tie band")
    fin = torch.isfinite(fbest_p) & (sel_k == sel_p)
    # the card's plain version scans its left sums in f32 in another
    # order: each is within 2 B 2^-24 of its channel's absolute sum
    absum = children.abs().sum(dim=2)                    # (C, F, 3)
    lbound = 2 * B * 2.0 ** -24 * absum + 1e-6
    err_l = torch.where(fin[..., None], (res[..., 3:] - pres[..., 3:]).abs(),
                        torch.zeros_like(lbound))
    check(bool((err_l <= lbound).all()), f"K2 {tag}: left sums off by "
          f"{float(err_l.max()):.3e} past 2 B 2^-24 of their absolute sum")
    bound = gain_bound(left2, kw["csums"], gains, shift, lbound, params)
    err_g = torch.where(fin, (res[..., :2] - pres[..., :2]).abs().amax(-1),
                        torch.zeros_like(fbest_p))
    check(bool(((err_g <= bound) | ~fin).all()), f"K2 {tag}: gains off by "
          f"{float(err_g.max()):.3e} past the bound the left sums' carries")
    # the cross-feature half on both residues
    shift_c = gain_shift(kw["csums"], params)
    pk = pick_pack(res, shift_c, kw["csums"], meta, B)
    pp = pick_pack(pres, shift_c, kw["csums"], meta, B)
    fk, fp = pk[:, 1].long(), pp[:, 1].long()
    ci = torch.arange(C, device=binned.device)
    gb = fbest_p.max(dim=1).values
    gband = TIE_RTOL * (shift_c.abs() + torch.where(
        torch.isfinite(gb), gb.abs(), torch.zeros_like(gb)))
    feat_off = (fk != fp) & ~(fbest_p[ci, fk] >= gb - 2 * gband)
    check(not bool(feat_off.any()), f"K2 {tag}: {int(feat_off.sum())} "
          "children pick another feature outside the tie band")
    out = {"case": tag, "residue_bitwise_cpu_plain": bitwise_cpu,
           "pick_finite": check_pick(f"K2 {tag}", res, kw),
           "sel_diff_in_band": int((sel_k != sel_p).sum()),
           "feature_diff_in_band": int((fk != fp).sum()),
           "max_gain_err": float(err_g.max()),
           "max_left_err": float(err_l.max()),
           "rows_in_slots": int((label < kw["nslots"]).sum())}
    log(f"  K2 {tag}: {out['rows_in_slots']} live rows; leaf ids, labels, "
        "K3 exact; hsmall "
        f"{'== K1' if hsm is not None else '(pool-free)'}; residue "
        f"{'bitwise equal to' if bitwise_cpu else 'differs from'} the CPU "
        "plain scan; the pick kernel on it bit for bit the CPU pick; vs "
        f"the card's plain version {out['sel_diff_in_band']}"
        f" picks / {out['feature_diff_in_band']} features differ in the "
        f"tie band, max gain err {out['max_gain_err']:.2e}, left "
        f"{out['max_left_err']:.2e}")
    return out


def sparse_leaves(N, chunk_rows, case):
    """Leaf ids for a sparse-live round whose one split takes leaf 1: the
    rows that stay in leaf 0 add to no histogram.  ``one row``: a single
    row in leaf 1; ``one chunk``: the rows of one row chunk of the plan;
    ``none``: no row (the split's leaf is empty); ``root``: every row in
    leaf 1, a root-sized round."""
    oleaf = np.zeros(N, np.int64)
    if case == "one row":
        oleaf[N // 2 + 17] = 1
    elif case == "one chunk":
        c = (N // chunk_rows) // 2
        oleaf[c * chunk_rows:(c + 1) * chunk_rows] = 1
    elif case == "root":
        oleaf[:] = 1
    return oleaf


# K3 routes a row set from the root through all of a tree's rounds in one
# launch: rows a synthetic tree, the recorded trees and their 1,001-row
# heads are held to
K3_HEAD_ROWS = 1001


def synthetic_rounds(rng, round_sizes, meta, dev):
    """A tree grown in rounds: round q splits up to ``round_sizes[q]`` of
    the leaves so far, picked at random, on random features and bins
    inside each feature's bin count, leaf j + 1 the right child of node j
    (the grower's numbering).  Returns ``(feats, thrs, dls, leafs, nls)``
    int32 in round order, the (R + 1,) offsets and the leaf count."""
    nb = meta.num_bins.cpu().numpy()
    leafs, sizes, nl = [], [], 1
    for want in round_sizes:
        n = min(want, nl)
        leafs.append(rng.choice(nl, n, replace=False))
        sizes.append(n)
        nl += n
    leafs = np.concatenate(leafs)
    P = leafs.shape[0]
    feats = rng.randint(0, nb.shape[0], P)
    thrs = np.array([rng.randint(0, max(int(nb[f]) - 1, 1)) for f in feats])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    return ((t(feats), t(thrs), t(rng.rand(P) < 0.5), t(leafs),
             t(np.arange(1, P + 1))), t(np.cumsum([0] + sizes)), nl)


def tree_of_rounds(feats, thrs, dls, leafs, meta) -> "TreeArrays":
    """The tree whose node j is split j of the rounds (it splits leaf
    ``leafs[j]`` into that leaf and leaf j + 1), with the child pointers
    ``tree_leaf_index_binned`` walks."""
    P = feats.shape[0]
    left, right, _ = child_pointers(leafs.tolist(), P + 1)
    dev = feats.device
    i32 = torch.int32
    return empty_tree(P + 1, dev)._replace(
        num_leaves=torch.tensor(P + 1, dtype=i32, device=dev),
        split_feature=feats, threshold_bin=thrs, default_left=dls != 0,
        missing_type=meta.missing_type[feats.long()].to(i32),
        left_child=torch.from_numpy(left).to(dev),
        right_child=torch.from_numpy(right).to(dev))


def single_rounds(binned, lids, feats, rmeta, offsets, num_leaves,
                  packed=False):
    """K3 launched once a round, R launches (the routing as it ran before
    a tree's rounds took one launch)."""
    bounds = offsets.tolist()
    for o0, o1 in zip(bounds[:-1], bounds[1:]):
        lids = fc.route_rows(binned, lids, feats[o0:o1].contiguous(),
                             rmeta[o0:o1].contiguous(), num_leaves,
                             packed=packed)
    return lids


def check_k3_tree(tag, binned, feats, rmeta, offsets, num_leaves, tree,
                  meta, packed=False, u8=None) -> list:
    """K3 on one tree's rounds from the root, at all of ``binned``'s rows
    and at its first K3_HEAD_ROWS: leaf ids bitwise its plain version run
    round after round on the card, R single-round launches, the tree walk
    of ``tree`` and a second launch; packed, also its u8 leg on ``u8``."""
    out = []
    P, R = rmeta.shape[0], offsets.shape[0] - 1
    # the kernel's leg: the tables in each block's shared memory up to
    # K3_SMEM_BYTES, past it built once in device memory (the CPU's plain
    # version has none)
    smem = 4 * (P * (wf.RMETA_COLS + 3) + R + 1) <= K3_SMEM_BYTES \
        if binned.is_cuda else None
    for n in (binned.shape[1], K3_HEAD_ROWS):
        b = binned[:, :n].contiguous()
        lids = torch.zeros(n, dtype=torch.int32, device=b.device)
        args = (b, lids, feats, rmeta, num_leaves)
        got = fc.route_rows(*args, packed=packed, offsets=offsets)
        check(torch.equal(got, fc.route_rows(*args, packed=packed,
                                             offsets=offsets)),
              f"K3 {tag} N={n}: two launches differ")
        check(torch.equal(got, fc.route_rows_ref(*args, packed, offsets)),
              f"K3 {tag} N={n}: differs from its plain version")
        check(torch.equal(got, single_rounds(*args[:4], offsets, num_leaves,
                                             packed)),
              f"K3 {tag} N={n}: differs from {R} single-round launches")
        walk = tree_leaf_index_binned(tree, b, meta.nan_bin,
                                      meta.missing_type, meta.zero_bin,
                                      packed)
        check(torch.equal(got, walk.to(torch.int32)),
              f"K3 {tag} N={n}: differs from the tree walk")
        if u8 is not None:
            check(torch.equal(got, fc.route_rows(
                u8[:, :n].contiguous(), lids, feats, rmeta, num_leaves,
                offsets=offsets)), f"K3 {tag} N={n}: differs from the u8 leg")
        moved = int((got != 0).sum())
        where = {True: "tables in shared memory", None: "plain version",
                 False: "tables in device memory"}[smem]
        log(f"  K3 {tag}, {n} rows, {P} splits in {R} rounds ({where}): "
            f"{moved} rows off the root; bitwise the plain version, R single-round "
            "launches, the tree walk" + (", the u8 leg" if u8 is not None else ""))
        out.append({"case": f"{tag} N={n}", "splits": P, "rounds": R,
                    "tables_in_shared_memory": smem, "rows_moved": moved,
                    "max_abs_err": 0.0})
    return out


def phase_k3_synthetic(binned, meta, rng) -> list:
    """K3 on two synthetic trees at VALID_ROWS of ``binned``'s rows: 2,295
    splits in 16 rounds (1, 2, 4, ... 128, then 255 a round: tables past
    a block's shared memory) and 10 rounds of up to 63 splits."""
    out = []
    b = binned[:, :VALID_ROWS].contiguous()
    for tag, sizes in (("synthetic 2,295 splits",
                        [1, 2, 4, 8, 16, 32, 64, 128] + [255] * 8),
                       ("synthetic 10 rounds", [1, 2, 4, 8, 16, 32, 63, 63,
                                                63, 2])):
        (feats, thrs, dls, leafs, nls), offsets, nl = synthetic_rounds(
            rng, sizes, meta, b.device)
        rmeta = wf.pack_route_meta(feats, thrs, dls, leafs, nls, meta)
        out += check_k3_tree(tag, b, feats, rmeta, offsets, nl,
                             tree_of_rounds(feats, thrs, dls, leafs, meta),
                             meta)
    check(out[0]["tables_in_shared_memory"] is False
          and out[2]["tables_in_shared_memory"] is True,
          "the synthetic trees do not take both of K3's legs")
    return out


K3_SMEM_BYTES = 48 * 1024     # csrc/wave_fused.cu kRouteSmemBytes


def k3_bound(binned, feats, rmeta, offsets, num_leaves, packed=False):
    """K3's bound by bytes on one call from the root: each row's leaf id
    read (4 B) and written (4 B), one bin byte for each round in which
    its leaf splits (this run's rows, counted round by round with the
    plain version), and the tables read once (feats, rmeta, offsets)."""
    N = binned.shape[1]
    lids = torch.zeros(N, dtype=torch.int32, device=binned.device)
    bounds = offsets.tolist()
    reads = 0
    for o0, o1 in zip(bounds[:-1], bounds[1:]):
        splits = torch.zeros(num_leaves + 1, dtype=torch.bool,
                             device=binned.device)
        splits[rmeta[o0:o1, 0].long()] = True
        reads += int(splits[lids.long()].sum())
        lids = fc.route_rows_ref(binned, lids, feats[o0:o1], rmeta[o0:o1],
                                 num_leaves, packed)
    nbytes = N * 8 + reads + 4 * (feats.numel() + rmeta.numel()
                                  + offsets.numel())
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "bin_reads": reads}


def k3_expected(booster, n_valid) -> int:
    """K3's launches on a wave-grown training: one a tree of more than
    one leaf and valid set."""
    return n_valid * sum(int(t.num_leaves) > 1
                         for t in booster._gbdt._device_trees)


def phase_fused_kernels(binned, meta, rng) -> list:
    """K2 and K3 against their plain versions on the headline bins; then
    the sparse-live rounds (``sparse_leaves``: one live row, live rows in
    one chunk only, none, and every row live), each bitwise as above."""
    out = []
    for S, n_live, sub in ((4, 3, True), (16, 16, True), (63, 63, True),
                           (63, 63, False)):
        for prec in hc.FLOAT_PRECISIONS:
            g3, kw = round_inputs(binned, meta, S, n_live, sub, prec, rng)
            out.append(check_k2(f"S={S} {'sub' if sub else 'pool-free'} "
                                f"{prec}", binned, g3, kw))
    F, N = binned.shape
    for case, sub in (("one row", False), ("one chunk", True),
                      ("none", True), ("root", False)):
        for prec in hc.FLOAT_PRECISIONS:
            chunk_rows = hc.plan(N, F, (4 if sub else 8) + 1, 64,
                                 prec)["chunk_rows"]
            g3, kw = round_inputs(binned, meta, 4, 1, sub, prec, rng,
                                  oleaf=sparse_leaves(N, chunk_rows, case),
                                  leafs=[1])
            out.append(check_k2(f"sparse {case}, S=4 "
                                f"{'sub' if sub else 'pool-free'} {prec}",
                                binned, g3, kw))
            live = out[-1]["rows_in_slots"]
            want = {"one row": live == 1, "one chunk": 0 < live <= chunk_rows,
                    "none": live == 0, "root": live == N}[case]
            check(want, f"K2 sparse {case}: {live} live rows")
    return out


class FusedRecorder:
    """Keeps the inputs of the last K2 call at each (nslots, precision,
    mode) of a run, and of the last K3 call (the last tree's valid
    routing, with ``offsets``; ``tree`` / ``meta`` that tree, set by the
    caller): the main path's own shapes
    and data, for the checks and the timing after it; and, with ``live``,
    each K2 launch's live rows (label below nslots: the rows its
    histograms add), in launch order, summed on the card: a probe that
    costs a reduction a launch, so a timed run goes without it.  It
    counts nothing; the wrappers count their launches."""

    def __init__(self, live=False):
        self.last = {}
        self.route = self.packed_route = None
        self.tree = self.meta = None   # the run's last tree and its meta
        self.count_live = live
        self.live = []      # (nslots, precision, mode), live rows, N

    def __enter__(self):
        self._orig = fc.fused_round, fc.route_rows

        def fused(binned, g3, **kw):
            mode = ("sub" if kw.get("parent") is not None else "pool") + (
                ":packed" if kw.get("packed") else "")
            key = (kw["nslots"], kw["precision"], mode)
            self.last[key] = (binned, g3, kw)
            out = self._orig[0](binned, g3, **kw)
            if self.count_live:
                self.live.append((key, (out[3] < kw["nslots"]).sum(),
                                  binned.shape[1]))
            return out

        def route(binned, lids, feats, rmeta, num_leaves, packed=False,
                  offsets=None):
            args = (binned, lids, feats, rmeta, num_leaves, offsets)
            if packed:
                self.packed_route = args
            else:
                self.route = args
            return self._orig[1](*args[:5], packed=packed, offsets=offsets)

        fc.fused_round, fc.route_rows = fused, route
        return self

    def __exit__(self, *exc):
        fc.fused_round, fc.route_rows = self._orig


def live_share(records) -> dict:
    """Per slot bucket ("nslots:precision:mode"): the rounds, their mean
    live share (live rows over N) and its distribution, from (key, live
    rows, N) records."""
    by = {}
    for (ns, prec, mode), live, n in records:
        by.setdefault(f"{ns}:{prec}:{mode}", []).append(int(live) / n)
    out = {}
    for key, v in sorted(by.items()):
        a = np.asarray(v)
        out[key] = {"rounds": len(v), "mean": float(a.mean()),
                    **{f"p{q}": float(np.percentile(a, q))
                       for q in (0, 10, 50, 90, 100)}}
        log(f"  live share {key}: {len(v)} rounds, mean {a.mean():.4f}, "
            "p0/p10/p50/p90/p100 " + " / ".join(
                f"{out[key][f'p{q}']:.4f}" for q in (0, 10, 50, 90, 100)))
    return out


def live_rows_run(params, ds, iters, dev, text):
    """The training of a timed run again, untimed, with each K2 launch's
    live rows counted (``FusedRecorder(live=True)``): training is
    deterministic, so its rounds are the timed run's, and its model text
    must be ``text``.  Returns the recorder and the live shares."""
    with FusedRecorder(live=True) as rec:
        probe = train(params, ds, iters, **_on(dev))
        _sync(dev)
    check(probe.model_to_string() == text, "the live-row probe's model "
          "text differs from the timed run's")
    return rec, live_share(rec.live)


def reset_counts() -> None:
    for mod in (hc, fc, pc, lc, qz, sc):
        mod.reset_launch_counts()
    hg.reset_matmul_counts()


def phase_fused_train(ds, dv, Xv, iters, dev, staged):
    """The fused training main path (counts reset before, read after),
    then the saved model served through K4."""
    reset_counts()
    ev = {}
    with FusedRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(FUSED_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    k2 = fc.launch_counts["fused_round"]
    k3 = fc.launch_counts["route_rows"]
    k1 = hc.launch_counts["hist_leaves"]
    rec.tree, rec.meta = booster._gbdt._device_trees[-1], booster._gbdt.meta
    buckets = {f"{ns}:{prec}:{mode}": v for (ns, prec, mode), v
               in sorted(fc.bucket_launch_counts.items())}
    picks = sc.launch_counts["split_pick"]
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
             **{f"scan.{k}": v for k, v in sc.plain_counts.items()}}
    trees = booster.num_trees()
    log(f"  launches on the fused path: K2 {k2} ({json.dumps(buckets)}), "
        f"K3 {k3}, K1 {k1}, the pick kernel {picks}; plain-version calls: "
        f"{plain}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(k2 > 0, "K2 never launched on the fused path")
    check(sum(buckets.values()) == k2,
          "K2's launches by bucket do not add up to its launches")
    check(set(rec.last) == set(fc.bucket_launch_counts),
          f"K2 was called at {sorted(rec.last)} but launched at "
          f"{sorted(fc.bucket_launch_counts)}")
    want_k3 = k3_expected(booster, 1)
    check(k3 == want_k3, f"K3 launched {k3} times for {want_k3} trees of "
          "more than one leaf (one valid set)")
    check(picks == k2, f"the pick kernel launched {picks} times for {k2} "
          "rounds")
    check(k1 == trees, f"K1 launched {k1} times for {trees} root passes")
    check(not any(plain.values()), "a plain version ran on the fused path")
    scan = scan_launches(trees)
    check(scan["launches"] == trees, "the fused path's split scans: "
          f"{scan['launches']} for {trees} root passes")
    text = booster.model_to_string()
    log("  K2's live rows on the fused path (label below nslots), from a "
        "second, untimed run of the same training:")
    live = live_rows_run(FUSED_PARAMS, ds, iters, dev, text)[1]
    n = ds.num_data()
    auc = ev["valid_0"]["auc"][-1]
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6, "valid_auc": auc,
           "valid_logloss": ev["valid_0"]["binary_logloss"][-1],
           "auc_minus_staged": auc - staged["valid_auc"], "trees": trees,
           "k2_launches": k2, "k2_launches_by_bucket": buckets,
           "k2_launches_per_tree": k2 / trees, "k3_launches": k3,
           "k1_launches": k1, "split_pick_launches": picks,
           "live_share": live}
    log(f"  {iters} fused iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; valid AUC {auc:.5f} (staged {staged['valid_auc']:.5f}"
        f"), logloss {out['valid_logloss']:.5f}; K2 "
        f"{out['k2_launches_per_tree']:.2f} launches a tree")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    check(abs(auc - staged["valid_auc"]) <= 2e-3,
          f"fused AUC {auc} is more than 2e-3 from the staged {staged}")
    out["split_scan"] = scan
    out.update(text_hash(text, "fused"))
    check(out["model_text_sha256"] == staged["model_text_sha256"],
          "the fused model text differs from the staged one")
    log("  fused model text == staged model text, byte for byte")
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "fused_model.txt")
    return out, rec


def phase_fused_main_inputs(rec: FusedRecorder) -> list:
    """K2 against its plain version on the main path's last inputs at each
    of its (nslots, precision, mode) keys."""
    return [check_k2(f"main path nslots={ns} {prec} {mode}", binned, g3, kw)
            for (ns, prec, mode), (binned, g3, kw) in sorted(rec.last.items())]


def live_row_bytes(N, Fn, live) -> int:
    """The row bytes of a round's work when only its live rows are read
    (the live-row bound): one pass over the leaf ids (read and written)
    and the labels (written), and the live rows' bins and (N, 3) rows.
    The all-rows bound reads every row's bins and rows instead."""
    return 3 * N * 4 + live * (Fn + 12)


def phase_fused_timing(rec: FusedRecorder, trained: dict, checks: list
                       ) -> list:
    """K2 at each slot bucket of the main path and K3, on their last
    inputs, beside their plain versions and bounds by bytes."""
    rows, buckets = [], []
    n_trees = trained["trees"]
    for (ns, prec, mode), (binned, g3, kw) in sorted(rec.last.items()):
        Fn, N = binned.shape
        B = kw["num_bins"]
        S = ns if mode == "sub" else ns // 2
        ms = time_ms(lambda: fc.fused_round(binned, g3, **kw), 10)
        plain_ms = time_ms(
            lambda: fc.fused_round_ref(binned, g3, **kw), 2)
        _, _, _, label = fc.fused_round(binned, g3, **kw)
        live = int((label < ns).sum())
        hist = S * Fn * B * 3 * 4
        # bins, rows, old leaf ids read; label and new leaf ids written;
        # parents read and hsmall written (subtraction mode); the
        # children's mask and sums read, the residue written
        other = ((2 * hist if mode == "sub" else 0)
                 + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4)
        nbytes = Fn * N + N * 12 + N * 4 + 2 * N * 4 + other
        live_ms = (live_row_bytes(N, Fn, live) + other) / HBM_BYTES_PER_S \
            * 1e3
        ops = ((2 if prec == "bf16x2" else 1) * 3 * live * Fn
               + 2 * S * Fn * B * 2 * 12)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        launches = trained["k2_launches_by_bucket"].get(f"{ns}:{prec}:{mode}",
                                                         0)
        b = {"nslots": ns, "S": S, "precision": prec, "mode": mode, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops, "launches": launches,
             "launches_per_tree": launches / n_trees, "live_rows": live,
             "live_bound_ms": max(live_ms, t_ops)}
        buckets.append(b)
        log(f"  K2 S={S} {mode} ({prec}), {live} live rows: {ms:.3f} ms "
            f"(plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}, live-row bound {b['live_bound_ms']:.4f} ms), "
            f"{b['launches_per_tree']:.2f} launches a tree")
    top = max(buckets, key=lambda b: b["nslots"])
    rows.append({
        "name": "fused_round", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:238",
        "launches": int(trained["k2_launches"]),
        "max_abs_err": max(max(c["max_gain_err"], c["max_left_err"])
                           for c in checks),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "live_bound_ms": top["live_bound_ms"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "computes a route + histogram + split scan",
        "at": f"S={top['S']} {top['precision']} {top['mode']}",
        "residue_bitwise_cpu_plain": all(c["residue_bitwise_cpu_plain"]
                                         for c in checks),
        "buckets": buckets, "checks": checks})
    binned, lids, feats, rmeta, num_leaves, offsets = rec.route
    N, P, R = binned.shape[1], rmeta.shape[0], offsets.shape[0] - 1
    k3_checks = check_k3_tree("recorded headline tree", binned, feats, rmeta,
                              offsets, num_leaves, rec.tree, rec.meta)

    def k3():
        return fc.route_rows(binned, lids, feats, rmeta, num_leaves,
                             offsets=offsets)

    def per_round():
        return single_rounds(binned, lids, feats, rmeta, offsets,
                             num_leaves)

    ms = time_ms(k3, 20)
    rounds_ms = time_ms(per_round, 20)
    plain_ms = time_ms(lambda: fc.route_rows_ref(
        binned, lids, feats, rmeta, num_leaves, offsets=offsets), 2)
    names = ("route_kernel", "route_global_kernel", "route_tables_kernel")
    # None: the profiler saw no kernel
    device_ms = sum(kernel_device_ms(k3, names).values()) or None
    rounds_device_ms = sum(kernel_device_ms(per_round, names).values()) \
        or None
    cold_ms = sum(cold_device_ms(k3, names).values()) or None
    rounds_cold_ms = sum(cold_device_ms(per_round, names).values()) or None
    bound = k3_bound(binned, feats, rmeta, offsets, num_leaves)
    rows.append({
        "name": "route_rows", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:558",
        "launches": int(trained["k3_launches"]), "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
        "library_note": "none: no single PyTorch call routes rows through "
        "a tree's splits", "rows": N, "splits": P, "rounds": R,
        "device_ms": device_ms, "cold_device_ms": cold_ms,
        "single_round_launches_ms": rounds_ms,
        "single_round_launches_device_ms": rounds_device_ms,
        "single_round_launches_cold_device_ms": rounds_cold_ms,
        "checks": k3_checks})
    log(f"  K3 on {N} valid rows, the last tree's {P} splits in {R} rounds:"
        f" {ms:.4f} ms, device {device_ms} ms (L2 cleared: {cold_ms}); {R} "
        f"single-round launches {rounds_ms:.4f} ms, device "
        f"{rounds_device_ms} ms (L2 cleared: {rounds_cold_ms}) (plain "
        f"{plain_ms:.2f} ms, bound {bound['bound_ms']:.5f} ms by bytes, "
        f"{bound['bin_reads']} bin reads)")
    return rows


# ---------------------------------------------------------------------------
# the persistent wave loop (K6)
# ---------------------------------------------------------------------------


class LoopRecorder:
    """Keeps the inputs of the second and the last K6 call of a run (the
    main path's own state, for the checks and the timing after it) and
    every call's split counts.  With ``debug`` each K6 launch gets a
    debug buffer (``loop_cuda.debug_buffer``): its stage stamps and live
    rows are kept with the call's ladder; a probe that allocates and
    zeroes a buffer a launch, so a timed run goes without it.  With
    ``k2_rounds`` the loop runs as R launches of K2 with the PyTorch pick
    and replay (``loop_cuda.loop_rounds``): single rounds, no K6.  It
    counts nothing; the wrappers count their launches."""

    def __init__(self, k2_rounds=False, debug=False, keep=0):
        self.k2_rounds = k2_rounds
        self.stamp = debug
        self.n_split = []
        self.debug = []     # (debug buffer, split counts, ladder)
        self.second = self.last = None
        self.keep = keep    # the inputs of the first ``keep`` calls too
        self.kept = []

    def __enter__(self):
        self._orig = lc.fused_wave_loop

        def wrapped(binned, g3, leaf_id, ft12, num_leaves, **kw):
            if self.k2_rounds:
                out = lc.loop_rounds(binned, g3, leaf_id, ft12, num_leaves,
                                     round_fn=fc.fused_round, **kw)
            else:
                dbg = None
                if self.stamp and binned.device.type == "cuda":
                    # the stamps are the card kernel's
                    dbg = lc.debug_buffer(kw["rounds"], binned.device)
                out = self._orig(binned, g3, leaf_id, ft12, num_leaves,
                                 debug=dbg, **kw)
                if dbg is not None:
                    self.debug.append((dbg, out[3],
                                       tuple(kw["slot_buckets"])))
            self.last = (binned, g3, leaf_id, ft12, num_leaves, kw)
            if len(self.n_split) == 1:
                self.second = self.last
            if len(self.kept) < self.keep:
                self.kept.append(self.last)
            self.n_split.append(out[3])
            return out

        lc.fused_wave_loop = wrapped
        return self

    def __exit__(self, *exc):
        lc.fused_wave_loop = self._orig


def loop_call(args, **over):
    """K6's keyword arguments of a recorded call, with ``over``."""
    binned, g3, leaf_id, ft12, num_leaves, kw = args
    kw = dict(kw, **over)
    return (binned, g3, leaf_id, ft12, num_leaves), kw


class RoundRecorder:
    """A K2 round function for ``loop_rounds`` that keeps each round's
    inputs and outputs: the children's histograms and the bounds of
    phase 14 come from them."""

    def __init__(self):
        self.rounds = []

    def __call__(self, binned, g3, **kw):
        out = fc.fused_round(binned, g3, **kw)
        self.rounds.append((kw, out))
        return out


def children_of(binned, g3, kw, out):
    """A recorded K2 round's (2S, F, B, 3) children histograms: K1's
    histogram of the label (K2's, bit for bit), subtracted from the
    parents in subtraction mode."""
    _, hsm, _, label = out
    if hsm is not None:
        return wf.subtract_children(hsm, kw["parent"], kw["sml"])
    return hc.hist_leaves(binned, g3, label, kw["nslots"] + 1,
                          kw["num_bins"], kw["precision"])[:kw["nslots"]]


def check_k6(tag, args, rounds, meta, params, min_rounds=2) -> dict:
    """K6 on one segment's inputs against R launches of K2 with the
    PyTorch pick and replay (bit for bit) and against its plain version
    on the card (split counts exact; round by round, the picks identical
    outside the tie band and the values within phase 14's gain bound; the
    leaf ids exact while every pick agrees).

    The two sides sum each histogram cell in other f32 orders, and a
    larger child is its parent minus the smaller, so by round r a cell may
    carry r + 1 such differences: each within 2 (n + 1) 2^-24 of the
    absolute sum of the n rows of its leaf at the segment's start (phase
    9's bound).  A child's left sums then differ by at most those cells'
    bounds summed over the bins, plus the prefix's own 2 B 2^-24 of its
    absolute sum; the gains by what ``gain_bound`` carries from that.
    The segment must run ``min_rounds`` live rounds."""
    pos, kw = args
    got = lc.fused_wave_loop(*pos, **kw)
    again = lc.fused_wave_loop(*pos, **kw)
    rec = RoundRecorder()
    k2 = lc.loop_rounds(*pos, round_fn=rec, **kw)
    plain = lc.fused_wave_loop_ref(*pos, **kw)
    names = ("packed rows", "new leaf ids", "pool", "split counts")
    for a, b, c, what in zip(got, again, k2, names):
        check(a is None or bool(same_value(a, b).all()),
              f"K6 {tag}: two launches differ in {what}")
        check(a is None or bool(same_value(a, c).all()),
              f"K6 {tag}: {what} differ from R K2 rounds")
    packed, n_split = got[0], got[3].tolist()
    check(n_split == plain[3].tolist(), f"K6 {tag}: split counts {n_split} "
          f"against the plain version's {plain[3].tolist()}")
    live = [n for n in n_split if n > 0]
    check(len(live) == len(rec.rounds) and len(live) >= min_rounds,
          f"K6 {tag}: {len(live)} live rounds, {len(rec.rounds)} K2 rounds")
    binned, g3, lid0 = pos[0], pos[1], pos[2].long()
    B, L = kw["num_bins"], pos[3].shape[0]
    absum0 = hc.index_add_hist(binned, [g3.abs()], lid0, L, B)
    before = lid0
    err_g = err_s = 0.0
    diverged = None
    for r, (n, (rkw, out)) in enumerate(zip(live, rec.rounds)):
        ch = children_of(binned, g3, rkw, out)[:2 * n]
        csums, mask = rkw["csums"][:2 * n], rkw["mask"][:2 * n]
        left2 = scan_left_sums(ch, meta)
        gains, shift = scan_direction_gains(left2, csums, meta, mask, params)
        # each child's leaf at the segment's start, through its parent
        anc = torch.zeros(L + 1, dtype=torch.long, device=binned.device)
        anc[before] = lid0
        a0 = absum0[anc[rkw["route"]["rmeta"][:n, 0].long()]
                    .repeat_interleave(2)]                # (2n, F, B, 3)
        cell = (r + 1) * 2 * (a0[..., 2:3] + 1) * 2.0 ** -24 * a0
        lbound = (cell.sum(dim=2) + 2 * B * 2.0 ** -24 * ch.abs().sum(dim=2)
                  + 1e-6)
        gbound = gain_bound(left2, csums, gains, shift, lbound, params)
        before = out[2].long()
        pk, pp = packed[r, :2 * n], plain[0][r, :2 * n]
        fk = pk[:, 1].long()
        ci = torch.arange(2 * n, device=pk.device)
        same = (pk[:, 1:4] == pp[:, 1:4]).all(dim=1)
        if not bool(same.all()):
            # a pick inside the tie band: the plain version's gain there
            # must be within the band of K6's; later rounds split other
            # leaves and are not compared
            band = TIE_RTOL * (shift.abs() + pk[:, 0].abs())
            check(bool(((pk[:, 0] - pp[:, 0]).abs()[~same]
                        <= 4 * band[~same]).all()),
                  f"K6 {tag}: round {r} picks differ outside the tie band")
            diverged = r
            break
        fin = torch.isfinite(pk[:, 0])
        eg = torch.where(fin, (pk[:, 0] - pp[:, 0]).abs(),
                         torch.zeros_like(pk[:, 0]))
        check(bool((eg <= gbound[ci, fk]).all()), f"K6 {tag}: round {r} "
              f"gains off by {float(eg.max()):.3e} past phase 14's bound")
        lb = lbound[ci, fk]
        es = torch.where(fin[:, None], (pk[:, 4:] - pp[:, 4:]).abs(),
                         torch.zeros_like(pk[:, 4:]))
        rb = lb + 2.0 ** -23 * csums.abs()
        check(bool((es <= torch.cat([lb, rb], dim=1)).all()),
              f"K6 {tag}: round {r} sums off by {float(es.max()):.3e}")
        err_g, err_s = max(err_g, float(eg.max())), max(err_s,
                                                       float(es.max()))
    if diverged is None:
        check(torch.equal(got[1], plain[1]), f"K6 {tag}: leaf ids differ "
              "from the plain version")
    out = {"case": tag, "n_split": n_split, "max_gain_err": err_g,
           "max_sum_err": err_s, "plain_diverged_at_round": diverged,
           "buckets": [rkw["nslots"] for rkw, _ in rec.rounds],
           "live_rows": [int((o[3] < rkw["nslots"]).sum())
                         for rkw, o in rec.rounds]}
    log(f"  K6 {tag}: split counts {n_split}, live rows "
        f"{out['live_rows']}; packed rows, leaf ids and "
        f"pool bitwise equal to {len(live)} K2 rounds and across two "
        f"launches; vs the plain version: "
        + ("picks identical, " if diverged is None else
           f"a tie-band pick at round {diverged}, ")
        + f"max gain err {err_g:.2e}, sums {err_s:.2e}")
    return out


LOOP_PARAMS = dict(FUSED_PARAMS, hist_dtype_deep="bf16x2",
                   wave_loop_rounds=4)


def parked_state(binned, g3, lid, ft, nl, meta, params, B):
    """A frontier and pool rebuilt from moved leaf ids ``lid``: each
    current leaf keeps its recorded split (gain, feature, threshold,
    default left, depth), and its left and right sums, its output and its
    histograms (the pool) become those of the rows it now holds, so a
    round's children sum to their rows.  A leaf left empty keeps its gain
    and still splits."""
    L, F = ft.shape[0], binned.shape[0]
    lid = lid.long()
    ft = ft.clone()
    feat = ft[:, 1].long().clamp(0, F - 1)[lid]                  # (N,)
    bins = binned.gather(0, feat[None]).squeeze(0).long()
    left = go_left_rule(bins, ft[lid, 2].long(), ft[lid, 3] != 0,
                        meta.missing_type[feat], meta.nan_bin[feat],
                        meta.zero_bin[feat])
    sums = torch.zeros((2 * L, 3), dtype=torch.float64, device=g3.device)
    sums.index_add_(0, 2 * lid + (~left).long(), g3.double())
    sums = sums.reshape(L, 2, 3)[:nl]
    ft[:nl, 4:7] = sums[:, 0].float()
    ft[:nl, 7:10] = sums[:, 1].float()
    ft[:nl, 10] = child_leaf_output(sums.sum(dim=1).float(), params)
    pool = hc.index_add_hist(binned, [g3], lid, L, B)
    return ft, pool


def phase_loop_kernels(binned, meta, rng) -> list:
    """K6 against R K2 rounds and its plain version on the headline bins
    with phase 14's signed, varied rows, from a frontier captured after
    the root and two single rounds of a headline tree grown on those rows:
    R = 4, subtraction and pool-free, bf16x2 and f32."""
    N = binned.shape[1]
    config = Config.from_dict(dict(LOOP_PARAMS, wave_loop_rounds=2))
    params = SplitParams(min_data_in_leaf=float(config.min_data_in_leaf))
    grow = build_trainer(config, meta, params, 64, binned.device,
                         num_data=N)
    with LoopRecorder(k2_rounds=True) as cap:
        grow(binned, signed_rows(rng, N, binned.device), meta.usable)
    check(cap.second is not None, "one segment in a tree")
    seg = cap.second
    out = []
    for prec in ("bf16x2", "f32"):
        for sub in (True, False):
            args = loop_call(seg, rounds=4, precision=prec,
                             pool=seg[5]["pool"] if sub else None)
            out.append(check_k6(f"R=4 {'sub' if sub else 'pool-free'} "
                                f"{prec}", args, 4, meta, params))
    # sparse-live segments: the same frontier with rows parked in a leaf
    # no round splits (the frontier's last, unused): one live row, one
    # chunk's rows, none, or every row in the first round's split; the
    # sums and the pool rebuilt from the moved rows (parked_state), with
    # lambda_l2 = 1 so an empty child's scan gives -inf past its gates,
    # not 0 / 0
    F = binned.shape[0]
    lid, ft, nl = seg[2], seg[3], seg[4]
    sparams = seg[5]["params"]._replace(lambda_l2=1.0)
    park = ft.shape[0] - 1
    top = int(ft[:nl, 0].argmax())
    chunk_rows = lc.bucket_plans(N, F, 64, "bf16x2", seg[5]["slot_buckets"],
                                 True)[0]["chunk_rows"]
    for case, sub in (("one row", False), ("one chunk", True),
                      ("none", True), ("root", False)):
        if case == "root":
            moved = torch.full_like(lid, top)
        else:
            keep = torch.zeros_like(lid, dtype=torch.bool)
            if case == "one row":
                keep[int((lid == top).nonzero()[0, 0])] = True
            elif case == "one chunk":
                c = (N // chunk_rows) // 2
                keep[c * chunk_rows:(c + 1) * chunk_rows] = True
            moved = torch.where(keep, lid, torch.full_like(lid, park))
        mft, mpool = parked_state(binned, seg[1], moved, ft, nl, meta,
                                  sparams, 64)
        for prec in ("bf16x2", "f32"):
            args = loop_call(seg[:2] + (moved, mft) + seg[4:], rounds=4,
                             precision=prec, params=sparams,
                             pool=mpool if sub else None)
            # empty children split no further, and a pool-free segment of
            # one leaf's rows may leave no child a split: one round
            out.append(check_k6(f"sparse {case}, R=4 "
                                f"{'sub' if sub else 'pool-free'} {prec}",
                                args, 4, meta, sparams,
                                2 if case == "one chunk" else 1))
            live = out[-1]["live_rows"][0]
            want = {"one row": live == 1, "one chunk": 0 < live <= chunk_rows,
                    "none": live == 0, "root": live == N}[case]
            check(want, f"K6 sparse {case}: {live} live rows in round 1")
    return out


def phase_loop_train(ds, dv, Xv, iters, dev):
    """The looped training main path (counts reset before, read after),
    then the single round with the same knobs in the same phase: the
    model texts byte-identical; the looped model served through K4.  The
    probes (K6's debug stamps, K2's live rows) run in a second, untimed
    run of each, so the timed windows carry none."""
    reset_counts()
    ev = {}
    with LoopRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(LOOP_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    k6 = lc.launch_counts["fused_wave_loop"]
    k2 = fc.launch_counts["fused_round"]
    k3 = fc.launch_counts["route_rows"]
    k1 = hc.launch_counts["hist_leaves"]
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
             **{f"loop.{k}": v for k, v in lc.plain_counts.items()}}
    trees = booster.num_trees()
    replayed = sum(int((c > 0).sum()) for c in rec.n_split)
    log(f"  launches on the looped path: K6 {k6} "
        f"({json.dumps({str(k): v for k, v in lc.bucket_launch_counts.items()})}"
        f"), K2 {k2}, K3 {k3} ({replayed} replayed rounds), K1 {k1}; "
        f"plain-version calls: {plain}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(k6 == len(rec.n_split) and k6 >= trees,
          f"K6 launched {k6} times, {len(rec.n_split)} calls, {trees} trees")
    check(k2 == 0, f"K2 launched {k2} times on the looped path")
    want_k3 = k3_expected(booster, 1)
    check(k3 == want_k3, f"K3 launched {k3} times for {want_k3} trees of "
          "more than one leaf (one valid set)")
    check(k1 == trees, f"K1 launched {k1} times for {trees} root passes")
    check(not any(plain.values()), "a plain version ran on the looped path")
    scan = scan_launches(trees)
    check(scan["launches"] == trees, "the looped path's split scans: "
          f"{scan['launches']} for {trees} root passes")
    auc = ev["valid_0"]["auc"][-1]
    n = ds.num_data()
    ev1 = {}
    single_params = dict(LOOP_PARAMS, wave_loop_rounds=1)
    t0 = time.perf_counter()
    single = train(single_params, ds, iters, valid_sets=[dv],
                   evals_result=ev1, **_on(dev))
    _sync(dev)
    secs1 = time.perf_counter() - t0
    text, text1 = booster.model_to_string(), single.model_to_string()
    check(text == text1, "the looped model text differs from the single "
          "round's")
    check(ev == ev1, "the looped metrics differ from the single round's")
    with LoopRecorder(debug=True) as drec:
        probe = train(LOOP_PARAMS, ds, iters, **_on(dev))
        _sync(dev)
    check(probe.model_to_string() == text, "the stamped looped run's "
          "model text differs from the timed run's")
    log("  the single round's live rows (the looped trees' rounds), from "
        "an untimed run:")
    srec, live = live_rows_run(single_params, ds, iters, dev, text)
    k6_live = [r["live_rows"] for dbg, n_split, _ in drec.debug
               for r in lc.stage_split(dbg, n_split.tolist())]
    k2_live = [int(v) for _, v, _ in srec.live]
    check(k6_live == k2_live, "K6's live rows a round (its list stage's "
          "counts) differ from the single round's K2 labels'")
    log(f"  K6's list stage counted the same live rows as K2's labels in "
        f"all {len(k6_live)} rounds")
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6,
           "single_round_s_per_iter": secs1 / iters,
           "single_round_M_row_trees_per_s": n * trees / secs1 / 1e6,
           "valid_auc": auc, "trees": trees, "k6_launches": k6,
           "k6_launches_per_tree": k6 / trees, "k3_launches": k3,
           "k1_launches": k1, "replayed_rounds": replayed,
           "model_text_identical": True, "live_share": live,
           "split_scan": scan,
           **text_hash(text, "looped")}
    log(f"  {iters} looped iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; single round, same knobs: {secs1 / iters:.3f} s/iter"
        f", {out['single_round_M_row_trees_per_s']:.2f} M row-trees/s (one "
        f"run each); model text byte-identical ({len(text)} bytes), valid "
        f"AUC {auc:.5f}; K6 {out['k6_launches_per_tree']:.2f} launches a "
        "tree")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "loop_model.txt")
    return out, rec, drec


def loop_plan(ds, dev) -> dict:
    """``plan_wave_loop`` at the headline shape on this card."""
    meta = make_feature_meta(ds._binned, dev)
    fn = wf.make_fused_wave_loop(
        meta=meta, params=SplitParams(), num_bins=64, precision="bf16x2",
        deep_precision="bf16x2", rounds=LOOP_PARAMS["wave_loop_rounds"])
    return fn.plan(N=ds.num_data(), F=F, K=63, L=255, use_sub=True,
                   slot_buckets=(4, 16, 63), device=dev)


def loop_stage_split(rec: LoopRecorder) -> dict:
    """K6's stage split on the main path: per slot bucket, the rounds and
    the median microseconds of each stage (``loop_cuda.LOOP_STAGES``) and
    of the whole round, from the debug stamps of every launch of phase
    20's stamped run; and the median entry + first boundary of a
    launch."""
    by, entry = {}, []
    for dbg, n_split, ladder in rec.debug:
        entry.append((int(dbg[1]) - int(dbg[0])) / 1e3)
        for r in lc.stage_split(dbg, n_split.tolist()):
            S = ladder[sum(r["n_split"] > b for b in ladder[:-1])]
            by.setdefault(S, []).append(r)
    out = {"entry_boundary_us": float(np.median(entry)) if entry
           else float("nan"), "buckets": {}}
    for S, rs in sorted(by.items()):
        med = {k: float(np.median([r[k] for r in rs]))
               for k in lc.LOOP_STAGES}
        med["round"] = float(np.median([sum(r[k] for k in lc.LOOP_STAGES)
                                        for r in rs]))
        out["buckets"][str(S)] = {"rounds": len(rs), "median_us": med}
        log(f"  K6 stage split at S={S} ({len(rs)} rounds), median us: "
            + ", ".join(f"{k} {v:.1f}" for k, v in med.items()))
    log(f"  K6 entry + first boundary, median {out['entry_boundary_us']:.1f}"
        " us a launch")
    return out


def loop_work(pos, kw):
    """The work of K6 on one segment's inputs, from its R K2 rounds: the
    bytes it must move (all rows and live rows only), its f32 operations,
    each round's bucket, splits and live rows, and the split counts.
    Packed bins (``kw["packed"]``) move ceil(F/2) bytes a row."""
    rr = RoundRecorder()
    _, _, _, n_split = lc.loop_rounds(*pos, round_fn=rr, **kw)
    N = pos[0].shape[1]
    Fn = kw["base_mask"].shape[0]
    Fb = -(-Fn // 2) if kw.get("packed") else Fn
    B, L = kw["num_bins"], pos[3].shape[0]
    nbytes = ops = live_bytes = 0
    rounds = []
    for n, (rkw, out) in zip([n for n in n_split.tolist() if n > 0],
                             rr.rounds):
        ns, sub = rkw["nslots"], rkw.get("parent") is not None
        S = ns if sub else ns // 2
        live = int((out[3] < ns).sum())
        row = Fn * B * 3 * 4
        # K2's round: bins, rows, old leaf ids read, label and new leaf
        # ids written, parents read (subtraction), children's mask and
        # sums read, residue written; then the packed rows, the
        # children's frontier rows and (subtraction) pool rows written
        other = ((S * row if sub else 0)
                 + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4
                 + 2 * S * wf.PACK_COLS * 4 + 2 * n * 12 * 4
                 + (2 * n * row if sub else 0))
        nbytes += Fb * N + N * 12 + N * 4 + 2 * N * 4 + other
        live_bytes += live_row_bytes(N, Fb, live) + other
        ops += ((2 if kw["precision"] == "bf16x2" else 1) * 3 * live * Fn
                + 2 * S * Fn * B * 2 * 12)
        rounds.append({"S": S, "n_split": n, "live_rows": live})
    nbytes += L * 12 * 4 * 2          # the frontier read once, written once
    live_bytes += L * 12 * 4 * 2
    return nbytes, live_bytes, ops, rounds, n_split


def phase_loop_timing(rec: LoopRecorder, drec: LoopRecorder, trained: dict,
                      checks: list) -> dict:
    """K6's stage split from the stamped run ``drec``; K6 on the main
    path's last inputs (CUDA events over 10 launches after a warm-up)
    beside its plain version, R K2 rounds on the same inputs and its bound
    by bytes; returns the kernels-line row."""
    split = loop_stage_split(drec)
    spos, skw = loop_call(rec.second)
    full_ms = time_ms(lambda: lc.fused_wave_loop(*spos, **skw), 10)
    full_k2_ms = time_ms(lambda: lc.loop_rounds(
        *spos, round_fn=fc.fused_round, **skw), 3)
    # one round alone (R = 1) at the first round's bucket of each segment,
    # K6 against K2 with the PyTorch pick, and against K2 alone on the
    # same round's inputs: the cost of the loop's grid
    one_round = []
    for name, call in (("second", rec.second), ("last", rec.last)):
        opos, okw = loop_call(call, rounds=1)
        n = int(lc.fused_wave_loop(*opos, **okw)[3][0])
        rr = RoundRecorder()
        lc.loop_rounds(*opos, round_fn=rr, **okw)
        rkw = rr.rounds[0][0]
        one_round.append({
            "segment": name, "n_split": n,
            "S": okw["slot_buckets"][sum(n > b for b in
                                         okw["slot_buckets"][:-1])],
            "live_rows": int((rr.rounds[0][1][3] < rkw["nslots"]).sum()),
            "k6_ms": time_ms(lambda: lc.fused_wave_loop(*opos, **okw), 10),
            "k2_ms": time_ms(lambda: lc.loop_rounds(
                *opos, round_fn=fc.fused_round, **okw), 10),
            "k2_alone_ms": time_ms(lambda: fc.fused_round(
                opos[0], opos[1], **rkw), 10)})
    pos, kw = loop_call(rec.last)
    ms = time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10)
    plain_ms = time_ms(lambda: lc.fused_wave_loop_ref(*pos, **kw), 2)
    k2_ms = time_ms(lambda: lc.loop_rounds(*pos, round_fn=fc.fused_round,
                                           **kw), 3)
    nbytes, live_bytes, ops, rounds, n_split = loop_work(pos, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_live = live_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    n_trees = trained["trees"]
    row = {"name": "fused_wave_loop", "route": "cuda", "source": LOOP_SRC,
           "replaces": "lightgbmv1_tpu/ops/wave_fused.py:904",
           "launches": int(trained["k6_launches"]),
           "max_abs_err": max(max(c["max_gain_err"], c["max_sum_err"])
                              for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "live_bound_ms": max(t_live, t_ops),
           "library_ms": None, "library_note": "none: no single PyTorch "
           "call runs a wave round", "k2_rounds_ms": k2_ms,
           "rounds": rounds, "R": len(n_split), "bytes": nbytes, "ops": ops,
           "launches_per_tree": trained["k6_launches"] / n_trees,
           "precision": kw["precision"],
           "mode": "sub" if kw.get("pool") is not None else "pool",
           "ms_second_segment": full_ms,
           "k2_rounds_ms_second_segment": full_k2_ms,
           "n_split_second_segment": rec.n_split[1].tolist(),
           "one_round": one_round, "stage_split": split, "checks": checks}
    log(f"  K6 ({row['precision']}, {row['mode']}, rounds "
        f"{[r['S'] for r in rounds]} of R={row['R']}): {ms:.3f} ms a launch "
        f"(plain {plain_ms:.1f} ms, {len(rounds)} K2 rounds + PyTorch pick "
        f"and replay {k2_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']}, live-row bound {row['live_bound_ms']:.4f} ms "
        f"for live rows {[r['live_rows'] for r in rounds]}), "
        f"{row['launches_per_tree']:.2f} launches a "
        f"tree; on the run's second segment (tree 1, rounds 5-8, split "
        f"counts {row['n_split_second_segment']}) {full_ms:.3f} ms, its K2 "
        f"rounds + PyTorch pick and replay {full_k2_ms:.3f} ms")
    for o in one_round:
        log(f"  one round alone, {o['segment']} segment's first (S="
            f"{o['S']}, {o['n_split']} splits, {o['live_rows']} live rows): "
            f"K6 {o['k6_ms']:.3f} ms, K2 alone {o['k2_alone_ms']:.3f} ms, "
            f"K2 + PyTorch pick and replay {o['k2_ms']:.3f} ms")
    return row


# ---------------------------------------------------------------------------
# the sequential and level-wise growers; regression, multiclass, lambdarank
# ---------------------------------------------------------------------------

# phase 22: no objective (the default, regression) and 7 leaves, where the
# auto wave size 1 routes to the sequential grower
REG_PARAMS = {"num_leaves": 7, "max_bin": 63, "verbosity": -1}
# phase 23: the root PERF.md level-wise row (bench.py:2488-2497)
LEVEL_PARAMS = dict(TRAIN_PARAMS, tree_growth="levelwise", metric="auc")
# phases 24 and 25: the bench parity configs (bench.py:2854-2861,
# :2906-2913)
MC_PARAMS = {"objective": "multiclass", "num_class": 5, "num_leaves": 127,
             "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
             "metric": "multi_logloss", "verbosity": -1}
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 63, "max_bin": 63,
               "learning_rate": 0.1, "min_data_in_leaf": 20,
               "metric": "ndcg", "eval_at": [10], "verbosity": -1}
# quality figures to print beside the port's, never times: the JAX
# package's (root PERF.md, BENCH_r05.json) and the reference C++'s
# (bench.py REF_MC_LOGLOSS, REF_RK_NDCG10) on the same generators
JAX_LEVEL_AUC = 0.91267          # 100 iterations, 1,000,000 rows
JAX_MC_LOGLOSS, REF_MC_LOGLOSS = 0.85144, 0.830193
JAX_RANK_NDCG10, REF_RANK_NDCG10 = 0.61497, 0.613977
# the card-against-CPU checks: f32 leaves within this share of
# max(1, |leaf|) (the f32 sums of the two devices run in other orders,
# and a larger child is its parent minus the smaller: phase 11 reads
# 3.9e-4 on the binary path)
PARITY_LEAF_TOL = 2e-3
PARITY_ROWS = 65536


def regression_target(X, seed):
    """make_data's logit of the rows plus unit noise: a continuous
    target for the headline rows."""
    rng = np.random.RandomState(seed)
    return (headline_logit(X) + rng.randn(len(X)).astype(np.float32)) \
        .astype(np.float64)


def make_multiclass_data(n, seed, n_class=5, f=28):
    """The JAX package's bench.py:51 make_multiclass_data, copied: linear
    class logits from fixed centres, two nonlinear terms, noise, argmax."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    centers = np.random.RandomState(12345).randn(n_class, f) \
        .astype(np.float32) * 0.6
    logits = X @ centers.T
    logits[:, 0] += 0.8 * X[:, 0] * X[:, 1]
    logits[:, 1] += 0.6 * np.sin(2.0 * X[:, 2])
    logits += rng.randn(n, n_class).astype(np.float32) * 1.5
    return X, logits.argmax(axis=1).astype(np.float64)


def make_rank_data(n_query, docs, seed, f=64):
    """The JAX package's bench.py:68 make_rank_data, copied: fixed-size
    queries, relevance 0..4 by within-query score quantiles."""
    rng = np.random.RandomState(seed)
    n = n_query * docs
    X = rng.randn(n, f).astype(np.float32)
    score = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3]
             + 0.3 * np.sin(2.0 * X[:, 4])
             + rng.randn(n).astype(np.float32) * 1.2)
    s = score.reshape(n_query, docs)
    ranks = s.argsort(axis=1).argsort(axis=1) / (docs - 1)
    y = np.digitize(ranks.reshape(-1), [0.5, 0.75, 0.9, 0.97]) \
        .astype(np.float64)
    return X, y, np.full(n_query, docs, dtype=np.int64)


def phase_path(tag, params, ds, dv, Xv, iters, dev, metric):
    """A training path, counts reset before and read after: ``train``
    for ``iters`` iterations with the valid set, then its saved model
    served through K4.  K1 launched (its launches by slot count and
    precision add up), no plain histogram, K4 launched; s/iteration,
    s/tree, M row-trees/s, K1 launches a tree, the last valid ``metric``
    and the model text's hash.  Returns its numbers, the K1 call record
    and the booster."""
    reset_counts()
    ev = {}
    with HistRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(params, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    launches = hc.launch_counts["hist_leaves"]
    buckets = {f"{L}:{prec}": v for (L, prec), v
               in sorted(hc.bucket_launch_counts.items())}
    plain = dict(hc.plain_counts)
    n, trees = ds.num_data(), booster.num_trees()
    value = ev["valid_0"][metric][-1]
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "s_per_tree": secs / trees,
           "M_row_trees_per_s": n * trees / secs / 1e6, metric: value,
           "trees": trees, "k1_launches": launches,
           "k1_launches_per_tree": launches / trees,
           "k1_launches_by_bucket": buckets}
    log(f"  {tag}: {iters} iterations, {trees} trees of {n} rows in "
        f"{secs:.2f} s: {out['s_per_iter']:.4f} s/iter, "
        f"{out['s_per_tree']:.4f} s/tree, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; valid {metric} {value:.5f}")
    log(f"  K1 launches: {launches} ({out['k1_launches_per_tree']:.2f} a "
        f"tree; {json.dumps(buckets)}); plain-version calls: {plain}")
    check(launches > 0, f"K1 never launched on the {tag} path")
    check(sum(buckets.values()) == launches,
          "K1's launches by bucket do not add up to its launches")
    check(set(rec.last) == set(hc.bucket_launch_counts),
          f"K1 was called at {sorted(rec.last)} but launched at "
          f"{sorted(hc.bucket_launch_counts)}")
    check(not any(plain.values()),
          f"a plain histogram ran on the {tag} path")
    check(trees == iters * booster.num_model_per_iteration(),
          f"{trees} trees for {iters} iterations")
    out["split_scan"] = scan_launches(trees)
    log(f"  split-scan launches: {out['split_scan']['launches']} "
        f"({out['split_scan']['per_tree']:.2f} a tree)")
    out.update(text_hash(booster.model_to_string(), tag))
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              f"{tag}_model.txt")
    out["k4_launches"] = pc.launch_counts["serving_fused"]
    check(out["k4_launches"] > 0, f"K4 never launched serving the {tag} "
          "model")
    return out, rec, booster


def phase_path_kernels(tag, rec, trained, checks):
    """K1 against its plain versions on the path's own last inputs at each
    (slots, precision), then timed there (phase 12's row, its buckets)."""
    checks = checks + phase_hist_main_inputs(rec)
    row = phase_hist_timing(rec, trained, checks)
    return {"path": tag, "buckets": row["buckets"],
            "max_abs_err": row["max_abs_err"],
            "max_err_over_abs_sum": row["max_err_over_abs_sum"]}


def phase_trained_k4(booster, Xv, dev, rng, tag) -> dict:
    """The trained model served on the card: K4 against its plain version
    (phase 4's checks, at the model's own width and classes), and the
    served raw and converted scores against the port's CPU predict (the
    float64 host walk) within the serving tolerance (softmax and sigmoid
    outputs within 1e-6)."""
    text = booster.model_to_string()
    card = Booster(model_str=text, **_on(dev))
    cpu = Booster(model_str=text, device="cpu")
    trees, K = card._all_trees(), card.num_model_per_iteration()
    errs = phase_kernels({tag: (text, trees, K, {})}, dev, 1 << 17, rng,
                         n_features=card.num_feature())
    raw = card.predict(Xv, predict_method="fused", raw_score=True)
    e_raw = float(np.abs(raw - cpu.predict(Xv, raw_score=True)).max())
    e_out = float(np.abs(card.predict(Xv, predict_method="fused")
                         - cpu.predict(Xv)).max())
    tol = raw_tol(trees)
    # an output the objective maps into [0, 1] is held to 1e-6; the
    # identity outputs (regression, lambdarank) are the raw scores
    out_tol = (tol if card.config.objective in ("regression", "lambdarank")
               else 1e-6)
    log(f"  {tag} served through K4 against the CPU host walk: raw "
        f"{e_raw:.3e} (tol {tol:.3e}), converted {e_out:.3e} (tol "
        f"{out_tol:.3e})")
    check(e_raw <= tol and e_out <= out_tol,
          f"{tag}: K4 against the CPU predict {e_raw}, {e_out}")
    return {"k4_max_abs_err": errs["serving_fused"], "vs_cpu_raw": e_raw,
            "vs_cpu_converted": e_out}


def card_vs_cpu(tag, params, X, y, dev, iters=5, group=None) -> dict:
    """The path in f32 on the card and on the CPU (the plain versions, K1's
    in the kernel's order): every split identical, leaves within
    PARITY_LEAF_TOL.  The CPU sums its histograms in K1's order because
    the split picks of these paths follow the order of the f32 sums: the
    first iteration's hessians are one constant a class (a softmax of
    equal scores), whose f32 sums drift with their order by up to 1e-5
    of the sum, and a small child's histogram is its parent's minus its
    sibling's, so that drift reaches 1e-3 of a deep leaf's gains; trained
    on the CPU with the index_add_ version and with the row-order one,
    9 of 10 multiclass trees at this shape split differently."""
    p = dict(params, hist_dtype="f32", hist_method="pallas")
    log(f"  {tag}, card against CPU (K1's order): {len(X)} rows, {iters} "
        "iterations")
    return split_parity(X, y, {"card": (p, dev), "CPU": (p, "cpu")},
                        iters=iters, group=group, leaf_tol=PARITY_LEAF_TOL,
                        roworder=True)


# ---------------------------------------------------------------------------
# 4-bit packed bins (bin_layout=packed4): the packed legs of K1, K2, K3, K6
# ---------------------------------------------------------------------------

# phase 27: the headline configuration at max_bin 15 (a 16-bin axis), where
# the default bin_layout=auto packs two features a byte on the card
PACKED_PARAMS = dict(TRAIN_PARAMS, max_bin=15)
PACKED_RUNS = (("staged", {}),
               ("fused", {"hist_method": "fused"}),
               ("looped", {"hist_method": "fused", "hist_dtype_deep": "bf16x2",
                           "wave_loop_rounds": 4}))
PACKED_SHORT_ITERS = 20     # the fused and looped packed trainings
SPARSE_CASES = (("one row", False), ("one chunk", True), ("none", True),
                ("root", False))


def check_packed_k1(tag, u8, packed, g3, lid, L, B=16) -> dict:
    """K1's packed leg on ``packed`` (``pack4bit(u8)``) against its u8 leg
    on ``u8`` and the row-order plain version bit for bit, in all three
    precisions (so the u8 leg at this bin axis too); counts exact against
    the index_add_ version; two launches bitwise equal; the dead slot
    (``live_slots = L - 1``) as phase 9."""
    pk = dict(packed=True, num_features=u8.shape[0])
    for prec in hc.FLOAT_PRECISIONS:
        got = hc.hist_leaves(packed, g3, lid, L, B, prec, **pk)
        again = hc.hist_leaves(packed, g3, lid, L, B, prec, **pk)
        u = hc.hist_leaves(u8, g3, lid, L, B, prec)
        row = hc.hist_leaves_roworder_ref(packed, g3, lid, L, B, prec, **pk)
        check(same_bits(got, u), f"K1 packed {tag} {prec}: not bitwise the "
              f"u8 leg ({int((got != u).sum())} cells differ)")
        check(same_bits(u, row), f"K1 u8 B={B} {tag} {prec}: not bitwise "
              f"the row-order version ({int((u != row).sum())} cells differ)")
        check(same_bits(got, again), f"K1 packed {tag} {prec}: two launches "
              "differ")
        want = hc.hist_leaves_ref(packed, g3, lid, L, B, prec, **pk)
        check(torch.equal(got[..., 2], want[..., 2]),
              f"K1 packed {tag} {prec}: counts differ")
        if L > 1:
            dead = hc.hist_leaves(packed, g3, lid, L, B, prec, L - 1, **pk)
            check(same_bits(dead[:L - 1], got[:L - 1])
                  and not bool(dead[L - 1].view(torch.int32).any()),
                  f"K1 packed {tag} {prec}: the dead slot's rows changed a "
                  "live cell or the dead slot is not 0")
    log(f"  K1 packed {tag}: bitwise the u8 leg and the row-order version "
        "in bf16x2 / bf16 / f32, counts exact, repeatable, dead slot 0")
    return {"case": tag, "bitwise_u8": True, "bitwise_roworder": True}


def check_packed_k2(tag, u8, packed, g3, kw) -> dict:
    """K2 and K3's packed legs on one round's inputs, bit for bit: against
    their u8 legs on the same bins (residue, hsmall, new leaf ids, label;
    K3's leaf ids) and across two launches; against their plain versions,
    leaf ids and labels exact, the smaller children's histograms the
    row-order plain version of the emitted label (K1's order) and the
    residue the plain scan run on the CPU on those histograms (phase 14's
    ``residue_bitwise_cpu_plain``)."""
    pkw = dict(kw, packed=True)
    F, B = kw["mask"].shape[1], kw["num_bins"]
    ns = kw["nslots"]
    got = fc.fused_round(packed, g3, **pkw)
    names = ("residue", "hsmall", "new leaf ids", "label")
    for other, what in ((fc.fused_round(packed, g3, **pkw), "a second "
                         "launch"), (fc.fused_round(u8, g3, **kw),
                                     "the u8 leg")):
        for a, b, name in zip(got, other, names):
            check(a is None or bool(same_value(a, b).all()),
                  f"K2 packed {tag}: {name} differ from {what}")
    res, hsm, nleaf, label = got
    plain = fc.fused_round_ref(packed, g3, **pkw)
    check(torch.equal(nleaf, plain[2]) and torch.equal(label, plain[3]),
          f"K2 packed {tag}: leaf ids or labels differ from the plain "
          "version")
    r = kw["route"]
    args = (r["oleaf"], r["feats"], r["rmeta"], r["num_leaves"])
    k3 = fc.route_rows(packed, *args, packed=True)
    check(torch.equal(k3, nleaf) and torch.equal(k3, fc.route_rows(u8, *args))
          and torch.equal(k3, fc.route_rows_ref(packed, *args, True)),
          f"K3 packed {tag}: differs from K2's leaf ids, the u8 leg or the "
          "plain version")
    h = hc.hist_leaves_roworder_ref(packed, g3, label, ns + 1, B,
                                    kw["precision"], packed=True,
                                    num_features=F)[:ns]
    if hsm is not None:
        check(same_bits(hsm, h), f"K2 packed {tag}: hsmall is not the "
              "row-order plain histogram of its label")
        h = wf.subtract_children(hsm, kw["parent"], kw["sml"])
    meta = kw["meta"]
    res_cpu = scan_residue(h.cpu(), kw["mask"].cpu(), kw["csums"].cpu(),
                           meta=to_cpu(meta),
                           params=kw["params"]).to(res.device)
    check(bool(same_value(res, res_cpu).all()), f"K2 packed {tag}: the "
          "residue is not the CPU plain scan of the plain histograms")
    live = int((label < ns).sum())
    log(f"  K2 / K3 packed {tag}: {live} live rows; bitwise the u8 legs and"
        " repeatable; leaf ids, labels, K3 the plain versions'; hsmall the "
        "row-order plain histogram, residue the CPU plain scan's")
    return {"case": tag, "bitwise_u8": True, "rows_in_slots": live,
            "residue_bitwise_cpu_plain": True, "max_abs_err": 0.0}


def phase_packed_kernels(binned, meta, rng) -> dict:
    """Phase 26: the packed legs on the headline rows binned at max_bin 15
    (``binned``: (F, N) byte bins of a 16-bin axis) against their u8 legs
    and plain versions.  K1 at L in {1, 2, 5, 17, 64} at F and at F - 1
    (odd: the last byte's hi nibble is the phantom feature); K2 and K3 at
    S = 4 / 16 / 63 (subtraction) in each precision, S = 63 pool-free and
    phase 14's sparse-live rounds; K6 at R = 4 (subtraction and pool-free,
    bf16x2 and f32) from a frontier grown on these bins: its u8 leg
    against R K2 rounds and its plain version (``check_k6``), its packed
    leg bitwise the u8 leg."""
    Fn, N = binned.shape
    dev = binned.device
    out = {"k1": [], "k2": [], "k6": []}
    for f in (Fn, Fn - 1):
        u8 = binned[:f].contiguous()
        packed = hc.pack4bit(u8)
        check(tuple(packed.shape) == (-(-f // 2), N)
              and torch.equal(hc.unpack4bit(packed, f), u8),
              f"pack4bit at F={f}: {tuple(packed.shape)}, not the bins back")
        if f % 2:
            check(not bool((packed[-1] >> 4).any()),
                  "the phantom hi nibble of an odd F is not 0")
        for L in (1, 2, 5, 17, 64):
            lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32)) \
                .to(dev)
            out["k1"].append(check_packed_k1(f"F={f} N={N} L={L}", u8,
                                             packed, signed_rows(rng, N, dev),
                                             lid, L))
    packed = hc.pack4bit(binned)
    cases = [(S, True, prec) for S in (4, 16, 63)
             for prec in hc.FLOAT_PRECISIONS]
    for S, sub, prec in cases + [(63, False, "bf16x2")]:
        g3, kw = round_inputs(binned, meta, S, S, sub, prec, rng, B=16)
        out["k2"].append(check_packed_k2(
            f"S={S} {'sub' if sub else 'pool-free'} {prec}", binned, packed,
            g3, kw))
    for case, sub in SPARSE_CASES:
        chunk_rows = hc.plan(N, Fn, (4 if sub else 8) + 1, 16,
                             "bf16x2")["chunk_rows"]
        g3, kw = round_inputs(binned, meta, 4, 1, sub, "bf16x2", rng,
                              oleaf=sparse_leaves(N, chunk_rows, case),
                              leafs=[1], B=16)
        out["k2"].append(check_packed_k2(
            f"sparse {case}, S=4 {'sub' if sub else 'pool-free'} bf16x2",
            binned, packed, g3, kw))
        live = out["k2"][-1]["rows_in_slots"]
        check({"one row": live == 1, "one chunk": 0 < live <= chunk_rows,
               "none": live == 0, "root": live == N}[case],
              f"K2 packed sparse {case}: {live} live rows")
    config = Config.from_dict(dict(LOOP_PARAMS, max_bin=15,
                                   wave_loop_rounds=2))
    params = SplitParams(min_data_in_leaf=float(config.min_data_in_leaf))
    grow = build_trainer(config, meta, params, 16, dev, num_data=N)
    with LoopRecorder(k2_rounds=True) as cap:
        grow(binned, signed_rows(rng, N, dev), meta.usable)
    check(cap.second is not None, "one segment in a tree at 16 bins")
    seg = cap.second
    for prec in ("bf16x2", "f32"):
        for sub in (True, False):
            pos, kw = loop_call(seg, rounds=4, precision=prec,
                                pool=seg[5]["pool"] if sub else None)
            tag = f"R=4 {'sub' if sub else 'pool-free'} {prec}"
            out["k6"].append(check_k6(f"u8 B=16 {tag}", (pos, kw), 4, meta,
                                      params))
            got = lc.fused_wave_loop(packed, *pos[1:], **dict(kw,
                                                               packed=True))
            want = lc.fused_wave_loop(*pos, **kw)
            for a, b, what in zip(got, want, ("packed rows", "new leaf ids",
                                              "pool", "split counts")):
                check(a is None or bool(same_value(a, b).all()),
                      f"K6 packed {tag}: {what} differ from the u8 leg")
            log(f"  K6 packed {tag}: bitwise the u8 leg")
            out["k6"][-1]["packed_bitwise_u8"] = True
    return out


def packed_run(params, ds, dv, iters, dev):
    """One training with the valid set, launch counts reset first, under
    the three call recorders; returns the booster, its seconds, metrics,
    launch and plain-version counts and the recorders."""
    reset_counts()
    ev = {}
    with HistRecorder() as hrec, FusedRecorder() as frec, \
            LoopRecorder() as lrec:
        t0 = time.perf_counter()
        booster = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                        **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    launches = {**hc.launch_counts, **fc.launch_counts, **lc.launch_counts}
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
             **{f"loop.{k}": v for k, v in lc.plain_counts.items()}}
    frec.tree, frec.meta = booster._gbdt._device_trees[-1], booster._gbdt.meta
    return booster, secs, ev, launches, plain, (hrec, frec, lrec)


# the packed launches each training must show, and the u8 ones it must not
PACKED_LEGS = {
    "staged": (("hist_leaves_packed", "route_rows_packed"),
               ("hist_leaves", "route_rows")),
    "fused": (("hist_leaves_packed", "fused_round_packed",
               "route_rows_packed"),
              ("hist_leaves", "fused_round", "route_rows")),
    "looped": (("hist_leaves_packed", "fused_wave_loop_packed",
                "route_rows_packed"),
               ("hist_leaves", "fused_wave_loop", "fused_round",
                "fused_round_packed", "route_rows"))}


def phase_packed_train(ds, dv, Xv, iters, dev):
    """Phase 27, the packed training main path at full width: the headline
    configuration at max_bin 15 with the default bin_layout (auto), staged
    for ``iters`` iterations, ``hist_method=fused`` and the looped fused
    path for PACKED_SHORT_ITERS each, each with its launch counts reset
    first; each trained again with ``bin_layout=u8``, whose model text
    must be the packed one byte for byte.  Returns the numbers and each
    packed run's recorders."""
    out, recs = {}, {}
    N, Fn = ds.num_data(), ds._binned.num_features
    for name, extra in PACKED_RUNS:
        n_it = iters if name == "staged" else PACKED_SHORT_ITERS
        params = dict(PACKED_PARAMS, **extra)
        bst, secs, ev, launches, plain, rec = packed_run(params, ds, dv, n_it,
                                                         dev)
        g = bst._gbdt
        check(g._packed and tuple(g.binned.shape) == (-(-Fn // 2), N),
              f"packed {name}: bin_layout=auto did not pack "
              f"({g._packed}, {tuple(g.binned.shape)})")
        want, never = PACKED_LEGS[name]
        log(f"  packed {name}: launches {json.dumps(launches)}; plain-version"
            f" calls: {plain}")
        check(all(launches[k] > 0 for k in want),
              f"packed {name}: a packed leg of {want} never launched")
        check(not any(launches[k] for k in never),
              f"packed {name}: a u8 leg of {never} launched")
        check(not any(plain.values()),
              f"packed {name}: a plain version ran on the path")
        ubst, usecs, uev, _, _, _ = packed_run(dict(params, bin_layout="u8"),
                                               ds, dv, n_it, dev)
        check(not ubst._gbdt._packed, f"u8 {name}: packed")
        text = bst.model_to_string()
        check(text == ubst.model_to_string(), f"packed {name}: the model text "
              "differs from bin_layout=u8's")
        check(ev == uev, f"packed {name}: the metrics differ from u8's")
        auc = ev["valid_0"]["auc"][-1]
        r = {"iters": n_it, "s_per_iter": secs / n_it,
             "u8_s_per_iter": usecs / n_it, "valid_auc": auc,
             "launches": {k: launches[k] for k in want},
             "model_text_identical_to_u8": True,
             **text_hash(text, f"packed {name}")}
        log(f"  packed {name}: {n_it} iterations of {N} rows, "
            f"{r['s_per_iter']:.4f} s/iter packed, {r['u8_s_per_iter']:.4f} "
            f"s/iter u8 (one run each); valid AUC {auc:.5f}; model text "
            "byte-identical to bin_layout=u8's")
        if name == "staged":
            check(auc > 0.90, f"packed staged: valid AUC {auc} <= 0.90")
            r["served_max_abs_err"] = serve_trained(bst, Xv, dev,
                                                    "packed_model.txt")
        out[name] = r
        recs[name] = rec
    return out, recs


def packed_bound(nbytes, ops) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes, "ops": ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_packed_timing(recs, trained) -> dict:
    """Each packed leg on phase 27's last inputs (its largest bucket)
    beside its u8 leg on the unpacked bins, its plain version, the unpack
    alone and, for K1, one ``index_add_`` on the unpacked bins; the bound
    by bytes with the bins stream at ceil(F/2) bytes a row.  Returns the
    ``packed`` record of each kernel (K1, K2, K3, K6)."""
    out = {}
    hrec = recs["staged"][0]
    (L, prec), (binned, g3, lid, B, live, Fn) = max(
        hrec.packed_last.items(), key=lambda kv: kv[0][0])
    Fb, N = binned.shape
    u8 = hc.unpack4bit(binned, Fn)
    pk = dict(packed=True, num_features=Fn)
    unpack_ms = time_ms(lambda: hc.unpack4bit(binned, Fn), 10)
    flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
             + lid.long()[None, :]) * B + u8.long()).reshape(-1)
    vals = g3.repeat(Fn, 1)
    acc = torch.zeros((Fn * L * B, 3), dtype=torch.float32,
                      device=binned.device)
    lim = L if live is None else int(live)
    n_live = int(((lid >= 0) & (lid < lim)).sum())
    out["hist_leaves"] = {
        "at": f"L={L} {prec}", "N": N, "F": Fn, "stored_columns": Fb,
        "launches": int(trained["staged"]["launches"]["hist_leaves_packed"]),
        "ms": time_ms(lambda: hc.hist_leaves(binned, g3, lid, L, B, prec,
                                             live, **pk), 10),
        "u8_ms": time_ms(lambda: hc.hist_leaves(u8, g3, lid, L, B, prec,
                                                live), 10),
        "plain_ms": time_ms(lambda: hc.hist_leaves_ref(
            binned, g3, lid, L, B, prec, live, **pk), 2),
        "library_ms": time_ms(lambda: acc.index_add_(0, flat, vals), 5),
        "unpack_ms": unpack_ms,
        **packed_bound(Fb * N + N * 12 + N * 4 + L * Fn * B * 3 * 4,
                       (2 if prec == "bf16x2" else 1) * 3 * n_live * Fn)}
    frec = recs["fused"][1]
    (ns, prec, mode), (binned, g3, kw) = max(frec.last.items(),
                                             key=lambda kv: kv[0][0])
    Fn = kw["mask"].shape[1]
    Fb, N = binned.shape
    u8 = hc.unpack4bit(binned, Fn)
    ukw = dict(kw, packed=False)
    sub = kw.get("parent") is not None
    S = ns if sub else ns // 2
    label = fc.fused_round(binned, g3, **kw)[3]
    n_live = int((label < ns).sum())
    other = ((2 * S * Fn * B * 3 * 4 if sub else 0)
             + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4)
    out["fused_round"] = {
        "at": f"S={S} {prec} {mode}", "N": N, "F": Fn, "stored_columns": Fb,
        "launches": int(trained["fused"]["launches"]["fused_round_packed"]),
        "ms": time_ms(lambda: fc.fused_round(binned, g3, **kw), 10),
        "u8_ms": time_ms(lambda: fc.fused_round(u8, g3, **ukw), 10),
        "plain_ms": time_ms(lambda: fc.fused_round_ref(
            binned, g3, **kw), 2),
        "library_ms": None, "unpack_ms": unpack_ms, "live_rows": n_live,
        "live_bound_ms": (live_row_bytes(N, Fb, n_live) + other)
        / HBM_BYTES_PER_S * 1e3,
        **packed_bound(Fb * N + N * 12 + N * 4 + 2 * N * 4 + other,
                       (2 if prec == "bf16x2" else 1) * 3 * n_live * Fn
                       + 2 * S * Fn * B * 2 * 12)}
    binned, lids, feats, rmeta, num_leaves, offsets = frec.packed_route
    Fb, N = binned.shape
    u8 = hc.unpack4bit(binned, Fn)
    checks = check_k3_tree("packed, the fused run's last tree", binned,
                           feats, rmeta, offsets, num_leaves, frec.tree,
                           frec.meta, packed=True, u8=u8)
    kw3 = dict(offsets=offsets)
    out["route_rows"] = {
        "N": N, "splits": int(rmeta.shape[0]),
        "rounds": int(offsets.shape[0] - 1), "stored_columns": Fb,
        "launches": int(trained["fused"]["launches"]["route_rows_packed"]),
        "launches_by_path": {k: int(v["launches"]["route_rows_packed"])
                             for k, v in trained.items()},
        "ms": time_ms(lambda: fc.route_rows(binned, lids, feats, rmeta,
                                            num_leaves, packed=True, **kw3),
                      20),
        "u8_ms": time_ms(lambda: fc.route_rows(u8, lids, feats, rmeta,
                                               num_leaves, **kw3), 20),
        "plain_ms": time_ms(lambda: fc.route_rows_ref(
            binned, lids, feats, rmeta, num_leaves, True, **kw3), 2),
        "library_ms": None, "checks": checks,
        **k3_bound(binned, feats, rmeta, offsets, num_leaves, packed=True)}
    pos, kw = loop_call(recs["looped"][2].last)
    Fn = kw["base_mask"].shape[0]
    u8 = hc.unpack4bit(pos[0], Fn)
    ukw = dict(kw, packed=False)
    nbytes, live_bytes, ops, rounds, _ = loop_work(pos, kw)
    out["fused_wave_loop"] = {
        "R": kw["rounds"], "rounds": rounds, "N": pos[0].shape[1], "F": Fn,
        "stored_columns": pos[0].shape[0],
        "launches": int(trained["looped"]["launches"][
            "fused_wave_loop_packed"]),
        "ms": time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10),
        "u8_ms": time_ms(lambda: lc.fused_wave_loop(u8, *pos[1:], **ukw),
                         10),
        "plain_ms": time_ms(lambda: lc.fused_wave_loop_ref(*pos, **kw), 2),
        "library_ms": None, "unpack_ms": unpack_ms,
        "live_bound_ms": live_bytes / HBM_BYTES_PER_S * 1e3,
        **packed_bound(nbytes, ops)}
    for name, r in out.items():
        log(f"  {name} packed ({r.get('at', '')}): {r['ms']:.4f} ms, u8 leg "
            f"{r['u8_ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}, library "
            f"{r['library_ms']}, unpack alone {r.get('unpack_ms')}; "
            f"{r['launches']} launches on phase 27's path")
    return out


# ---------------------------------------------------------------------------
# stochastic-rounded int8 histograms (hist_dtype_deep=int8sr): the quantize
# kernel and the int8sr legs of K1, K2 and K6
# ---------------------------------------------------------------------------

# phase 29: the headline configuration with hist_dtype_deep=int8sr, the
# knob whose automatic value is int8sr on the JAX package's TPU: the
# 16-slot ramp and the sustained 63-slot rounds quantize
INT8SR_PARAMS = dict(TRAIN_PARAMS, hist_dtype_deep="int8sr")
INT8SR_RUNS = (("staged", {}), ("fused", {"hist_method": "fused"}),
               ("looped", {"hist_method": "fused", "wave_loop_rounds": 4}))
QUANT_SRC = "lightgbmv1_tpu_torch/csrc/quantize.cu"
# H100 SXM int32 operations a second outside the tensor cores: 64 INT32
# lanes an SM x 132 SMs x 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of one threefry2x32 draw (csrc/prng.cuh): 20 rounds
# of an add, a funnel-shift rotation and an XOR, the 2 initial key adds,
# 5 injections of 2 adds each (a key word plus its round constant is one
# word a launch, so one add), and the XOR, shift, OR of the float bits;
# the key schedule itself is made once a launch and not counted
DRAW_OPS = 20 * 3 + 2 + 5 * 2 + 3
# the tree key of the kernel checks (utils/prng.py)
CHECK_KEY = prng.fold_in(prng.prng_key(7), 3)


def quant_rows(g3, key):
    """The prequantized rows, the scales and the quantize kernel's rows."""
    zq, scale3 = qz.prequantize_rows(g3)
    return zq, scale3, qz.sr_quantize(zq, key)


def check_quantize(tag, g3, key) -> dict:
    """The quantize kernel against its plain version on the card and on
    the CPU, and the prequantized rows and scales of the card against the
    CPU's: bit for bit; the rows integers in [-127, 127]."""
    zq, scales, got = quant_rows(g3, key)
    zq_c, sc_c = qz.prequantize_rows(g3.cpu())
    check(same_bits(zq.cpu(), zq_c) and same_bits(scales.cpu(), sc_c),
          f"quantize {tag}: the prequantized rows or scales differ from "
          "the CPU's")
    again = qz.sr_quantize(zq, key)
    plain = qz.sr_quantize_ref(zq, key)
    cpu = qz.sr_quantize_ref(zq_c, key)
    check(same_bits(got, again), f"quantize {tag}: two launches differ")
    check(same_bits(got, plain), f"quantize {tag}: not bitwise the plain "
          f"version ({int((got != plain).sum())} values differ)")
    check(same_bits(got.cpu(), cpu), f"quantize {tag}: not bitwise the "
          "plain version on the CPU")
    q = got[:, :2]
    check(bool((q == q.round()).all()) and float(q.abs().max()) <= 127,
          f"quantize {tag}: rows not integers in [-127, 127]")
    log(f"  quantize {tag}: {g3.shape[0]} rows bitwise the plain version on "
        f"the card and the CPU, scales {scales.tolist()}")
    return {"case": tag, "N": int(g3.shape[0]), "scales": scales.tolist(),
            "max_abs_err": 0.0}


def check_k1_int8sr(tag, binned, q3, lid, L, B=64, packed=None) -> dict:
    """K1's int8sr leg on quantized rows against its integer plain
    versions (exact), across two launches, with the dead slot; with
    ``packed`` (the pack4bit bytes of ``binned``) its packed leg bitwise
    the u8 leg.  Every cell below 2^24 in magnitude."""
    got = hc.hist_leaves(binned, q3, lid, L, B, "int8sr")
    check(torch.equal(got, hc.hist_leaves(binned, q3, lid, L, B, "int8sr")),
          f"K1 int8sr {tag}: two launches differ")
    want = hc.hist_leaves_ref(binned, q3, lid, L, B, "int8sr")
    check(torch.equal(got, want), f"K1 int8sr {tag}: not the integer plain "
          f"version ({int((got != want).sum())} cells differ)")
    check(torch.equal(got, hc.hist_leaves_roworder_ref(
        binned, q3, lid, L, B, "int8sr")), f"K1 int8sr {tag}: not the "
        "row-order plain version")
    check(float(got.abs().max()) < 2 ** 24, f"K1 int8sr {tag}: a cell "
          "reaches 2^24")
    if L > 1:
        dead = hc.hist_leaves(binned, q3, lid, L, B, "int8sr", L - 1)
        check(torch.equal(dead[:L - 1], got[:L - 1])
              and not bool(dead[L - 1].any()),
              f"K1 int8sr {tag}: the dead slot changed a live cell or is "
              "not 0")
    if packed is not None:
        pk = hc.hist_leaves(packed, q3, lid, L, B, "int8sr", packed=True,
                            num_features=binned.shape[0])
        check(torch.equal(pk, got), f"K1 int8sr {tag}: the packed leg "
              "differs from the u8 leg")
    log(f"  K1 int8sr {tag}: exact, the integer plain versions', "
        f"repeatable{', packed leg the u8 leg' if packed is not None else ''}"
        f"; largest cell {float(got.abs().max()):.0f}")
    return {"case": tag, "max_abs_err": 0.0, "packed": packed is not None}


def check_k2_int8sr(tag, binned, q3, kw) -> dict:
    """K2's int8sr leg on one round's quantized rows, bit for bit: leaf
    ids, labels and K3 as the plain version; hsmall K1's int8sr histogram
    of the emitted label; the residue the CPU plain scan's of the plain
    dequantization (the smaller child scaled, then subtracted; pool-free
    the integer prefix sums scaled); two launches equal."""
    B, F = kw["num_bins"], binned.shape[0]
    got = fc.fused_round(binned, q3, **kw)
    again = fc.fused_round(binned, q3, **kw)
    for a, b, what in zip(got, again, ("residue", "hsmall", "new leaf ids",
                                       "label")):
        check(a is None or bool(same_value(a, b).all()),
              f"K2 int8sr {tag}: two launches differ in {what}")
    res, hsm, nleaf, label = got
    want = fc.fused_round_ref(binned, q3, **kw)
    check(torch.equal(nleaf, want[2]) and torch.equal(label, want[3]),
          f"K2 int8sr {tag}: leaf ids or labels differ from the plain "
          "version")
    r = kw["route"]
    check(torch.equal(fc.route_rows(binned, r["oleaf"], r["feats"],
                                    r["rmeta"], r["num_leaves"]), nleaf),
          f"K3 {tag}: differs from K2's leaf ids")
    ns = kw["nslots"]
    k1 = hc.hist_leaves(binned, q3, label, ns + 1, B, "int8sr")[:ns]
    scale = kw["scale"]
    if hsm is not None:
        check(torch.equal(hsm, k1), f"K2 int8sr {tag}: hsmall is not K1's "
              "int8sr histogram of its label")
        children = wf.subtract_children(hsm, kw["parent"], kw["sml"], scale)
        hscale = None
    else:
        children, hscale = k1, scale
    meta = kw["meta"]
    res_cpu = scan_residue(
        children.cpu(), kw["mask"].cpu(), kw["csums"].cpu(),
        meta=to_cpu(meta), params=kw["params"],
        hist_scale=None if hscale is None else hscale.cpu()).to(res.device)
    check(bool(same_value(res, res_cpu).all()), f"K2 int8sr {tag}: the "
          "residue is not the CPU plain scan of the plain dequantization")
    live = int((label < ns).sum())
    log(f"  K2 int8sr {tag}: {live} live rows; leaf ids, labels, K3 exact; "
        "hsmall K1's int8sr histogram; residue the CPU plain scan's; "
        "repeatable")
    return {"case": tag, "rows_in_slots": live, "max_abs_err": 0.0,
            "residue_bitwise_cpu_plain": True}


def int8sr_round(binned, meta, S, n_live, sub, rng, **kw):
    """One quantized round's inputs (``round_inputs``) at int8sr: the
    quantize kernel's rows under a key of the round and the slots'
    scales."""
    g3, rkw = round_inputs(binned, meta, S, n_live, sub, "int8sr", rng, **kw)
    _, scale3, q3 = quant_rows(g3, prng.fold_in(CHECK_KEY, S))
    rkw["scale"] = scale3[None, :].expand(rkw["nslots"], 3).contiguous()
    return q3, rkw


def last_quant_nl(kw, nl0, n_split) -> int:
    """The leaf count at the start of a launch's last quantized round."""
    nl, last = nl0, None
    ladder, qb = kw["slot_buckets"], kw["quant_buckets"]
    for n in n_split.tolist():
        if n == 0:
            break
        if ladder[sum(n > b for b in ladder[:-1])] in qb:
            last = nl
        nl += n
    return last


def check_k6_int8sr(tag, args, min_rounds=2) -> dict:
    """K6 with quantized buckets against R launches of K2 (each quantized
    round's rows from the quantize kernel) with the PyTorch pick and
    replay: packed rows, leaf ids, pool and split counts bit for bit;
    two launches equal; the rows K6 drew for its last quantized round
    equal the quantize kernel's for the same key; split counts equal the
    plain version's.  The segment mixes quantized and unquantized
    rounds."""
    pos, kw = args
    dev = pos[0].device
    # the kernel's quantized rows (a CPU rehearsal runs the plain version)
    q3 = torch.empty((pos[0].shape[1], 3), dtype=torch.float32,
                     device=dev) if dev.type == "cuda" else None
    got = lc.fused_wave_loop(*pos, q3=q3, **kw)
    again = lc.fused_wave_loop(*pos, **kw)
    rec = RoundRecorder()
    k2 = lc.loop_rounds(*pos, round_fn=rec, **kw)
    plain = lc.fused_wave_loop_ref(*pos, **kw)
    names = ("packed rows", "new leaf ids", "pool", "split counts")
    for a, b, c, what in zip(got, again, k2, names):
        check(a is None or bool(same_value(a, b).all()),
              f"K6 int8sr {tag}: two launches differ in {what}")
        check(a is None or bool(same_value(a, c).all()),
              f"K6 int8sr {tag}: {what} differ from R K2 rounds")
    n_split = got[3].tolist()
    check(n_split == plain[3].tolist(), f"K6 int8sr {tag}: split counts "
          f"{n_split} against the plain version's {plain[3].tolist()}")
    precs = [rkw["precision"] for rkw, _ in rec.rounds]
    check(len(precs) >= min_rounds, f"K6 int8sr {tag}: {len(precs)} live "
          "rounds")
    nl = last_quant_nl(kw, pos[4], got[3])
    drew = nl is not None and q3 is not None
    if drew:
        want = qz.sr_quantize(kw["quant"][0],
                              prng.fold_in(kw["key"], 8_000_011 + nl))
        check(same_bits(q3, want), f"K6 int8sr {tag}: its draw at {nl} "
              "leaves differs from the quantize kernel's")
    log(f"  K6 int8sr {tag}: split counts {n_split}, rounds {precs}; packed "
        f"rows, leaf ids and pool bitwise {len(precs)} K2 rounds and across "
        "two launches; "
        + (f"its draw at {nl} leaves the quantize kernel's" if drew
           else "no quantized round" if nl is None
           else "its draw is the card's to check"))
    return {"case": tag, "n_split": n_split, "rounds": precs,
            "draw_bitwise_quantize": drew, "max_abs_err": 0.0}


def phase_int8sr_kernels(binned, meta, rng) -> dict:
    """Phase 28: the quantize kernel at N rows and an odd N (weighted
    counts, a zero hessian column); K1's int8sr leg at L = 1, 17, 64 on
    byte bins and (a 16-bin axis) packed bins; K2's at S = 16 and 63 in
    subtraction mode, 63 pool-free and the sparse-live rounds; K6 at R = 4
    on a segment of a headline int8sr tree (bf16x2 and int8sr rounds),
    subtraction and pool-free, and a sparse-live segment."""
    Fn, N = binned.shape
    dev = binned.device
    out = {"quantize": [], "k1": [], "k2": [], "k6": []}
    g3 = signed_rows(rng, N, dev)
    out["quantize"].append(check_quantize(f"N={N}", g3, CHECK_KEY))
    odd = (N * 3 // 4) | 1
    w = signed_rows(rng, odd, dev)
    w[:, 1] = 0.0
    w[:, 2] = torch.from_numpy(rng.rand(odd).astype(np.float32) * 3).to(dev)
    out["quantize"].append(check_quantize(
        f"N={odd} weighted counts, zero hessians", w, CHECK_KEY))
    b16 = (binned % 16).to(torch.uint8).contiguous()
    p16 = hc.pack4bit(b16)
    for L in (1, 17, 64):
        lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32)).to(dev)
        q3 = quant_rows(signed_rows(rng, N, dev), prng.fold_in(CHECK_KEY,
                                                               L))[2]
        out["k1"].append(check_k1_int8sr(f"L={L} B=64", binned, q3, lid, L))
        out["k1"].append(check_k1_int8sr(f"L={L} B=16", b16, q3, lid, L, 16,
                                         p16))
    for S, sub in ((16, True), (63, True), (63, False)):
        q3, kw = int8sr_round(binned, meta, S, S, sub, rng)
        out["k2"].append(check_k2_int8sr(
            f"S={S} {'sub' if sub else 'pool-free'}", binned, q3, kw))
    for case, sub in SPARSE_CASES:
        chunk_rows = hc.plan(N, Fn, (16 if sub else 32) + 1, 64,
                             "int8sr")["chunk_rows"]
        q3, kw = int8sr_round(binned, meta, 16, 1, sub, rng,
                              oleaf=sparse_leaves(N, chunk_rows, case),
                              leafs=[1])
        out["k2"].append(check_k2_int8sr(
            f"sparse {case}, S=16 {'sub' if sub else 'pool-free'}", binned,
            q3, kw))
        live = out["k2"][-1]["rows_in_slots"]
        check({"one row": live == 1, "one chunk": 0 < live <= chunk_rows,
               "none": live == 0, "root": live == N}[case],
              f"K2 int8sr sparse {case}: {live} live rows")
    config = Config.from_dict(dict(INT8SR_PARAMS, hist_method="fused",
                                   wave_loop_rounds=2))
    params = SplitParams(min_data_in_leaf=float(config.min_data_in_leaf))
    grow = build_trainer(config, meta, params, 64, dev, num_data=N)
    with LoopRecorder(k2_rounds=True, keep=3) as cap:
        grow(binned, signed_rows(rng, N, dev), meta.usable, key=CHECK_KEY)
    check(len(cap.kept) == 3, "three segments in an int8sr tree")
    seg = cap.second
    check(tuple(seg[5]["quant_buckets"]) == (16, 63),
          f"the loop's quantized buckets {seg[5]['quant_buckets']}")
    for sub in (True, False):
        args = loop_call(seg, rounds=4, pool=seg[5]["pool"] if sub else None)
        out["k6"].append(check_k6_int8sr(
            f"R=4 {'sub' if sub else 'pool-free'} bf16x2 + int8sr", args))
    # the third segment (16 leaves: its first round quantizes) with the
    # rows of one row chunk left in their leaves and the rest parked
    seg = cap.kept[2]
    lid, ft, nl = seg[2], seg[3], seg[4]
    sparams = seg[5]["params"]._replace(lambda_l2=1.0)
    chunk_rows = lc.bucket_plans(N, Fn, 64, "bf16x2", seg[5]["slot_buckets"],
                                 True, (16, 63))[1]["chunk_rows"]
    keep = torch.zeros_like(lid, dtype=torch.bool)
    c = (N // chunk_rows) // 2
    keep[c * chunk_rows:(c + 1) * chunk_rows] = True
    moved = torch.where(keep, lid, torch.full_like(lid, ft.shape[0] - 1))
    mft, mpool = parked_state(binned, seg[1], moved, ft, nl, meta, sparams,
                              64)
    args = loop_call(seg[:2] + (moved, mft) + seg[4:], rounds=4,
                     params=sparams, pool=mpool)
    out["k6"].append(check_k6_int8sr("sparse one chunk, R=4 sub", args, 1))
    return out


# the int8sr launches each training must show and the counts that must
# stay 0; the quantized buckets' K1 slots are S + 1 (the dead slot)
INT8SR_K1_L = {17, 64}
INT8SR_K2_NS = {16, 63}


def int8sr_run(params, ds, dv, iters, dev):
    """One int8sr training with the valid set, launch counts reset first,
    under the call recorders; returns the booster, its seconds, metrics,
    launch counts (K1, K2, K6 by bucket; the quantize kernel), plain-
    version counts and the recorders."""
    reset_counts()
    ev = {}
    with HistRecorder() as hrec, FusedRecorder() as frec, \
            LoopRecorder() as lrec, QuantRecorder() as qrec:
        t0 = time.perf_counter()
        booster = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                        **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    counts = {
        "k1": {f"{k[0]}:{k[1]}": v
               for k, v in sorted(hc.bucket_launch_counts.items())},
        "k2": {f"{k[0]}:{k[1]}:{k[2]}": v
               for k, v in sorted(fc.bucket_launch_counts.items())},
        "k6": {f"{k[0]}:{k[1]}:{k[2]}": v
               for k, v in sorted(lc.bucket_launch_counts.items())},
        "sr_quantize": qz.launch_counts["sr_quantize"]}
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
             **{f"loop.{k}": v for k, v in lc.plain_counts.items()},
             **{f"quantize.{k}": v for k, v in qz.plain_counts.items()}}
    return booster, secs, ev, counts, plain, (hrec, frec, lrec, qrec)


class QuantRecorder:
    """Keeps the inputs of the last quantize-kernel call of a run (the main
    path's prequantized rows and key).  It counts nothing."""

    def __init__(self):
        self.last = None

    def __enter__(self):
        self._orig = qz.sr_quantize

        def wrapped(zq, key):
            self.last = (zq, key)
            return self._orig(zq, key)

        qz.sr_quantize = wrapped
        return self

    def __exit__(self, *exc):
        qz.sr_quantize = self._orig


def check_int8sr_launches(name, counts):
    """The int8sr legs launched at the quantized buckets only, and each
    path through its own kernels: staged K1's int8sr leg at L = 17 and 64
    with one quantize launch each; fused K2's at nslots 16 and 63 with one
    quantize launch each; looped K6 with its quantized ladder (the draw in
    the kernel: no quantize launch)."""
    k1q = {k: v for k, v in counts["k1"].items() if k.endswith(":int8sr")}
    k2q = {k: v for k, v in counts["k2"].items() if ":int8sr:" in k}
    k6q = {k: v for k, v in counts["k6"].items() if k.endswith(":int8sr")}
    q = counts["sr_quantize"]
    if name == "staged":
        check({int(k.split(":")[0]) for k in k1q} == INT8SR_K1_L,
              f"staged int8sr: K1's int8sr leg at {sorted(k1q)}")
        check(q == sum(k1q.values()) and not k2q and not k6q,
              f"staged int8sr: {q} quantize launches for {k1q}")
    elif name == "fused":
        check({int(k.split(":")[0]) for k in k2q} == INT8SR_K2_NS,
              f"fused int8sr: K2's int8sr leg at {sorted(k2q)}")
        check(q == sum(k2q.values()) and not k1q and not k6q,
              f"fused int8sr: {q} quantize launches for {k2q}")
    else:
        check(k6q and sum(k6q.values()) == sum(counts["k6"].values())
              and not k1q and not k2q and q == 0,
              f"looped int8sr: K6 {counts['k6']}, K2 {k2q}, K1 {k1q}, "
              f"quantize {q}")
    # the root pass and the 4-slot rounds never quantize
    check(not any(k.startswith(("2:", "5:")) for k in k1q)
          and not any(k.startswith(("4:", "8:")) for k in k2q),
          f"{name} int8sr: a root or 4-slot round quantized")


def phase_int8sr_train(ds, dv, Xv, iters, dev):
    """Phase 29, the int8sr training main path at the headline: staged,
    fused and looped, each with its launch counts reset around it; the
    int8sr legs only at the quantized buckets; the looped text its single
    round's (the fused one) byte for byte; a second staged training
    hashes the same; the staged text the fused one (the staged scan is
    the split-scan kernel, K2's scan stage); AUC > 0.90; each model
    served through K4.  Returns the numbers and each run's recorders."""
    out, recs, texts = {}, {}, {}
    for name, extra in INT8SR_RUNS:
        params = dict(INT8SR_PARAMS, **extra)
        bst, secs, ev, counts, plain, rec = int8sr_run(params, ds, dv, iters,
                                                       dev)
        log(f"  int8sr {name}: launches {json.dumps(counts)}; plain-version"
            f" calls: {plain}")
        check(not any(plain.values()),
              f"int8sr {name}: a plain version ran on the path")
        check_int8sr_launches(name, counts)
        text = bst.model_to_string()
        texts[name] = text
        auc = ev["valid_0"]["auc"][-1]
        r = {"iters": iters, "s_per_iter": secs / iters, "valid_auc": auc,
             "launches": counts, **text_hash(text, f"int8sr {name}")}
        log(f"  int8sr {name}: {iters} iterations, {r['s_per_iter']:.4f} "
            f"s/iter; valid AUC {auc:.5f}")
        check(auc > 0.90, f"int8sr {name}: valid AUC {auc} <= 0.90")
        r["served_max_abs_err"] = serve_trained(bst, Xv, dev,
                                                f"int8sr_{name}_model.txt")
        out[name] = r
        recs[name] = rec
    check(texts["looped"] == texts["fused"], "int8sr: the looped model text "
          "differs from its single round's")
    again = train(INT8SR_PARAMS, ds, iters, **_on(dev)).model_to_string()
    check(again == texts["staged"], "int8sr: a second staged training "
          "writes another model text")
    check(texts["staged"] == texts["fused"], "int8sr: the staged model text "
          "differs from the fused one")
    out["staged"]["staged_equals_fused"] = True
    log("  int8sr: staged == fused == looped, and a second staged training "
        "the same text, byte for byte")
    return out, recs


def int8sr_fused_vs_staged(X, y, dev) -> dict:
    """Phase 16's check at int8sr (its configuration: waves of 32, so the
    16- and 32-slot buckets quantize): f32 trainings on the card, fused
    against staged, split identically at every node with leaves within
    PARITY_LEAF_TOL, each through its int8sr legs (K2's at the fused run,
    K1's at the staged run)."""
    p = dict(PARITY_PARAMS, hist_dtype_deep="int8sr")
    log(f"  int8sr, fused against staged on the card: {len(X)} rows, f32, "
        f"{p['num_leaves']} leaves in waves of {p['leafwise_wave_size']}")
    reset_counts()
    out = split_parity(X, y, {"fused": (dict(p, hist_method="fused"), dev),
                              "staged": (p, dev)}, leaf_tol=PARITY_LEAF_TOL)
    k1q = sum(v for k, v in hc.bucket_launch_counts.items()
              if k[1] == "int8sr")
    k2q = sum(v for k, v in fc.bucket_launch_counts.items()
              if k[1] == "int8sr")
    check(k1q > 0 and k2q > 0, f"int8sr fused vs staged: int8sr launches "
          f"K1 {k1q}, K2 {k2q}")
    return dict(out, k1_int8sr_launches=k1q, k2_int8sr_launches=k2q)


def int8sr_bound(nbytes, f32_ops, int_ops) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes,
            "f32_ops": f32_ops, "int_ops": int_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_int8sr_timing(recs, trained) -> dict:
    """Each int8sr leg on phase 29's last inputs (its largest bucket)
    beside its bf16x2 / bf16 leg on the same inputs, its plain version
    and, for K1, one ``index_add_`` of the integer rows; the quantize
    kernel beside its plain version.  Bounds: bytes of each input read
    once and output written once at 3.35 TB/s, and operations (f32 adds,
    and the draws' integer operations at the int32 rate).  Returns the
    ``int8sr`` record of K1, K2 and K6 and the quantize kernel's row."""
    out = {}
    hrec, _, _, qrec = recs["staged"]
    (L, _), (binned, q3, lid, B, live) = max(
        ((k, v) for k, v in hrec.last.items() if k[1] == "int8sr"),
        key=lambda kv: kv[0][0])
    Fn, N = binned.shape
    n_live = int(((lid >= 0) & (lid < (L if live is None else live))).sum())
    flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
             + lid.long()[None, :]) * B + binned.long()).reshape(-1)
    ivals = q3.to(torch.int32).repeat(Fn, 1)
    iacc = torch.zeros((Fn * L * B, 3), dtype=torch.int32,
                       device=binned.device)
    k1 = trained["staged"]["launches"]["k1"]
    out["hist_leaves"] = {
        "at": f"L={L} int8sr", "N": N,
        "launches": sum(v for k, v in k1.items() if k.endswith(":int8sr")),
        "ms": time_ms(lambda: hc.hist_leaves(binned, q3, lid, L, B,
                                             "int8sr", live), 10),
        "bf16_ms": time_ms(lambda: hc.hist_leaves(binned, q3, lid, L, B,
                                                  "bf16", live), 10),
        "bf16x2_ms": time_ms(lambda: hc.hist_leaves(binned, q3, lid, L, B,
                                                    "bf16x2", live), 10),
        "plain_ms": time_ms(lambda: hc.hist_leaves_ref(
            binned, q3, lid, L, B, "int8sr", live), 2),
        "library_ms": time_ms(lambda: iacc.index_add_(0, flat, ivals), 5),
        **int8sr_bound(Fn * N + N * 12 + N * 4 + L * Fn * B * 3 * 4, 0,
                       3 * n_live * Fn)}
    _, frec, _, _ = recs["fused"]
    (ns, prec, mode), (binned, q3, kw) = max(
        ((k, v) for k, v in frec.last.items() if k[1] == "int8sr"),
        key=lambda kv: kv[0][0])
    Fn, N = binned.shape
    sub = kw.get("parent") is not None
    S = ns if sub else ns // 2
    label = fc.fused_round(binned, q3, **kw)[3]
    n_live = int((label < ns).sum())
    other = ((2 * S * Fn * B * 3 * 4 if sub else 0) + ns * 12
             + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4)
    bkw = dict(kw, precision="bf16x2", scale=None)
    k2 = trained["fused"]["launches"]["k2"]
    out["fused_round"] = {
        "at": f"S={S} int8sr {mode}", "N": N,
        "launches": sum(v for k, v in k2.items() if ":int8sr:" in k),
        "ms": time_ms(lambda: fc.fused_round(binned, q3, **kw), 10),
        "bf16x2_ms": time_ms(lambda: fc.fused_round(binned, q3, **bkw), 10),
        "plain_ms": time_ms(lambda: fc.fused_round_ref(
            binned, q3, **kw), 2),
        "library_ms": None, "live_rows": n_live,
        "live_bound_ms": (live_row_bytes(N, Fn, n_live) + other)
        / HBM_BYTES_PER_S * 1e3,
        **int8sr_bound(Fn * N + N * 12 + N * 4 + 2 * N * 4 + other,
                       2 * S * Fn * B * 2 * 12, 3 * n_live * Fn)}
    pos, kw = loop_call(recs["looped"][2].last)
    nbytes, live_bytes, f32_ops, rounds, n_split = loop_work(pos, kw)
    N = pos[0].shape[1]
    n_quant = sum(1 for r in rounds if r["S"] in kw["quant_buckets"])
    # a quantized round's draws, and its adds counted as integer ones
    int_ops = sum(2 * N * DRAW_OPS + 3 * r["live_rows"] * pos[0].shape[0]
                  for r in rounds if r["S"] in kw["quant_buckets"])
    f32_ops -= sum(3 * r["live_rows"] * pos[0].shape[0]
                   for r in rounds if r["S"] in kw["quant_buckets"])
    k6 = trained["looped"]["launches"]["k6"]
    ukw = dict(kw, quant_buckets=())
    # each round's stages from the debug stamps (a separate, untimed
    # launch each), quantized and not
    splits = {}
    for name, skw in (("stage_split", kw), ("unquantized_stage_split", ukw)):
        dbg = lc.debug_buffer(kw["rounds"], pos[0].device)
        ns = lc.fused_wave_loop(*pos, debug=dbg, **skw)[3]
        splits[name] = lc.stage_split(dbg, ns)
        log(f"  K6 {name.replace('_', ' ')} (us a round): " + "; ".join(
            ", ".join(f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in r.items()) for r in splits[name]))
    out["fused_wave_loop"] = {
        "R": kw["rounds"], "rounds": rounds, "quantized_rounds": n_quant,
        "N": N, "launches": sum(k6.values()), **splits,
        "ms": time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10),
        "unquantized_ms": time_ms(lambda: lc.fused_wave_loop(*pos, **ukw),
                                  10),
        "plain_ms": time_ms(lambda: lc.fused_wave_loop_ref(*pos, **kw), 2),
        "library_ms": None,
        "live_bound_ms": live_bytes / HBM_BYTES_PER_S * 1e3,
        **int8sr_bound(nbytes, f32_ops, int_ops)}
    zq, key = qrec.last
    N = zq.shape[0]
    qrow = {
        "name": "sr_quantize", "route": "cuda", "source": QUANT_SRC,
        "replaces": "lightgbmv1_tpu/ops/quantize.py:56 sr_quantize_g3 (XLA "
                    "in the JAX package; the draw K6 inlines)",
        "N": N, "launches": int(trained["staged"]["launches"]["sr_quantize"]),
        "launches_by_path": {k: int(v["launches"]["sr_quantize"])
                             for k, v in trained.items()},
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: qz.sr_quantize(zq, key), 20),
        "plain_ms": time_ms(lambda: qz.sr_quantize_ref(zq, key), 2),
        "library_ms": None,
        **int8sr_bound(N * 24, 2 * N * 2, 2 * N * DRAW_OPS)}
    for name, r in list(out.items()) + [("sr_quantize", qrow)]:
        legs = ", ".join(f"{k} {r[k]:.4f} ms" for k in
                         ("bf16_ms", "bf16x2_ms", "unquantized_ms") if k in r)
        log(f"  {name} int8sr ({r.get('at', '')}): {r['ms']:.4f} ms"
            + (f" beside {legs}" if legs else "")
            + f", plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']}, library {r['library_ms']}; "
            f"{r['launches']} launches on phase 29's path")
    return out, qrow


# ---------------------------------------------------------------------------
# the split-scan kernel and the constrained legs of K2 and K6 (phases 31-33)
# ---------------------------------------------------------------------------

SCAN_SRC = "lightgbmv1_tpu_torch/csrc/split_scan.cu"
# phase 32's monotone directions: make_data's logit rises in X0 and X4 and
# falls in X1 (bench.py:42-48)
MONO = [1, -1, 0, 0, 1] + [0] * (F - 5)
CONTRI = [1.0] * 5 + [0.5] * (F - 5)
MONO_PARAMS = dict(TRAIN_PARAMS, monotone_constraints=MONO)
# phase 32's AUC gate of the monotone models, under phase 10's 0.90: the
# bounds cost the model accuracy by design.  mono_auc.py (this generator
# and configuration, 262,144 rows, 50 iterations, on the CPU) reads the
# JAX package at 0.8893 in basic mode and 0.8930 in intermediate mode,
# 0.9077 unconstrained
MONO_AUC_MIN = 0.88
# the looped path needs one precision for the whole launch (phase 20's
# knob), so the three paths of this set all run bf16x2 deep rounds
OPTS_PARAMS = dict(TRAIN_PARAMS, feature_contri=CONTRI, path_smooth=1.0,
                   max_delta_step=0.7, hist_dtype_deep="bf16x2")
CONSTRAINED_RUNS = (
    ("basic", MONO_PARAMS, ("staged", "fused")),
    ("intermediate", dict(MONO_PARAMS,
                          monotone_constraints_method="intermediate"),
     ("staged", "fused")),
    ("contri+smooth+max_output", OPTS_PARAMS, ("staged", "fused", "looped")))
PATH_EXTRA = {"staged": {}, "fused": {"hist_method": "fused"},
              "looped": {"hist_method": "fused", "hist_dtype_deep": "bf16x2",
                         "wave_loop_rounds": 4}}
# the scan options phase 31 holds the kernels to: (monotone, penalty,
# contri, path smoothing, max output)
SCAN_OPTIONS = {
    "none": (False, 0.0, False, 0.0, 0.0),
    "monotone": (True, 0.0, False, 0.0, 0.0),
    "penalty": (True, 1.0, False, 0.0, 0.0),
    "contri": (False, 0.0, True, 0.0, 0.0),
    "smooth": (False, 0.0, False, 1.0, 0.0),
    "max_output": (False, 0.0, False, 0.0, 0.7),
    "all": (True, 1.0, True, 1.0, 0.7),
}
LOOP_OPTIONS = (False, 0.0, True, 1.0, 0.7)   # K6 runs no monotone leg


def option_meta(meta, opts):
    """``meta`` with the option's monotone types (+1, -1, 0 in turn) and
    contri multipliers (0.5 past the fifth feature)."""
    mono_on, _, contri_on, _, _ = opts
    F_ = meta.num_bins.shape[0]
    dev = meta.num_bins.device
    mono = torch.tensor(([1, -1, 0] * F_)[:F_], dtype=torch.int64,
                        device=dev) if mono_on else None
    contri = torch.tensor(([1.0] * 5 + [0.5] * F_)[:F_],
                          dtype=torch.float32, device=dev) \
        if contri_on else None
    return with_tables(meta._replace(monotone_type=mono, contri=contri))


def option_params(opts, **kw) -> SplitParams:
    _, pen, _, smooth, mds = opts
    return SplitParams(**dict(dict(min_data_in_leaf=20.0), **kw),
                       max_delta_step=mds, path_smooth=smooth,
                       monotone_penalty=pen)


def to_cpu(v):
    """A tensor, a FeatureMeta or a dict of them, on the CPU."""
    if torch.is_tensor(v):
        return v.cpu()
    if isinstance(v, FeatureMeta):
        return FeatureMeta(*(None if x is None else x.cpu() for x in v))
    if isinstance(v, dict):
        return {k: to_cpu(x) for k, x in v.items()}
    return v


def child_legs(csums, meta, params, rng, constr=None, depth=None):
    """The constrained legs' inputs of C children (``split.scan_inputs``):
    binding bounds 0.05 either side of each child's own output (every
    fourth child unbounded) unless ``constr`` is given, depths 1-8, and
    parent outputs at 0.8 of the child's."""
    C, dev = csums.shape[0], csums.device
    out = -csums[:, 0] / (csums[:, 1] + params.lambda_l2 + 1.0)
    if constr is None:
        constr = torch.stack([out - 0.05, out + 0.05], dim=1)
        constr[::4] = torch.tensor(NO_CONSTRAINT, device=dev)
    if depth is None:
        depth = torch.as_tensor(rng.randint(1, 9, C), device=dev)
    return scan_inputs(meta, params, C, dev, constr.contiguous(), depth,
                       (0.8 * out).contiguous())


def scan_children(C, F_, B, rng, dev, scaled=False):
    """C children's (C, F, B, 3) histograms binned from 200 signed, varied
    rows each (every feature sums to its child's totals), their sums and
    mask, and a feature meta of every missing type (zero, NaN, none; a
    2-bin feature and a narrower bin axis).  ``scaled``: the histograms
    hold integer sums and (C, 3) power-of-two scales (int8sr)."""
    mt = np.array([1, 2, 0, 0, 0] * F_)[:F_]
    nb = np.full(F_, B)
    nb[3] = 2
    nb[4] = max(2, B - 5)
    nanb = np.where(mt == 2, nb - 1, -1)
    zb = np.where(mt == 1, np.minimum(3, nb - 1), 0)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    meta = with_tables(FeatureMeta(
        num_bins=t(nb), missing_type=t(mt), nan_bin=t(nanb), zero_bin=t(zb),
        usable=torch.ones(F_, dtype=torch.bool, device=dev)))
    N = 200 * C
    rows = signed_rows(rng, N, dev)
    child = torch.as_tensor(rng.randint(0, C, N), device=dev)
    bins = torch.as_tensor(rng.randint(0, 1 << 16, (F_, N)) % nb[:, None],
                           device=dev)
    hist = torch.zeros((C, F_, B, 3), dtype=torch.float32, device=dev)
    for f in range(F_):
        hist[:, f].index_put_((child, bins[f]), rows, accumulate=True)
    csums = hist[:, 0].double().sum(dim=1).float()
    mask = torch.ones((C, F_), dtype=torch.bool, device=dev)
    mask[C // 2, 2] = False
    scale = None
    if scaled:
        scale = torch.tensor([2.0 ** -6, 2.0 ** -9, 1.0],
                             device=dev).expand(C, 3).contiguous()
        hist = torch.round(hist / scale[:, None, None, :])
    return hist.contiguous(), csums, mask, meta, scale


class ScanRecorder:
    """Keeps the inputs of the last split-scan call (``split_scan_pick``,
    every ``find_best_split``'s) at each child count C of a run (the main
    path's own, for the checks and the timing after it).  It counts
    nothing; the wrapper counts its launches."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        self._orig = sc.split_scan_pick

        def wrapped(hist, mask, csums, **kw):
            self.last[hist.shape[0]] = (hist, mask, csums, kw)
            return self._orig(hist, mask, csums, **kw)

        sc.split_scan_pick = wrapped
        return self

    def __exit__(self, *exc):
        sc.split_scan_pick = self._orig


def check_scan(tag, hist, mask, csums, kw) -> dict:
    """The split-scan kernel's packed rows (one launch: scan and pick) bit
    for bit its plain version run on the CPU on the same inputs (copied
    there), ``pick_pack`` on ``scan_residue``; its residue (the same
    kernel writing the scan's half) bit for bit ``scan_residue``; two
    launches of each bitwise equal."""
    got = sc.split_scan_pick(hist, mask, csums, **kw)
    again = sc.split_scan_pick(hist, mask, csums, **kw)
    check(bool(same_value(got, again).all()),
          f"split scan {tag}: two launches differ")
    res = sc.split_scan(hist, mask, csums, **kw)
    check(bool(same_value(res, sc.split_scan(hist, mask, csums, **kw))
               .all()), f"split scan {tag}: two residue launches differ")
    ckw = to_cpu(kw)
    cs = csums.cpu()
    want_res = scan_residue(hist.cpu(), mask.cpu(), cs, **ckw)
    want = pick_pack(want_res, gain_shift(cs, ckw["params"],
                                          ckw.get("parent_output")),
                     cs, ckw["meta"], hist.shape[2])
    bad = int((~same_value(got.cpu(), want)).sum())
    check(bad == 0, f"split scan {tag}: {bad} packed values differ from "
          "the CPU plain scan and pick")
    bad = int((~same_value(res.cpu(), want_res)).sum())
    check(bad == 0, f"split scan {tag}: {bad} residue values differ from "
          "the CPU plain scan")
    return {"case": tag, "finite": int(torch.isfinite(want_res[..., 0])
                                       .sum()),
            "cells": int(want_res[..., 0].numel()),
            "finite_picks": int(torch.isfinite(want[:, 0]).sum())}


def scan_case_kw(meta, opts, csums, rng, scale=None, constr=None):
    params = option_params(opts, lambda_l1=0.1, lambda_l2=1.0)
    m = option_meta(meta, opts)
    return dict(meta=m, params=params, hist_scale=scale,
                **child_legs(csums, m, params, rng, constr))


def phase_scan_kernels(ds, binned, meta, rng, dev) -> dict:
    """Phase 31: the split-scan kernel against the CPU plain scan on a
    real round's inputs and on synthetic children at C in {1, 2, 8, 32,
    126}, B in {16, 64, 256}, F = 28 and 27, each option set and with
    int8sr scales, null legs, a broadcast mask row and, at C = 2, F past
    the features a block's shared memory holds (the residue through
    global memory); K2's constrained legs at S = 4 / 16 / 63 (also with
    null legs) and on phase 14's sparse-live rounds; K6's contri / smooth / max-output
    legs against R K2 rounds and the plain scan.  Every check bit for
    bit."""
    out = {"scan": [], "k2": [], "k6": []}
    # a real round's bounds: two headline iterations with phase 32's
    # monotone constraints, staged, recorded at their largest round
    with ScanRecorder() as srec:
        train(MONO_PARAMS, ds, 2, **_on(dev))
        _sync(dev)
    C_r = max(srec.last)
    hist, mask, csums, kw = srec.last[C_r]
    real = kw["constraint"]
    bound = ((real[:, 0] > NO_CONSTRAINT[0]) | (real[:, 1]
                                                < NO_CONSTRAINT[1]))
    log(f"  a real round: C = {C_r}, {int(bound.sum())} children bounded")
    check(bool(bound.any()), "no bounded child in the real round")
    for name in ("monotone", "all"):
        opts = SCAN_OPTIONS[name]
        ckw = scan_case_kw(meta, opts, csums, rng, constr=real)
        out["scan"].append(check_scan(f"real round C={C_r} {name}", hist,
                                      mask, csums, ckw))
    for B in (16, 64, 256):
        for C in (1, 2, 8, 32, 126):
            hist, csums, mask, m, _ = scan_children(C, F, B, rng, dev)
            for name, opts in SCAN_OPTIONS.items():
                out["scan"].append(check_scan(
                    f"C={C} B={B} F={F} {name}", hist, mask, csums,
                    scan_case_kw(m, opts, csums, rng,
                                 constr=real[torch.arange(C) % C_r]
                                 if name == "monotone" else None)))
            hist, csums, mask, m, scale = scan_children(C, F, B, rng, dev,
                                                        scaled=True)
            for name in ("none", "all"):
                out["scan"].append(check_scan(
                    f"C={C} B={B} F={F} {name} int8sr scales", hist, mask,
                    csums, scan_case_kw(m, SCAN_OPTIONS[name], csums, rng,
                                        scale)))
    for name in ("none", "all"):        # an odd feature count
        hist, csums, mask, m, _ = scan_children(32, F - 1, 64, rng, dev)
        out["scan"].append(check_scan(
            f"C=32 B=64 F={F - 1} {name}", hist, mask, csums,
            scan_case_kw(m, SCAN_OPTIONS[name], csums, rng)))
    for C in (1, 126):      # the kernel's defaults for absent legs
        hist, csums, mask, m, _ = scan_children(C, F, 64, rng, dev)
        ckw = scan_case_kw(m, SCAN_OPTIONS["all"], csums, rng)
        out["scan"].append(check_scan(
            f"C={C} B=64 F={F} all, no bounds or parent outputs (null: "
            "NO_CONSTRAINT, 0)", hist, mask, csums,
            dict(ckw, constraint=None, parent_output=None)))
        row = mask[0].clone()       # one mask row for every child, as
        row[2] = False              # node_feature_masks expands it
        for name in ("none", "all"):
            out["scan"].append(check_scan(
                f"C={C} B=64 F={F} {name}, one broadcast mask row", hist,
                row[None, :].expand(C, F), csums,
                scan_case_kw(m, SCAN_OPTIONS[name], csums, rng)))
    for name in ("none", "all"):    # a residue past shared memory
        opts = SCAN_OPTIONS[name]
        m_opts = sc.scan_options(option_meta(meta, opts), option_params(opts))
        F_big = 37 + (sc.resident_features(dev.index, 16, m_opts)
                      if dev.type == "cuda" else 64)   # a CPU rehearsal
        hist, csums, mask, m, _ = scan_children(2, F_big, 16, rng, dev)
        out["scan"].append(check_scan(
            f"C=2 B=16 F={F_big} {name}, the residue in global memory",
            hist, mask, csums, scan_case_kw(m, opts, csums, rng)))
    fin = sum(c["finite"] for c in out["scan"])
    log(f"  split scan: {len(out['scan'])} cases bit for bit the CPU plain "
        f"scan ({fin} finite feature picks)")
    # K2's constrained legs
    N = binned.shape[1]
    cases = [(S, S, True) for S in (4, 16, 63)] + [(63, 63, False)]
    for S, n_live, sub in cases:
        for name in (("all",) if S < 63 or not sub else SCAN_OPTIONS):
            if name == "none":
                continue
            g3, kw = round_inputs(binned, meta, S, n_live, sub, "bf16x2",
                                  rng)
            out["k2"].append(check_k2_legs(
                f"S={S} {'sub' if sub else 'pool-free'} {name}", binned,
                g3, legs_kw(kw, SCAN_OPTIONS[name], rng)))
    g3, kw = round_inputs(binned, meta, 4, 4, True, "bf16x2", rng)
    out["k2"].append(check_k2_legs(     # null legs: NO_CONSTRAINT and 0
        "S=4 sub all, no bounds or parent outputs", binned, g3,
        dict(legs_kw(kw, SCAN_OPTIONS["all"], rng), constraint=None,
             parent_output=None)))
    for case, sub in SPARSE_CASES:
        chunk_rows = hc.plan(N, F, (4 if sub else 8) + 1, 64,
                             "bf16x2")["chunk_rows"]
        g3, kw = round_inputs(binned, meta, 4, 1, sub, "bf16x2", rng,
                              oleaf=sparse_leaves(N, chunk_rows, case),
                              leafs=[1])
        out["k2"].append(check_k2_legs(
            f"sparse {case} {'sub' if sub else 'pool-free'} all", binned,
            g3, legs_kw(kw, SCAN_OPTIONS["all"], rng)))
        live = out["k2"][-1]["live_rows"]
        want = {"one row": live == 1, "one chunk": 0 < live <= chunk_rows,
                "none": live == 0, "root": live == N}[case]
        check(want, f"K2 legs sparse {case}: {live} live rows")
    # K6's legs on a segment of a headline tree grown with them
    out["k6"] = loop_legs_kernels(binned, meta, rng)
    return out


def legs_kw(kw, opts, rng) -> dict:
    """A round's K2 keyword arguments with the option's meta, params and
    the children's legs (dead children as the grower fills them)."""
    params = option_params(opts)
    m = option_meta(kw["meta"], opts)
    legs = child_legs(kw["csums"], m, params, rng)
    return dict(kw, meta=m, params=params, **legs)


def check_k2_legs(tag, binned, g3, kw) -> dict:
    """K2 with constrained legs: leaf ids and labels its plain version's
    and K3's, hsmall K1's on the emitted label, the residue bit for bit
    the CPU plain scan (with the same legs) of its children, two launches
    bitwise equal."""
    got = fc.fused_round(binned, g3, **kw)
    again = fc.fused_round(binned, g3, **kw)
    for a, b, what in zip(got, again, ("residue", "hsmall", "new leaf ids",
                                       "label")):
        check(a is None or bool(same_value(a, b).all()),
              f"K2 {tag}: two launches differ in {what}")
    res, hsm, nleaf, label = got
    want = fc.fused_round_ref(binned, g3, **kw)
    check(torch.equal(nleaf, want[2]) and torch.equal(label, want[3]),
          f"K2 {tag}: leaf ids or labels differ from the plain version")
    route = kw["route"]
    check(torch.equal(fc.route_rows(binned, route["oleaf"], route["feats"],
                                    route["rmeta"], route["num_leaves"]),
                      nleaf), f"K3 {tag}: differs from K2's leaf ids")
    k1 = hc.hist_leaves(binned, g3, label, kw["nslots"] + 1,
                        kw["num_bins"], kw["precision"])[:kw["nslots"]]
    if hsm is not None:
        check(torch.equal(hsm, k1), f"K2 {tag}: hsmall differs from K1")
        children = wf.subtract_children(hsm, kw["parent"], kw["sml"])
    else:
        children = k1
    res_cpu = scan_residue(
        children.cpu(), kw["mask"].cpu(), kw["csums"].cpu(),
        meta=to_cpu(kw["meta"]), params=kw["params"],
        **to_cpu({k: kw[k] for k in ("constraint", "pfac",
                                     "parent_output")}))
    bad = int((~same_value(res.cpu(), res_cpu)).sum())
    check(bad == 0, f"K2 {tag}: {bad} residue values differ from the CPU "
          "plain scan")
    fin = check_pick(f"K2 legs {tag}", res, kw)
    live = int((label < kw["nslots"]).sum())
    log(f"  K2 legs {tag}: {live} live rows; leaf ids, labels, K3 exact; "
        "hsmall == K1; residue bit for bit the CPU plain scan, the pick "
        f"kernel on it the CPU pick ({fin} finite gains)")
    return {"case": tag, "live_rows": live, "pick_finite": fin}


def check_k6_legs(tag, args, min_rounds=2) -> dict:
    """K6 with its legs against R K2 rounds with the PyTorch pick and
    replay (bit for bit; two launches too) and, round by round, each K2
    round's residue and K6's packed rows bit for bit the CPU plain scan
    and pick of the round's children (phase 19's chain, its plain scan on
    the CPU)."""
    pos, kw = args
    got = lc.fused_wave_loop(*pos, **kw)
    again = lc.fused_wave_loop(*pos, **kw)
    rec = RoundRecorder()
    k2 = lc.loop_rounds(*pos, round_fn=rec, **kw)
    for a, b, c, what in zip(got, again, k2, ("packed rows", "new leaf ids",
                                              "pool", "split counts")):
        check(a is None or bool(same_value(a, b).all()),
              f"K6 {tag}: two launches differ in {what}")
        check(a is None or bool(same_value(a, c).all()),
              f"K6 {tag}: {what} differ from R K2 rounds")
    live = [n for n in got[3].tolist() if n > 0]
    check(len(live) == len(rec.rounds) and len(live) >= min_rounds,
          f"K6 {tag}: {len(live)} live rounds, {len(rec.rounds)} K2 rounds")
    meta_c, params = to_cpu(kw["meta"]), kw["params"]
    for r, (rkw, out) in enumerate(rec.rounds):
        ch = children_of(pos[0], pos[1], rkw, out)
        legs = to_cpu({k: rkw.get(k) for k in ("constraint", "pfac",
                                               "parent_output")})
        res_cpu = scan_residue(ch.cpu(), rkw["mask"].cpu(),
                               rkw["csums"].cpu(), meta=meta_c,
                               params=params, **legs)
        check(bool(same_value(out[0].cpu(), res_cpu).all()),
              f"K6 {tag}: round {r}'s residue differs from the CPU scan")
        cs = rkw["csums"].cpu()
        pk = pick_pack(res_cpu, gain_shift(cs, params,
                                           legs["parent_output"]), cs,
                       meta_c, kw["num_bins"])
        check(bool(same_value(got[0][r, :pk.shape[0]].cpu(), pk).all()),
              f"K6 {tag}: round {r}'s packed rows differ from the CPU pick")
    log(f"  K6 legs {tag}: split counts {got[3].tolist()}; packed rows, "
        f"leaf ids and pool bitwise equal to {len(live)} K2 rounds and "
        "across two launches; each round's residue and pick bit for bit "
        "the CPU plain scan's")
    return {"case": tag, "n_split": got[3].tolist()}


def loop_legs_kernels(binned, meta, rng) -> list:
    """K6's contri / smooth / max-output legs: a segment of a headline
    tree grown with them (phase 19's capture), R = 4, subtraction and
    pool-free, bf16x2; then a sparse-live segment (one chunk's rows)."""
    N = binned.shape[1]
    m = option_meta(meta, LOOP_OPTIONS)
    config = Config.from_dict(dict(LOOP_PARAMS, wave_loop_rounds=2))
    params = option_params(LOOP_OPTIONS,
                           min_data_in_leaf=float(config.min_data_in_leaf))
    grow = build_trainer(config, m, params, 64, binned.device, num_data=N)
    with LoopRecorder(k2_rounds=True) as cap:
        grow(binned, signed_rows(rng, N, binned.device), m.usable)
    check(cap.second is not None, "one segment in a tree")
    seg = cap.second
    out = [check_k6_legs(f"R=4 {'sub' if sub else 'pool-free'} bf16x2",
                         loop_call(seg, rounds=4,
                                   pool=seg[5]["pool"] if sub else None))
           for sub in (True, False)]
    lid, ft, nl = seg[2], seg[3], seg[4]
    sparams = params._replace(lambda_l2=1.0)
    chunk_rows = lc.bucket_plans(N, F, 64, "bf16x2", seg[5]["slot_buckets"],
                                 True)[0]["chunk_rows"]
    keep = torch.zeros_like(lid, dtype=torch.bool)
    c = (N // chunk_rows) // 2
    keep[c * chunk_rows:(c + 1) * chunk_rows] = True
    moved = torch.where(keep, lid, torch.full_like(lid, ft.shape[0] - 1))
    mft, mpool = parked_state(binned, seg[1], moved, ft, nl, m, sparams, 64)
    out.append(check_k6_legs(
        "sparse one chunk, R=4 sub bf16x2",
        loop_call(seg[:2] + (moved, mft) + seg[4:], rounds=4,
                  params=sparams, pool=mpool), 1))
    return out


def cuda_kernels(fn, reps: int = 20) -> list:
    """The names of the device kernels (and copies) one call of ``fn``
    runs, each as often as it ran a call: torch.profiler's device events
    over ``reps`` calls after a warm-up (CUDA activity alone, as
    ``kernel_device_ms``: with the CPU's too a profile of one short call
    may hold no device event); a profile that saw no device work is taken
    again, up to PROFILE_TRIES."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = Counter(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if seen:
            break
    return [name for name, n in sorted(seen.items())
            for _ in range(round(n / reps))]


def scan_timing(last: dict, launches: dict) -> dict:
    """Phase 31's timing: on phase 10's last inputs at C = 1, 8, 32 and
    126 (the root and the staged rounds of 4, 16 and 63 splits) the whole
    ``find_best_split`` and the split-scan kernel's wrapper by events, the
    kernel's device time, the device kernels one ``find_best_split``
    runs (profiler), its plain version on the card and its bound by bytes
    (each histogram cell read once, the packed rows written once); its
    launches a tree on the main paths.  No single PyTorch call computes a
    split scan."""
    rows = []
    for C in (1, 8, 32, 126):
        if C not in last:
            continue
        hist, mask, csums, kw = last[C]
        _, F_, B, _ = hist.shape

        def fbs():
            return find_best_split(
                hist, csums, kw["meta"], mask, kw["params"],
                hist_scale=kw["hist_scale"], constraint=kw["constraint"],
                parent_output=kw["parent_output"])

        fbs_ms = time_ms(fbs, 50)
        ms = time_ms(lambda: sc.split_scan_pick(hist, mask, csums, **kw), 50)
        device_ms = kernel_device_ms(lambda: sc.split_scan_pick(
            hist, mask, csums, **kw), ("split_scan_kernel",))[
                "split_scan_kernel"] or None   # None: the profiler saw none
        kernels = cuda_kernels(fbs)
        plain_ms = time_ms(lambda: sc.split_pick_ref(hist, mask, csums,
                                                     **kw), 3)
        nbytes = (C * F_ * B * 12 + C * F_ + C * 12 + 5 * F_ * 4
                  + C * sc.PACK_COLS * 4)
        ops = 2 * C * F_ * B * 20
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        rows.append({"C": C, "find_best_split_ms": fbs_ms, "ms": ms,
                     "device_ms": device_ms, "plain_ms": plain_ms,
                     "kernels_a_call": len(kernels),
                     "kernel_names": sorted(set(kernels)),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "ops": ops})
        log(f"  find_best_split C={C} (F={F_}, B={B}): {fbs_ms:.4f} ms by "
            f"events, {len(kernels)} device kernels a call "
            f"({', '.join(sorted(set(k[:40] for k in kernels)))}); the "
            f"kernel's wrapper {ms:.4f} ms, device {device_ms} ms (plain "
            f"{plain_ms:.3f} ms on the card, bound {rows[-1]['bound_ms']:.5f}"
            f" ms by {rows[-1]['bound_by']})")
    top = rows[-1]
    log(f"  split-scan launches a tree: {json.dumps(launches)}")
    return {"name": "split_scan", "route": "cuda", "source": SCAN_SRC,
            "replaces": "lightgbmv1_tpu/ops/split.py:437 find_best_split: "
            ":459 scan_left_sums, :533 scan_direction_gains, :636 "
            "scan_pick_feature and the cross-feature pick (XLA; "
            "ops/wave_fused.py:215 child_scan_residue inside K2, :610 "
            "_pick_pack)",
            "launches": int(launches["staged"]["launches"]),
            "max_abs_err": 0.0, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "library_note": "none: no single PyTorch "
            "call computes a split scan", "at": f"C={top['C']}",
            "buckets": rows, "launches_per_tree": launches}


def pick_timing(rec, trained: dict) -> dict:
    """The pick kernel on phase 15's last K2 inputs at each bucket: K2's
    round with its pick by events, the pick alone by events and on the
    device, the device kernels one pick runs (profiler), its plain
    version on the card and its bound by bytes (the residue read once,
    the packed rows written once); its launches on the fused path."""
    rows = []
    for (ns, prec, mode), (binned, g3, kw) in sorted(rec.last.items()):
        res = fc.fused_round(binned, g3, **kw)[0]
        C, F_, _ = res.shape
        pkw = dict(meta=kw["meta"], params=kw["params"],
                   parent_output=kw.get("parent_output"),
                   num_bins=kw["num_bins"])

        def round_pick():
            r = fc.fused_round(binned, g3, **kw)[0]
            return sc.split_pick(r, kw["csums"], **pkw)

        round_ms = time_ms(round_pick, 10)
        k2_ms = time_ms(lambda: fc.fused_round(binned, g3, **kw), 10)
        ms = time_ms(lambda: sc.split_pick(res, kw["csums"], **pkw), 50)
        device_ms = kernel_device_ms(lambda: sc.split_pick(
            res, kw["csums"], **pkw), ("split_pick_kernel",))[
                "split_pick_kernel"] or None
        kernels = cuda_kernels(lambda: sc.split_pick(res, kw["csums"], **pkw))
        plain_ms = time_ms(lambda: sc.pick_ref(res, kw["csums"], **pkw), 10)
        nbytes = C * F_ * sc.RES_COLS * 4 + C * 12 + C * 4 + 5 * F_ * 4 \
            + C * sc.PACK_COLS * 4
        rows.append({"nslots": ns, "precision": prec, "mode": mode, "C": C,
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "k2_ms": k2_ms, "round_with_pick_ms": round_ms,
                     "kernels_a_call": len(kernels),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "bytes": nbytes})
        log(f"  pick after K2 nslots={ns} {prec} {mode} (C={C}): {ms:.4f} "
            f"ms by events, device {device_ms} ms, {len(kernels)} device "
            f"kernels a call (plain {plain_ms:.3f} ms, bound "
            f"{rows[-1]['bound_ms']:.6f} ms by bytes); K2 with its pick "
            f"{round_ms:.4f} ms, K2 alone {k2_ms:.4f} ms")
    top = max(rows, key=lambda r: r["C"])
    return {"name": "split_pick", "route": "cuda", "source": SCAN_SRC,
            "replaces": "lightgbmv1_tpu/ops/wave_fused.py:610 _pick_pack "
            "(XLA, after the Pallas kernel K2)",
            "launches": int(trained["split_pick_launches"]),
            "max_abs_err": 0.0, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "library_note": "none: no single PyTorch "
            "call computes a tie-band pick", "at": f"C={top['C']}",
            "buckets": rows}


def scan_launches(trees) -> dict:
    """The split-scan launches since the counts were reset, and a tree's;
    no plain scan ran."""
    n = sc.launch_counts["split_scan"]
    check(n > 0, "the split-scan kernel never launched")
    check(not any(sc.plain_counts.values()),
          f"a plain scan or pick ran on the path: {sc.plain_counts}")
    return {"launches": n, "per_tree": n / trees,
            "by_opts": {str(k): v for k, v in
                        sorted(sc.opt_launch_counts.items())}}


def monotone_on_grid(text, Xv, dev, mono) -> dict:
    """The model served through K4 (raw scores) is monotone along every
    constrained feature on a grid of 64 points (the feature's 1st to 99th
    percentile) at 64 probe rows: non-decreasing where +1, non-increasing
    where -1 (tests/test_monotone.py's check)."""
    bst = Booster(model_str=text, **_on(dev))
    base = Xv[:64]
    out = {}
    for f, sign in enumerate(mono):
        if sign == 0:
            continue
        grid = np.quantile(Xv[:, f], np.linspace(0.01, 0.99, 64))
        pts = np.repeat(base, 64, axis=0)
        pts[:, f] = np.tile(grid, 64)
        p = bst.predict(pts, predict_method="fused",
                        raw_score=True).reshape(64, 64)
        d = np.diff(p, axis=1) * sign
        out[f"X{f}"] = float(d.min())
        check(bool((d >= -1e-10).all()), f"monotone X{f}: the served model "
              f"moves against its constraint by {float(-d.min()):.3e}")
    return out


def phase_constrained_train(ds, dv, Xv, iters, dev):
    """Phase 32, the slice's main path: monotone basic and intermediate
    trainings staged and fused, and contri + path smoothing + max output
    staged, fused and looped, launch counts reset around each; each
    pair's or triple's texts equal, only kernels on the path, the split
    scan and the legs each needs launched; the monotone models AUC >
    0.90 and monotone on the grids.  Returns the numbers and each run's
    recorders."""
    out, recs = {}, {}
    for name, params, paths in CONSTRAINED_RUNS:
        texts = {}
        for path in paths:
            p = dict(params, **PATH_EXTRA[path])
            reset_counts()
            ev = {}
            with FusedRecorder() as frec, LoopRecorder() as lrec:
                t0 = time.perf_counter()
                bst = train(p, ds, iters, valid_sets=[dv], evals_result=ev,
                            **_on(dev))
                _sync(dev)
                secs = time.perf_counter() - t0
            trees = bst.num_trees()
            plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
                     **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
                     **{f"loop.{k}": v for k, v in lc.plain_counts.items()},
                     **{f"scan.{k}": v for k, v in sc.plain_counts.items()}}
            check(not any(plain.values()),
                  f"{name} {path}: a plain version ran: {plain}")
            scan = scan_launches(trees)
            k2 = {f"{k[0]}:{k[1]}:{k[2]}": v
                  for k, v in sorted(fc.bucket_launch_counts.items())}
            k6 = {f"{k[0]}:{k[1]}:{k[2]}": v
                  for k, v in sorted(lc.bucket_launch_counts.items())}
            opts = sc.scan_options(
                make_feature_meta(ds._binned, dev,
                                  p.get("monotone_constraints"),
                                  p.get("feature_contri")),
                bst._gbdt.split_params)
            check(set(scan["by_opts"]) == {str(opts)}, f"{name} {path}: "
                  f"split scans at options {scan['by_opts']}, not {opts}")
            if path == "fused":
                check(k2 and all(k.endswith(f":opts{opts}") for k in k2),
                      f"{name} fused: K2 launches {k2}")
            if path == "looped":
                check(k6 and all(k.endswith(f":opts{opts}") for k in k6)
                      and not k2, f"{name} looped: K6 {k6}, K2 {k2}")
            text = bst.model_to_string()
            texts[path] = text
            auc = ev["valid_0"]["auc"][-1]
            r = {"iters": iters, "s_per_iter": secs / iters,
                 "valid_auc": auc, "split_scan": scan, "k2": k2, "k6": k6,
                 **text_hash(text, f"{name} {path}")}
            log(f"  {name} {path}: {iters} iterations, "
                f"{r['s_per_iter']:.4f} s/iter; valid AUC {auc:.5f}; "
                f"split scans {scan['per_tree']:.2f} a tree "
                f"({json.dumps(scan['by_opts'])}), K2 {json.dumps(k2)}, K6 "
                f"{json.dumps(k6)}")
            if params is not OPTS_PARAMS:
                check(auc > MONO_AUC_MIN, f"{name} {path}: valid AUC {auc} "
                      f"<= {MONO_AUC_MIN}")
                r["monotone_min_step"] = monotone_on_grid(text, Xv, dev,
                                                          MONO)
            out[f"{name} {path}"] = r
            recs[(name, path)] = (frec, lrec)
        check(all(t == texts[paths[0]] for t in texts.values()),
              f"{name}: the {', '.join(paths)} model texts differ")
        log(f"  {name}: the {', '.join(paths)} model texts are one, byte "
            "for byte")
    return out, recs


def legs_timing(recs) -> dict:
    """K2's and K6's constrained legs on phase 32's last inputs (the
    contri + smooth + max-output fused and looped runs, the monotone
    basic fused run) beside the same launch unconstrained (the options'
    meta and params off) on the same inputs."""
    out = {}
    name = "contri+smooth+max_output"
    for tag, key in (("k2 monotone", ("basic", "fused")),
                     ("k2 contri+smooth+max_output", (name, "fused"))):
        frec = recs[key][0]
        ns, prec, mode = max(frec.last)
        binned, g3, kw = frec.last[(ns, prec, mode)]
        plain = dict(kw, meta=with_tables(kw["meta"]._replace(
                         monotone_type=None, contri=None)),
                     params=SplitParams(*kw["params"][:5]), constraint=None,
                     pfac=None, parent_output=None)
        ms = time_ms(lambda: fc.fused_round(binned, g3, **kw), 10)
        ms0 = time_ms(lambda: fc.fused_round(binned, g3, **plain), 10)
        ms_b = time_ms(lambda: fc.fused_round(binned, g3, **kw), 10)
        out[tag] = {"nslots": ns, "precision": prec, "mode": mode,
                    "ms": (ms + ms_b) / 2, "unconstrained_ms": ms0}
        log(f"  {tag} at nslots={ns} {prec} {mode}: {out[tag]['ms']:.4f} ms"
            f" beside {ms0:.4f} ms unconstrained on the same inputs")
    lrec = recs[(name, "looped")][1]
    pos, kw = loop_call(lrec.last)
    plain = dict(kw, meta=with_tables(kw["meta"]._replace(contri=None)),
                 params=SplitParams(*kw["params"][:5]))
    ms = time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10)
    ms0 = time_ms(lambda: lc.fused_wave_loop(*pos, **plain), 10)
    ms_b = time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10)
    out["k6 contri+smooth+max_output"] = {"ms": (ms + ms_b) / 2,
                                          "unconstrained_ms": ms0}
    log(f"  k6 contri+smooth+max_output on the looped run's last inputs: "
        f"{(ms + ms_b) / 2:.4f} ms beside {ms0:.4f} ms unconstrained")
    return out


class CardRounding:
    """The two f32 roundings of a training that differ between the card
    and the CPU outside the ported kernels: the objective's gradients
    (the card's and the CPU's f32 exp round differently) and each tree's
    root sums (``models/grower.root_sums``, an f32 reduction in each
    device's own order).  ``record()`` keeps a card training's, in call
    order; ``replay()`` hands them to a CPU training of the same
    configuration, whose plain versions then see the card's inputs.
    Phase 33 needs it: a monotone bound's strict output compare (the
    reference's, in the scan) flips on a one-ulp difference of its
    inputs, where phase 11's unconstrained gains only move in the tie
    band."""

    def __init__(self):
        self.grads, self.sums = [], []

    @contextlib.contextmanager
    def _patched(self, grads, sums):
        saved = objectives.ObjectiveFunction.get_gradients, \
            grower_wave.root_sums
        objectives.ObjectiveFunction.get_gradients = grads
        grower_wave.root_sums = sums
        try:
            yield self
        finally:
            objectives.ObjectiveFunction.get_gradients, \
                grower_wave.root_sums = saved

    def record(self):
        grads0, sums0 = objectives.ObjectiveFunction.get_gradients, \
            grower_wave.root_sums

        def grads(obj, score):
            out = grads0(obj, score)
            self.grads.append(tuple(t.cpu() for t in out))
            return out

        def sums(g3):
            out = sums0(g3)
            self.sums.append(out.cpu())
            return out

        return self._patched(grads, sums)

    def replay(self):
        it_g, it_s = iter(self.grads), iter(self.sums)

        def grads(obj, score):
            return tuple(t.to(score.device) for t in next(it_g))

        def sums(g3):
            return next(it_s).to(g3.device)

        return self._patched(grads, sums)


def card_vs_cpu_replay(tag, params, X, y, dev, iters=5,
                       precision="f32") -> dict:
    """``card_vs_cpu`` with the CPU training taking the card training's
    gradients and root sums (``CardRounding``): every split identical,
    leaves within PARITY_LEAF_TOL; at ``hist_dtype=precision``."""
    p = dict(params, hist_dtype=precision, hist_method="pallas")
    log(f"  {tag}, card against CPU (K1's order, the card's gradients and "
        f"root sums): {len(X)} rows, {iters} iterations")
    rounding = CardRounding()
    saved = grower_wave._BUCKET_MIN_N
    grower_wave._BUCKET_MIN_N = 1
    try:
        with rounding.record(), (roworder_plain() if torch.device(
                dev).type == "cpu" else contextlib.nullcontext()):
            card = train(p, Dataset(X, label=y), iters, **_on(dev))
            _sync(dev)
        with rounding.replay(), roworder_plain():
            cpu = train(p, Dataset(X, label=y), iters, device="cpu")
    finally:
        grower_wave._BUCKET_MIN_N = saved
    return compare_splits(tag, card, cpu, ("card", "CPU"), PARITY_LEAF_TOL)


CONSTRAINED_PARITY = dict(monotone_constraints=MONO,
                          monotone_constraints_method="intermediate",
                          monotone_penalty=1.0, feature_contri=CONTRI,
                          path_smooth=1.0, max_delta_step=0.7)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# plain int8 histograms and sampling (phases 34-37)
# ---------------------------------------------------------------------------

INT8_PARAMS = dict(TRAIN_PARAMS, hist_dtype="int8")
INT8_DEEP_PARAMS = dict(TRAIN_PARAMS, hist_dtype_deep="int8")
INT8_RUNS = (
    ("staged", INT8_PARAMS),
    ("fused", dict(INT8_PARAMS, hist_method="fused")),
    ("looped", dict(INT8_PARAMS, hist_method="fused", wave_loop_rounds=4)),
    ("deep staged", INT8_DEEP_PARAMS),
    ("deep fused", dict(INT8_DEEP_PARAMS, hist_method="fused")))
# int8_auc.py (this generator, TRAIN_PARAMS with hist_method=pallas, 50
# iterations; the JAX package's Pallas kernel interpreted on the CPU): the
# JAX package's valid AUC at hist_dtype=int8 on phase 35's 1,048,576 rows
# (4,246 s), and at int8 / bf16x2 on 65,536 rows.  The gate sits just
# below the JAX figure: past the first trees the two packages' trees part
# (a one-ulp gradient difference moves a rounding to 255 levels).
JAX_INT8_AUC = 0.908416
JAX_INT8_AUC_65K = (0.902336, 0.902183)
INT8_AUC_MIN = 0.906
SAMPLE = dict(bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.9,
              feature_fraction_bynode=0.8)
BAG_TREE = dict(bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.9)
SAMPLE_RUNS = (
    ("staged", dict(TRAIN_PARAMS, **SAMPLE)),
    ("fused", dict(TRAIN_PARAMS, hist_method="fused", **SAMPLE)),
    ("bag+tree fused", dict(LOOP_PARAMS, wave_loop_rounds=1, **BAG_TREE)),
    ("bag+tree looped", dict(LOOP_PARAMS, **BAG_TREE)))


def bagged_rows(rng, n, dev, frac=0.8) -> torch.Tensor:
    """``signed_rows`` with the out-of-bag rows zeroed, as bagging leaves
    them (count 0 too), and one all-zero 1,024-row tile (amax 0)."""
    g3 = signed_rows(rng, n, dev)
    g3 *= torch.from_numpy((rng.rand(n) < frac).astype(np.float32)).to(
        dev)[:, None]
    g3[1024:2048] = 0.0
    return g3.contiguous()


def check_rn_quantize(tag, g3, T) -> dict:
    """The round-to-nearest quantize kernel against its plain version on
    the card and on the CPU at the scale tile T: rows and scales bit for
    bit, two launches equal; the rows integers in [-127, 127], the counts
    0 or 64."""
    q, scale = qz.rn_quantize(g3, T)
    q2, s2 = qz.rn_quantize(g3, T)
    pq, ps = qz.rn_quantize_ref(g3, T)
    cq, cs = qz.rn_quantize_ref(g3.cpu(), T)
    check(same_bits(q, q2) and same_bits(scale, s2),
          f"rn_quantize {tag}: two launches differ")
    check(same_bits(q, pq) and same_bits(scale, ps), f"rn_quantize {tag}: "
          f"not bitwise the plain version ({int((q != pq).sum())} values, "
          f"{int((scale != ps).sum())} scales differ)")
    check(same_bits(q.cpu(), cq) and same_bits(scale.cpu(), cs),
          f"rn_quantize {tag}: not bitwise the plain version on the CPU")
    check(bool((q == q.round()).all()) and float(q[:, :2].abs().max()) <= 127
          and bool(((q[:, 2] == 0) | (q[:, 2] == 64)).all()),
          f"rn_quantize {tag}: rows not integers in [-127, 127] or counts "
          "not 0 / 64")
    zero = int((scale[:, 0] == 0).sum())
    log(f"  rn_quantize {tag}: {g3.shape[0]} rows, {scale.shape[0]} tiles "
        f"({zero} with amax 0) bitwise the plain version on the card and "
        "the CPU")
    return {"case": tag, "N": int(g3.shape[0]), "T": T,
            "zero_tiles": zero, "max_abs_err": 0.0}


def int8_bound(binned, g3, lid, L, B, T, live=None):
    """A K1 int8 cell's bound against the Pallas kernel's order (the plain
    version ``hist_leaves_ref``): each order rounds at most once a tile
    and once a chunk, each rounding within 2^-24 of the cell's absolute
    sum of products, at most (1 + 1/254) times the rows' absolute sum."""
    absum = hc.index_add_hist(binned, [g3.abs()], lid, L, B, live)
    N = g3.shape[0]
    steps = 2 * (-(-N // T) + hc.plan(N, binned.shape[0], L, B, "int8",
                                      T)["n_chunks"])
    return steps * 2.0 ** -24 * (1 + 1 / 254) * absum + 1e-30


def check_k1_int8(tag, binned, g3, lid, L, B=64, packed=None,
                  live=None, T=None) -> dict:
    """K1's int8 leg against its plain version in the kernel's order
    (``hist_leaves_roworder_ref``): bit for bit; counts exact and values
    within ``int8_bound`` of the Pallas kernel's order; two launches
    equal; the dead slot; with ``packed`` (the pack4bit bytes of
    ``binned``) its packed leg bitwise the u8 leg (F even: one scale
    tile for both).  ``T``: the scale tile (default the kernel's own,
    ``hist_row_tile``)."""
    T = T or hc.hist_row_tile(L, binned.shape[0], B)
    got = hc.hist_leaves(binned, g3, lid, L, B, "int8", live, row_tile=T)
    check(same_bits(got, hc.hist_leaves(binned, g3, lid, L, B, "int8",
                                        live, row_tile=T)),
          f"K1 int8 {tag}: two launches differ")
    row = hc.hist_leaves_roworder_ref(binned, g3, lid, L, B, "int8", live,
                                      row_tile=T)
    check(same_bits(got, row), f"K1 int8 {tag}: not bitwise the row-order "
          f"version ({int((got != row).sum())} cells differ)")
    want = hc.hist_leaves_ref(binned, g3, lid, L, B, "int8", live,
                              row_tile=T)
    check(torch.equal(got[..., 2], want[..., 2]), f"K1 int8 {tag}: counts "
          "differ from the Pallas kernel's order")
    diff = (got - want).abs()
    tol = int8_bound(binned, g3, lid, L, B, T, live)
    over = int((diff > tol).sum())
    check(over == 0, f"K1 int8 {tag}: {over} cells past the order bound")
    if L > 1:
        dead = hc.hist_leaves(binned, g3, lid, L, B, "int8", L - 1,
                              row_tile=T)
        check(same_bits(dead[:L - 1], got[:L - 1])
              and not bool(dead[L - 1].view(torch.int32).any()),
              f"K1 int8 {tag}: the dead slot changed a live cell or is "
              "not 0")
    if packed is not None:
        pk = hc.hist_leaves(packed, g3, lid, L, B, "int8", live, packed=True,
                            num_features=binned.shape[0], row_tile=T)
        check(same_bits(pk, got), f"K1 int8 {tag}: the packed leg differs "
              "from the u8 leg")
    p = hc.plan(g3.shape[0], binned.shape[0], L, B, "int8", T)
    log(f"  K1 int8 {tag}: T={T}, {p['groups']} slot group(s), "
        f"{p['n_chunks']} chunks of "
        f"{p['chunk_rows']} rows; bitwise the row-order version, "
        f"repeatable{', packed leg the u8 leg' if packed is not None else ''}"
        f"; vs the Pallas order max_abs_err {float(diff.max()):.3e}")
    return {"case": tag, "T": T, "groups": p["groups"],
            "n_chunks": p["n_chunks"],
            "max_abs_err": 0.0, "max_err_vs_pallas_order": float(diff.max()),
            "packed": packed is not None}


def check_k2_int8(tag, binned, g3, kw, packed=None) -> dict:
    """K2's int8 leg on one round, bit for bit: leaf ids, labels and K3 as
    the plain version; hsmall K1's int8 histogram of the emitted label at
    K2's scale tile, in the kernel's order (the row-order version and K1
    itself); the residue the CPU plain scan's of those children; two
    launches equal; with ``packed`` the packed leg the u8 leg."""
    B, F_ = kw["num_bins"], binned.shape[0]
    got = fc.fused_round(binned, g3, **kw)
    again = fc.fused_round(binned, g3, **kw)
    for a, b, what in zip(got, again, ("residue", "hsmall", "new leaf ids",
                                       "label")):
        check(a is None or bool(same_value(a, b).all()),
              f"K2 int8 {tag}: two launches differ in {what}")
    res, hsm, nleaf, label = got
    want = fc.fused_round_ref(binned, g3, **kw)
    check(torch.equal(nleaf, want[2]) and torch.equal(label, want[3]),
          f"K2 int8 {tag}: leaf ids or labels differ from the plain version")
    r = kw["route"]
    check(torch.equal(fc.route_rows(binned, r["oleaf"], r["feats"],
                                    r["rmeta"], r["num_leaves"]), nleaf),
          f"K3 {tag}: differs from K2's leaf ids")
    ns = kw["nslots"]
    T = hc.round_row_tile(ns, F_, B)
    k1 = hc.hist_leaves_roworder_ref(binned, g3, label, ns + 1, B, "int8",
                                     ns, row_tile=T)[:ns]
    kk = hc.hist_leaves(binned, g3, label, ns + 1, B, "int8", ns,
                        row_tile=T)[:ns]
    check(same_bits(kk, k1), f"K2 int8 {tag}: K1 at K2's tile is not its "
          "row-order version")
    if hsm is not None:
        check(same_bits(hsm, k1), f"K2 int8 {tag}: hsmall is not the int8 "
              "histogram of its label in the kernel's order")
        children = wf.subtract_children(hsm, kw["parent"], kw["sml"])
    else:
        children = k1
    meta = kw["meta"]
    res_cpu = scan_residue(children.cpu(), kw["mask"].cpu(),
                           kw["csums"].cpu(), meta=to_cpu(meta),
                           params=kw["params"]).to(res.device)
    check(bool(same_value(res, res_cpu).all()), f"K2 int8 {tag}: the "
          "residue is not the CPU plain scan of its children")
    if packed is not None:
        pgot = fc.fused_round(packed, g3, packed=True, **kw)
        for a, b, what in zip(pgot, got, ("residue", "hsmall",
                                          "new leaf ids", "label")):
            check(a is None or bool(same_value(a, b).all()),
                  f"K2 int8 {tag}: the packed leg differs in {what}")
    rows = (label < ns).nonzero()[:, 0]
    live = int(rows.numel())
    # the scale tiles a 256-entry run of the listed rows meets, on average
    # (the list walk's tiles; its chunks start new runs, ignored here)
    tiles = rows // T
    steps = torch.ones_like(tiles, dtype=torch.bool)
    steps[1:] = tiles[1:] != tiles[:-1]
    steps[::256] = True
    span = float(steps.sum()) / max(1, -(-live // 256))
    log(f"  K2 int8 {tag}: T={T}, {live} live rows, {span:.1f} scale tiles "
        "a 256-row list tile; leaf ids, labels, K3 "
        "exact; hsmall the row-order int8 histogram; residue the CPU plain "
        "scan's; repeatable"
        + ("; packed leg the u8 leg" if packed is not None else ""))
    return {"case": tag, "T": T, "rows_in_slots": live, "max_abs_err": 0.0,
            "tiles_per_list_tile": span, "packed": packed is not None}


def check_k6_int8(tag, args, min_rounds=2) -> dict:
    """K6's int8 leg against R launches of K2 with the PyTorch pick and
    replay: packed rows, leaf ids, pool and split counts bit for bit; two
    launches equal; split counts the plain version's."""
    pos, kw = args
    got = lc.fused_wave_loop(*pos, **kw)
    again = lc.fused_wave_loop(*pos, **kw)
    rec = RoundRecorder()
    k2 = lc.loop_rounds(*pos, round_fn=rec, **kw)
    plain = lc.fused_wave_loop_ref(*pos, **kw)
    for a, b, c, what in zip(got, again, k2, ("packed rows", "new leaf ids",
                                              "pool", "split counts")):
        check(a is None or bool(same_value(a, b).all()),
              f"K6 int8 {tag}: two launches differ in {what}")
        check(a is None or bool(same_value(a, c).all()),
              f"K6 int8 {tag}: {what} differ from R K2 rounds")
    n_split = got[3].tolist()
    check(n_split == plain[3].tolist(), f"K6 int8 {tag}: split counts "
          f"{n_split} against the plain version's {plain[3].tolist()}")
    precs = [rkw["precision"] for rkw, _ in rec.rounds]
    check(len(precs) >= min_rounds and set(precs) == {"int8"},
          f"K6 int8 {tag}: rounds {precs}")
    tiles = [hc.round_row_tile(rkw["nslots"], kw["base_mask"].shape[0],
                               kw["num_bins"]) for rkw, _ in rec.rounds]
    log(f"  K6 int8 {tag}: split counts {n_split}, scale tiles {tiles}; "
        f"packed rows, leaf ids and pool bitwise {len(precs)} K2 rounds and "
        "across two launches")
    return {"case": tag, "n_split": n_split, "tiles": tiles,
            "max_abs_err": 0.0}


def int8_segment(binned, meta, B, rng, packed=False):
    """The second segment of a looped int8 grow (R = 2 a launch) on
    ``binned``, recorded as R K2 rounds: K6's inputs at a tree's own
    state."""
    config = Config.from_dict(dict(INT8_PARAMS, hist_method="fused",
                                   wave_loop_rounds=2))
    params = SplitParams(min_data_in_leaf=float(config.min_data_in_leaf))
    N = binned.shape[1]
    grow = build_trainer(config, meta, params, B, binned.device, num_data=N,
                         packed=packed)
    with LoopRecorder(k2_rounds=True) as cap:
        grow(binned, bagged_rows(rng, N, binned.device), meta.usable,
             key=CHECK_KEY)
    check(cap.second is not None, "an int8 tree of one segment")
    return cap.second


def phase_int8_kernels(binned, meta, rng, packed_ds) -> dict:
    """Phase 34: the round-to-nearest quantize kernel at every scale tile
    (out-of-bag zero rows, an all-zero tile, an odd N); K1's int8 leg at
    L = 2, 17, 64 on byte bins and (16 bins) packed bins, and at L = 64 at
    every scale tile; K2's at S = 16 and 63 in subtraction mode, 63
    pool-free, the sparse-live rounds, two rounds whose listed rows are
    spaced so that a warp batch crosses scale tiles, and (16 bins) its
    packed leg; K6 at R = 4 on a segment of a headline int8 tree,
    subtraction and pool-free, and its packed leg on a 16-bin tree's
    segment."""
    Fn, N = binned.shape
    dev = binned.device
    out = {"quantize": [], "k1": [], "k2": [], "k6": []}
    for T in qz.ROW_TILES:
        out["quantize"].append(check_rn_quantize(
            f"N={N} T={T}", bagged_rows(rng, N, dev), T))
    odd = (N * 3 // 4) | 1
    out["quantize"].append(check_rn_quantize(
        f"N={odd} T=512", bagged_rows(rng, odd, dev), 512))
    # the tails the kernel's 16-byte loads and stores mask
    for T in qz.ROW_TILES:
        for n in (1, 3, T - 1, T + 1, 4 * T + 3):
            out["quantize"].append(check_rn_quantize(
                f"N={n} T={T}", bagged_rows(rng, n, dev), T))
    # rows a float past a 16-byte boundary: the kernel's scalar leg
    n = 4 * 512 + 3
    buf = torch.empty(3 * n + 1, dtype=torch.float32, device=dev)
    buf[1:] = bagged_rows(np.random.RandomState(34), n, dev).reshape(-1)
    for T in (128, 512):
        out["quantize"].append(check_rn_quantize(
            f"N={n} T={T} off 16 B", buf[1:].view(n, 3), T))
    b16 = (binned % 16).to(torch.uint8).contiguous()
    p16 = hc.pack4bit(b16)
    for L in (2, 17, 64):
        lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32)).to(dev)
        g3 = bagged_rows(rng, N, dev)
        out["k1"].append(check_k1_int8(f"L={L} B=64", binned, g3, lid, L))
        out["k1"].append(check_k1_int8(f"L={L} B=16", b16, g3, lid, L, 16,
                                       p16))
    # L = 64 at every scale tile: T = 128 puts two in a 256-row tile, 1024
    # spans four, so a warp's rows cross tiles within and across batches
    lid = torch.from_numpy(rng.randint(0, 64, N).astype(np.int32)).to(dev)
    g3 = bagged_rows(rng, N, dev)
    for T in qz.ROW_TILES:
        out["k1"].append(check_k1_int8(f"L=64 B=64 T={T}", binned, g3, lid,
                                       64, T=T))
    for S, sub in ((16, True), (63, True), (63, False)):
        g3, kw = round_inputs(binned, meta, S, S, sub, "int8", rng)
        g3 = g3 * bagged_rows(rng, N, dev)[:, 2:3]
        out["k2"].append(check_k2_int8(
            f"S={S} {'sub' if sub else 'pool-free'}", binned, g3, kw))
    for case, sub in SPARSE_CASES:
        ns = 16 if sub else 32
        chunk_rows = hc.plan(N, Fn, ns + 1, 64, "int8", hc.round_row_tile(
            ns, Fn, 64))["chunk_rows"]
        g3, kw = round_inputs(binned, meta, 16, 1, sub, "int8", rng,
                              oleaf=sparse_leaves(N, chunk_rows, case),
                              leafs=[1])
        out["k2"].append(check_k2_int8(
            f"sparse {case}, S=16 {'sub' if sub else 'pool-free'}", binned,
            g3, kw))
    # one live row every `stride`: a list tile's 256 rows span many scale
    # tiles, so each warp batch crosses several (613: nearly one a row)
    for stride in (37, 613):
        oleaf = np.zeros(N, np.int64)
        oleaf[stride // 2::stride] = 1
        g3, kw = round_inputs(binned, meta, 16, 1, False, "int8", rng,
                              oleaf=oleaf, leafs=[1])
        out["k2"].append(check_k2_int8(
            f"spaced every {stride} rows, S=16 pool-free", binned, g3, kw))
    # 16 bins: a packed dataset's meta, so every split is one of its bins
    pb = torch.as_tensor(packed_ds.binned, device=dev).contiguous()
    pmeta = make_feature_meta(packed_ds, dev)
    ppk = hc.pack4bit(pb)
    for S, sub in ((16, True), (63, False)):
        g3, kw = round_inputs(pb, pmeta, S, S, sub, "int8", rng, B=16)
        out["k2"].append(check_k2_int8(
            f"S={S} {'sub' if sub else 'pool-free'} B=16", pb, g3, kw, ppk))
    seg = int8_segment(binned, meta, 64, rng)
    for sub in (True, False):
        args = loop_call(seg, rounds=4, pool=seg[5]["pool"] if sub else None)
        out["k6"].append(check_k6_int8(
            f"R=4 {'sub' if sub else 'pool-free'}", args))
    seg = int8_segment(ppk, pmeta, 16, rng, packed=True)
    out["k6"].append(check_k6_int8("R=4 sub packed B=16",
                                   loop_call(seg, rounds=4)))
    return out


def int8_counts() -> dict:
    """The launch counts of a run by leg: K1, K2, K6 by bucket and the
    quantize kernels."""
    return {
        "k1": {f"{k[0]}:{k[1]}": v
               for k, v in sorted(hc.bucket_launch_counts.items())},
        "k2": {f"{k[0]}:{k[1]}:{k[2]}": v
               for k, v in sorted(fc.bucket_launch_counts.items())},
        "k6": {f"{k[0]}:{k[1]}:{k[2]}": v
               for k, v in sorted(lc.bucket_launch_counts.items())},
        "rn_quantize": qz.launch_counts["rn_quantize"],
        "sr_quantize": qz.launch_counts["sr_quantize"]}


def plain_calls() -> dict:
    return {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
            **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
            **{f"loop.{k}": v for k, v in lc.plain_counts.items()},
            **{f"quantize.{k}": v for k, v in qz.plain_counts.items()},
            **{f"scan.{k}": v for k, v in sc.plain_counts.items()}}


def recorded_run(params, ds, dv, iters, dev):
    """One training with the valid set, launch counts reset first, under
    the call recorders; returns the booster, its seconds, the valid
    metrics, launch and plain-version counts and the recorders."""
    reset_counts()
    ev = {}
    with HistRecorder() as hrec, FusedRecorder() as frec, \
            LoopRecorder() as lrec:
        t0 = time.perf_counter()
        booster = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                        **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    return booster, secs, ev, int8_counts(), plain_calls(), (hrec, frec,
                                                             lrec)


def check_int8_launches(name, counts):
    """Each int8 run through its int8 legs and no other leg of the
    precision's: hist_dtype=int8 runs every K1, K2 and K6 launch at int8
    (K1 the staged rounds and every root pass, K2 the fused rounds, K6
    the looped segments); hist_dtype_deep=int8 runs int8 exactly at the
    sustained 63-slot bucket (K1 at 64 slots, K2 at nslots 63) and
    bf16x2 elsewhere; the quantize kernel ran."""
    k1, k2, k6 = counts["k1"], counts["k2"], counts["k6"]
    prec = {path: {k.split(":")[1] for k in d} for path, d in
            (("k1", k1), ("k2", k2), ("k6", k6))}
    check(counts["rn_quantize"] > 0 and counts["sr_quantize"] == 0,
          f"int8 {name}: quantize launches {counts}")
    if not name.startswith("deep"):
        check(prec["k1"] == {"int8"} and prec["k2"] <= {"int8"}
              and prec["k6"] <= {"int8"}, f"int8 {name}: legs {prec}")
        check({"staged": not k2 and not k6, "fused": k2 and not k6,
               "looped": k6 and not k2}[name],
              f"int8 {name}: K2 {k2}, K6 {k6}")
        check(name != "staged" or {int(k.split(":")[0]) for k in k1}
              > {2}, f"int8 staged: K1 at {sorted(k1)}")
        return
    path = k2 if name == "deep fused" else k1
    at = {k.split(":")[0] for k in path if k.split(":")[1] == "int8"}
    check(at == ({"63"} if name == "deep fused" else {"64"}),
          f"int8 {name}: int8 launches at {sorted(at)}")
    check(prec["k1"] <= {"int8", "bf16x2"} and not k6
          and (name == "deep fused") == bool(k2),
          f"int8 {name}: legs {prec}")


def phase_int8_train(ds, dv, Xv, iters, dev, bf16x2_leaf=None):
    """Phase 35, the int8 training main path at the headline: staged,
    fused and looped at hist_dtype=int8, staged and fused at
    hist_dtype_deep=int8, each with its launch counts reset around it and
    only its int8 legs; the looped text the fused one, the staged text
    the fused one (K1's and K2's scale tiles and plans agree on byte
    bins) and a second staged training the same text; the valid AUC
    beside the JAX package's figure; each model's largest |leaf| beside
    ``bf16x2_leaf`` (phase 10's); each model served through K4."""
    out, recs, texts = {}, {}, {}
    for name, params in INT8_RUNS:
        bst, secs, ev, counts, plain, rec = recorded_run(params, ds, dv,
                                                         iters, dev)
        log(f"  int8 {name}: launches {json.dumps(counts)}")
        check(not any(plain.values()), f"int8 {name}: a plain version ran "
              f"on the path: {plain}")
        check_int8_launches(name, counts)
        texts[name] = bst.model_to_string()
        auc = ev["valid_0"]["auc"][-1]
        r = {"iters": iters, "s_per_iter": secs / iters, "valid_auc": auc,
             "launches": counts, **text_hash(texts[name], f"int8 {name}")}
        log(f"  int8 {name}: {iters} iterations, {r['s_per_iter']:.4f} "
            f"s/iter; valid AUC {auc:.5f} (the JAX package's int8 "
            f"{JAX_INT8_AUC}; at 65,536 rows int8 / bf16x2 "
            f"{JAX_INT8_AUC_65K[0]} / {JAX_INT8_AUC_65K[1]}; int8_auc.py)")
        check(auc > INT8_AUC_MIN, f"int8 {name}: valid AUC {auc} <= "
              f"{INT8_AUC_MIN}")
        r["max_abs_leaf"] = max_abs_leaf(bst)
        log(f"  int8 {name}: max |leaf| {r['max_abs_leaf']:.6g} beside "
            f"bf16x2's {bf16x2_leaf} (phase 10)")
        r["served_max_abs_err"] = serve_trained(
            bst, Xv, dev, f"int8_{name.replace(' ', '_')}_model.txt")
        out[name] = r
        recs[name] = rec
    check(texts["looped"] == texts["fused"], "int8: the looped model text "
          "differs from its single round's")
    check(texts["staged"] == texts["fused"], "int8: the staged model text "
          "differs from the fused one")
    check(texts["deep staged"] == texts["deep fused"], "int8 deep: the "
          "staged model text differs from the fused one")
    again = train(INT8_PARAMS, ds, iters, **_on(dev)).model_to_string()
    check(again == texts["staged"], "int8: a second staged training writes "
          "another model text")
    log("  int8: staged == fused == looped, deep staged == deep fused, and "
        "a second staged training the same text, byte for byte")
    return out, recs


def int8_ops(binned, lid, L, B, T, live=None):
    """A K1 int8 pass's work on these inputs: its integer adds (3 a live
    row and feature) and its fmas (3 a non-empty (cell, scale tile))."""
    Fn, N = binned.shape
    live = L if live is None else live
    rows = ((lid >= 0) & (lid < live)).nonzero()[:, 0]
    cells = 0
    for f in range(Fn):
        key = (rows // T) * (L * B) + lid[rows].long() * B \
            + binned[f, rows].long()
        cells += int(torch.unique(key).numel())
    return 3 * rows.numel() * Fn, 3 * cells


INT8_TIMING_ROUNDS = 5


def legs_in_turns(fns, reps=10, rounds=INT8_TIMING_ROUNDS) -> dict:
    """Each leg of ``fns`` (name -> launch; the first is int8) timed by
    ``time_ms`` over ``reps`` launches, the legs in turns, ``rounds``
    times, the order reversed every other round (so a drift of the card's
    clock falls on every leg alike).  Returns the int8 leg's median as
    ``ms``, each other leg's as ``<name>_ms``, every round's times and
    the int8 leg's ratio to each other leg's median."""
    runs = {k: [] for k in fns}
    order = list(fns)
    for i in range(rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            runs[k].append(time_ms(fns[k], reps))
    med = {k: float(np.median(v)) for k, v in runs.items()}
    first = order[0]
    return {"ms": med[first],
            **{f"{k}_ms": med[k] for k in order[1:]},
            "rounds_ms": runs,
            "ratios": {f"{first}/{k}": med[first] / med[k]
                       for k in order[1:]}}


def phase_int8_timing(recs, trained) -> dict:
    """Each int8 leg on phase 35's last inputs at its largest bucket beside
    its int8sr and bf16 / bf16x2 legs on the same inputs, in turns
    (``legs_in_turns``: medians and ratios), its plain version and, for
    K1, one ``index_add_`` of the integer rows; the quantize kernel
    beside its plain version.  Bounds: bytes (each input
    read once, each output written once) at 3.35 TB/s, and operations
    (integer adds at the int32 rate, one fma a non-empty cell and scale
    tile at the f32 rate).  The int8 legs run on the tree's rounded rows
    (``NearestRows``, quantized before the timing, as a tree does once)."""
    out = {}
    hrec = recs["staged"][0]
    (L, _), (binned, g3, lid, B, live) = max(
        ((k, v) for k, v in hrec.last.items() if k[1] == "int8"),
        key=lambda kv: kv[0][0])
    rows8 = hrec.rows8[(L, "int8")] or qz.NearestRows(g3)
    Fn, N = binned.shape
    T = hc.hist_row_tile(L, Fn, B)
    q, _ = rows8(T)
    q3 = qz.sr_quantize(qz.prequantize_rows(g3)[0], CHECK_KEY)
    iadd, fmas = int8_ops(binned, lid, L, B, T, live)
    flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
             + lid.long()[None, :]) * B + binned.long()).reshape(-1)
    ivals = q.to(torch.int32).repeat(Fn, 1)
    iacc = torch.zeros((Fn * L * B, 3), dtype=torch.int32,
                       device=binned.device)
    k1 = trained["staged"]["launches"]["k1"]
    out["hist_leaves"] = {
        "at": f"L={L} int8 T={T}", "N": N,
        "launches": sum(v for k, v in k1.items() if k.endswith(":int8")),
        "launches_by_bucket": k1,
        **legs_in_turns({
            "int8": lambda: hc.hist_leaves(binned, g3, lid, L, B, "int8",
                                           live, rows8=rows8),
            "int8sr": lambda: hc.hist_leaves(binned, q3, lid, L, B,
                                             "int8sr", live),
            "bf16": lambda: hc.hist_leaves(binned, g3, lid, L, B, "bf16",
                                           live),
            "bf16x2": lambda: hc.hist_leaves(binned, g3, lid, L, B,
                                             "bf16x2", live)}),
        "plain_ms": time_ms(lambda: hc.hist_leaves_ref(
            binned, g3, lid, L, B, "int8", live, rows8=rows8), 1),
        "library_ms": time_ms(lambda: iacc.index_add_(0, flat, ivals), 5),
        **int8sr_bound(Fn * N + N * 12 + N * 4 + -(-N // T) * 12
                       + L * Fn * B * 3 * 4, 2 * fmas, iadd)}
    frec = recs["fused"][1]
    (ns, prec, mode), (binned, g3, kw) = max(
        ((k, v) for k, v in frec.last.items() if k[1] == "int8"),
        key=lambda kv: kv[0][0])
    Fn, N = binned.shape
    sub = kw.get("parent") is not None
    S = ns if sub else ns // 2
    T = hc.round_row_tile(ns, Fn, kw["num_bins"])
    rows8 = kw.get("rows8") or qz.NearestRows(g3)
    kw = dict(kw, rows8=rows8)
    label = fc.fused_round(binned, g3, **kw)[3]
    iadd, fmas = int8_ops(binned, label, ns + 1, kw["num_bins"], T, ns)
    n_live = int((label < ns).sum())
    Bn = kw["num_bins"]
    other = ((2 * S * Fn * Bn * 3 * 4 if sub else 0) + ns * 12
             + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4)
    q3 = qz.sr_quantize(qz.prequantize_rows(g3)[0], CHECK_KEY)
    skw = dict(kw, precision="int8sr",
               scale=torch.ones((ns, 3), dtype=torch.float32,
                                device=binned.device))
    bkw = dict(kw, precision="bf16x2")
    k2 = trained["fused"]["launches"]["k2"]
    out["fused_round"] = {
        "at": f"S={S} int8 {mode} T={T}", "N": N,
        "launches": sum(v for k, v in k2.items() if ":int8:" in k),
        **legs_in_turns({
            "int8": lambda: fc.fused_round(binned, g3, **kw),
            "int8sr": lambda: fc.fused_round(binned, q3, **skw),
            "bf16x2": lambda: fc.fused_round(binned, g3, **bkw)}),
        "plain_ms": time_ms(lambda: fc.fused_round_ref(
            binned, g3, **kw), 1),
        "library_ms": None, "live_rows": n_live,
        "live_bound_ms": (live_row_bytes(N, Fn, n_live) + other)
        / HBM_BYTES_PER_S * 1e3,
        **int8sr_bound(Fn * N + N * 12 + N * 4 + 2 * N * 4 + other,
                       2 * S * Fn * Bn * 2 * 12 + 2 * fmas, iadd)}
    pos, kw = loop_call(recs["looped"][2].last)
    rows8 = kw.get("rows8") or qz.NearestRows(pos[1])
    kw = dict(kw, rows8=rows8)
    nbytes, live_bytes, f32_ops, rounds, n_split = loop_work(pos, kw)
    N = pos[0].shape[1]
    Fn = pos[0].shape[0]
    int_ops = sum(3 * r["live_rows"] * Fn for r in rounds)
    f32_ops -= int_ops
    bkw = dict(kw, precision="bf16x2")
    qkw = dict(kw, precision="bf16x2", key=CHECK_KEY,
               quant_buckets=tuple(S for S in kw["slot_buckets"] if S >= 16),
               quant=qz.prequantize_rows(pos[1]))
    k6 = trained["looped"]["launches"]["k6"]
    out["fused_wave_loop"] = {
        "R": kw["rounds"], "rounds": rounds, "N": N,
        "launches": sum(k6.values()),
        **legs_in_turns({
            "int8": lambda: lc.fused_wave_loop(*pos, **kw),
            "int8sr": lambda: lc.fused_wave_loop(*pos, **qkw),
            "bf16x2": lambda: lc.fused_wave_loop(*pos, **bkw)}),
        "plain_ms": time_ms(lambda: lc.fused_wave_loop_ref(*pos, **kw), 1),
        "library_ms": None,
        "live_bound_ms": live_bytes / HBM_BYTES_PER_S * 1e3,
        **int8sr_bound(nbytes, f32_ops, int_ops)}
    g3 = recs["staged"][0].last[max(k for k in recs["staged"][0].last
                                    if k[1] == "int8")][1]
    N = g3.shape[0]
    T = 512

    def rn_times(T):
        def fn():
            return qz.rn_quantize(g3, T)
        name = ("rn_quantize_kernel",)
        return {"ms": time_ms(fn, 20),
                "device_ms": kernel_device_ms(fn, name)[name[0]] or None,
                "cold_device_ms": cold_device_ms(fn, name)[name[0]] or None}

    qrow = {
        "name": "rn_quantize", "route": "cuda", "source": QUANT_SRC,
        "replaces": "lightgbmv1_tpu/ops/hist_pallas.py:144 _kernel "
                    "(precision=\"int8\": the tile amax, scale and "
                    "rounding; K2's and K6's tile of adds, "
                    "wave_fused.py:110)",
        "at": f"T={T}", "N": N,
        "launches": int(trained["staged"]["launches"]["rn_quantize"]),
        "launches_by_path": {k: int(v["launches"]["rn_quantize"])
                             for k, v in trained.items()},
        "max_abs_err": 0.0, **rn_times(T), "T128": rn_times(128),
        "plain_ms": time_ms(lambda: qz.rn_quantize_ref(g3, T), 1),
        "library_ms": None,
        **int8sr_bound(N * 24 + -(-N // T) * 12, N * 8, 0)}
    log(f"  rn_quantize at {N} rows: T=512 {qrow['ms']:.4f} ms, device "
        f"{qrow['device_ms']} ms (L2 cleared: {qrow['cold_device_ms']}); "
        f"T=128 {qrow['T128']['ms']:.4f} ms, device "
        f"{qrow['T128']['device_ms']} ms (L2 cleared: "
        f"{qrow['T128']['cold_device_ms']})")
    for name, r in list(out.items()) + [("rn_quantize", qrow)]:
        legs = ", ".join(f"{k} {r[k]:.4f} ms" for k in
                         ("int8sr_ms", "bf16_ms", "bf16x2_ms") if k in r)
        ratios = ", ".join(f"{k} {v:.3f}" for k, v in
                           r.get("ratios", {}).items())
        log(f"  {name} int8 ({r.get('at', '')}): {r['ms']:.4f} ms"
            + (f" beside {legs} (medians of {INT8_TIMING_ROUNDS} rounds in "
               f"turns; ratios {ratios})" if legs else "")
            + f", plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']}, library {r['library_ms']}; "
            f"{r['launches']} launches on phase 35's path")
    return out, qrow


def phase_sample_train(ds, dv, Xv, iters, dev):
    """Phase 36, the sampling main path at the headline: bagging 0.8 every
    5 iterations, feature_fraction 0.9 and feature_fraction_bynode 0.8,
    staged and fused (one model text); bagging with the per-tree mask
    fused and looped (one model text); the card's bag masks (plain and
    pos / neg, across bagging_freq boundaries) the CPU's bit for bit; AUC
    > 0.90; s/iteration."""
    out, texts = {}, {}
    for name, params in SAMPLE_RUNS:
        bst, secs, ev, counts, plain, _ = recorded_run(params, ds, dv, iters,
                                                       dev)
        check(not any(plain.values()), f"sampled {name}: a plain version "
              f"ran on the path: {plain}")
        texts[name] = bst.model_to_string()
        auc = ev["valid_0"]["auc"][-1]
        out[name] = {"iters": iters, "s_per_iter": secs / iters,
                     "valid_auc": auc, "launches": counts,
                     **text_hash(texts[name], f"sampled {name}")}
        log(f"  sampled {name}: {iters} iterations, "
            f"{out[name]['s_per_iter']:.4f} s/iter; valid AUC {auc:.5f}; "
            f"launches {json.dumps(counts)}")
        check(auc > 0.90, f"sampled {name}: valid AUC {auc} <= 0.90")
        if name == "bag+tree looped":
            check(bool(counts["k6"]), f"sampled {name}: no K6 launch")
        gbdt = bst._gbdt
    check(texts["staged"] == texts["fused"], "sampled: the staged model "
          "text differs from the fused one")
    check(texts["bag+tree looped"] == texts["bag+tree fused"], "sampled: "
          "the looped model text differs from the fused one")
    # the last run's bag stream on the card against the CPU's
    N = gbdt.num_data
    for it in (0, 4, 5, 49):
        key = prng.fold_in(prng.prng_key(gbdt.config.bagging_seed), it // 5)
        card = prng.bernoulli(key, 0.8, N, dev)
        cpu = prng.bernoulli(key, 0.8, N, "cpu")
        check(torch.equal(card.cpu(), cpu), f"sampled: the bag of iteration "
              f"{it} differs between the card and the CPU")
        gbdt._bag_mask = None
        check(torch.equal(gbdt._bagging_mask(it).cpu() != 0, cpu),
              f"sampled: GBDT's bag of iteration {it} is not the stream's")
        pos = prng.bernoulli(key, 0.5, N, dev)
        neg = prng.bernoulli(prng.fold_in(key, 1), 0.3, N, dev)
        check(torch.equal(pos.cpu(), prng.bernoulli(key, 0.5, N, "cpu"))
              and torch.equal(neg.cpu(), prng.bernoulli(
                  prng.fold_in(key, 1), 0.3, N, "cpu")),
              f"sampled: the pos / neg bags of iteration {it} differ")
    log(f"  sampled: staged == fused and bag+tree looped == bag+tree fused "
        f"byte for byte; the bag masks of iterations 0, 4, 5, 49 the CPU's "
        f"bit for bit ({N} rows)")
    return out


# ---------------------------------------------------------------------------
# extra_trees, callbacks, onehot / bench and int16 bins (phases 38-41)
# ---------------------------------------------------------------------------

SCAN_WIDE_SRC = "lightgbmv1_tpu_torch/csrc/split_scan_wide.cu"
# a tree key and an extra_seed for the rand leg's checks
RAND_KEY = prng.fold_in(prng.prng_key(0), 3)
EXTRA_SEED = 6
EXTRA_PARAMS = dict(TRAIN_PARAMS, extra_trees=True)
EXTRA_REASON = "extra_trees draws per-node randomness inside the scan"
INT16_REASON = "int16 bins exceed the uint8 one-hot kernel family"
# phase 40: staged training of up to CALLBACK_ITERS iterations stopped
# after EARLY_STOP rounds of no gain on the valid set, under a
# learning-rate schedule
CALLBACK_ITERS = 100
EARLY_STOP = 5


def lr_schedule(i: int) -> float:
    """Phase 40's learning rate of iteration i: 0.2 growing by 5% an
    iteration, so the valid metrics turn and early stopping ends the
    training (a constant rate trains other trees)."""
    return 0.2 * 1.05 ** i


ONEHOT_PARAMS = dict(TRAIN_PARAMS, hist_method="onehot")
ONEHOT_ITERS = 50
INT16_PARAMS = dict(TRAIN_PARAMS, max_bin=511)
# 50 iterations, as phase 10: the headline's valid AUC passes the 0.90
# gate only past about 30 (0.8884 / 0.8937 / 0.8969 after 10 / 20 / 25 at
# max_bin 63, the port on the CPU)
INT16_ITERS = 50
# the one-hot product against K1 at bf16x2 / bf16: the same rounded parts
# summed in other orders (k1_tol); against the scatter of the f32 rows also
# the parts' rounding, 2^-16 of a cell's absolute sum at bf16x2 (hi + lo
# keep 16 of the 24 bits) and 2^-8 at bf16
ONEHOT_PART_REL = {"f32": 0.0, "bf16x2": 2.0 ** -16, "bf16": 2.0 ** -8}


def rand_leg(C, dev, seed=EXTRA_SEED) -> RandLeg:
    """C children's extra_trees leg: the uids 2c + 1 under RAND_KEY."""
    return RandLeg(RAND_KEY, torch.arange(C, dtype=torch.int32,
                                          device=dev) * 2 + 1, seed)


def no_rand(kw) -> dict:
    """A recorded scan's keyword arguments without its rand leg."""
    return {k: v for k, v in kw.items() if k != "rand"}


def check_scan_leg(tag, hist, mask, csums, kw, rand=None, wide=None
                   ) -> dict:
    """The split-scan kernel's ``rand`` / ``wide`` leg (``wide`` None: the
    one the bin count takes) on one input: packed rows and residue bit for
    bit the CPU plain scan's, two launches equal, and the thresholds it
    drew (``rand_out``) exactly ``split.extra_rand_bins``'s."""
    kw = no_rand(kw)
    C, F_ = hist.shape[:2]
    dev = hist.device
    rout = (torch.full((C, F_), -7, dtype=torch.int32, device=dev)
            if rand is not None else None)
    kk = dict(kw, rand=rand, wide=wide)
    got = sc.split_scan_pick(hist, mask, csums, rand_out=rout, **kk)
    check(bool(same_value(got, sc.split_scan_pick(hist, mask, csums, **kk))
               .all()), f"split scan {tag}: two launches differ")
    res = sc.split_scan(hist, mask, csums, **kk)
    ckw = to_cpu(kw)
    crand = None if rand is None else rand._replace(uids=rand.uids.cpu())
    cs = csums.cpu()
    want_res = scan_residue(hist.cpu(), mask.cpu(), cs, rand=crand, **ckw)
    want = pick_pack(want_res, gain_shift(cs, ckw["params"],
                                          ckw.get("parent_output")),
                     cs, ckw["meta"], hist.shape[2])
    bad = int((~same_value(got.cpu(), want)).sum())
    check(bad == 0, f"split scan {tag}: {bad} packed values differ from "
          "the CPU plain scan and pick")
    bad = int((~same_value(res.cpu(), want_res)).sum())
    check(bad == 0, f"split scan {tag}: {bad} residue values differ from "
          "the CPU plain scan")
    out = {"case": tag, "finite": int(torch.isfinite(want_res[..., 0])
                                      .sum()),
           "cells": int(want_res[..., 0].numel()),
           "finite_picks": int(torch.isfinite(want[:, 0]).sum())}
    if rand is not None:
        rb = extra_rand_bins(crand, ckw["meta"].num_bins)
        check(torch.equal(rout.cpu(), rb), f"split scan {tag}: the drawn "
              "thresholds differ from extra_rand_bins")
        # every finite pick sits on its feature's drawn threshold
        fin = torch.isfinite(want_res[..., 0])
        thr = want_res[..., 2].long() % hist.shape[2]
        check(bool((thr[fin] == rb.long()[fin]).all()),
              f"split scan {tag}: a pick off its drawn threshold")
        out["rand_bins_exact"] = True
    return out


def scan_leg_ms(hist, mask, csums, kw, rand=None, wide=None) -> float:
    """The split-scan kernel's device ms a launch with the L2 cleared
    before each (None: the profiler saw none)."""
    kw = no_rand(kw)
    return cold_device_ms(lambda: sc.split_scan_pick(
        hist, mask, csums, rand=rand, wide=wide, **kw),
        ("split_scan_kernel",))["split_scan_kernel"] or None


def scan_bound(C, F_, B, rand=False) -> dict:
    """The scan's bound (scan_timing's): each histogram cell read once,
    the mask, sums, table (and uids) read, the packed rows written; by
    bytes (a rand leg's two threefry hashes a (child, feature), 20 rounds
    of 4 integer ops each, stay far below the rate)."""
    nbytes = (C * F_ * B * 12 + C * F_ + C * 12 + 5 * F_ * 4
              + C * sc.PACK_COLS * 4 + (4 * C if rand else 0))
    ops = 2 * C * F_ * B * 20 + (2 * C * F_ * 2 * 20 * 4 if rand else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def int16_meta(F_, nb, dev):
    """A feature meta of F_ features of ``nb`` bins, every missing type in
    turn (zero at bin 3, NaN at the last bin, none)."""
    mt = np.array([1, 2, 0] * F_)[:F_]
    nbs = np.full(F_, nb)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return with_tables(FeatureMeta(
        num_bins=t(nbs), missing_type=t(mt),
        nan_bin=t(np.where(mt == 2, nbs - 1, -1)),
        zero_bin=t(np.where(mt == 1, 3, 0)),
        usable=torch.ones(F_, dtype=torch.bool, device=dev)))


def k3_leg_ms(binned, feats, rmeta, offsets, nl) -> float:
    names = ("route_kernel", "route_global_kernel", "route_tables_kernel")
    lids = torch.zeros(binned.shape[1], dtype=torch.int32,
                       device=binned.device)
    return sum(cold_device_ms(lambda: fc.route_rows(
        binned, lids, feats, rmeta, nl, offsets=offsets), names).values()) \
        or None


def phase_new_legs(binned, meta, rng, scan_last, dev) -> dict:
    """Phase 38: the split-scan kernel's extra_trees leg on phase 10's
    last inputs (each child count) and on synthetic children at B = 64
    and 256 (no options, all options, int8sr scales); its wide leg at B
    = 512 and 1,024 (with and without the options and the rand leg), and
    at B = 64 against the 256-bin leg; K3's 16-bit leg on phase 8's bins
    as int16 (its u8 leg's ids) and on 512-bin int16 bins, two synthetic
    trees each.  Every check bit for bit its plain version.  Then each
    leg's device time (L2 cleared) beside its u8 / unrandomized leg on
    the same inputs and its bound."""
    out = {"rand": [], "wide": [], "k3_16": [], "timing": {}}
    for C in sorted(scan_last):
        hist, mask, csums, kw = scan_last[C]
        out["rand"].append(check_scan_leg(
            f"phase 10 C={C} rand", hist, mask, csums, kw, rand_leg(C, dev)))
        out["rand"].append(check_scan_leg(
            f"phase 10 C={C} rand extra_seed=0", hist, mask, csums, kw,
            rand_leg(C, dev, 0)))
    for B in (64, 256):
        for scaled in (False, True):
            hist, csums, mask, m, scale = scan_children(126, F, B, rng, dev,
                                                        scaled)
            for name in ("none", "all"):
                out["rand"].append(check_scan_leg(
                    f"C=126 B={B} {name} rand"
                    + (" int8sr scales" if scaled else ""), hist, mask,
                    csums, scan_case_kw(m, SCAN_OPTIONS[name], csums, rng,
                                        scale), rand_leg(126, dev)))
    log(f"  the split scan's rand leg: {len(out['rand'])} cases bit for "
        "bit the CPU plain scan, the drawn thresholds exact")
    for B in (512, 1024):
        for C in (8, 126):
            hist, csums, mask, m, _ = scan_children(C, F, B, rng, dev)
            for name in ("none", "all"):
                kw = scan_case_kw(m, SCAN_OPTIONS[name], csums, rng)
                out["wide"].append(check_scan_leg(
                    f"wide C={C} B={B} {name}", hist, mask, csums, kw))
            out["wide"].append(check_scan_leg(
                f"wide C={C} B={B} all rand", hist, mask, csums,
                scan_case_kw(m, SCAN_OPTIONS["all"], csums, rng),
                rand_leg(C, dev)))
        hist, csums, mask, m, scale = scan_children(32, F, B, rng, dev, True)
        out["wide"].append(check_scan_leg(
            f"wide C=32 B={B} none int8sr scales", hist, mask, csums,
            scan_case_kw(m, SCAN_OPTIONS["none"], csums, rng, scale)))
    F_big = 37 + (sc.resident_features(dev.index, 512, 0, True)
                  if dev.type == "cuda" else 64)     # a CPU rehearsal
    hist, csums, mask, m, _ = scan_children(2, F_big, 512, rng, dev)
    out["wide"].append(check_scan_leg(
        f"wide C=2 B=512 F={F_big} (the residue in global memory)", hist,
        mask, csums, scan_case_kw(m, SCAN_OPTIONS["none"], csums, rng)))
    del hist
    for C in sorted(scan_last):          # the wide leg at B = 64
        hist, mask, csums, kw = scan_last[C]
        out["wide"].append(check_scan_leg(
            f"wide leg on phase 10 C={C} (B=64)", hist, mask, csums, kw,
            wide=True))
        kw = no_rand(kw)
        check(same_value(sc.split_scan(hist, mask, csums, wide=True, **kw),
                         sc.split_scan(hist, mask, csums, wide=False, **kw))
              .all().item(), f"wide leg C={C}: differs from the 256-bin "
              "leg")
    log(f"  the split scan's wide leg: {len(out['wide'])} cases bit for bit "
        "the CPU plain scan (at B = 64 the 256-bin leg's residue too)")

    # K3's 16-bit leg
    b = binned[:, :VALID_ROWS].contiguous()
    b16 = b.to(torch.int16)
    m512 = int16_meta(F, 512, dev)
    b512 = torch.as_tensor(rng.randint(0, 512, (F, VALID_ROWS)),
                           dtype=torch.int16, device=dev)
    trees = {}
    for tag, sizes in (("2,295 splits", [1, 2, 4, 8, 16, 32, 64, 128]
                        + [255] * 8),
                       ("10 rounds", [1, 2, 4, 8, 16, 32, 63, 63, 63, 2])):
        for bins, m, u8 in ((b16, meta, b), (b512, m512, None)):
            (feats, thrs, dls, leafs, nls), offsets, nl = synthetic_rounds(
                rng, sizes, m, dev)
            rmeta = wf.pack_route_meta(feats, thrs, dls, leafs, nls, m)
            name = (f"16-bit {tag} " + ("phase 8's bins" if u8 is not None
                                        else "512 bins"))
            out["k3_16"] += check_k3_tree(
                name, bins, feats, rmeta, offsets, nl,
                tree_of_rounds(feats, thrs, dls, leafs, m), m, u8=u8)
            trees[name] = (bins, feats, rmeta, offsets, nl, u8)
    check(fc.int16_launch_counts["route_rows"] > 0,
          "K3's 16-bit leg never launched")

    # timing: each leg beside its u8 / unrandomized leg on the same inputs
    C = max(scan_last)
    hist, mask, csums, kw = scan_last[C]
    kw = no_rand(kw)
    _, F_, B, _ = hist.shape
    t = out["timing"]
    t["rand"] = {"C": C, "B": B, "device_ms": scan_leg_ms(
        hist, mask, csums, kw, rand_leg(C, dev)),
        "unrandomized_device_ms": scan_leg_ms(hist, mask, csums, kw),
        "ms": time_ms(lambda: sc.split_scan_pick(
            hist, mask, csums, rand=rand_leg(C, dev), **kw), 50),
        "plain_ms": time_ms(lambda: sc.split_pick_ref(
            hist, mask, csums, rand=rand_leg(C, dev), **kw), 3),
        **scan_bound(C, F_, B, rand=True)}
    t["wide_b64"] = {"C": C, "B": B, "device_ms": scan_leg_ms(
        hist, mask, csums, kw, wide=True),
        "narrow_device_ms": t["rand"]["unrandomized_device_ms"],
        **scan_bound(C, F_, B)}
    for Bw in (512, 1024):
        h, cs_, mk, m, _ = scan_children(126, F, Bw, rng, dev)
        kw_ = scan_case_kw(m, SCAN_OPTIONS["none"], cs_, rng)
        t[f"wide_b{Bw}"] = {
            "C": 126, "B": Bw, "device_ms": scan_leg_ms(h, mk, cs_, kw_),
            "ms": time_ms(lambda: sc.split_scan_pick(h, mk, cs_, **kw_), 20),
            "plain_ms": time_ms(lambda: sc.split_pick_ref(h, mk, cs_,
                                                          **kw_), 2),
            **scan_bound(126, F, Bw)}
    for name, (bins, feats, rmeta, offsets, nl, u8) in trees.items():
        if "10 rounds" not in name:
            continue
        row = {"rows": bins.shape[1], "splits": rmeta.shape[0],
               "device_ms": k3_leg_ms(bins, feats, rmeta, offsets, nl),
               **k3_bound(bins, feats, rmeta, offsets, nl)}
        # the bound's bin reads are two bytes each here
        row["bound_ms"] += row["bin_reads"] / HBM_BYTES_PER_S * 1e3
        row["bytes"] += row["bin_reads"]
        if u8 is not None:
            row["u8_device_ms"] = k3_leg_ms(u8, feats, rmeta, offsets, nl)
        lids = torch.zeros(bins.shape[1], dtype=torch.int32, device=dev)
        row["ms"] = time_ms(lambda: fc.route_rows(
            bins, lids, feats, rmeta, nl, offsets=offsets), 20)
        row["plain_ms"] = time_ms(lambda: fc.route_rows_ref(
            bins, lids, feats, rmeta, nl, offsets=offsets), 2)
        t["k3_16 " + name] = row
    for k, v in t.items():
        log(f"  {k}: " + ", ".join(
            f"{a} {fmt_ms(b) if a.endswith('ms') else b}"
            for a, b in v.items() if a not in ("bytes", "ops")))
    return out


def phase_extra_trees(ds, dv, Xv, iters, dev, seed) -> dict:
    """Phase 39: extra_trees at the headline (phase 8's data, staged,
    ``iters`` iterations; launch counts reset): every split scan with the
    rand leg, no plain version; a second training writes the same text;
    f32 card against CPU (the card's gradients and root sums) splits
    identical at 65,536 rows; hist_method=fused raises the JAX reason.
    s/iteration, valid AUC, split-scan launches a tree."""
    bst, secs, ev, counts, plain, _ = recorded_run(EXTRA_PARAMS, ds, dv,
                                                   iters, dev)
    check(not any(plain.values()), f"extra_trees: a plain version ran on "
          f"the path: {plain}")
    trees = bst.num_trees()
    scans = scan_launches(trees)
    check(all(int(k) & sc.OPT_RAND for k in scans["by_opts"]),
          f"extra_trees: a scan without the rand leg: {scans['by_opts']}")
    k3 = fc.launch_counts["route_rows"]
    check(k3 == k3_expected(bst, 1), f"extra_trees: K3 launched {k3} times")
    text = bst.model_to_string()
    auc = ev["valid_0"]["auc"][-1]
    out = {"iters": iters, "s_per_iter": secs / iters, "valid_auc": auc,
           "split_scan": scans, "k3_launches": k3, "launches": counts,
           **text_hash(text, "extra_trees staged")}
    log(f"  extra_trees staged: {iters} iterations, "
        f"{out['s_per_iter']:.4f} s/iter; valid AUC {auc:.5f}; split scans "
        f"{scans['per_tree']:.2f} a tree ({json.dumps(scans['by_opts'])})")
    again = train(EXTRA_PARAMS, ds, iters, **_on(dev))
    check(again.model_to_string() == text, "extra_trees: a second training "
          "wrote another model text")
    try:
        train(dict(EXTRA_PARAMS, hist_method="fused"), ds, 1, **_on(dev))
        check(False, "extra_trees: hist_method=fused trained")
    except NotImplementedError as e:
        check(EXTRA_REASON in str(e), f"extra_trees fused: {e}")
    Xp, yp = make_data(PARITY_ROWS, seed + 7)
    out["parity"] = card_vs_cpu_replay(
        "extra_trees", dict(PARITY_PARAMS, extra_trees=True), Xp, yp, dev)
    log("  extra_trees: a second training the same text; hist_method=fused "
        "raises the JAX reason")
    return out


def jax_rule_best(ev: dict, rounds: int, end: int,
                  first_metric_only=False):
    """(best iteration, its scores) of the JAX ``early_stopping`` rule
    (callback.py:102) replayed on recorded metrics ``ev`` {data: {metric:
    [...]}} of a training of up to ``end`` iterations: at each iteration
    each metric's best (higher or lower is better by name) kept in order,
    and the first metric that has not improved for ``rounds`` iterations,
    or any at the last iteration, stops with its best."""
    higher = {"auc": True, "ndcg": True, "map": True}
    items = [(d, m, v) for d, ms in ev.items() for m, v in ms.items()]
    n = len(items[0][2])
    best = [None] * len(items)
    first = items[0][1]
    for it in range(n):
        for i, (d, m, v) in enumerate(items):
            hb = higher.get(m.split("@")[0], False)
            if best[i] is None or (v[it] > v[best[i]] if hb
                                   else v[it] < v[best[i]]):
                best[i] = it
            if first_metric_only and m != first:
                continue
            if it - best[i] >= rounds or it == end - 1:
                return best[i] + 1, {mm: vv[best[i]] for _, mm, vv in items}
    raise AssertionError("no metric recorded")


def phase_callbacks(ds, dv, Xv, iters, dev) -> dict:
    """Phase 40: staged training at the headline for up to ``iters``
    iterations with early_stopping_rounds=EARLY_STOP on the valid rows,
    record_evaluation and a reset_parameter learning-rate schedule
    (launch counts reset).  Gates: best_iteration is the JAX rule's on
    the recorded metrics; predict, model_to_string and save_model default
    to it; the schedule's trees differ from a constant rate's and carry
    its shrinkage; the first trees equal a plain training's at the
    schedule's first rate."""
    from lightgbmv1_tpu_torch import callback as cb_mod

    reset_counts()
    ev = {}
    t0 = time.perf_counter()
    bst = train(TRAIN_PARAMS, ds, iters, valid_sets=[dv],
                early_stopping_rounds=EARLY_STOP,
                callbacks=[cb_mod.record_evaluation(ev),
                           cb_mod.reset_parameter(learning_rate=lr_schedule)],
                **_on(dev))
    _sync(dev)
    secs = time.perf_counter() - t0
    ran = bst.current_iteration()
    best, scores = jax_rule_best(ev, EARLY_STOP, iters)
    check(bst.best_iteration == best, f"callbacks: best_iteration "
          f"{bst.best_iteration}, the JAX rule's {best}")
    check(bst.best_score["valid_0"] == scores,
          f"callbacks: best_score {bst.best_score} against {scores}")
    check(bst.model_to_string() == bst.model_to_string(num_iteration=best),
          "callbacks: model_to_string() is not the best iteration's")
    check(bst.model_to_string() != bst.model_to_string(num_iteration=ran)
          or best == ran, "callbacks: the best iteration's text is all")
    p = bst.predict(Xv[:4096], raw_score=True)
    check(np.array_equal(p, bst.predict(Xv[:4096], raw_score=True,
                                        num_iteration=best)),
          "callbacks: predict does not default to the best iteration")
    # each tree's rate (the model text's shrinkage, but the first tree's,
    # which carries the init score and is written at 1)
    check(bst._gbdt._model_shrink == [lr_schedule(i) for i in range(ran)],
          "callbacks: the trees' rates are not the schedule's")
    const = train(dict(TRAIN_PARAMS, learning_rate=lr_schedule(0)), ds, 3,
                  **_on(dev))
    ct, st = const._all_trees(), bst._all_trees()
    check(np.array_equal(ct[0].leaf_value, st[0].leaf_value),
          "callbacks: the first tree is not the first rate's")
    check(any(not np.array_equal(a.leaf_value, b.leaf_value)
              for a, b in zip(ct[1:], st[1:3])),
          "callbacks: the schedule's trees equal a constant rate's")
    out = {"iters_run": ran, "best_iteration": best,
           "best_score": scores, "s_per_iter": secs / ran,
           "stopped_early": ran < iters,
           "valid_auc_at_best": ev["valid_0"]["auc"][best - 1],
           **text_hash(bst.model_to_string(), "callbacks staged")}
    log(f"  callbacks: {ran} iterations of {iters} ({secs / ran:.4f} "
        f"s/iter), best iteration {best} (the JAX rule's), valid AUC there "
        f"{out['valid_auc_at_best']:.5f}; predict / model_to_string default "
        f"to it; the schedule's trees are not a constant rate's")
    return out


class OnehotRecorder:
    """Keeps the inputs of the last one-hot call at each (slots,
    precision) of a run (the main path's own)."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        self._orig = hg.hist_leaves_onehot

        def wrapped(binned, g3, leaf_id, num_leaves, num_bins,
                    precision="bf16x2", row_chunk=hg.ONEHOT_ROW_CHUNK,
                    live_slots=None):
            self.last[(int(num_leaves), precision)] = (
                binned, g3, leaf_id, num_bins, live_slots)
            return self._orig(binned, g3, leaf_id, num_leaves, num_bins,
                              precision, row_chunk, live_slots)

        hg.hist_leaves_onehot = wrapped
        return self

    def __exit__(self, *exc):
        hg.hist_leaves_onehot = self._orig


def check_onehot(tag, binned, g3, lid, L, B, prec, live) -> dict:
    """The one-hot product of one input against the scatter of the f32
    rows (within k1_tol plus the parts' rounding, ONEHOT_PART_REL of each
    cell's absolute sum) and, on byte bins, K1 at the same precision
    (k1_tol: the same parts in another order); counts exact."""
    got = hg.hist_leaves_onehot(binned, g3, lid, L, B, prec,
                                live_slots=live)
    absum = hc.index_add_hist(binned, [g3.abs()], lid, L, B, live)
    tol = k1_tol(absum, absum[..., 2:3])
    exact = hg.hist_leaves_scatter(binned, g3, lid, L, B, live)
    check(torch.equal(got[..., 2], exact[..., 2]),
          f"onehot {tag}: counts differ from the scatter")
    d = (got - exact).abs()
    over = int((d > tol + ONEHOT_PART_REL[prec] * absum).sum())
    check(over == 0, f"onehot {tag}: {over} cells past the scatter's "
          "tolerance")
    out = {"case": tag, "precision": prec,
           "max_abs_err_vs_scatter": float(d.max()),
           "max_err_over_abs_sum_vs_scatter":
           float((d / (absum + 1e-30)).max())}
    if binned.dtype == torch.uint8:
        k1 = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        dk = (got - k1).abs()
        over = int((dk > tol).sum())
        check(over == 0, f"onehot {tag}: {over} cells past K1's tolerance")
        out["max_abs_err_vs_k1"] = float(dk.max())
    return out


TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense


def onehot_bound(binned, g3, L, B, prec) -> dict:
    """The one-hot path's least time: its (3 (L + 1), N) x (N, F B)
    products (two of them at bf16x2) at the rate of their type (f32
    outside the tensor cores at f32, TF32 for the bf16 legs,
    ``histogram.onehot_matmul_level``), or the bins and rows read and the
    histograms written, the larger."""
    F_, N = binned.shape
    mults = 2 if prec == "bf16x2" else 1
    ops = 2 * mults * 3 * (L + 1) * N * F_ * B
    nbytes = binned.numel() * binned.element_size() + g3.numel() * 4 \
        + N * 4 + L * F_ * B * 12
    rate = F32_OPS_PER_S if prec == "f32" else TF32_OPS_PER_S
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def phase_onehot_bench_int16(ds, dv, Xv, X, y, dev, seed, k1_s_per_iter
                             ) -> dict:
    """Phase 41: staged onehot training at the headline (bf16x2, at most
    ONEHOT_ITERS iterations; launch counts reset), AUC > 0.90, the one-hot
    histograms of the path's last inputs against the scatter and K1;
    hist_method=bench, whose pick trains the text of that method chosen
    directly; phase 8's rows binned at max_bin=511, INT16_ITERS staged
    iterations through onehot (the wide scan, K3's 16-bit leg), AUC >
    0.90, K3 launches = trees of more than one leaf x valid sets, f32
    splits card against CPU identical at 65,536 rows (2 iterations: the
    CPU's one-hot product of 512 bins is slow)."""
    out = {}
    with OnehotRecorder() as orec:
        bst, secs, ev, counts, plain, _ = recorded_run(
            ONEHOT_PARAMS, ds, dv, ONEHOT_ITERS, dev)
    auc = ev["valid_0"]["auc"][-1]
    onehot_calls = hg.matmul_counts["hist_leaves_onehot"]
    check(onehot_calls > 0 and not counts["k1"] and not any(plain.values()),
          f"onehot: K1 {counts['k1']}, plain calls {plain}")
    out["onehot"] = {"iters": ONEHOT_ITERS,
                     "s_per_iter": secs / ONEHOT_ITERS, "valid_auc": auc,
                     "k1_s_per_iter": k1_s_per_iter,
                     "onehot_calls": onehot_calls,
                     **text_hash(bst.model_to_string(), "onehot staged")}
    log(f"  onehot staged: {ONEHOT_ITERS} iterations, {secs / ONEHOT_ITERS:.4f}"
        f" s/iter (K1's staged {k1_s_per_iter:.4f} s/iter, phase 10); valid "
        f"AUC {auc:.5f}")
    check(auc > 0.90, f"onehot: valid AUC {auc} <= 0.90")
    checks, timing = [], []
    for (L, prec), (b, g3, lid, B, live) in sorted(orec.last.items()):
        checks.append(check_onehot(f"L={L} {prec}", b, g3, lid, L, B, prec,
                                   live))
        if prec == "bf16x2" or L == max(k for k, _ in orec.last):
            row = {"L": L, "precision": prec, **onehot_bound(b, g3, L, B,
                                                             prec)}
            row["ms"] = time_ms(lambda: hg.hist_leaves_onehot(
                b, g3, lid, L, B, prec, live_slots=live), 5)
            row["k1_ms"] = time_ms(lambda: hc.hist_leaves(
                b, g3, lid, L, B, prec, live), 20)
            row["library_ms"] = time_ms(lambda: hc.index_add_hist(
                b, [g3], lid, L, B, live), 5)
            timing.append(row)
            log(f"  onehot L={L} {prec}: {row['ms']:.3f} ms (K1 "
                f"{row['k1_ms']:.4f} ms, index_add_ {row['library_ms']:.3f}"
                f" ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']})")
    log(f"  onehot histograms on the path's last inputs: {len(checks)} "
        "within the scatter's and K1's tolerance, counts exact")
    out["onehot"]["checks"] = checks
    out["onehot"]["timing"] = timing

    # hist_method=bench: the pick trains the text of the method chosen
    # directly
    reset_counts()
    times = {}
    bst = train(dict(TRAIN_PARAMS, hist_method="bench"), ds, 5, **_on(dev))
    pick = bst._gbdt._grow.hist_method
    times = {k: v * 1e3 for k, v in bst._gbdt._grow.bench_times.items()}
    check(set(times) == {"pallas", "onehot"}, f"bench timed {times}")
    direct = train(dict(TRAIN_PARAMS, hist_method=pick), ds, 5, **_on(dev))
    check(bst.model_to_string() == direct.model_to_string(),
          f"bench: its pick {pick} trains another text than "
          f"hist_method={pick}")
    out["bench"] = {"pick": pick, "candidate_ms": times}
    log(f"  hist_method=bench: candidates {json.dumps(times)} ms a "
        f"16-slot pass -> {pick}; its 5-iteration text is "
        f"hist_method={pick}'s")

    # int16 bins at max_bin=511
    t0 = time.perf_counter()
    d16 = Dataset(X, label=y, params=INT16_PARAMS)
    d16v = Dataset(Xv, label=dv.get_label(), reference=d16)
    d16.construct()
    d16v.construct()
    bin_s = time.perf_counter() - t0
    nb = d16._binned.padded_bin
    check(d16._binned.binned.dtype == np.int16 and nb == 512,
          f"max_bin=511: {d16._binned.binned.dtype} bins, axis {nb}")
    log(f"  phase 8's rows binned at max_bin=511 in {bin_s:.1f} s "
        f"(int16 bins, bin axis {nb})")
    bst, secs, ev, counts, plain, _ = recorded_run(
        INT16_PARAMS, d16, d16v, INT16_ITERS, dev)
    auc = ev["valid_0"]["auc"][-1]
    k3 = fc.int16_launch_counts["route_rows"]
    scans = scan_launches(bst.num_trees())
    check(k3 == k3_expected(bst, 1) and fc.launch_counts["route_rows"] == 0,
          f"int16: K3's 16-bit leg launched {k3} times (u8 leg "
          f"{fc.launch_counts['route_rows']})")
    check(sc.launch_counts["split_scan_wide"] == scans["launches"],
          "int16: a split scan off the wide leg")
    check(hg.matmul_counts["hist_leaves_onehot"] > 0 and not counts["k1"]
          and not any(plain.values()),
          f"int16: K1 {counts['k1']}, plain calls {plain}")
    check(auc > 0.90, f"int16: valid AUC {auc} <= 0.90")
    try:
        train(dict(INT16_PARAMS, hist_method="fused"), d16, 1, **_on(dev))
        check(False, "int16: hist_method=fused trained")
    except NotImplementedError as e:
        check(INT16_REASON in str(e), f"int16 fused: {e}")
    out["int16"] = {"binning_s": bin_s, "bin_axis": nb,
                    "iters": INT16_ITERS, "s_per_iter": secs / INT16_ITERS,
                    "valid_auc": auc, "k3_16_launches": k3,
                    "split_scan_wide": scans,
                    **text_hash(bst.model_to_string(), "int16 staged")}
    log(f"  int16 staged: {INT16_ITERS} iterations, "
        f"{secs / INT16_ITERS:.4f} s/iter; valid AUC {auc:.5f}; K3 16-bit "
        f"{k3} launches; wide split scans {scans['per_tree']:.2f} a tree")
    Xp, yp = make_data(PARITY_ROWS, seed + 7)
    out["int16"]["parity"] = onehot_vs_cpu("int16", dict(
        PARITY_PARAMS, max_bin=511, hist_method="onehot"), Xp, yp, dev,
        iters=2)
    return out


def onehot_vs_cpu(tag, params, X, y, dev, iters=5) -> dict:
    """``card_vs_cpu_replay`` on the one-hot path at f32 (int16 bins have
    no K1): the CPU training takes the card's gradients and root sums;
    every split identical, leaves within PARITY_LEAF_TOL."""
    p = dict(params, hist_dtype="f32", hist_method="onehot")
    log(f"  {tag}, card against CPU (onehot f32, the card's gradients and "
        f"root sums): {len(X)} rows, {iters} iterations")
    rounding = CardRounding()
    saved = grower_wave._BUCKET_MIN_N
    grower_wave._BUCKET_MIN_N = 1
    try:
        with rounding.record():
            card = train(p, Dataset(X, label=y), iters, **_on(dev))
            _sync(dev)
        with rounding.replay():
            cpu = train(p, Dataset(X, label=y), iters, device="cpu")
    finally:
        grower_wave._BUCKET_MIN_N = saved
    return compare_splits(tag, card, cpu, ("card", "CPU"), PARITY_LEAF_TOL)


def new_leg_rows(legs: dict, extra: dict, int16: dict) -> list:
    """The kernels line's rows of the three legs of phases 38-41."""
    t = legs["timing"]
    r = t["rand"]
    rand_row = {
        "name": "split_scan:extra_trees", "route": "cuda",
        "source": SCAN_SRC, "replaces": "lightgbmv1_tpu/ops/split.py:602 "
        "find_best_split's extra_trees draw (XLA, inside the staged scan)",
        "launches": int(extra["split_scan"]["launches"]), "max_abs_err": 0.0,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "computes a split scan", "device_ms": r["device_ms"],
        "unrandomized_device_ms": r["unrandomized_device_ms"],
        "at": f"C={r['C']} B={r['B']}", "checks": legs["rand"]}
    w = t["wide_b512"]
    wide_row = {
        "name": "split_scan:wide", "route": "cuda", "source": SCAN_WIDE_SRC,
        "replaces": "lightgbmv1_tpu/ops/split.py:437 find_best_split on "
        "int16 histograms (XLA)",
        "launches": int(int16["split_scan_wide"]["launches"]),
        "max_abs_err": 0.0, "ms": w["ms"], "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "computes a split scan", "device_ms": w["device_ms"],
        "at": "C=126 B=512", "b1024": t["wide_b1024"],
        "b64_vs_256_bin_leg": t["wide_b64"], "checks": legs["wide"]}
    k = next(v for n, v in t.items() if n.startswith("k3_16")
             and "phase 8" in n)
    k512 = next(v for n, v in t.items() if n.startswith("k3_16")
                and "512 bins" in n)
    k3_row = {
        "name": "route_rows:int16", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:558 (the routing the "
        "JAX staged path runs with XLA route() on int16 bins)",
        "launches": int(int16["k3_16_launches"]), "max_abs_err": 0.0,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "library_note": "none: no single PyTorch call routes rows through "
        "a tree's splits", "device_ms": k["device_ms"],
        "u8_device_ms": k.get("u8_device_ms"), "bins_512": k512,
        "checks": legs["k3_16"]}
    return [rand_row, wide_row, k3_row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--train-rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reg-iters", type=int, default=20)
    ap.add_argument("--level-iters", type=int, default=100)
    ap.add_argument("--mc-iters", type=int, default=50)
    ap.add_argument("--rank-iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this runs "
              "the port on a CUDA card", file=sys.stderr)
        return 2
    global GATE_TEXT_SHA
    GATE_TEXT_SHA = all(v == ap.get_default(k) for k, v in vars(args).items())
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(args.seed)

    log("== phase 1: device")
    card = nvidia_smi()
    log(card)
    log(f"  torch {torch.__version__} CUDA {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 2: build")
    secs = _build.build(["predict_walk", "hist", "wave_fused", "wave_loop",
                         "wave_loop_int8", "quantize", "split_scan",
                         "split_scan_wide"])
    for name, rec in _build.build_log.items():
        log(f"  nvcc {name}.cu: {rec['seconds']:.1f} s")
        for k in ptxas_kernels(rec["log"]):
            log(f"    {k['kernel']}: {k.get('registers')} registers, "
                f"{k.get('spill_stores')} / {k.get('spill_loads')} bytes "
                f"spilled / reloaded, {k.get('stack')} bytes of stack")
    log(f"  built: {sorted(secs) or 'already built'}")

    log("== phase 3: model")
    t0 = time.perf_counter()
    text_a, trees_a = make_model(args.seed)
    text_b, trees_b = make_model(args.seed + 1, n_grid=13)   # packed codes
    text_c, trees_c = make_model(args.seed + 2, n_trees=60, num_class=3)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "smoke_model.txt")
    with open(path, "w") as fh:
        fh.write(text_a)
    booster = Booster(model_file=path)
    booster_b = Booster(model_str=text_b)
    trees = booster._all_trees()
    check(len(trees) == 500 and booster.num_feature() == F, "model shape")
    check(str(booster.device) == "cuda", f"booster on {booster.device}")
    depth = max(int(leaf_depths(trees, 255).max()), 0)
    log(f"  {len(trees)} trees x 255 leaves, {F} features, depth {depth}, "
        f"{len(text_a) / 1e6:.1f} MB of text, {time.perf_counter() - t0:.1f} s")

    log("== phase 4: kernels against their plain versions")
    errs = phase_kernels({
        "A(u8,K=1)": (text_a, trees_a, 1, {}),
        "B(packed,K=1)": (text_b, trees_b, 1, {}),
        "C(u8,K=3)": (text_c, trees_c, 3, {}),
    }, dev, 1 << 17, rng)          # the bulk path's chunk shape
    phase_leaf_shapes(BatchPredictor(trees_a, 1, F, method="pallas",
                                     device=dev), dev, rng)

    log("== phase 5: bulk predict (main path; launch counts reset)")
    pc.reset_launch_counts()
    bulk = phase_bulk(booster, trees, args.rows, rng)
    log("== phase 6: server")
    snap = phase_server(booster, booster_b, args.requests, rng, dev)
    torch.cuda.synchronize()
    launches = dict(pc.launch_counts)

    log("== phase 7: launches, timing, bounds")
    log(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    bp = booster._device_predictor(trees, 1, 0, "fused", {})
    check(bp.fused_plan["eligible"], f"fused plan: {bp.fused_plan}")
    log(f"  fused plan: {json.dumps(bp.fused_plan)}")
    rows = phase_timing(booster, trees, dev, launches, errs, rng)

    log("== phase 8: training data")
    t0 = time.perf_counter()
    X, y = make_data(args.train_rows, args.seed)
    Xv, yv = make_data(VALID_ROWS, args.seed + 1)
    ds = Dataset(X, label=y, params=TRAIN_PARAMS)
    dv = Dataset(Xv, label=yv, reference=ds)
    ds.construct()
    dv.construct()
    bin_s = time.perf_counter() - t0
    log(f"  {args.train_rows} + {VALID_ROWS} rows x {F} made and binned "
        f"in {bin_s:.1f} s (bin axis {ds._binned.padded_bin})")
    check(ds._binned.padded_bin == 64, "bin axis is not 64")

    log("== phase 9: K1 against its plain version")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    k1_checks = phase_hist_kernel(binned, dev, rng)
    del binned

    log("== phase 10: training (main path; launch counts reset)")
    trained, rec = phase_train(ds, dv, Xv, args.iters, dev)
    trained_scan_last = rec.scan_last
    log("  K1 against its plain version on the main path's last inputs")
    k1_checks += phase_hist_main_inputs(rec)

    log("== phase 11: f32 parity, card vs CPU")
    parity = phase_parity(args.seed, dev)

    log("== phase 12: K1 timing at the main path's buckets")
    k1_row = phase_hist_timing(rec, trained, k1_checks)
    del rec

    log("== phase 13: where a training iteration's time goes")
    prof = phase_profile(ds, 5, dev)

    log("== phase 14: K2 and K3 against their plain versions")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    meta = make_feature_meta(ds._binned, dev)
    k2_checks = phase_fused_kernels(binned, meta, rng)
    k3_checks = phase_k3_synthetic(binned, meta, rng)
    del binned, meta

    log("== phase 15: fused training (main path; launch counts reset)")
    fused, frec = phase_fused_train(ds, dv, Xv, args.iters, dev, trained)
    log("  K2 against its plain version on the main path's last inputs")
    k2_checks += phase_fused_main_inputs(frec)

    log("== phase 16: f32 parity on the card, fused vs staged")
    fparity = same_splits(args.seed, 65536, {
        "fused": (dict(PARITY_PARAMS, hist_method="fused"), dev),
        "staged": (PARITY_PARAMS, dev)})

    log("== phase 17: K2 and K3 timing at the main path's buckets, and the "
        "pick after K2")
    fused_rows = phase_fused_timing(frec, fused, k2_checks)
    fused_rows[1]["checks"] = k3_checks + fused_rows[1]["checks"]
    pick_row = pick_timing(frec, fused)
    pick_row["checks"] = [{"case": c["case"], "finite": c["pick_finite"]}
                          for c in k2_checks]
    del frec

    log("== phase 18: where a fused training iteration's time goes")
    fprof = phase_profile(ds, 5, dev, FUSED_PARAMS)

    log("== phase 19: K6 against R K2 rounds and its plain version")
    plan = loop_plan(ds, dev)
    log(f"  plan at the headline: {json.dumps(plan)}")
    check(plan["eligible"], f"the loop's plan refuses: {plan['reason']}")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    k6_checks = phase_loop_kernels(binned, make_feature_meta(ds._binned,
                                                             dev), rng)
    del binned

    log("== phase 20: looped training (main path; launch counts reset)")
    looped, lrec, drec = phase_loop_train(ds, dv, Xv, args.iters, dev)

    log("== phase 21: K6 timing and where a looped iteration's time goes")
    k6_row = phase_loop_timing(lrec, drec, looped, k6_checks)
    k6_row["plan"] = plan
    fused_rows[1]["launches_by_path"] = {
        "staged": trained["k3_launches"], "fused": fused["k3_launches"],
        "looped": looped["k3_launches"]}
    del lrec, drec
    lprof = phase_profile(ds, 5, dev, LOOP_PARAMS)

    paths, path_k1 = {}, []
    log("== phase 22: regression, the sequential grower (main path; launch "
        "counts reset)")
    t0 = time.perf_counter()
    y_reg, yv_reg = (regression_target(X, args.seed + 2),
                     regression_target(Xv, args.seed + 3))
    dreg = Dataset(X, label=y_reg, reference=ds)
    dvreg = Dataset(Xv, label=yv_reg, reference=dreg)
    dreg.construct()
    dvreg.construct()
    log(f"  continuous targets, rows binned on phase 8's bins in "
        f"{time.perf_counter() - t0:.1f} s")
    reg, rec, _ = phase_path("regression", REG_PARAMS, dreg, dvreg, Xv,
                             args.reg_iters, dev, "l2")
    check(all(L == 1 for L, _ in rec.last),
          f"the sequential grower called K1 at {sorted(rec.last)}")
    path_k1.append(phase_path_kernels("sequential", rec, reg, []))
    reg["profile"] = phase_profile(dreg, 5, dev, REG_PARAMS)
    reg["parity"] = card_vs_cpu("sequential", REG_PARAMS, X[:PARITY_ROWS],
                                y_reg[:PARITY_ROWS], dev)
    paths["regression"] = reg
    del rec, dreg, dvreg

    log("== phase 23: level-wise at the headline (main path; launch counts "
        "reset)")
    lvl, rec, _ = phase_path("levelwise", LEVEL_PARAMS, ds, dv, Xv,
                             args.level_iters, dev, "auc")
    log(f"  valid AUC {lvl['auc']:.5f} after {args.level_iters} iterations;"
        f" the JAX package's level-wise AUC {JAX_LEVEL_AUC} (root PERF.md,"
        f" 100 iterations of 1,000,000 rows; a quality figure)")
    check(lvl["auc"] > 0.90, f"level-wise valid AUC {lvl['auc']} <= 0.90")
    path_k1.append(phase_path_kernels("level-wise", rec, lvl, []))
    lvl["profile"] = phase_profile(ds, 5, dev, LEVEL_PARAMS)
    lvl["parity"] = card_vs_cpu("level-wise", LEVEL_PARAMS, X[:PARITY_ROWS],
                                y[:PARITY_ROWS], dev)
    paths["levelwise"] = lvl
    del rec, X, Xv

    log("== phase 24: multiclass at the bench parity config (main path; "
        "launch counts reset)")
    t0 = time.perf_counter()
    Xm, ym = make_multiclass_data(250_000, 10)
    Xmv, ymv = make_multiclass_data(50_000, 11)
    dm = Dataset(Xm, label=ym, params=MC_PARAMS)
    dmv = Dataset(Xmv, label=ymv, reference=dm)
    dm.construct()
    dmv.construct()
    log(f"  250,000 + 50,000 rows x 28, 5 classes, made and binned in "
        f"{time.perf_counter() - t0:.1f} s")
    mc, rec, booster_mc = phase_path("multiclass", MC_PARAMS, dm, dmv, Xmv,
                                     args.mc_iters, dev, "multi_logloss")
    log(f"  multi_logloss {mc['multi_logloss']:.5f} after {args.mc_iters} "
        f"iterations; the JAX package's {JAX_MC_LOGLOSS}, the reference "
        f"C++'s {REF_MC_LOGLOSS} (root PERF.md parity set, 50 iterations; "
        "quality figures)")
    mc["served"] = phase_trained_k4(booster_mc, Xmv, dev, rng, "multiclass")
    path_k1.append(phase_path_kernels("multiclass", rec, mc, []))
    mc["profile"] = phase_profile(dm, 5, dev, MC_PARAMS)
    mc["parity"] = card_vs_cpu("multiclass", MC_PARAMS, Xm[:PARITY_ROWS],
                               ym[:PARITY_ROWS], dev, iters=2)
    paths["multiclass"] = mc
    del rec, booster_mc, dm, dmv, Xm, Xmv

    log("== phase 25: lambdarank at the bench parity config (main path; "
        "launch counts reset)")
    t0 = time.perf_counter()
    Xr, yr, gr = make_rank_data(2000, 100, 20)
    Xrv, yrv, grv = make_rank_data(400, 100, 21)
    dr = Dataset(Xr, label=yr, group=gr, params=RANK_PARAMS)
    drv = Dataset(Xrv, label=yrv, group=grv, reference=dr)
    dr.construct()
    drv.construct()
    log(f"  2,000 + 400 queries x 100 documents x 64 features made and "
        f"binned in {time.perf_counter() - t0:.1f} s")
    rk, rec, booster_rk = phase_path("lambdarank", RANK_PARAMS, dr, drv,
                                     Xrv, args.rank_iters, dev, "ndcg@10")
    log(f"  ndcg@10 {rk['ndcg@10']:.5f} after {args.rank_iters} iterations;"
        f" the JAX package's {JAX_RANK_NDCG10}, the reference C++'s "
        f"{REF_RANK_NDCG10} (root PERF.md parity set, 100 iterations; "
        "quality figures)")
    rk["served"] = phase_trained_k4(booster_rk, Xrv, dev, rng, "lambdarank")
    path_k1.append(phase_path_kernels("lambdarank", rec, rk, []))
    rk["profile"] = phase_profile(dr, 5, dev, RANK_PARAMS)
    rk["parity"] = card_vs_cpu("lambdarank", RANK_PARAMS, Xr[:40000],
                               yr[:40000], dev, group=gr[:400])
    paths["lambdarank"] = rk
    del rec, booster_rk, dr, drv
    k1_row["paths"] = path_k1

    log("== phase 26: packed bins: K1, K2, K3 and K6 against their u8 legs "
        "and plain versions")
    t0 = time.perf_counter()
    X, y = make_data(args.train_rows, args.seed)
    Xv, yv = make_data(VALID_ROWS, args.seed + 1)
    dp = Dataset(X, label=y, params=PACKED_PARAMS)
    dpv = Dataset(Xv, label=yv, reference=dp)
    dp.construct()
    dpv.construct()
    log(f"  phase 8's rows binned at max_bin=15 in "
        f"{time.perf_counter() - t0:.1f} s (bin axis "
        f"{dp._binned.padded_bin})")
    check(dp._binned.padded_bin == 16, "bin axis is not 16")
    binned = torch.as_tensor(dp._binned.binned, device=dev).contiguous()
    pchecks = phase_packed_kernels(binned, make_feature_meta(dp._binned,
                                                             dev), rng)
    del binned

    log("== phase 27: packed training (main path; launch counts reset)")
    packed, precs = phase_packed_train(dp, dpv, Xv, args.iters, dev)
    prow = phase_packed_timing(precs, packed)
    del precs, dp, dpv
    k1_row["packed"] = dict(prow["hist_leaves"], max_abs_err=0.0,
                            checks=pchecks["k1"])
    fused_rows[0]["packed"] = dict(prow["fused_round"], max_abs_err=0.0,
                                   checks=pchecks["k2"])
    fused_rows[1]["packed"] = dict(prow["route_rows"], max_abs_err=0.0)
    k6_row["packed"] = dict(
        prow["fused_wave_loop"], checks=pchecks["k6"],
        max_abs_err=max(max(c["max_gain_err"], c["max_sum_err"])
                        for c in pchecks["k6"]))

    log("== phase 28: int8sr: the quantize kernel, K1, K2 and K6 against "
        "their plain versions")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    ichecks = phase_int8sr_kernels(binned, make_feature_meta(ds._binned,
                                                             dev), rng)
    del binned

    log("== phase 29: int8sr training (main path; launch counts reset)")
    int8sr, irecs = phase_int8sr_train(ds, dv, Xv, args.iters, dev)
    irow, qrow = phase_int8sr_timing(irecs, int8sr)
    del irecs

    log("== phase 30: int8sr parity, card vs CPU")
    iparity = card_vs_cpu("int8sr", INT8SR_PARAMS, X[:PARITY_ROWS],
                          y[:PARITY_ROWS], dev)
    iparity["fused_vs_staged"] = int8sr_fused_vs_staged(
        X[:PARITY_ROWS], y[:PARITY_ROWS], dev)
    del X
    k1_row["int8sr"] = dict(irow["hist_leaves"], max_abs_err=0.0,
                            checks=ichecks["k1"])
    fused_rows[0]["int8sr"] = dict(irow["fused_round"], max_abs_err=0.0,
                                   checks=ichecks["k2"])
    k6_row["int8sr"] = dict(irow["fused_wave_loop"], max_abs_err=0.0,
                            checks=ichecks["k6"])
    qrow["checks"] = ichecks["quantize"]

    log("== phase 31: the split-scan kernel and K2's and K6's constrained "
        "legs against their plain versions")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    schecks = phase_scan_kernels(ds, binned, make_feature_meta(ds._binned,
                                                               dev), rng, dev)
    del binned
    log("  the split-scan kernel on phase 10's last inputs")
    scan_row = scan_timing(trained_scan_last, {
        "staged": trained["split_scan"], "fused": fused["split_scan"],
        "looped": looped["split_scan"],
        **{k: paths[k]["split_scan"] for k in paths}})
    scan_row["checks"] = schecks["scan"]

    log("== phase 32: constrained training (main path; launch counts "
        "reset)")
    constrained, crecs = phase_constrained_train(ds, dv, Xv, args.iters, dev)
    legs = legs_timing(crecs)
    del crecs
    fused_rows[0]["constrained"] = dict(
        legs["k2 contri+smooth+max_output"], max_abs_err=0.0,
        monotone=legs["k2 monotone"], checks=schecks["k2"],
        launches={k: v["k2"] for k, v in constrained.items() if v["k2"]})
    k6_row["constrained"] = dict(
        legs["k6 contri+smooth+max_output"], max_abs_err=0.0,
        checks=schecks["k6"],
        launches={k: v["k6"] for k, v in constrained.items() if v["k6"]})

    log("== phase 33: constrained parity, card vs CPU")
    Xp, yp = make_data(PARITY_ROWS, args.seed + 7)
    cparity = card_vs_cpu_replay("constrained", dict(PARITY_PARAMS,
                                                     **CONSTRAINED_PARITY),
                                 Xp, yp, dev)

    log("== phase 34: plain int8: the quantize kernel, K1, K2 and K6 "
        "against their plain versions")
    t0 = time.perf_counter()
    Xq, yq = make_data(1 << 18, args.seed + 9)
    dq = Dataset(Xq, label=yq, params=PACKED_PARAMS)
    dq.construct()
    log(f"  262,144 rows binned at max_bin=15 for the 16-bin legs in "
        f"{time.perf_counter() - t0:.1f} s")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    qchecks = phase_int8_kernels(binned, make_feature_meta(ds._binned, dev),
                                 rng, dq._binned)
    del binned, dq, Xq, yq

    log("== phase 35: int8 training (main path; launch counts reset)")
    int8, qrecs = phase_int8_train(ds, dv, Xv, args.iters, dev,
                                   trained["max_abs_leaf"])
    qrow8, rnrow = phase_int8_timing(qrecs, int8)
    del qrecs
    k1_row["int8"] = dict(qrow8["hist_leaves"], max_abs_err=0.0,
                          checks=qchecks["k1"])
    fused_rows[0]["int8"] = dict(qrow8["fused_round"], max_abs_err=0.0,
                                 checks=qchecks["k2"])
    k6_row["int8"] = dict(qrow8["fused_wave_loop"], max_abs_err=0.0,
                          checks=qchecks["k6"])
    rnrow["checks"] = qchecks["quantize"]

    log("== phase 36: sampling training (main path; launch counts reset)")
    sampled = phase_sample_train(ds, dv, Xv, args.iters, dev)

    log("== phase 37: int8 and sampled parity, card vs CPU")
    qparity = {
        "int8": card_vs_cpu_replay("int8", PARITY_PARAMS, Xp, yp, dev,
                                   precision="int8"),
        "sampled": card_vs_cpu_replay("sampled", dict(PARITY_PARAMS,
                                                      **SAMPLE), Xp, yp,
                                      dev)}
    del Xp, yp

    log("== phase 38: the split scan's extra_trees and wide legs and K3's "
        "16-bit leg against their plain versions")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    legs38 = phase_new_legs(binned, make_feature_meta(ds._binned, dev), rng,
                            trained_scan_last, dev)
    del binned

    log("== phase 39: extra_trees training (main path; launch counts "
        "reset)")
    extra = phase_extra_trees(ds, dv, Xv, args.iters, dev, args.seed)

    log("== phase 40: callbacks and early stopping (main path; launch "
        "counts reset)")
    callbacks = phase_callbacks(ds, dv, Xv, CALLBACK_ITERS, dev)

    log("== phase 41: onehot, bench and int16 bins (main path; launch "
        "counts reset)")
    X, y = make_data(args.train_rows, args.seed)
    newer = phase_onehot_bench_int16(ds, dv, Xv, X, y, dev, args.seed,
                                     trained["s_per_iter"])
    del X, y
    new_rows = new_leg_rows(legs38, extra, newer["int16"])
    k1_row["onehot"] = {
        "note": "a torch.matmul path (the JAX package's XLA one-hot "
        "product), not a kernel", **newer["onehot"]}

    log(json.dumps({"rows_per_s": {m: bulk[m]["rows_per_s"]
                                   for m in ("fused", "pallas")},
                    "host_prebin_s": bulk["encode_s"],
                    "predictor_build_s": bulk["build_fused_s"],
                    "server": {k: snap[k] for k in (
                        "qps", "p50_ms", "p99_ms", "batches",
                        "batch_occupancy", "steady")},
                    "train": trained,
                    "train_binning_s": bin_s, "parity": parity,
                    "train_profile": prof, "fused_train": fused,
                    "fused_parity": fparity, "fused_profile": fprof,
                    "loop_train": looped, "loop_profile": lprof,
                    "paths": paths, "packed_train": packed,
                    "int8sr_train": int8sr, "int8sr_parity": iparity,
                    "constrained_train": constrained,
                    "constrained_parity": cparity,
                    "int8_train": int8, "sampled_train": sampled,
                    "int8_sampled_parity": qparity,
                    "extra_trees_train": extra, "callbacks_train": callbacks,
                    "onehot_train": newer["onehot"], "bench": newer["bench"],
                    "int16_train": newer["int16"],
                    "seconds": time.perf_counter() - t_start}))
    pick_row["checks"] += [{"case": c["case"], "finite": c["pick_finite"]}
                           for c in schecks["k2"]]
    print(json.dumps({"kernels": [k1_row] + fused_rows
                      + [k6_row, qrow, rnrow, scan_row, pick_row] + new_rows
                      + rows}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

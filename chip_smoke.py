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
13. profile — one headline iteration under torch.profiler, after a
              warm-up: device time by kernel and the device's busy share.
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
18. profile — one fused headline iteration, as phase 13.
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
              on that round's inputs; one looped iteration profiled, as
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
              versions on the path's last inputs and timed there; one
              iteration profiled; and the path in f32 on the card and on
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
41. onehot, bench, int16 — staged onehot training (bf16x2, 20
              iterations): AUC > ONEHOT_AUC_MIN, the one-hot histograms of the
              path's last inputs within the scatter's and K1's
              tolerance, their time beside K1's (a torch.matmul path, not
              a kernel); hist_method=bench's pick trains the text of that
              method chosen directly, the candidates' times printed;
              phase 8's rows at max_bin=511 (int16 bins, binning time),
              20 staged iterations through onehot, the wide scan and
              K3's 16-bit leg: AUC > ONEHOT_AUC_MIN, K3 launches = trees
              x valid sets, hist_method=fused raising the JAX reason, f32
              card against CPU splits identical at 65,536 rows.
42. boosting — GOSS (defaults), DART (drop_rate 0.1) and RF (bagging
              0.63 every iteration) at the headline, 25 iterations each
              (bench.py:2783-2821's knobs), staged and fused, GOSS also
              looped (all three at hist_dtype_deep=bf16x2): each mode's
              staged, fused (and looped) model texts one, a second staged
              DART training the same text; K1, K2, K3 and K6 launched on
              their paths; RF's text carrying ``average_output`` and its
              predictions through K4 within the serving tolerance over the
              iterations of the host walk's; DART's training scores a
              fresh K4 sum of its saved trees (plus the cache's f32
              roundings); valid AUC above 0.88 (GOSS, DART), 0.85 (RF);
              s/iteration beside phase 10's.
43. objectives — phase 8's rows and bins with the labels swapped by
              ``Dataset.set_label`` (phase 22's regression target; the
              exp of its half; its sigmoid) for L1, huber, fair,
              quantile, mape, poisson, gamma, tweedie and the two
              cross-entropies, and
              phase 25's rank data for rank_xendcg: 15 staged iterations
              each at the headline width, the valid metric printed
              beside the JAX package's on the same generator
              (``objective_levels.py``), every saved model served
              through K4 within the serving tolerance; f32 card against
              CPU splits identical at 65,536 rows (40,000 ranked rows)
              for regression_l1 (leaf renewal), poisson and rank_xendcg.
44. lifecycle — phase 8's bins, the headline staged with
              finite_guard=raise (which must stay silent): 10 iterations
              in one go, and 5, ``save_checkpoint``, a fresh Booster
              ``resume_from_checkpoint`` and 5 more: the model texts byte
              for byte, the valid scores bit for bit, K1 and K3 (a tree)
              launched and no plain version; ``rollback_one_iter`` gives
              the 9-iteration text; ``train(init_model=<5-iteration
              text>)`` trains 5 more on the card, its score seed through
              K5; ``refit`` on the valid rows keeps every tree's structure
              and launches K5.  Checkpoint size and write / resume time.
45. EFB       — 131,072 + 131,072 rows of ``make_efb_data`` (bench.py's
              28 features beside 8 one-hot groups of 16 levels, from
              ``--seed``), binned dense and from ``scipy.sparse`` CSR
              (host seconds each): fewer bundle columns than features
              (the CSR set never dense); K1 on the bundle matrix against
              its plain versions (as in phase 9, at L = 1, 17, 64 and on
              the path's last inputs); K3's bundle leg on two synthetic
              trees (tables in shared and in device memory) bitwise its
              plain version, the u8 leg on the unbundled bins and the
              tree walk; 10 staged headline iterations on the bundle
              columns with a bundled valid set: K3's bundle leg once a
              tree (the u8 leg never), valid AUC within 2e-3 of
              enable_bundle=false, the CSR construction's model text the
              dense one's byte for byte; K3's bundle leg timed on the
              path's last routing (L2 cleared) beside its u8 leg and its
              bound, K1 at its last 64-slot call beside the unbundled
              matrix.
46-48.        the categorical, CEGB and bitset legs against their plain
              versions; categorical training at the headline width;
              interaction constraints, CEGB and forced splits.
49. native    — phase 3's model through ``predict_method=native`` (the
              threaded C++ walk, ``native/predictor.cpp``) at 131,072
              rows: bitwise the host walk on 2,048 rows, ``auto`` taking
              it, within the serving tolerance of K4 on the same rows
              (launched); rows/s of each with the host's threads; the
              native csv parser bit for bit the Python one on 262,144
              rows of phase 8's generator, seconds of each.
50. CLI       — ``cli.main`` in process on the card: ``task=train`` on
              that csv with a 65,536-row ``valid=`` file at the headline
              width, 10 iterations (K1 launched, K3 once a tree, a text
              that loads; s/iteration beside phase 10's),
              ``task=predict`` with ``predict_method=fused`` (K4, the
              file equal to ``Booster.predict``), ``task=convert_model``
              compiled by g++ (raw scores within 1e-12 on 1,000 rows),
              ``task=refit`` (K5, structures kept), an
              ``LGBMClassifier`` fit whose ``predict_proba`` is its
              booster's.
51. TreeSHAP  — ``pred_contrib`` on 32 rows of phase 10's 50-tree model,
              each row summing to its raw score within 1e-9 (ms a row and
              tree); ``pred_early_stop`` (freq 5, margin 4) on the valid
              rows: the rows that stopped early, seconds beside the full
              host walk.
52. serving   — ``cli.run_serve`` in process on the card: phase 3's
              model A behind the HTTP front-end on a port of 127.0.0.1
              the system picks (``predict_method`` at its default, the
              f64 lane, a two-tenant manifest, ``trace_out``, watchdog
              and breaker armed); 8 client threads POST 200 requests of
              1-256 rows
              while model B is published and rolled back, every answer
              bit for bit ``Booster.predict(raw_score=True)`` of its
              version; requests/s, p50 / p99 ms, batches and mean batch
              rows; each tenant its own version (``/tenants``); ``/slo``
              burn rates; the Prometheus view parsed; a ``replica_wedge``
              stall answered 503, a dispatcher killed and restarted, two
              failed batches opening the breaker (a rollback); the
              sampled responses' trace ids in the exported trace.  Then a
              degrading server (the first 100 trees, answered by K4 under
              a forced backlog) and a drift-armed one (PSI under the
              threshold on the training distribution, over it on shifted
              rows).  Every version any of them publishes walks with K4
              (its predictor and its degrade predictor), and K4's
              launches are exactly the servers' batches plus each
              publish's warm batches and its two probe batches.  Its
              artifacts go to ``build/obs`` (phase 54).
53. fleet     — ``cli.run_serve`` with ``serve_replicas=3`` in process:
              the first 250 trees of model A on three replicas of the
              one card behind the router (health poll 15 ms, two
              retries, hedges after 50 ms), two tenants under
              ``placement_replicas_per_tenant=2``; 6 client threads POST
              2-row requests for 2.5 s and r1 closes at 40% of the
              window: no client error, timeout or shed, every answer bit
              for bit ``Booster.predict(raw_score=True)``, r1 ejected
              within 3 s; then model A whole published fleet-wide (one
              tag on every replica) and each tenant answered on its two
              pinned replicas; requests/s, p50 / p99 ms, retries,
              ``hedge_frac``; K4's launches exactly every replica's
              batches plus every version's warm and probe batches, K5
              none.
54. obs       — ``task=train`` through the CLI at the headline width
              (phase 50's 32,768-row valid file, 3 iterations) with
              ``profile_dir``,
              ``obs_dir`` and ``obs_trace``, then ``aggregate_dir`` over
              phases 52-54's artifacts and the capture: a lane a
              process role and a device lane with K1's and K3's CUDA
              kernels and their ``lgbm.*`` scopes, the anchor read, the
              device-memory gauges set, the kernel counters equal to the
              launch tables, every ``nvcc`` build's seconds present.
              Then the ``kernels`` line (K1, K2, K3, K6, the two quantize
              kernels, the split-scan kernel, the pick kernel, the
              split scan's extra_trees and wide legs, K3's 16-bit and
              bundle legs, K4, K5) is printed; K1's row carries phases
              22-25's K1 shapes too (``paths``), phase 41's one-hot path
              beside it (``onehot``) and phase 45's bundle matrix
              (``bundle``), K1, K2, K3 and K6 a ``packed`` record, K1,
              K2 and K6 an ``int8sr`` one and an ``int8`` one, and K2
              and K6 a ``constrained`` one; K1's row also a ``stream``
              record (phase 55).
55. stream    — out-of-core training at bench.py's measure_stream
              configuration: 200,000 rows of phase 8's generator (binary,
              31 leaves, ``tree_growth=leafwise_masked``, bagging 0.8
              every 2, ``feature_fraction`` 0.9, seed 7), 3 iterations,
              blocks of 4,096 rows (49, the last of 3,392).  (a) resident
              training; (b) ``save_block_cache`` then ``Dataset(dir)``
              trained with ``stream_prefetch`` on (launch counts reset,
              the allocator's peak reset) and off; (c) ``stream_enable``
              with one block of 262,144 rows; (d) ``task=save_binary`` on
              phase 50's 32,768-row valid file, then ``task=train
              data=<dir>`` (2 iterations).  Gates: (c) is (a)'s model
              text byte for byte; (b)'s two texts equal; K1's launches
              in (b) are 49 x (1 + the tree's splits) a tree (the pool
              kept), the split scan's a tree's root and splits, and no
              plain histogram or scan ran; K1 on (b)'s last full block
              and on the tail
              block bit for bit its row-order version (``check_k1``); the
              ledger's peak and the allocator's peak over (b) within
              measure_stream's bound (bench.py:1877-1880); (d) streams
              through K1 and writes the Python API's model text; (b)'s
              AUC on 65,536 held-out rows served by K4 within 1e-3 of
              (a)'s.  Prints the streamed and resident s/iteration and
              their ratio, the peaks and the ledger's tags, the resident
              matrix bytes, the cache write seconds, the bytes a pass
              uploads, and the host's time in the ``stream.*`` spans of
              the prefetch-off run (the tracer armed for it alone).
56. parallel  — the data, voting and feature learners over two gloo
              ranks on the one card (two processes of this script,
              ``--parallel-rank``, started before phase 55 and waiting
              for phase 56's job).  (a) the serial learner at the
              headline width, 262,144 rows, 5 iterations, in process;
              then each rank takes its rows of the same binned set and
              trains (b) data with reduce_scatter, (c) data with
              allreduce, (d) voting at top_k 5 (2k = 10 < 28), (e) voting
              at top_k 28, (f) feature, counts reset just before each;
              then the CLI's ``task=train tree_learner=data
              num_machines=2`` through its machine list on phase 50's
              32,768-row file.  Gates: the two ranks' model texts byte
              for byte in every leg; (b), (c), (e), (f) one structure and
              (b) (a)'s; each rank's K1 and split-scan launches non-zero,
              equal across the ranks and, for (b), (c), (e), (f), (a)'s;
              after (b) (a 131,072-row shard) and (f) (this rank's 14
              features, a view of the bins at its storage offset), K1 on
              each rank's last inputs at every slot bucket of the leg bit
              for bit its row-order plain version, and the split scan on
              its last inputs at every child count, masked to the rank's
              columns, bit for bit the CPU plain scan (``check_scan``); no
              plain histogram or scan on a leg; every collective call's
              payload
              the analytic table's (``obs/metrics.comm_table_per_round``);
              each leg's held-out AUC on 65,536 rows served by K4 within
              1e-3 of (a)'s; the CLI's ranks launched K1 and wrote a
              model of its trees; every collective call handed gloo a
              CUDA tensor (none staged through the host).  Prints each
              leg's s/iteration beside (a)'s with the card's name and
              power limit, and the collectives' calls and bytes.

At the default arguments every model text named in ``TEXT_SHA`` must
keep its sha256 (a gate: the kernels claim the same bits).  The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from lightgbmv1_tpu_torch import Booster, Dataset, objectives, train
from lightgbmv1_tpu_torch import native as native_mod
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io import bundle as bundle_mod
from lightgbmv1_tpu_torch.io.binning import (K_ZERO_THRESHOLD, MISSING_NAN,
                                             MISSING_ZERO)
from lightgbmv1_tpu_torch.io.model_text import model_to_string
from lightgbmv1_tpu_torch.data import load_manifest
from lightgbmv1_tpu_torch.models import gbdt as gbdt_mod, grower_wave
from lightgbmv1_tpu_torch.models import gbdt_stream
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
from lightgbmv1_tpu_torch.parallel.cluster import find_free_port
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer
from lightgbmv1_tpu_torch.obs import agg as obs_agg
from lightgbmv1_tpu_torch.obs import device as obs_device
from lightgbmv1_tpu_torch.obs import events as obs_events
from lightgbmv1_tpu_torch.obs import trace as obs_trace
from lightgbmv1_tpu_torch.serve import ServeConfig, ServeHTTP, Server
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


# the seconds the timing helpers (``timing_budget``) spend, by phase and
# helper: what the run's timing repetitions cost, beside its gates
TIMING_SECONDS: dict = {}
_PHASE = ["0"]
_TIMING_DEPTH = [0]


def log(msg: str) -> None:
    """Print a line; a phase's heading also gets the run's seconds so far."""
    if msg.startswith("== phase"):
        _PHASE[0] = msg.split()[2].rstrip(":")
        msg += f" [{time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


def timing_budget(fn):
    """Add the wall seconds of each outermost call of ``fn`` (a timing
    helper) to ``TIMING_SECONDS[<phase>:<fn>]``."""
    @functools.wraps(fn)
    def run(*a, **kw):
        _TIMING_DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            _TIMING_DEPTH[0] -= 1
            if _TIMING_DEPTH[0] == 0:
                key = f"{_PHASE[0]}:{fn.__name__}"
                TIMING_SECONDS[key] = (TIMING_SECONDS.get(key, 0.0)
                                       + time.perf_counter() - t0)
    return run


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
    host_raw = booster.predict(sub, raw_score=True,        # host walk, f64
                               predict_method="host")
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


@timing_budget
def time_once_ms(fn) -> float:
    """The ms of one call of ``fn`` by CUDA events, no warm-up: for the
    plain versions that take a second or so a call, where a warm-up call
    costs as much as the timing and an allocator's first growth is a
    small share of it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


@timing_budget
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


@timing_budget
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


@timing_budget
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
        plain_ms = time_once_ms(plain)
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
    counts its launches.  With ``clone`` each call's rows and leaf ids are
    kept as copies (the bins as given: a view stays a view), so later
    rounds' writes to the grower's buffers leave them as the call saw
    them."""

    def __init__(self, clone=False):
        self.last = {}
        self.clone = clone
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
            elif self.clone:
                self.last[key] = (binned, g3.clone(), leaf_id.clone(),
                                  num_bins, live_slots)
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
# level-wise, multiclass, lambdarank, onehot, int16 and GOSS / DART / RF
# at the depths cut to make room for phases 49-51
TEXT_SHA = {
    "staged": "2f70fd68", "fused": "2f70fd68", "looped": "ab555744",
    **{f"int8sr {p}": "9cb41f19" for p in ("staged", "fused", "looped")},
    "packed staged": "2d313420", "packed fused": "3879b939",
    "packed looped": "cd0e138f", "regression": "edfe5496",
    "levelwise": "b1101a6f", "multiclass": "733e6092",
    "lambdarank": "1ef35dfc",
    **{f"basic {p}": "466d723f" for p in ("staged", "fused")},
    **{f"intermediate {p}": "a97a6b24" for p in ("staged", "fused")},
    **{f"contri+smooth+max_output {p}": "94cb7dfb"
       for p in ("staged", "fused", "looped")},
    **{f"int8 {p}": "72e55fbf" for p in ("staged", "fused", "looped")},
    **{f"int8 deep {p}": "7d766b41" for p in ("staged", "fused")},
    **{f"sampled {p}": "394caec2" for p in ("staged", "fused")},
    **{f"sampled bag+tree {p}": "bba170e4" for p in ("fused", "looped")},
    "extra_trees staged": "63a2d740", "callbacks staged": "e3d3bfd1",
    "onehot staged": "f3bbcb82", "int16 staged": "b7be91ea",
    **{f"goss {p}": "daba829f" for p in ("staged", "fused", "looped")},
    **{f"dart {p}": "8c90c892" for p in ("staged", "fused")},
    **{f"rf {p}": "70a813ce" for p in ("staged", "fused")},
    "regression_l1": "d32a0fd3", "huber": "d32c0780", "fair": "1ecd415e",
    "quantile": "f783914f", "mape": "48f80f3d", "poisson": "2cc91b29",
    "gamma": "617c5fde", "tweedie": "7f993b1b", "cross_entropy": "a49356e5",
    "cross_entropy_lambda": "34ddfe6e", "rank_xendcg": "75d12e91",
    "categorical staged": "24108f2d",
    **{f"interaction {p}": "d85b0b25" for p in ("staged", "fused")},
    "cegb sequential": "41243922", "forced leafwise": "1dcc9854",
    "forced levelwise": "903cd43a",
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

@timing_budget
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


def k3_bound(binned, feats, rmeta, offsets, num_leaves, packed=False,
             bundle=None, cat=None):
    """K3's bound by bytes on one call from the root: each row's leaf id
    read (4 B) and written (4 B), one bin byte for each round in which
    its leaf splits (this run's rows, counted round by round with the
    plain version; a bundle-bin byte under ``bundle``), and the tables
    read once (feats, rmeta, offsets, the bundle leg's (5, F) table and
    the bitset leg's (P, 1 + W) rows ``cat``)."""
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
                                 num_leaves, packed, bundle=bundle,
                                 cat=None if cat is None else cat[o0:o1])
    nbytes = N * 8 + reads + 4 * (feats.numel() + rmeta.numel()
                                  + offsets.numel()) + (
        0 if bundle is None else 4 * bundle.table.numel()) + (
        0 if cat is None else 4 * cat.numel())
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
                  offsets=None, bundle=None, cat=None):
            args = (binned, lids, feats, rmeta, num_leaves, offsets)
            if packed:
                self.packed_route = args
            elif bundle is None and cat is None:
                self.route = args
            return self._orig[1](*args[:5], packed=packed, offsets=offsets,
                                 bundle=bundle, cat=cat)

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
# iterations under torch.profiler in phases 13, 18, 21 and 22-25, after
# one warm-up (no gate reads them; five until phase 52 needed the room,
# three until phase 56 did)
PROFILE_ITERS = 1


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


@timing_budget
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
        "plain_ms": time_once_ms(lambda: hc.hist_leaves_ref(
            binned, g3, lid, L, B, "int8", live, rows8=rows8)),
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
        "plain_ms": time_once_ms(lambda: fc.fused_round_ref(
            binned, g3, **kw)),
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
        "plain_ms": time_once_ms(lambda: lc.fused_wave_loop_ref(*pos,
                                                                **kw)),
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
ONEHOT_ITERS = 20
INT16_PARAMS = dict(TRAIN_PARAMS, max_bin=511)
# 20 iterations (50 until phases 49-51 needed the room): the headline's
# valid AUC passes 0.90 only past about 30 (0.8884 / 0.8937 / 0.8969 after
# 10 / 20 / 25 at max_bin 63, the port on the CPU), so these two gate
# their AUC at 20 iterations: the card reads 0.89394 (onehot) and 0.89398
# (int16) there, and the gate keeps the 0.009 margin the 0.90 gate kept
# below phase 10's 0.908 at 50
INT16_ITERS = 20
ONEHOT_AUC_MIN = 0.885
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
    check(auc > ONEHOT_AUC_MIN,
          f"onehot: valid AUC {auc} <= {ONEHOT_AUC_MIN}")
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
    check(auc > ONEHOT_AUC_MIN,
          f"int16: valid AUC {auc} <= {ONEHOT_AUC_MIN}")
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


# ---------------------------------------------------------------------------
# GOSS, DART and RF (phase 42); the other objectives (phase 43)
# ---------------------------------------------------------------------------

BOOST_ITERS = 25           # 30 until phases 49-51 needed the room
# bench.py:2783-2821's knobs on the headline configuration; every run at
# hist_dtype_deep=bf16x2, the looped path's precision (LOOP_PARAMS)
BOOST_MODES = (
    ("goss", {"boosting": "goss"}, ("staged", "fused", "looped"), 0.88),
    ("dart", {"boosting": "dart", "drop_rate": 0.1}, ("staged", "fused"),
     0.88),
    ("rf", {"boosting": "rf", "bagging_fraction": 0.63, "bagging_freq": 1},
     ("staged", "fused"), 0.85))
BOOST_PATH = {"staged": dict(TRAIN_PARAMS, hist_dtype_deep="bf16x2"),
              "fused": dict(FUSED_PARAMS, hist_dtype_deep="bf16x2"),
              "looped": LOOP_PARAMS}
OBJ_ITERS = 15
OBJ_PARAMS = {k: v for k, v in TRAIN_PARAMS.items() if k != "metric"}
BREADTH_OBJECTIVES = ("regression_l1", "huber", "fair", "quantile", "mape",
                      "poisson", "gamma", "tweedie", "cross_entropy",
                      "cross_entropy_lambda", "rank_xendcg")
# objective_levels.py: the JAX package on the CPU (its default histogram
# method, the f32 scatter), the same generators, rows, iterations and
# knobs as phase 43: each objective's default valid metric, a quality
# figure beside the card's, not a gate.  Its poisson training diverges:
# at 1,048,576 rows the f32 scatter's bin sums carry errors of hundreds,
# so a 128-row leaf's hessian sum by parent subtraction reads 1.41 for
# about 425, the leaf 23.7 after shrinkage, and the next tree finds no
# split (the port's CPU scatter reads 2.11 there, a leaf of 5.55)
JAX_OBJECTIVE_METRIC = {
    "regression_l1": 0.9771486916595067, "huber": 0.7175920995546876,
    "fair": 0.34876330616214296, "quantile": 0.2170630403401027,
    "mape": 0.5824348782342417, "poisson": 2343649.7165084817,
    "gamma": 1.1848539160930094, "tweedie": 4.768119765456176,
    "cross_entropy": 0.5685625031635606,
    "cross_entropy_lambda": 0.6820183334481955,
    "rank_xendcg": 0.566487698452287}


def objective_label(objective, target):
    """Phase 43's label of ``objective`` from the regression target: the
    target, the exp of its half (poisson, gamma, tweedie: the exp of the
    whole target, a log-normal of sigma about 2, gives gamma's first tree
    leaves of -43 in both packages, which then stop after 2 iterations
    with no split left), or its sigmoid (the two cross-entropies)."""
    if objective in ("poisson", "gamma", "tweedie"):
        return np.exp(0.5 * target)
    if objective in ("cross_entropy", "cross_entropy_lambda"):
        return 1.0 / (1.0 + np.exp(-target))
    return target


def boost_counts() -> dict:
    return {"k1": hc.launch_counts["hist_leaves"],
            "k2": fc.launch_counts["fused_round"],
            "k3": fc.launch_counts["route_rows"],
            "k6": lc.launch_counts["fused_wave_loop"],
            "split_scan": sc.launch_counts["split_scan"]}


@contextlib.contextmanager
def recorded_drops():
    """Each DART iteration's drop list (``DART._select_drops``)."""
    lists, orig = [], gbdt_mod.DART._select_drops

    def spy(self):
        lists.append(orig(self))
        return lists[-1]

    gbdt_mod.DART._select_drops = spy
    try:
        yield lists
    finally:
        gbdt_mod.DART._select_drops = orig


def cache_tol(trees, scores, iters) -> float:
    """The serving tolerance plus four f32 roundings of the largest score
    an iteration: a DART cache removes, restores and adds each
    iteration where a K4 walk sums each tree once."""
    return raw_tol(trees) + 4 * iters * 2.0 ** -24 * max(
        1.0, float(np.abs(scores).max()))


def phase_boosting(ds, dv, Xv, X, iters, dev, staged10) -> dict:
    """Phase 42: GOSS, DART and RF at the headline (launch counts reset
    before each training and read after it)."""
    out = {}
    for mode, knobs, paths, auc_min in BOOST_MODES:
        texts, res = {}, {}
        for path in paths:
            params = dict(BOOST_PATH[path], **knobs)
            reset_counts()
            ev = {}
            t0 = time.perf_counter()
            bst = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                        **_on(dev))
            _sync(dev)
            secs = time.perf_counter() - t0
            counts = boost_counts()
            plain = plain_calls()
            trees = bst.num_trees()
            auc = ev["valid_0"]["auc"][-1]
            texts[path] = bst.model_to_string()
            res[path] = {"s_per_iter": secs / iters, "valid_auc": auc,
                         "launches": counts,
                         **text_hash(texts[path], f"{mode} {path}")}
            log(f"  {mode} {path}: {iters} iterations, "
                f"{secs / iters:.4f} s/iter (phase 10 staged "
                f"{staged10['s_per_iter']:.4f}); valid AUC {auc:.5f} "
                f"(phase 10 {staged10['valid_auc']:.5f}); launches "
                f"{json.dumps(counts)}")
            check(trees == iters, f"{mode} {path}: {trees} trees")
            check(not any(plain.values()), f"{mode} {path}: a plain version "
                  f"ran on the path: {plain}")
            check(auc > auc_min, f"{mode} {path}: valid AUC {auc} <= "
                  f"{auc_min}")
            check(counts["k3"] == k3_expected(bst, 1), f"{mode} {path}: K3 "
                  f"launched {counts['k3']} times")
            check(counts["k1"] > 0 and counts["split_scan"] > 0,
                  f"{mode} {path}: K1 or the split scan never launched")
            if path == "fused":
                check(counts["k2"] > 0, f"{mode} fused: no K2 launch")
            if path == "looped":
                check(counts["k6"] > 0 and counts["k2"] == 0,
                      f"{mode} looped: K6 {counts['k6']}, K2 {counts['k2']}")
            if path == "staged":
                check(counts["k2"] == counts["k6"] == 0,
                      f"{mode} staged: a fused kernel launched")
                staged_bst = bst
        for path in paths[1:]:
            check(texts[path] == texts["staged"], f"{mode}: the {path} model "
                  "text differs from the staged one")
        log(f"  {mode}: the {' / '.join(paths)} model texts are one, byte "
            "for byte")
        if mode == "dart":
            with recorded_drops() as drop_lists:
                again = train(dict(BOOST_PATH["staged"], **knobs), ds, iters,
                              **_on(dev))
            check(again.model_to_string() == texts["staged"], "dart: a "
                  "second staged training wrote another model text")
            res["repeat_same_text"] = True
            res["dropped_trees"] = sum(len(d) for d in drop_lists)
            res["iterations_with_drops"] = sum(1 for d in drop_lists if d)
            log(f"  dart: {res['dropped_trees']} trees dropped in "
                f"{res['iterations_with_drops']} of {iters} iterations (the "
                "second staged training)")
            rows = min(len(X), VALID_ROWS)
            res["train_scores_vs_k4"] = served_vs_cache(
                texts["staged"], X[:rows],
                staged_bst._gbdt.raw_train_scores()[:rows, 0], iters, dev,
                f"the training scores of {rows} rows")
            res["served_max_abs_err"] = served_vs_cache(
                texts["staged"], Xv,
                staged_bst._gbdt.raw_valid_scores(0)[:, 0], iters, dev,
                "the valid scores")
        elif mode == "rf":
            check("average_output" in texts["staged"].splitlines(),
                  "rf: the model text lacks average_output")
            card = Booster(model_str=texts["staged"], **_on(dev))
            cpu = Booster(model_str=texts["staged"], device="cpu")
            raw = card.predict(Xv, predict_method="fused", raw_score=True)
            tol = raw_tol(card._all_trees()) / iters
            e = float(np.abs(raw - cpu.predict(Xv, raw_score=True)).max())
            log(f"  rf: served through K4 against the CPU host walk, "
                f"averaged over {iters} iterations: {e:.3e} (tol {tol:.3e})")
            check(e <= tol, f"rf: K4 against the host walk {e}")
            check(pc.launch_counts["serving_fused"] > 0, "rf: K4 never "
                  "launched")
            res["served_vs_host"] = e
        else:
            res["served_max_abs_err"] = serve_trained(
                staged_bst, Xv, dev, f"{mode}_model.txt")
        out[mode] = res
        del staged_bst
    return out


def served_vs_cache(text, X, want, iters, dev, what) -> float:
    """A saved DART model through K4 against a score cache of the same
    rows, within ``cache_tol``."""
    served = Booster(model_str=text, **_on(dev))
    raw = served.predict(X, predict_method="fused", raw_score=True)
    tol = cache_tol(served._all_trees(), want, iters)
    e = float(np.abs(raw - want).max())
    log(f"  dart: {what} against a fresh K4 sum of the saved trees: "
        f"{e:.3e} (tol {tol:.3e})")
    check(e <= tol, f"dart: {what} {e} from the saved trees")
    return e


def phase_objectives(ds, dv, X, Xv, iters, dev, seed, rank) -> dict:
    """Phase 43: each objective the breadth slice ports at the headline
    width, 15 staged iterations on phase 8's rows and bins, the labels
    swapped in with ``Dataset.set_label`` (no binning); rank_xendcg on
    phase 25's rank data, ``rank``: its binned sets, valid rows and the
    parity rows with their labels and query sizes.  Launch counts reset
    before each training."""
    y_tr, y_va = ds.get_label(), dv.get_label()
    target = regression_target(X, seed + 2)
    vtarget = regression_target(Xv, seed + 3)
    out = {}
    try:
        for objective in BREADTH_OBJECTIVES:
            if objective == "rank_xendcg":
                continue
            ds.set_label(objective_label(objective, target))
            dv.set_label(objective_label(objective, vtarget))
            out[objective] = objective_run(
                objective, dict(OBJ_PARAMS, objective=objective), ds, dv, Xv,
                iters, dev)
    finally:
        ds.set_label(y_tr)
        dv.set_label(y_va)
    dr, drv, Xrv, Xr, yr, gr = rank
    out["rank_xendcg"] = objective_run(
        "rank_xendcg", dict(RANK_PARAMS, objective="rank_xendcg"), dr, drv,
        Xrv, iters, dev)
    parity = {}
    for objective in ("regression_l1", "poisson"):
        parity[objective] = card_vs_cpu(
            objective, dict(PARITY_PARAMS, objective=objective),
            X[:PARITY_ROWS], objective_label(objective,
                                             target[:PARITY_ROWS]), dev)
    parity["rank_xendcg"] = card_vs_cpu(
        "rank_xendcg", dict(PARITY_PARAMS, objective="rank_xendcg"), Xr, yr,
        dev, group=gr)
    out["parity"] = parity
    return out


def objective_run(objective, params, ds, dv, Xv, iters, dev) -> dict:
    reset_counts()
    ev = {}
    t0 = time.perf_counter()
    bst = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                **_on(dev))
    _sync(dev)
    secs = time.perf_counter() - t0
    counts, plain = boost_counts(), plain_calls()
    (metric, values), = ev["valid_0"].items()
    jax = JAX_OBJECTIVE_METRIC.get(objective)
    log(f"  {objective}: {iters} iterations of {ds.num_data()} rows, "
        f"{secs / iters:.4f} s/iter; valid {metric} {values[-1]:.6g} (the "
        f"JAX package's on the CPU: {jax}); launches {json.dumps(counts)}")
    check(bst.num_trees() == iters, f"{objective}: {bst.num_trees()} trees")
    check(not any(plain.values()), f"{objective}: a plain version ran on "
          f"the path: {plain}")
    check(counts["k1"] > 0 and counts["split_scan"] > 0,
          f"{objective}: K1 or the split scan never launched")
    check(counts["k3"] == k3_expected(bst, 1), f"{objective}: K3 launched "
          f"{counts['k3']} times")
    check(all(np.isfinite(v) for v in values), f"{objective}: a non-finite "
          f"{metric}")
    res = {"s_per_iter": secs / iters, metric: values[-1], "jax": jax,
           "launches": counts,
           **text_hash(bst.model_to_string(), objective)}
    res["served_max_abs_err"] = serve_trained(bst, Xv, dev,
                                              f"{objective}_model.txt")
    return res


# ---------------------------------------------------------------------------
# the model lifecycle (phase 44); EFB on dense and CSR data (phase 45)
# ---------------------------------------------------------------------------

LIFE_ITERS = 10
# the headline, staged, with the finite guard armed: it reads one scalar
# an iteration and must stay silent
LIFE_PARAMS = dict(TRAIN_PARAMS, finite_guard="raise")
EFB_ROWS = 131072
EFB_GROUPS, EFB_LEVELS = 8, 16
EFB_ITERS = 10
EFB_AUC_TOL = 2e-3          # bundled beside unbundled valid AUC
K3_ROUTE_KERNELS = ("route_kernel", "route_global_kernel",
                    "route_tables_kernel")


def grown_trees(booster, skip=0) -> int:
    """The trees of more than one leaf a booster grew, past the first
    ``skip`` (restored from a checkpoint, not grown)."""
    return sum(int(t.num_leaves) > 1
               for t in booster._gbdt._device_trees[skip:])


def same_structures(a, b) -> bool:
    """Every node of two tree lists splits alike."""
    return len(a) == len(b) and all(
        ta.num_leaves == tb.num_leaves and all(
            np.array_equal(getattr(ta, f), getattr(tb, f))
            for f in ("split_feature", "threshold_bin", "default_left",
                      "left_child", "right_child"))
        for ta, tb in zip(a, b))


def phase_lifecycle(ds, dv, iters, dev) -> dict:
    """Phase 44: on phase 8's bins, the headline staged with
    finite_guard=raise: ``iters`` iterations in one go; ``iters / 2``, a
    checkpoint, a fresh Booster resumed for the rest (the model texts
    byte for byte, the valid scores bit for bit); ``rollback_one_iter``
    giving the text of ``iters - 1`` iterations; ``init_model`` from the
    half-way text training on (its score seed through K5); ``refit`` on
    the valid rows keeping every structure (K5).  Counts reset before
    each part and read after it."""
    out = {}
    reset_counts()
    t0 = time.perf_counter()

    def booster():
        b = Booster(LIFE_PARAMS, train_set=ds, **_on(dev))
        b.add_valid(dv, "v")
        return b

    straight = booster()
    for _ in range(iters):
        straight.update()
    _sync(dev)
    out["straight_s"] = time.perf_counter() - t0
    text = straight.model_to_string()
    text_before = straight.model_to_string(num_iteration=iters - 1)
    half = iters // 2
    part = booster()
    for _ in range(half):
        part.update()
    half_text = part.model_to_string()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    ckpt = os.path.join(_build.BUILD_DIR, "smoke_state.ckpt")
    t1 = time.perf_counter()
    part.save_checkpoint(ckpt)
    out["checkpoint_write_s"] = time.perf_counter() - t1
    out["checkpoint_bytes"] = os.path.getsize(ckpt)
    t1 = time.perf_counter()
    resumed = booster().resume_from_checkpoint(ckpt)
    out["checkpoint_resume_s"] = time.perf_counter() - t1
    for _ in range(iters - half):
        resumed.update()
    _sync(dev)
    counts, plain = boost_counts(), plain_calls()
    want_k3 = grown_trees(straight) + grown_trees(part) \
        + grown_trees(resumed, half)
    check(resumed.model_to_string() == text, "lifecycle: the resumed model "
          "text differs from the uninterrupted one")
    check(torch.equal(resumed._gbdt._valid_scores[0].score,
                      straight._gbdt._valid_scores[0].score),
          "lifecycle: the resumed valid scores differ")
    check(counts["k1"] > 0 and counts["k3"] == want_k3,
          f"lifecycle: K1 {counts['k1']}, K3 {counts['k3']} for {want_k3} "
          "trees")
    check(not any(plain.values()), f"lifecycle: a plain version ran: "
          f"{plain}")
    log(f"  {iters} iterations straight in {out['straight_s']:.2f} s; "
        f"{half} + checkpoint ({out['checkpoint_bytes']} bytes, written in "
        f"{out['checkpoint_write_s']:.2f} s, resumed in "
        f"{out['checkpoint_resume_s']:.2f} s) + {iters - half}: the model "
        "text byte for byte, the valid scores bit for bit; "
        "finite_guard=raise silent; launches " + json.dumps(counts))
    straight.rollback_one_iter()
    check(straight.model_to_string() == text_before, "lifecycle: the "
          f"rolled-back text is not the {iters - 1}-iteration text")
    log(f"  rollback_one_iter: the {iters - 1}-iteration model text")
    out.update(text_hash(text, "lifecycle"), resumed_same_text=True,
               rollback_same_text=True, launches=counts)

    path = os.path.join(_build.BUILD_DIR, "smoke_half.txt")
    with open(path, "w") as fh:
        fh.write(half_text)
    reset_counts()
    ev = {}
    t1 = time.perf_counter()
    cont = train(LIFE_PARAMS, ds, iters - half, init_model=path,
                 valid_sets=[dv], evals_result=ev, **_on(dev))
    _sync(dev)
    counts = dict(boost_counts(), k5=pc.launch_counts["serving_leaf"])
    auc = ev["valid_0"]["auc"][-1]
    out["init_model"] = {"seconds": time.perf_counter() - t1,
                         "valid_auc": auc, "launches": counts}
    check(cont.num_trees() == iters, f"init_model: {cont.num_trees()} trees")
    check(counts["k1"] > 0 and counts["k5"] >= 2, "init_model: K1 or the "
          f"score seed's K5 never launched: {counts}")
    check(not any(plain_calls().values()), "init_model: a plain version "
          "ran")
    log(f"  init_model from the {half}-iteration text: {iters - half} "
        f"iterations on, valid AUC {auc:.5f}; launches "
        + json.dumps(counts))

    reset_counts()
    Xv, yv = dv.data, dv.get_label()
    t1 = time.perf_counter()
    refit = straight.refit(Xv, yv, decay_rate=0.9)
    out["refit"] = {"seconds": time.perf_counter() - t1,
                    "k5_launches": pc.launch_counts["serving_leaf"]}
    before, after = straight._all_trees(), refit._all_trees()
    check(same_structures(before, after), "refit changed a tree's "
          "structure")
    check(out["refit"]["k5_launches"] > 0, "refit: K5 never launched")
    moved = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                for a, b in zip(before, after))
    check(np.isfinite(refit.predict(Xv)).all() and moved > 0,
          "refit: no leaf moved or a prediction is not finite")
    log(f"  refit on {len(yv)} valid rows in {out['refit']['seconds']:.2f} s:"
        f" {len(after)} structures kept, leaves moved up to {moved:.3e}; "
        f"K5 launches {out['refit']['k5_launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def make_efb_data(n, seed):
    """``make_data``'s 28 standard-normal features beside EFB_GROUPS
    one-hot groups of EFB_LEVELS levels (each row one level a group: the
    group's columns are exclusive), the label a noisy logit of
    ``headline_logit`` plus each group's level effect, all from
    ``seed``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    cats = rng.randint(0, EFB_LEVELS, (n, EFB_GROUPS))
    effect = 0.5 * rng.randn(EFB_GROUPS, EFB_LEVELS)
    onehot = np.zeros((n, EFB_GROUPS * EFB_LEVELS), np.float32)
    onehot[np.arange(n)[:, None],
           np.arange(EFB_GROUPS) * EFB_LEVELS + cats] = 1.0
    logit = headline_logit(X) + effect[np.arange(EFB_GROUPS), cats].sum(1)
    y = (logit + rng.randn(n) > 0).astype(np.float64)
    return np.hstack([X, onehot]), y


@contextlib.contextmanager
def last_route_call():
    """The arguments of the wave grower's last valid routing (a tree's
    splits, its rounds' offsets, the bundle arrays, the valid bins)."""
    rec, orig = {}, grower_wave.fused_route_rows

    def spy(row_sets, **kw):
        rec.update(kw, binned=row_sets[0][0])
        return orig(row_sets, **kw)

    grower_wave.fused_route_rows = spy
    try:
        yield rec
    finally:
        grower_wave.fused_route_rows = orig


def check_k3_bundle(tag, bundled, binned, ba, feats, rmeta, offsets, nl,
                    tree, meta) -> list:
    """K3's bundle leg on one tree's rounds from the root, at all rows and
    at the first K3_HEAD_ROWS: leaf ids bitwise its plain version (the
    bundle decode round after round), a second launch, the u8 leg on the
    unbundled bins and the tree walk through the bundle decode."""
    out = []
    P, R = rmeta.shape[0], offsets.shape[0] - 1
    smem = 4 * (P * (wf.RMETA_COLS + 3 + fc.BUNDLE_DEC_INTS) + R + 1) \
        <= K3_SMEM_BYTES
    for n in (bundled.shape[1], K3_HEAD_ROWS):
        b = bundled[:, :n].contiguous()
        lids = torch.zeros(n, dtype=torch.int32, device=b.device)
        args = (b, lids, feats, rmeta, nl)
        got = fc.route_rows(*args, offsets=offsets, bundle=ba)
        check(torch.equal(got, fc.route_rows(*args, offsets=offsets,
                                             bundle=ba)),
              f"K3 bundle {tag} N={n}: two launches differ")
        check(torch.equal(got, fc.route_rows_ref(*args, offsets=offsets,
                                                 bundle=ba)),
              f"K3 bundle {tag} N={n}: differs from its plain version")
        check(torch.equal(got, fc.route_rows(
            binned[:, :n].contiguous(), lids, feats, rmeta, nl,
            offsets=offsets)), f"K3 bundle {tag} N={n}: differs from the u8 "
            "leg on the unbundled bins")
        walk = tree_leaf_index_binned(tree, b, meta.nan_bin,
                                      meta.missing_type, meta.zero_bin,
                                      bundle=ba)
        check(torch.equal(got, walk.to(torch.int32)),
              f"K3 bundle {tag} N={n}: differs from the tree walk")
        moved = int((got != 0).sum())
        log(f"  K3 bundle leg {tag}, {n} rows, {P} splits in {R} rounds "
            f"(tables in {'shared' if smem else 'device'} memory): {moved} "
            "rows off the root; bitwise the plain version, the u8 leg and "
            "the tree walk")
        out.append({"case": f"{tag} N={n}", "splits": P, "rounds": R,
                    "tables_in_shared_memory": smem, "rows_moved": moved,
                    "max_abs_err": 0.0})
    return out


def unbundled(b):
    """A binned dataset's plain (F, N) bins without its EFB bundles (the
    bins and mappers shared)."""
    out = copy.copy(b)
    out.bundled = out.bundle_layout = None
    return out


def with_binned(ds, X, y, binned):
    """A Dataset of ``X`` whose bins are ``binned`` (already made), with
    ``ds``'s params."""
    out = Dataset(X, label=y, params=dict(ds.params))
    out._binned = binned
    return out


def efb_run(tag, params, dtrain, dvalid, iters, dev):
    """A recorded EFB training (counts reset before, read after)."""
    reset_counts()
    ev = {}
    with HistRecorder() as rec, last_route_call() as route:
        t0 = time.perf_counter()
        bst = train(params, dtrain, iters, valid_sets=[dvalid],
                    evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    counts = dict(boost_counts(), k3_bundle=fc.bundle_launch_counts[
        "route_rows"])
    auc = ev["valid_0"]["auc"][-1]
    res = {"seconds": secs, "s_per_iter": secs / iters, "valid_auc": auc,
           "launches": counts, **text_hash(bst.model_to_string(), tag)}
    log(f"  {tag}: {iters} iterations in {secs:.2f} s, valid AUC "
        f"{auc:.5f}; launches {json.dumps(counts)}")
    check(not any(plain_calls().values()), f"{tag}: a plain version ran")
    check(counts["k1"] > 0, f"{tag}: K1 never launched")
    return bst, res, rec, route


def phase_efb(dev, seed, rng) -> dict:
    """Phase 45: EFB_ROWS + VALID_ROWS rows of ``make_efb_data`` binned
    dense and as CSR (host time); bundles form; K1 on the bundle matrix
    and K3's bundle leg against their plain versions; EFB_ITERS staged
    iterations at the headline on the bundle columns beside
    enable_bundle=false (valid AUC), the CSR construction training the
    dense one's model text; K3's bundle leg launched once a tree."""
    import scipy.sparse as sps

    out, t0 = {}, time.perf_counter()
    X, y = make_efb_data(EFB_ROWS, seed + 40)
    Xv, yv = make_efb_data(VALID_ROWS, seed + 41)
    t1 = time.perf_counter()
    ds = Dataset(X, label=y, params=TRAIN_PARAMS).construct()
    dv = Dataset(Xv, label=yv, reference=ds).construct()
    out["dense_binning_s"] = time.perf_counter() - t1
    csr, csrv = sps.csr_matrix(X), sps.csr_matrix(Xv)
    t1 = time.perf_counter()
    dcs = Dataset(csr, label=y, params=TRAIN_PARAMS).construct()
    dcv = Dataset(csrv, label=yv, reference=dcs).construct()
    out["csr_binning_s"] = time.perf_counter() - t1
    b = ds._binned
    BF, Fo = b.bundled.shape[0], b.num_features
    check(b.bundle_layout is not None and BF < Fo,
          f"EFB: {BF} bundle columns for {Fo} features")
    check(dcs._binned.binned is None and dcs._binned.bundled is not None,
          "EFB: the CSR construction formed a dense matrix")
    out.update(features=Fo, bundle_columns=BF,
               bundle_bin_axis=b.padded_bundle_bin)
    log(f"  {EFB_ROWS} + {VALID_ROWS} rows x {Fo} features ({F} dense, "
        f"{EFB_GROUPS} one-hot groups of {EFB_LEVELS}): binned dense in "
        f"{out['dense_binning_s']:.2f} s, from CSR in "
        f"{out['csr_binning_s']:.2f} s; {BF} bundle columns, bin axis "
        f"{b.padded_bundle_bin}")

    bundled = torch.as_tensor(b.bundled, device=dev).contiguous()
    vbundled = torch.as_tensor(dv._binned.bundled, device=dev).contiguous()
    vbinned = torch.as_tensor(dv._binned.binned, device=dev).contiguous()
    meta = make_feature_meta(b, dev)
    ba = bundle_mod.BundleArrays(b.bundle_layout, b.zero_bins, b.num_bins,
                                 dev)
    Bh = b.padded_bundle_bin
    g3 = signed_rows(rng, EFB_ROWS, dev)
    k1 = []
    for L in (1, 17, 64):
        lid = torch.as_tensor(rng.randint(0, L, EFB_ROWS), dtype=torch.int32,
                              device=dev)
        k1.append(check_k1(f"bundle matrix L={L}", bundled, g3, lid, L, Bh))
    k3 = []
    for tag, sizes in (("synthetic 10 rounds", [1, 2, 4, 8, 16, 32, 63, 63,
                                                63, 2]),
                       ("synthetic 2,295 splits",
                        [1, 2, 4, 8, 16, 32, 64, 128] + [255] * 8)):
        (feats, thrs, dls, leafs, nls), offsets, nl = synthetic_rounds(
            rng, sizes, meta, dev)
        rmeta = wf.pack_route_meta(feats, thrs, dls, leafs, nls, meta)
        k3 += check_k3_bundle(tag, vbundled, vbinned, ba, feats, rmeta,
                              offsets, nl,
                              tree_of_rounds(feats, thrs, dls, leafs, meta),
                              meta)
    check(k3[0]["tables_in_shared_memory"]
          and not k3[2]["tables_in_shared_memory"],
          "the synthetic trees do not take both of K3's bundle leg's legs")

    efb, res, rec, route = efb_run("efb dense", TRAIN_PARAMS, ds, dv,
                                   EFB_ITERS, dev)
    want = k3_expected(efb, 1)
    check(efb._gbdt._bundle is not None, "EFB: the trainer did not bundle")
    check(res["launches"]["k3_bundle"] == want
          and res["launches"]["k3"] == 0,
          f"EFB: K3's bundle leg launched {res['launches']['k3_bundle']} "
          f"times (u8 leg {res['launches']['k3']}) for {want} trees")
    k1 += phase_hist_main_inputs(rec)
    t1 = time.perf_counter()
    # the same bins, unbundled (no second binning of the same rows)
    unb_ds = with_binned(ds, X, y, unbundled(ds._binned))
    unb_dv = with_binned(dv, Xv, yv, unbundled(dv._binned))
    out["unbundled_binning_s"] = time.perf_counter() - t1
    _, unb, _, _ = efb_run("efb unbundled", dict(TRAIN_PARAMS,
                                                 enable_bundle=False),
                           unb_ds, unb_dv, EFB_ITERS, dev)
    gap = abs(res["valid_auc"] - unb["valid_auc"])
    check(gap <= EFB_AUC_TOL, f"EFB: valid AUC {res['valid_auc']} against "
          f"{unb['valid_auc']} unbundled")
    csr_bst, cres, _, _ = efb_run("efb csr", TRAIN_PARAMS, dcs, dcv,
                                  EFB_ITERS, dev)
    check(cres["model_text_sha256"] == res["model_text_sha256"],
          "EFB: the CSR construction trained another model text")
    log(f"  bundled AUC {res['valid_auc']:.5f} beside unbundled "
        f"{unb['valid_auc']:.5f} (gap {gap:.2e}); the CSR construction's "
        "model text the dense one's, byte for byte")
    out.update(train=res, unbundled=unb, csr=cres, k1_checks=k1,
               k3_checks=k3)

    # the bundle leg on the main path's last routing, and K1 at its last
    # 64-slot call beside the unbundled matrix's same rows
    rfeats = route["feats"].to(torch.int32).contiguous()
    rmeta = wf.pack_route_meta(route["feats"], route["thrs"], route["dls"],
                               route["leafs"], route["nls"], route["meta"])
    offs, nl, vb = route["offsets"], route["num_leaves"], route["binned"]
    lids = torch.zeros(vb.shape[1], dtype=torch.int32, device=dev)
    row = {"rows": vb.shape[1], "splits": rmeta.shape[0],
           "rounds": offs.shape[0] - 1,
           "ms": time_ms(lambda: fc.route_rows(vb, lids, rfeats, rmeta, nl,
                                               offsets=offs, bundle=ba), 20),
           "plain_ms": time_ms(lambda: fc.route_rows_ref(
               vb, lids, rfeats, rmeta, nl, offsets=offs, bundle=ba), 2),
           "cold_device_ms": sum(cold_device_ms(lambda: fc.route_rows(
               vb, lids, rfeats, rmeta, nl, offsets=offs, bundle=ba),
               K3_ROUTE_KERNELS).values()) or None,
           "u8_cold_device_ms": sum(cold_device_ms(lambda: fc.route_rows(
               vbinned, lids, rfeats, rmeta, nl, offsets=offs),
               K3_ROUTE_KERNELS).values()) or None,
           **k3_bound(vb, rfeats, rmeta, offs, nl, bundle=ba)}
    check(torch.equal(fc.route_rows(vb, lids, rfeats, rmeta, nl,
                                    offsets=offs, bundle=ba),
                      fc.route_rows_ref(vb, lids, rfeats, rmeta, nl,
                                        offsets=offs, bundle=ba)),
          "K3 bundle leg: the main path's last routing differs from its "
          "plain version")
    out["k3_timing"] = row
    key = max(rec.last)
    kb, kg, kl, kB, klive = rec.last[key]
    plain_b = torch.as_tensor(b.binned, device=dev).contiguous()
    out["k1_timing"] = {
        "slots": key[0], "precision": key[1], "bundle_columns": BF,
        "ms": time_ms(lambda: hc.hist_leaves(kb, kg, kl, key[0], kB, key[1],
                                             klive), 20),
        "unbundled_columns": Fo,
        "unbundled_ms": time_ms(lambda: hc.hist_leaves(
            plain_b, kg, kl, key[0], 64, key[1], klive), 20),
        **k1_bundle_extra(kb, kg, kl, key[0], kB, key[1], klive)}
    log(f"  K3 bundle leg on the last tree ({row['splits']} splits, "
        f"{row['rounds']} rounds, {row['rows']} rows): {fmt_ms(row['ms'])} "
        f"(L2 cleared {fmt_ms(row['cold_device_ms'])}; the u8 leg on the "
        f"unbundled bins {fmt_ms(row['u8_cold_device_ms'])}), plain "
        f"{fmt_ms(row['plain_ms'])}, bound {fmt_ms(row['bound_ms'])}; K1 at "
        f"L={key[0]} {key[1]}: {BF} bundle columns "
        f"{fmt_ms(out['k1_timing']['ms'])}, {Fo} unbundled columns "
        f"{fmt_ms(out['k1_timing']['unbundled_ms'])}")
    out["seconds"] = time.perf_counter() - t0
    del csr_bst
    return out


def k1_bundle_extra(binned, g3, label, L, B, prec, live) -> dict:
    """K1's row on the bundle columns, completed: its plain version on the
    card, one ``index_add_`` on the same inputs and its bound by K1's rule
    (phase_hist_timing: the bins, rows and labels read once, the
    histograms written once, against the live rows' adds)."""
    Fn, N = binned.shape
    plain_ms = time_ms(lambda: hc.hist_leaves_ref(binned, g3, label, L, B,
                                                  prec, live), 2)
    flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
             + label.long()[None, :]) * B + binned.long()).reshape(-1)
    vals = g3.repeat(Fn, 1)
    acc = torch.zeros((Fn * L * B, 3), dtype=torch.float32,
                      device=binned.device)
    library_ms = time_ms(lambda: acc.index_add_(0, flat, vals), 5)
    lim = L if live is None else int(live)
    n_live = int(((label >= 0) & (label < lim)).sum())
    nbytes = Fn * N + N * 12 + N * 4 + L * Fn * B * 3 * 4
    ops = (2 if prec == "bf16x2" else 1) * 3 * n_live * Fn
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "rows": N}


def efb_rows(efb: dict) -> list:
    """The kernels line's row of K3's bundle leg (phase 45)."""
    t = efb["k3_timing"]
    return [{
        "name": "route_rows:bundle", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:595 (fused_route_rows"
        "' routing; under EFB the JAX staged path decodes with "
        "io/bundle.py:258 bundle_bins_of_feat)",
        "launches": int(efb["train"]["launches"]["k3_bundle"]),
        "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "routes rows through a tree's splits",
        "cold_device_ms": t["cold_device_ms"],
        "u8_cold_device_ms": t["u8_cold_device_ms"],
        "at": f"{t['rows']} rows, {t['splits']} splits in {t['rounds']} "
        "rounds", "checks": efb["k3_checks"]}]


# ---------------------------------------------------------------------------
# categorical features (phases 46-47) and the constraints and penalties of
# item 1's part 1.6 (phase 48)
# ---------------------------------------------------------------------------

CAT_SRC = "lightgbmv1_tpu_torch/csrc/split_scan_cat.cu"
CAT_ROWS = 262144
CAT_ITERS = 20
# the categorical columns' cardinalities: one-vs-rest (3), the sorted scan
# (24, 60) and past the bin axis (500: 62 kept, the rest the other bin)
CAT_CARDS = (3, 24, 60, 500)
CAT_COLS = list(range(F, F + len(CAT_CARDS)))
CAT_PARAMS = dict(TRAIN_PARAMS, hist_method="pallas")
CAT_PARITY = dict(PARITY_PARAMS,
                  categorical_feature=",".join(map(str, CAT_COLS)))
CAT_CHILDREN = (1, 8, 32, 126)
CAT_EFB_ROWS = 65536
# the JAX package's valid AUC on phase 47's data and configuration, on the
# CPU (f32 scatter histograms), categorical and the same columns numeric
# (cat_auc.py): on this data the categorical splits fit the training rows
# closer and the valid rows less well, in both packages; the card's
# bf16x2 histograms move the trees, so the gate is a floor
JAX_CAT_AUC = 0.767555       # cat_auc.py, 262,144 rows, 20 iterations
JAX_CAT_NUM_AUC = 0.796636
CAT_AUC_TOL = 3e-3
P16_ITERS = 5
# interaction groups of the headline's 28 features; feature 27 in none
P16_GROUPS = "[0,1,2,3,4,5],[6,7,8,9,10,11,12,13],[14,15,16,17,18,19,20]" \
    ",[21,22,23,24,25,26]"
# CEGB: feature 5's coupled cost keeps it out of every tree
P16_CEGB = dict(TRAIN_PARAMS, cegb_penalty_split=1e-4,
                cegb_penalty_feature_coupled=[1.0] * 5 + [1e9]
                + [1.0] * (F - 6),
                cegb_penalty_feature_lazy=[1e-5] * F)
P16_FORCED = {"feature": 0, "threshold": 0.0,
              "left": {"feature": 1, "threshold": 0.5},
              "right": {"feature": 2, "threshold": -0.5}}
CAT_LEG_KERNELS = ("split_cat_kernel",)


def make_cat_data(n, seed):
    """``make_data``'s 28 features beside CAT_CARDS categorical columns,
    each category a random effect (non-ordinal), 3% NaN in the second;
    the label a noisy logit of ``headline_logit`` and the effects."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    logit = headline_logit(X)
    cols = []
    for card in CAT_CARDS:
        c = rng.randint(0, card, n)
        logit = logit + 0.8 * rng.randn(card)[c]
        cols.append(c.astype(np.float32))
    Xc = np.column_stack([X] + cols)
    Xc[rng.rand(n) < 0.03, F + 1] = np.nan
    y = (logit + rng.randn(n) > 0).astype(np.float64)
    return Xc, y


def cat_meta(meta, cats):
    """``meta`` with the features ``cats`` categorical (its kernel
    tables remade)."""
    is_cat = torch.zeros(meta.num_bins.shape[0], dtype=torch.bool,
                         device=meta.num_bins.device)
    is_cat[list(cats)] = True
    return with_tables(meta._replace(is_categorical=is_cat))


class CatRecorder:
    """Keeps the inputs of the last categorical-leg call (``split_scan_cat``)
    at each child count C, the numerical rows it merges into copied first
    (the leg writes them in place)."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        self._orig = sc.split_scan_cat

        def wrapped(hist, mask, csums, packed, **kw):
            self.last[hist.shape[0]] = (hist, mask, csums, packed.clone(),
                                        kw)
            return self._orig(hist, mask, csums, packed, **kw)

        sc.split_scan_cat = wrapped
        return self

    def __exit__(self, *exc):
        sc.split_scan_cat = self._orig


def check_cat_leg(tag, hist, mask, csums, packed, kw) -> dict:
    """The categorical leg (merged rows and [is_cat, bitset] rows) bit for
    bit its plain version run on the CPU on the same inputs, and two
    launches alike."""
    got, cat = sc.split_scan_cat(hist, mask, csums, packed.clone(), **kw)
    again, cat2 = sc.split_scan_cat(hist, mask, csums, packed.clone(), **kw)
    check(bool(same_value(got, again).all()) and torch.equal(cat, cat2),
          f"categorical leg {tag}: two launches differ")
    ckw = to_cpu(kw)
    if ckw.get("rand") is not None:
        r = ckw["rand"]
        ckw["rand"] = RandLeg(r.key, r.uids.cpu(), r.extra_seed)
    want, wcat = sc.split_cat_ref(hist.cpu(), mask.cpu(), csums.cpu(),
                                  packed.cpu(), **ckw)
    bad = int((~same_value(got.cpu(), want)).sum()) + int(
        (cat.cpu() != wcat).sum())
    check(bad == 0, f"categorical leg {tag}: {bad} values differ from the "
          "CPU plain version")
    return {"case": tag, "C": hist.shape[0],
            "categorical_picks": int(wcat[:, 0].sum()), "max_abs_err": 0.0}


def check_cegb_leg(tag, hist, mask, csums, kw) -> dict:
    """The split-scan kernel with CEGB penalties bit for bit its plain
    version on the CPU (packed rows and residue)."""
    got = sc.split_scan_pick(hist, mask, csums, **kw)
    res = sc.split_scan(hist, mask, csums, **kw)
    ckw = to_cpu(kw)
    if ckw.get("rand") is not None:
        r = ckw["rand"]
        ckw["rand"] = RandLeg(r.key, r.uids.cpu(), r.extra_seed)
    cs = csums.cpu()
    want_res = scan_residue(hist.cpu(), mask.cpu(), cs, **ckw)
    want = pick_pack(want_res, gain_shift(cs, ckw["params"],
                                          ckw.get("parent_output")),
                     cs, ckw["meta"], hist.shape[2])
    bad = int((~same_value(got.cpu(), want)).sum()) + int(
        (~same_value(res.cpu(), want_res)).sum())
    check(bad == 0, f"CEGB leg {tag}: {bad} values differ from the CPU "
          "plain scan")
    return {"case": tag, "C": hist.shape[0], "max_abs_err": 0.0,
            "finite_picks": int(torch.isfinite(want[:, 0]).sum())}


def cat_children(C, rng, dev, F_=32, B=64):
    """C children's (C, F_, B, 3) histograms binned from 300 signed rows
    each, four categorical features (3 bins, one-vs-rest; 40, 64 and 64
    bins, the sorted scan) binned through a permutation of the rows'
    gradient sign (non-ordinal signal), the rest at random; their sums,
    mask and meta (``scan_children``'s missing types)."""
    _, _, _, meta, _ = scan_children(1, F_, B, rng, dev)
    cats = (3, 6, 17, 30)
    nb = meta.num_bins.clone()
    nb[3], nb[6] = 3, 40
    meta = cat_meta(with_tables(meta._replace(num_bins=nb)), cats)
    N = 300 * C
    rows = signed_rows(rng, N, dev)
    child = torch.as_tensor(rng.randint(0, C, N), device=dev)
    bins = torch.as_tensor(rng.randint(0, 1 << 16, (F_, N)), device=dev) \
        % nb[:, None]
    pos = (rows[:, 0] > 0).long()
    for f in cats:
        k = int(nb[f]) - 1                      # the last bin: other
        perm = torch.as_tensor(rng.permutation(k), device=dev)
        half = (bins[f] % max(k // 2, 1)) + pos * (k // 2)
        bins[f] = perm[half.clamp(max=k - 1)]
    hist = torch.zeros((C, F_, B, 3), dtype=torch.float32, device=dev)
    for f in range(F_):
        hist[:, f].index_put_((child, bins[f]), rows, accumulate=True)
    csums = hist[:, 0].double().sum(dim=1).float()
    mask = torch.ones((C, F_), dtype=torch.bool, device=dev)
    mask[C // 2, 2] = False
    return hist.contiguous(), csums, mask, meta


def phase_cat_kernels(rng, dev) -> dict:
    """Phase 46 (synthetic half): the categorical leg and the CEGB leg at C
    in CAT_CHILDREN on ``cat_children`` histograms (F = 32, B = 64, four
    of them categorical), each with and without extra_trees' draw, bit
    for bit their plain versions."""
    out = {"cat": [], "cegb": []}
    for C in CAT_CHILDREN:
        hist, csums, mask, meta = cat_children(C, rng, dev)
        for rand in (False, True):
            params = SplitParams(lambda_l1=0.1, lambda_l2=1.0,
                                 min_data_in_leaf=5.0,
                                 min_data_per_group=20.0, cat_smooth=5.0,
                                 extra_trees=rand, extra_seed=3)
            rl = (RandLeg((17, 29), torch.arange(C, dtype=torch.int32,
                                                 device=dev) * 2 + 1, 3)
                  if rand else None)
            pen = torch.as_tensor(rng.rand(C, 32).astype(np.float32) * 0.5,
                                  device=dev)
            kw = dict(meta=meta, params=params, rand=rl)
            tag = f"C={C}{' rand' if rand else ''}"
            packed = sc.split_scan_pick(hist, mask, csums, **kw, cegb=pen)
            out["cat"].append(check_cat_leg(tag, hist, mask, csums, packed,
                                            dict(kw, cegb=pen)))
            out["cegb"].append(check_cegb_leg(tag, hist, mask, csums,
                                              dict(kw, cegb=pen)))
    n = sum(c["categorical_picks"] for c in out["cat"])
    check(n > 0, "phase 46: no synthetic child picked a categorical split")
    log(f"  categorical leg and CEGB leg at C = {list(CAT_CHILDREN)}, with "
        f"and without extra_trees' draw: bit for bit their plain versions "
        f"({n} categorical picks of {sum(c['C'] for c in out['cat'])})")
    return out


def cat_bound(C, F_, B, n_cat, W, onehot, used) -> dict:
    """The categorical leg's bound: the categorical features' rows read
    once, the sums, mask and packed rows read, the packed and [is_cat,
    bitset] rows written; its operations this run's data needs (each
    sorted feature's B^2 sort compares and about 40 f32 operations a
    candidate, ``used`` the sorted features' valid bins)."""
    nbytes = (C * n_cat * B * 12 + C * 12 + C * F_ + 5 * F_ * 4 + n_cat * 4
              + 2 * C * sc.PACK_COLS * 4 + C * (1 + W) * 4)
    ops = int(C * (onehot * B * 40 + (n_cat - onehot) * B * B)
              + 40 * 2 * used)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def cat_timing(rec: CatRecorder, checks: list) -> list:
    """Phase 46 (main-path half): the categorical leg on phase 47's last
    inputs at each child count, bit for bit its plain version, by events,
    on the device with the L2 cleared, its plain version on the card and
    its bound."""
    rows = []
    for C in sorted(rec.last):
        hist, mask, csums, packed, kw = rec.last[C]
        checks.append(check_cat_leg(f"main path C={C}", hist, mask, csums,
                                    packed, kw))
        _, F_, B, _ = hist.shape
        meta = kw["meta"]
        n_cat = int(meta.cat32.shape[0])
        nb = meta.num_bins[meta.cat32.long()]
        onehot = int((nb <= kw["params"].max_cat_to_onehot).sum())
        used = int((hist[:, meta.cat32.long(), :, 2]
                    >= kw["params"].cat_smooth).sum())
        W = -(-B // 32)
        ms = time_ms(lambda: sc.split_scan_cat(hist, mask, csums,
                                               packed.clone(), **kw), 30)
        cold = cold_device_ms(lambda: sc.split_scan_cat(
            hist, mask, csums, packed.clone(), **kw), CAT_LEG_KERNELS)
        plain_ms = time_ms(lambda: sc.split_cat_ref(hist, mask, csums,
                                                    packed.clone(), **kw), 2)
        b = cat_bound(C, F_, B, n_cat, W, onehot, used)
        rows.append({"C": C, "F": F_, "B": B, "categorical_features": n_cat,
                     "ms": ms, "cold_device_ms":
                     cold["split_cat_kernel"] or None, "plain_ms": plain_ms,
                     **b})
        log(f"  categorical leg C={C} ({n_cat} categorical of {F_} "
            f"features, B={B}): {fmt_ms(ms)} by events, "
            f"{fmt_ms(rows[-1]['cold_device_ms'])} on the device (L2 "
            f"cleared), plain {fmt_ms(plain_ms)} on the card, bound "
            f"{fmt_ms(b['bound_ms'])} by {b['bound_by']}")
    return rows


def cat_route_check(tag, route, dev) -> dict:
    """K3's bitset leg on a recorded routing (a tree's splits with their
    categorical rows): leaf ids bitwise its plain version and a second
    launch; timed by events, on the device with the L2 cleared, the plain
    version on the card; its bound (``k3_bound`` with the categorical
    rows' bytes)."""
    feats = route["feats"].to(torch.int32).contiguous()
    rmeta = wf.pack_route_meta(route["feats"], route["thrs"], route["dls"],
                               route["leafs"], route["nls"], route["meta"])
    offs, nl, vb = route["offsets"], route["num_leaves"], route["binned"]
    cat, ba = route["cat"], route.get("bundle")
    check(cat is not None and bool(cat[:, 0].any()),
          f"K3 bitset {tag}: the last tree has no categorical split")
    lids = torch.zeros(vb.shape[1], dtype=torch.int32, device=dev)
    args = (vb, lids, feats, rmeta, nl)
    kw = dict(offsets=offs, bundle=ba, cat=cat)
    got = fc.route_rows(*args, **kw)
    check(torch.equal(got, fc.route_rows(*args, **kw)),
          f"K3 bitset {tag}: two launches differ")
    check(torch.equal(got, fc.route_rows_ref(*args, **kw)),
          f"K3 bitset {tag}: differs from its plain version")
    b = k3_bound(vb, feats, rmeta, offs, nl, bundle=ba, cat=cat)
    row = {"case": tag, "rows": vb.shape[1], "splits": rmeta.shape[0],
           "rounds": offs.shape[0] - 1,
           "categorical_splits": int(cat[:, 0].sum()),
           "ms": time_ms(lambda: fc.route_rows(*args, **kw), 20),
           "cold_device_ms": sum(cold_device_ms(
               lambda: fc.route_rows(*args, **kw), K3_ROUTE_KERNELS)
               .values()) or None,
           "no_cat_cold_device_ms": sum(cold_device_ms(
               lambda: fc.route_rows(*args, offsets=offs, bundle=ba),
               K3_ROUTE_KERNELS).values()) or None,
           "plain_ms": time_ms(lambda: fc.route_rows_ref(*args, **kw), 2),
           "max_abs_err": 0.0, **b}
    log(f"  K3 bitset leg {tag} ({row['splits']} splits, "
        f"{row['categorical_splits']} categorical, {row['rounds']} rounds, "
        f"{row['rows']} rows): bitwise its plain version; "
        f"{fmt_ms(row['ms'])} by events, {fmt_ms(row['cold_device_ms'])} "
        f"on the device (L2 cleared; the same splits without their bitsets "
        f"{fmt_ms(row['no_cat_cold_device_ms'])}), plain "
        f"{fmt_ms(row['plain_ms'])}, "
        f"bound {fmt_ms(row['bound_ms'])}")
    return row


def cat_splits_equal(tag, a, b) -> dict:
    """Two boosters' trees split identically at every node, categorical
    nodes' raw-category sets included."""
    nodes = cats = 0
    for ta, tb in zip(a._all_trees(), b._all_trees()):
        n = ta.num_leaves - 1
        check(ta.num_leaves == tb.num_leaves
              and np.array_equal(ta.split_feature, tb.split_feature)
              and np.array_equal(ta.is_cat, tb.is_cat),
              f"{tag}: the trees split differently")
        for i in range(n):
            if ta.is_cat[i]:
                check(np.array_equal(ta.cat_sets[i], tb.cat_sets[i]),
                      f"{tag}: node {i}'s categories differ")
                cats += 1
            else:
                check(ta.threshold_bin[i] == tb.threshold_bin[i],
                      f"{tag}: node {i}'s threshold differs")
        nodes += n
    log(f"  {tag}: {nodes} nodes identical ({cats} categorical, their "
        "category sets equal)")
    return {"nodes": nodes, "categorical_nodes": cats}


def phase_cat_train(dev, seed) -> dict:
    """Phase 47: CAT_ROWS + VALID_ROWS rows of ``make_cat_data`` (four
    categorical columns); CAT_ITERS staged iterations at the headline
    (launch counts reset) beside the same columns taken as numeric (valid
    AUC); the categorical leg launched, K3's bitset leg once a tree; the
    text saved, loaded and predicted alike; card against CPU split by
    split at CAT_PARITY (5 iterations, PARITY_ROWS rows)."""
    out, t0 = {}, time.perf_counter()
    X, y = make_cat_data(CAT_ROWS, seed + 50)
    Xv, yv = make_cat_data(VALID_ROWS, seed + 51)
    t1 = time.perf_counter()
    ds = Dataset(X, label=y, params=CAT_PARAMS,
                 categorical_feature=CAT_COLS).construct()
    dv = Dataset(Xv, label=yv, reference=ds).construct()
    out["binning_s"] = time.perf_counter() - t1
    b = ds._binned
    check(b.is_categorical.tolist() == [False] * F + [True] * 4,
          "the categorical columns are not categorical")
    check(b.padded_bin == 64, f"bin axis {b.padded_bin}, not 64")
    log(f"  {CAT_ROWS} + {VALID_ROWS} rows x {F} + {len(CAT_CARDS)} "
        f"categorical columns (cardinalities {list(CAT_CARDS)}; bins "
        f"{[int(v) for v in b.num_bins[F:]]}) binned in "
        f"{out['binning_s']:.2f} s")
    reset_counts()
    ev = {}
    with ScanRecorder() as srec, CatRecorder() as crec, \
            last_route_call() as route:
        t1 = time.perf_counter()
        bst = train(CAT_PARAMS, ds, CAT_ITERS, valid_sets=[dv],
                    evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t1
    counts = dict(boost_counts(),
                  split_scan_cat=sc.launch_counts["split_scan_cat"],
                  k3_bitset=fc.cat_launch_counts["route_rows"])
    res = {"seconds": secs, "s_per_iter": secs / CAT_ITERS,
           "valid_auc": ev["valid_0"]["auc"][-1], "launches": counts,
           **text_hash(bst.model_to_string(), "categorical staged")}
    trees = bst._all_trees()
    res["categorical_nodes"] = int(sum(t.is_cat.sum() for t in trees))
    want = k3_expected(bst, 1)
    check(not any(plain_calls().values()), "categorical: a plain version "
          "ran")
    check(counts["split_scan_cat"] == counts["split_scan"] > 0,
          f"categorical: the categorical leg launched "
          f"{counts['split_scan_cat']} times for {counts['split_scan']} "
          "scans")
    check(counts["k3"] == want and counts["k3_bitset"] == want,
          f"categorical: K3 launched {counts['k3']} times (bitset leg "
          f"{counts['k3_bitset']}) for {want} trees")
    check(res["categorical_nodes"] > 0, "categorical: no categorical split")
    log(f"  categorical staged: {CAT_ITERS} iterations in {secs:.2f} s, "
        f"valid AUC {res['valid_auc']:.5f}, {res['categorical_nodes']} "
        f"categorical nodes; launches {json.dumps(counts)}")
    # the same columns as numbers: the 28 numeric columns' bins as they
    # are, the four columns binned as numbers (the same sampled rows a
    # whole binning would take)
    t1 = time.perf_counter()
    nb4 = Dataset(X[:, CAT_COLS], label=y,
                  params=dict(CAT_PARAMS, enable_bundle=False)).construct()
    nmap = nb4._binned.bin_mappers

    def numeric(bd, Xs):
        out = copy.copy(bd)
        out.bin_mappers = bd.bin_mappers[:F] + nmap
        out.binned = np.vstack([bd.binned[:F]] + [
            m.value_to_bin(Xs[:, c]).astype(bd.binned.dtype)[None]
            for m, c in zip(nmap, CAT_COLS)])
        out._build_feature_meta()
        return out

    nds = with_binned(ds, X, y, numeric(ds._binned, X))
    ndv = with_binned(dv, Xv, yv, numeric(dv._binned, Xv))
    ev2 = {}
    num = train(CAT_PARAMS, nds, CAT_ITERS, valid_sets=[ndv],
                evals_result=ev2, **_on(dev))
    res["numeric_valid_auc"] = ev2["valid_0"]["auc"][-1]
    res["numeric_seconds"] = time.perf_counter() - t1
    log(f"  the same columns as numeric: valid AUC "
        f"{res['numeric_valid_auc']:.5f} (categorical "
        f"{res['valid_auc']:.5f}); the JAX package's on the CPU "
        f"{JAX_CAT_AUC} / {JAX_CAT_NUM_AUC} (cat_auc.py)")
    check(res["valid_auc"] > JAX_CAT_AUC - CAT_AUC_TOL,
          f"categorical: valid AUC {res['valid_auc']} below the JAX "
          f"package's {JAX_CAT_AUC} by more than {CAT_AUC_TOL}")
    del num, nds, ndv
    # the text saved, loaded and predicted alike
    path = os.path.join(_build.BUILD_DIR, "categorical_model.txt")
    bst.save_model(path)
    loaded = Booster(model_file=path, **_on(dev))
    check(loaded.model_to_string() == bst.model_to_string(),
          "categorical: the loaded model's text differs")
    head = Xv[:8192]
    e = float(np.abs(loaded.predict(head, raw_score=True)
                     - bst.predict(head, raw_score=True)).max())
    vs = bst._gbdt._valid_scores[0].score[:8192, 0].cpu().numpy()
    e2 = float(np.abs(loaded.predict(head, raw_score=True) - vs).max())
    check(e == 0.0 and e2 <= raw_tol(trees),
          f"categorical: the loaded model predicts {e} / {e2} apart")
    res["loaded_predict_max_abs_err"] = e
    res["valid_scores_max_abs_err"] = e2
    log(f"  text saved, loaded and predicted: equal (max |diff| {e}); "
        f"against the trainer's valid scores {e2:.3e}")
    # card against CPU: the CPU training takes the card's gradients and
    # root sums and sums its histograms in K1's order (``CardRounding``,
    # ``roworder_plain``): a categorical pick has no tie band (the bins'
    # sort by g / (h + cat_smooth), the strict compare with the numerical
    # pick), so it needs the card's bits
    Xp, yp = X[:PARITY_ROWS], y[:PARITY_ROWS]
    rounding = CardRounding()
    saved = grower_wave._BUCKET_MIN_N
    grower_wave._BUCKET_MIN_N = 1
    try:
        with rounding.record():
            card = train(CAT_PARITY, Dataset(Xp, label=yp), 5, **_on(dev))
            _sync(dev)
        with rounding.replay(), roworder_plain():
            cpu = train(CAT_PARITY, Dataset(Xp, label=yp), 5, device="cpu")
    finally:
        grower_wave._BUCKET_MIN_N = saved
    res["parity"] = dict(
        cat_splits_equal("categorical card vs CPU", card, cpu),
        **compare_splits("categorical card vs CPU", card, cpu,
                         ("card", "CPU"), PARITY_LEAF_TOL))
    out.update(train=res, scan_last=srec.last, cat_rec=crec, route=route,
               booster=bst, Xv=Xv)
    out["seconds"] = time.perf_counter() - t0
    return out


def make_cat_efb_data(n, seed):
    """Four sparse categorical columns (a row non-zero in one of them: EFB
    bundles them) beside ``make_data``'s first 8 features."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    which = rng.randint(0, 4, n)
    cat = rng.randint(1, 20, n)
    C = np.zeros((n, 4), np.float32)
    C[np.arange(n), which] = cat
    logit = headline_logit(np.hstack([X, np.zeros((n, 20), np.float32)])) \
        + 1.5 * rng.randn(4, 20)[which, cat]
    y = (logit + rng.randn(n) > 0).astype(np.float64)
    return np.hstack([X, C]), y


def phase_cat_efb(dev, seed) -> dict:
    """Phase 46's bundle half: CAT_EFB_ROWS rows whose four categorical
    columns bundle; three staged iterations (K3's bundle leg with the
    bitset leg once a tree), then the bitset leg on the last tree's
    routing, bundle columns and the unbundled bins alike."""
    X, y = make_cat_efb_data(CAT_EFB_ROWS, seed + 52)
    Xv, yv = make_cat_efb_data(16384, seed + 53)
    cats = [8, 9, 10, 11]
    ds = Dataset(X, label=y, params=CAT_PARAMS,
                 categorical_feature=cats).construct()
    dv = Dataset(Xv, label=yv, reference=ds).construct()
    check(ds._binned.bundle_layout is not None,
          "categorical EFB: the categorical columns did not bundle")
    reset_counts()
    with last_route_call() as route:
        bst = train(CAT_PARAMS, ds, 3, valid_sets=[dv], **_on(dev))
        _sync(dev)
    want = k3_expected(bst, 1)
    got = (fc.bundle_launch_counts["route_rows"],
           fc.cat_launch_counts["route_rows"])
    check(got == (want, want), f"categorical EFB: K3's bundle / bitset "
          f"legs launched {got} times for {want} trees")
    row = cat_route_check("bundle leg", route, dev)
    vbin = torch.as_tensor(dv._binned.binned, device=dev).contiguous()
    u8 = cat_route_check("u8 leg, unbundled bins",
                         dict(route, binned=vbin, bundle=None), dev)
    lids = torch.zeros(vbin.shape[1], dtype=torch.int32, device=dev)
    feats = route["feats"].to(torch.int32).contiguous()
    rmeta = wf.pack_route_meta(route["feats"], route["thrs"], route["dls"],
                               route["leafs"], route["nls"], route["meta"])
    check(torch.equal(
        fc.route_rows(route["binned"], lids, feats, rmeta,
                      route["num_leaves"], offsets=route["offsets"],
                      bundle=route["bundle"], cat=route["cat"]),
        fc.route_rows(vbin, lids, feats, rmeta, route["num_leaves"],
                      offsets=route["offsets"], cat=route["cat"])),
        "categorical EFB: the bundle leg differs from the u8 leg")
    return {"launches": {"k3_bundle": got[0], "k3_bitset": got[1]},
            "trees": want, "bundle": row, "u8": u8}


def p16_run(tag, params, ds, dv, Xv, dev, iters=P16_ITERS):
    """One headline training of part 1.6's knobs (launch counts reset),
    its text hash and the numeric model served through K4."""
    reset_counts()
    ev = {}
    t0 = time.perf_counter()
    bst = train(params, ds, iters, valid_sets=[dv], evals_result=ev,
                **_on(dev))
    _sync(dev)
    secs = time.perf_counter() - t0
    counts = dict(boost_counts(),
                  cegb_scans=sc.cegb_launch_counts["split_scan"])
    res = {"seconds": secs, "s_per_iter": secs / iters,
           "valid_auc": ev["valid_0"]["auc"][-1], "launches": counts,
           **text_hash(bst.model_to_string(), tag)}
    check(not any(plain_calls().values()), f"{tag}: a plain version ran")
    check(counts["k1"] > 0 and counts["split_scan"] > 0,
          f"{tag}: K1 or the split scan never launched")
    res["served_max_abs_err"] = serve_trained(bst, Xv, dev, f"{tag}.txt")
    log(f"  {tag}: {iters} iterations in {secs:.2f} s, valid AUC "
        f"{res['valid_auc']:.5f}; launches {json.dumps(counts)}")
    return bst, res


def tree_paths(t) -> list:
    """Each leaf's split features along its root path (a host tree)."""
    out, stack = [], [(0, frozenset())] if t.num_leaves > 1 else []
    while stack:
        node, feats = stack.pop()
        if node < 0:
            out.append(feats)
            continue
        f = feats | {int(t.split_feature[node])}
        stack += [(int(t.left_child[node]), f),
                  (int(t.right_child[node]), f)]
    return out


def phase_p16(ds, dv, Xv, dev) -> dict:
    """Phase 48: interaction constraints on the staged and fused paths at
    the headline (every root-to-leaf path inside one group; the loop
    refuses them), CEGB split + coupled + lazy on the sequential grower
    (feature 5's coupled cost keeps it out), forced splits on the
    sequential and level-wise growers (each tree's top splits the forced
    ones); each P16_ITERS iterations, a text hash, served through K4."""
    out, t0 = {}, time.perf_counter()
    groups = [set(map(int, g.split(","))) for g in
              re.findall(r"\[([\d,]+)\]", P16_GROUPS)]
    for path in ("staged", "fused"):
        p = dict(TRAIN_PARAMS, interaction_constraints=P16_GROUPS,
                 **PATH_EXTRA[path])
        bst, res = p16_run(f"interaction {path}", p, ds, dv, Xv, dev)
        bad = sum(not any(pth <= g for g in groups)
                  for t in bst._all_trees() for pth in tree_paths(t))
        check(bad == 0, f"interaction {path}: {bad} paths cross groups")
        out[f"interaction_{path}"] = res
    try:
        train(dict(FUSED_PARAMS, wave_loop_rounds=4,
                   interaction_constraints=P16_GROUPS), ds, 1, **_on(dev))
        check(False, "interaction constraints: the loop did not refuse")
    except NotImplementedError as e:
        check("interaction constraints re-mask features per split"
              in str(e), f"the loop refused with another reason: {e}")
        out["loop_refusal"] = str(e)
    bst, res = p16_run("cegb sequential", P16_CEGB, ds, dv, Xv, dev)
    used = set()
    for t in bst._all_trees():
        used |= set(t.split_feature[:t.num_leaves - 1].tolist())
    check(5 not in used, "CEGB: feature 5 split despite its coupled cost")
    check(res["launches"]["cegb_scans"] == res["launches"]["split_scan"] > 0,
          "CEGB: a scan ran without its penalties")
    res["features_used"] = len(used)
    out["cegb"] = res
    fpath = os.path.join(_build.BUILD_DIR, "forced_splits.json")
    with open(fpath, "w") as fh:
        json.dump(P16_FORCED, fh)
    for growth in ("leafwise", "levelwise"):
        p = dict(TRAIN_PARAMS, forcedsplits_filename=fpath,
                 tree_growth=growth)
        bst, res = p16_run(f"forced {growth}", p, ds, dv, Xv, dev)
        top = [(int(t.split_feature[0]), int(t.split_feature[1]))
               for t in bst._all_trees()]
        check(all(a == 0 for a, _ in top),
              f"forced {growth}: a tree's root is not the forced split")
        out[f"forced_{growth}"] = res
    out["seconds"] = time.perf_counter() - t0
    return out


def p16_rows(cat: dict, cat_train: dict, cat_efb: dict, p16: dict,
             k3_rows: list) -> list:
    """The kernels line's rows of the categorical leg, the CEGB leg and
    K3's bitset leg."""
    top = max(cat["timing"], key=lambda r: r["C"])
    rb = k3_rows[0]
    cegb_top = max(cat["cegb_timing"], key=lambda r: r["C"])
    return [{
        "name": "split_scan:cat", "route": "cuda", "source": CAT_SRC,
        "replaces": "lightgbmv1_tpu/ops/split.py:281 _best_categorical and "
        "its merge in find_best_split (:721-740), XLA",
        "launches": int(cat_train["train"]["launches"]["split_scan_cat"]),
        "max_abs_err": 0.0, "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "computes a categorical split scan",
        "cold_device_ms": top["cold_device_ms"], "at": f"C={top['C']}",
        "buckets": cat["timing"], "checks": cat["cat"]}, {
        "name": "split_scan:cegb", "route": "cuda", "source": SCAN_SRC,
        "replaces": "lightgbmv1_tpu/ops/split.py:627-628 (the CEGB penalty "
        "in find_best_split, XLA)",
        "launches": int(p16["cegb"]["launches"]["cegb_scans"]),
        "max_abs_err": 0.0, "ms": cegb_top["ms"],
        "plain_ms": cegb_top["plain_ms"], "bound_ms": cegb_top["bound_ms"],
        "bound_by": cegb_top["bound_by"], "library_ms": None,
        "library_note": "none: no single PyTorch call computes a split "
        "scan", "cold_device_ms": cegb_top["cold_device_ms"],
        "at": f"C={cegb_top['C']}", "buckets": cat["cegb_timing"],
        "checks": cat["cegb"]}, {
        "name": "route_rows:bitset", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:595 (fused_route_rows"
        "' routing; a categorical split's decision is "
        "lightgbmv1_tpu/ops/split.py:251 bitset_contains, tree.py:183-189)",
        "launches": int(cat_train["train"]["launches"]["k3_bitset"]),
        "max_abs_err": 0.0, "ms": rb["ms"], "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"], "bound_by": rb["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "routes rows through a tree's splits",
        "cold_device_ms": rb["cold_device_ms"],
        "at": f"{rb['rows']} rows, {rb['splits']} splits in {rb['rounds']} "
        "rounds", "cases": k3_rows + [cat_efb["bundle"], cat_efb["u8"]]}]


def cegb_timing(last: dict, rng, checks: list) -> list:
    """The CEGB leg on phase 47's last scan inputs at each child count
    with random penalties: by events, on the device with the L2 cleared,
    the plain version on the card, its bound by bytes (the split scan's
    plus the (C, F) penalties read)."""
    rows = []
    for C in sorted(last):
        hist, mask, csums, kw = last[C]
        _, F_, B, _ = hist.shape
        pen = torch.as_tensor(rng.rand(C, F_).astype(np.float32),
                              device=hist.device)
        k = dict(kw, cegb=pen)
        checks.append(check_cegb_leg(f"main path C={C}", hist, mask, csums,
                                     k))
        ms = time_ms(lambda: sc.split_scan_pick(hist, mask, csums, **k), 30)
        cold = cold_device_ms(lambda: sc.split_scan_pick(
            hist, mask, csums, **k), ("split_scan_kernel",))
        bare = cold_device_ms(lambda: sc.split_scan_pick(
            hist, mask, csums, **kw), ("split_scan_kernel",))
        plain_ms = time_ms(lambda: sc.split_pick_ref(hist, mask, csums, **k),
                           2)
        nbytes = (C * F_ * B * 12 + C * F_ + C * 12 + 5 * F_ * 4
                  + C * F_ * 4 + C * sc.PACK_COLS * 4)
        ops = 2 * C * F_ * B * 21
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        rows.append({"C": C, "ms": ms,
                     "cold_device_ms": cold["split_scan_kernel"] or None,
                     "no_cegb_cold_device_ms":
                     bare["split_scan_kernel"] or None,
                     "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "ops": ops})
        log(f"  CEGB leg C={C} (F={F_}, B={B}): {fmt_ms(ms)} by events, "
            f"{fmt_ms(rows[-1]['cold_device_ms'])} on the device (L2 "
            f"cleared; without penalties "
            f"{fmt_ms(rows[-1]['no_cegb_cold_device_ms'])}), plain "
            f"{fmt_ms(plain_ms)}, bound "
            f"{fmt_ms(rows[-1]['bound_ms'])} by {rows[-1]['bound_by']}")
    return rows



# phases 49-51: the host prediction paths and the CLI
NATIVE_ROWS = 131072        # phase 49's bulk rows (phase 4's chunk shape)
PARSE_ROWS = 262144         # phase 49's csv of phase 8's generator
HOST_ROWS = 2048            # the host walk's subset, bitwise the native
CLI_VALID_ROWS = 32768      # phase 50's valid file and sklearn fit
CLI_ITERS = 10
CONVERT_ROWS = 1000
CONTRIB_ROWS = 32           # TreeSHAP is a host loop a row and tree
ES_FREQ, ES_MARGIN = 5, 4.0
ES_ROWS = 32768


def threads() -> int:
    """The cores this process may run on (the native walk's threads)."""
    return len(os.sched_getaffinity(0))


def write_csv(path, X, y) -> float:
    """A label-first csv with a header line; returns the seconds."""
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.9g",
               header=",".join(["label"] + [f"f{j}" for j in
                                            range(X.shape[1])]),
               comments="")
    return time.perf_counter() - t0


def phase_native(booster, trees, bulk, n_bulk, rng, seed) -> dict:
    """Phase 49: the native C++ walk (``predict_method=native``) on phase
    3's model at NATIVE_ROWS rows: its pack built once (cached), bitwise
    the host walk in float64 on HOST_ROWS rows, ``auto`` taking it at
    rows x trees >= ``_NATIVE_PREDICT_MIN_WORK``, within the serving
    tolerance of K4's raw scores on the same rows (launch counts reset:
    K4 launched); rows/s beside K4's here and phase 5's, the pack's build
    timed apart (a one-row call).  Then the native
    parser against the Python parser on a PARSE_ROWS-row csv of phase 8's
    generator: equal bit for bit (NaN-aware), seconds of each."""
    from lightgbmv1_tpu_torch import basic as basic_mod
    from lightgbmv1_tpu_torch.io.parser import _parse_dense
    from lightgbmv1_tpu_torch.native import parse_dense_file

    out = {"threads": threads()}
    X = make_rows(rng, NATIVE_ROWS)
    t0 = time.perf_counter()
    first = booster.predict(X[:1], predict_method="native", raw_score=True)
    out["pack_s"] = time.perf_counter() - t0     # the pack, built once
    t0 = time.perf_counter()
    raw = booster.predict(X, predict_method="native", raw_score=True)
    secs = time.perf_counter() - t0
    out.update(seconds=secs, rows_per_s=NATIVE_ROWS / secs)
    check(np.array_equal(first, raw[:1]), "native: two calls differ")
    host = booster.predict(X[:HOST_ROWS], predict_method="host",
                           raw_score=True)
    check(np.array_equal(raw[:HOST_ROWS], host),
          "native raw scores are not the host walk's bit for bit")
    check(HOST_ROWS * len(trees) >= basic_mod._NATIVE_PREDICT_MIN_WORK,
          "the subset is below the native threshold")
    check(np.array_equal(booster.predict(X[:HOST_ROWS], raw_score=True),
                         host), "auto: not the native walk's scores")
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    k4 = booster.predict(X, predict_method="fused", raw_score=True)
    torch.cuda.synchronize()
    k4_s = time.perf_counter() - t0
    check(pc.launch_counts["serving_fused"] > 0, "fused: K4 not launched")
    tol = raw_tol(trees)
    e = float(np.abs(k4 - raw).max())
    check(e <= tol, f"native vs K4: {e} > {tol}")
    out.update(k4_seconds=k4_s, k4_rows_per_s=NATIVE_ROWS / k4_s,
               k4_launches=pc.launch_counts["serving_fused"],
               k4_max_abs_err=e,
               phase5_k4_rows_per_s=bulk["fused"]["rows_per_s"])
    log(f"  native: {NATIVE_ROWS} rows x {len(trees)} trees in {secs:.3f} s"
        f" ({out['rows_per_s']:.0f} rows/s, {out['threads']} host threads;"
        f" the pack {out['pack_s']:.3f} s); K4 fused "
        f"on the same rows {k4_s:.3f} s ({out['k4_rows_per_s']:.0f} rows/s;"
        f" phase 5 {out['phase5_k4_rows_per_s']:.0f} rows/s at "
        f"{n_bulk} rows); bitwise the host walk on {HOST_ROWS} rows,"
        f" auto the native walk, K4 within {e:.3e} (tol {tol:.3e})")

    Xp, yp = make_data(PARSE_ROWS, seed)
    path = os.path.join(_build.BUILD_DIR, "smoke_train.csv")
    out["csv_write_s"] = write_csv(path, Xp, yp)
    t0 = time.perf_counter()
    native = parse_dense_file(path, True, ",")
    out["native_parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path) as fh:
        py = _parse_dense(fh.read().splitlines()[1:], ",")
    out["python_parse_s"] = time.perf_counter() - t0
    check(native is not None and native.shape == (PARSE_ROWS, F + 1),
          f"native parse: {None if native is None else native.shape}")
    check(np.array_equal(native, py, equal_nan=True),
          "the native parser differs from the Python parser")
    out["csv_bytes"] = os.path.getsize(path)
    log(f"  parse of a {PARSE_ROWS}-row csv ({out['csv_bytes'] / 1e6:.1f} "
        f"MB): native {out['native_parse_s']:.3f} s, Python "
        f"{out['python_parse_s']:.3f} s, equal bit for bit (written in "
        f"{out['csv_write_s']:.1f} s)")
    return out, path, native


def cli_run(args, lines) -> float:
    """``cli.main(args)`` in process; its log lines into ``lines``;
    returns the seconds."""
    from lightgbmv1_tpu_torch import cli
    from lightgbmv1_tpu_torch.utils.log import register_callback

    register_callback(lines.append)
    try:
        t0 = time.perf_counter()
        rc = cli.main(list(args))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        register_callback(None)
    check(rc == 0, f"cli {args[0]}: exit {rc}")
    return secs


def logged_seconds(lines, pattern) -> float:
    """The number the last log line matching ``pattern`` (one group)
    carries."""
    hits = [m for m in (re.search(pattern, ln) for ln in lines) if m]
    check(bool(hits), f"no log line matches {pattern!r}")
    return float(hits[-1].group(1))


def phase_cli(csv_path, parsed, seed, dev) -> dict:
    """Phase 50: the CLI in process on the card (launch counts reset
    before each task).  ``task=train`` on phase 49's csv with a
    CLI_VALID_ROWS-row ``valid=`` file at the headline width
    (CLI_ITERS iterations): K1 launched, K3 once a tree, no plain version,
    a model text that loads; ``task=predict`` with
    ``predict_method=fused``: K4 launched, the output file equal to
    ``Booster.predict``; ``task=convert_model``: the C++ compiled with
    g++, its raw scores within 1e-12 of ``predict(raw_score=True)`` on
    CONVERT_ROWS rows; ``task=refit`` on the valid file: K5 launched,
    every structure kept; an ``LGBMClassifier`` fit whose
    ``predict_proba`` is its booster's."""
    from lightgbmv1_tpu_torch import LGBMClassifier

    out, bd = {}, str(_build.BUILD_DIR)
    Xv, yv = make_data(CLI_VALID_ROWS, seed + 1)
    valid = os.path.join(bd, "smoke_valid.csv")
    write_csv(valid, Xv, yv)
    model = os.path.join(bd, "cli_model.txt")
    common = ["header=true", "verbosity=1"]
    reset_counts()
    pc.reset_launch_counts()
    lines = []
    secs = cli_run(["task=train", f"data={csv_path}", f"valid={valid}",
                    "objective=binary", "num_leaves=255", "max_bin=63",
                    "metric=auc", f"num_iterations={CLI_ITERS}",
                    f"output_model={model}", *common], lines)
    k1 = hc.launch_counts["hist_leaves"]
    k3 = fc.launch_counts["route_rows"]
    plain = {**dict(hc.plain_counts), **dict(fc.plain_counts)}
    load_s = logged_seconds(lines, r"Finished loading data in ([0-9.]+)")
    loop_s = logged_seconds(lines, r"([0-9.]+) seconds elapsed, finished "
                            rf"iteration {CLI_ITERS}\b")
    auc = logged_seconds(lines, rf"Iteration:{CLI_ITERS}, \S+ auc : "
                         r"([0-9.]+)")
    bst = Booster(model_file=model)
    grown = sum(int(t.num_leaves) > 1 for t in bst._all_trees())
    check(bst.num_trees() == CLI_ITERS, f"cli train: {bst.num_trees()} "
          "trees")
    check(k1 > 0, "cli train: K1 never launched")
    check(k3 == grown, f"cli train: K3 launched {k3} times for {grown} "
          "trees (one valid set)")
    check(not any(plain.values()), f"cli train: plain versions {plain}")
    check(auc > 0.85, f"cli train: valid AUC {auc}")
    out["train"] = {"seconds": secs, "load_s": load_s,
                    "s_per_iter": loop_s / CLI_ITERS, "valid_auc": auc,
                    "k1_launches": k1, "k3_launches": k3}
    log(f"  task=train: {secs:.2f} s ({load_s:.2f} s loading {PARSE_ROWS} "
        f"+ {CLI_VALID_ROWS} rows, {loop_s / CLI_ITERS:.4f} s/iteration); "
        f"valid AUC {auc:.5f}; K1 {k1}, K3 {k3} launches")

    result = os.path.join(bd, "cli_predict.txt")
    pc.reset_launch_counts()
    secs = cli_run(["task=predict", f"data={valid}", f"input_model={model}",
                    f"output_result={result}", "predict_method=fused",
                    *common], [])
    got = np.loadtxt(result)
    k4 = pc.launch_counts["serving_fused"]
    want = bst.predict(np.loadtxt(valid, delimiter=",", skiprows=1)[:, 1:],
                       predict_method="fused")
    check(k4 > 0, "cli predict: K4 never launched")
    check(np.array_equal(got, want), "cli predict: the output file is not "
          "Booster.predict's")
    out["predict"] = {"seconds": secs, "k4_launches": k4}
    log(f"  task=predict (fused): {secs:.2f} s for {CLI_VALID_ROWS} rows, "
        f"K4 {k4} launches, the file equal to Booster.predict")

    cpp = os.path.join(bd, "cli_model.cpp")
    cli_run(["task=convert_model", f"input_model={model}",
             f"convert_model={cpp}", *common], [])
    out["convert"] = convert_check(cpp, bst, parsed[:CONVERT_ROWS, 1:], bd)

    refit = os.path.join(bd, "cli_refit.txt")
    pc.reset_launch_counts()
    secs = cli_run(["task=refit", f"data={valid}", f"input_model={model}",
                    f"output_model={refit}", *common], [])
    k5 = pc.launch_counts["serving_leaf"]
    rb = Booster(model_file=refit)
    check(k5 > 0, "cli refit: K5 never launched")
    check(same_structures(rb._all_trees(), bst._all_trees()),
          "cli refit: a tree's structure moved")
    out["refit"] = {"seconds": secs, "k5_launches": k5}
    log(f"  task=refit: {secs:.2f} s, K5 {k5} launches, structures kept")

    reset_counts()
    t0 = time.perf_counter()
    clf = LGBMClassifier(n_estimators=CLI_ITERS, num_leaves=255,
                         max_bin=63).fit(Xv, yv)
    secs = time.perf_counter() - t0
    proba = clf.predict_proba(Xv)
    check(proba.shape == (CLI_VALID_ROWS, 2) and np.array_equal(
        proba[:, 1], clf.booster_.predict(Xv)),
        "LGBMClassifier: predict_proba is not its booster's")
    check(hc.launch_counts["hist_leaves"] > 0,
          "LGBMClassifier: K1 never launched")
    out["sklearn"] = {"seconds": secs,
                      "k1_launches": hc.launch_counts["hist_leaves"]}
    log(f"  LGBMClassifier: fit {secs:.2f} s on the card, predict_proba "
        "its booster's")
    return out


def convert_check(cpp, bst, X, bd) -> dict:
    """``task=convert_model``'s code compiled with g++ beside a ``main``
    that scores rows read from a file: within 1e-12 of the booster's raw
    scores."""
    main_cpp = os.path.join(bd, "cli_model_main.cpp")
    with open(main_cpp, "w") as fh:
        fh.write('#include <cstdio>\n#include <vector>\n'
                 'void PredictRaw(const double*, double*);\n'
                 'int main(int c, char** v) {\n'
                 '  FILE* f = std::fopen(v[1], "rb");\n'
                 f'  std::vector<double> row({X.shape[1]});\n'
                 '  double out;\n'
                 '  while (std::fread(row.data(), sizeof(double), row.size(),'
                 ' f) == row.size()) {\n'
                 '    PredictRaw(row.data(), &out);\n'
                 '    std::printf("%.17g\\n", out);\n  }\n  return 0;\n}\n')
    exe = os.path.join(bd, "cli_model_bin")
    rows = os.path.join(bd, "cli_model_rows.bin")
    np.ascontiguousarray(X, np.float64).tofile(rows)
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O0", "-o", exe, cpp, main_cpp], check=True,
                   capture_output=True)
    compile_s = time.perf_counter() - t0
    res = subprocess.run([exe, rows], check=True, capture_output=True,
                         text=True)
    got = np.array([float(v) for v in res.stdout.split()])
    want = bst.predict(X, raw_score=True)
    e = float(np.abs(got - want).max())
    check(len(got) == len(X) and e <= 1e-12,
          f"convert_model: {len(got)} rows, max err {e}")
    log(f"  task=convert_model: {os.path.getsize(cpp) / 1e6:.1f} MB of C++,"
        f" g++ {compile_s:.1f} s, raw scores within {e:.1e} of predict on "
        f"{len(X)} rows")
    return {"compile_s": compile_s, "cpp_bytes": os.path.getsize(cpp),
            "max_abs_err": e}


def phase_contrib(Xv) -> dict:
    """Phase 51: TreeSHAP on CONTRIB_ROWS rows of phase 10's 50-tree
    headline model (``pred_contrib=True``): (N, F + 1), each row summing
    to its raw score within 1e-9; ms a row and tree.  Then
    ``pred_early_stop`` (freq ES_FREQ, margin ES_MARGIN) on ES_ROWS valid
    rows: the rows whose score stopped short of the full walk's, the
    seconds beside the full host walk's."""
    bst = Booster(model_file=os.path.join(_build.BUILD_DIR,
                                          "trained_model.txt"))
    T = bst.num_trees()
    X = np.asarray(Xv[:CONTRIB_ROWS], np.float64)
    t0 = time.perf_counter()
    contrib = bst.predict(X, pred_contrib=True)
    secs = time.perf_counter() - t0
    raw = bst.predict(X, raw_score=True, predict_method="host")
    e = float(np.abs(contrib.sum(axis=1) - raw).max())
    check(contrib.shape == (CONTRIB_ROWS, F + 1) and e <= 1e-9,
          f"pred_contrib: shape {contrib.shape}, sum off by {e}")
    out = {"trees": T, "rows": CONTRIB_ROWS, "seconds": secs,
           "ms_per_row_tree": secs * 1e3 / (CONTRIB_ROWS * T),
           "sum_max_abs_err": e}
    log(f"  pred_contrib: {CONTRIB_ROWS} rows x {T} trees in {secs:.2f} s "
        f"({out['ms_per_row_tree']:.2f} ms a row and tree), rows sum to "
        f"the raw score within {e:.1e}")
    Xv = Xv[:ES_ROWS]
    t0 = time.perf_counter()
    es = bst.predict(Xv, raw_score=False, pred_early_stop=True,
                     pred_early_stop_freq=ES_FREQ,
                     pred_early_stop_margin=ES_MARGIN)
    es_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = bst.predict(Xv, predict_method="host")
    full_s = time.perf_counter() - t0
    check(es.shape == full.shape and np.isfinite(es).all(),
          "pred_early_stop: bad output")
    retired = int((es != full).sum())
    out["early_stop"] = {"rows": len(Xv), "freq": ES_FREQ,
                         "margin": ES_MARGIN, "stopped_rows": retired,
                         "seconds": es_s, "host_seconds": full_s}
    log(f"  pred_early_stop (freq {ES_FREQ}, margin {ES_MARGIN}): "
        f"{retired} of {len(Xv)} rows stopped early, {es_s:.2f} s beside "
        f"the full host walk's {full_s:.2f} s")
    return out


OBS_DIR = os.path.join(_build.BUILD_DIR, "obs")   # phases 52-54's artifacts
SERVE_CLIENTS = 8           # phase 52's HTTP client threads
SERVE_HTTP_REQUESTS = 200   # its main window's requests (1-256 rows each)
SERVE_DEGRADE_TREES = 100   # the truncated ensemble of the degrade check
DRIFT_ROWS = 32768          # the drift check's training rows


class PreparedVersions:
    """Records every version a serving registry prepares (its build,
    warm batches and golden probe) while active, with the probe's rows."""

    def __enter__(self):
        from lightgbmv1_tpu_torch.serve.registry import ModelRegistry

        self.versions = []
        self._cls, self._orig = ModelRegistry, ModelRegistry.prepare
        orig, seen = self._orig, self.versions

        def prepare(reg, model, **kw):
            mv = orig(reg, model, **kw)
            seen.append((mv, int(kw.get("probe_rows", 64))))
            return mv

        ModelRegistry.prepare = prepare
        return self

    def __exit__(self, *exc):
        self._cls.prepare = self._orig


def check_k4_serving(what, prepared, batches) -> dict:
    """Every version prepared so far walks with K4 (its predictor and
    its degrade predictor), and K4's launches since the counts were reset
    are exactly the servers' ``batches`` plus each version's warm batches
    and, where it was probed, its two probe batches (the f64 lane's leaf
    mode and the f32 lane): no serving batch took another walk.
    ``batches`` is a count, or the servers (a fleet's replicas) whose
    batches it sums: a hedged request counts on each replica it
    reached."""
    if not isinstance(batches, int):
        batches = sum(s.metrics_snapshot()["batches"] for s in batches)
    walks = [bp for mv, _ in prepared.versions
             for bp in (mv.predictor, mv.degraded) if bp is not None]
    unfused = [bp.method for bp in walks if not bp._fused_engaged()]
    check(walks and not unfused,
          f"{what}: {len(unfused)} of {len(walks)} serving predictors not "
          f"on K4 ({unfused[:3]})")
    warm = sum(mv.meta["n_warm"] for mv, _ in prepared.versions)
    probe = sum(2 for _, rows in prepared.versions if rows > 0)
    launches = int(pc.launch_counts["serving_fused"])
    check(launches == batches + warm + probe
          and pc.launch_counts["serving_leaf"] == 0,
          f"{what}: K4 {launches} launches, want {batches} batches + "
          f"{warm} warm + {probe} probe; K5 "
          f"{pc.launch_counts['serving_leaf']}")
    return {"launches": launches, "batches": batches, "warm": warm,
            "probe": probe, "versions": len(prepared.versions),
            "predictors": len(walks)}


def http_call(port, path, payload=None, headers=None):
    """``(status, headers, body bytes)`` of one request to the local
    front-end (a POST when ``payload`` is given)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def http_predict(port, rows, **extra):
    code, hdr, body = http_call(port, "/predict",
                                {"rows": np.asarray(rows).tolist(), **extra})
    return code, hdr, json.loads(body)


def serve_traffic(port, srv, booster_b, n_requests, rng):
    """SERVE_CLIENTS threads POST 1-256-row requests; a publish of model
    B and a rollback to A happen in mid-traffic.  Returns the answers
    ``(rows, version, values, latency_ms, trace_id)``, the tags and the
    window's seconds."""
    seeds = rng.randint(1 << 30, size=SERVE_CLIENTS)
    answers, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(seed):
        r = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = make_rows(r, r.randint(1, 257))
                t0 = time.perf_counter()
                code, hdr, body = http_predict(port, rows)
                lat = (time.perf_counter() - t0) * 1e3
                if code != 200:
                    raise RuntimeError(f"HTTP {code}: {body}")
                with lock:
                    answers.append((rows, body["version"],
                                    np.asarray(body["values"]), lat,
                                    hdr["X-Trace-Id"]))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(e)

    def more(n):
        goal = len(answers) + n
        while len(answers) < goal and not errors:
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(s,)) for s in seeds]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    more(n_requests // 3)
    tag_b = srv.publish(booster_b)
    more(n_requests // 3)
    tag_a = srv.rollback()
    more(n_requests - 2 * (n_requests // 3))
    stop.set()
    for t in threads:
        t.join(timeout=300)
    secs = time.perf_counter() - t0
    check(not errors, f"HTTP client errors: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "an HTTP client hung")
    return answers, (tag_a, tag_b), secs


def check_answers(answers, by_tag, what):
    """Every answer equals ``Booster.predict(raw_score=True)`` of the
    version it names, bit for bit (the f64 lane)."""
    for tag, booster in by_tag.items():
        mine = [(rows, vals) for rows, t, vals, *_ in answers if t == tag]
        check(bool(mine), f"{what}: no answer tagged {tag}")
        X = np.concatenate([rows for rows, _ in mine])
        want = booster.predict(X, raw_score=True)
        got = np.concatenate([vals[:, 0] for _, vals in mine])
        e = float(np.abs(got - want).max())
        check(np.array_equal(got, want),
              f"{what}: answers of {tag} differ from Booster.predict by {e}")
        log(f"  {what}: {len(mine)} answers tagged {tag}, bit for bit "
            "Booster.predict(raw_score=True)")


PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                       r'(-?[0-9.eE+-]+|\+Inf|NaN)$')


def parse_prometheus(text: str) -> dict:
    """Prometheus text exposition 0.0.4 -> ``{series: value}``; every
    sample line must parse."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = PROM_LINE.match(ln)
        check(m is not None, f"unparsable exposition line {ln!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def serve_failure_domains(port, srv, booster_a, booster_b, rng):
    """On the serving window's server (watchdog 1 s, breaker after 2
    failed batches, no retries): a ``replica_wedge`` stall answers 503
    and the next request 200; a dispatcher killed by ``exit_thread`` is
    restarted and the next request answered; two failed batches after a
    publish open the breaker, which rolls back to the previous
    version."""
    from lightgbmv1_tpu_torch.utils import faults

    X = make_rows(rng, 16)
    out = {}
    with faults.inject(faults.FaultSpec("replica_wedge", mode="stall",
                                        stall_s=1.5, match="server")):
        code, _, body = http_predict(port, X)
    check(code == 503 and "DispatcherStalled" in body.get("error", ""),
          f"a wedged batch answered {code}: {body}")
    deadline = time.monotonic() + 30.0
    while srv.wedged() and time.monotonic() < deadline:
        time.sleep(0.01)
    code, _, body = http_predict(port, X)
    check(code == 200, f"after the wedge: HTTP {code} {body}")
    out["wedge"] = {"status": 503, "after": code,
                    "watchdog_failures": srv.metrics.value(
                        "watchdog_failures")}
    with faults.inject(faults.FaultSpec("dispatch", mode="exit_thread")):
        code, _, body = http_predict(port, X)
    check(code == 503, f"a dying dispatcher answered {code}: {body}")
    deadline = time.monotonic() + 30.0
    while not srv.dispatcher_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    code, _, body = http_predict(port, X)
    restarts = srv.metrics.value("dispatcher_restarts")
    check(code == 200 and restarts >= 1,
          f"after the restart: HTTP {code}, {restarts} restarts")
    out["restart"] = {"status": 503, "after": code, "restarts": restarts}
    before = srv.version()
    tag = srv.publish(booster_b)
    with faults.inject(faults.FaultSpec("dispatch", mode="raise", count=2)):
        codes = [http_predict(port, X)[0] for _ in range(2)]
    code, _, body = http_predict(port, X)
    trips = srv.metrics.value("breaker_trips")
    check(codes == [503, 503] and trips == 1 and srv.version() == before
          and body.get("version") == before,
          f"breaker: {codes}, {trips} trips, serving {srv.version()} "
          f"(published {tag}, previous {before})")
    want = booster_a.predict(X, raw_score=True)
    check(np.array_equal(np.asarray(body["values"])[:, 0], want),
          "the rolled-back version's answer differs from Booster.predict")
    out["breaker"] = {"failed": codes, "trips": trips, "published": tag,
                      "rolled_back_to": before}
    log(f"  failure domains: {json.dumps(out)}")
    return out


def serve_degrade(booster, dev, rng):
    """A server with ``degrade_trees=SERVE_DEGRADE_TREES``: a first batch
    stalled by a ``dispatch`` plan while four 128-row requests queue;
    the next batch leaves 256 rows backlogged (a quarter of the queue)
    and is answered ``degraded`` by K4 on the truncated tables, equal to
    ``Booster.predict(num_iteration=SERVE_DEGRADE_TREES)``; the last
    batch, with no backlog, by the whole ensemble."""
    from lightgbmv1_tpu_torch.utils import faults

    srv = Server(booster, ServeConfig(
        max_batch_rows=256, max_batch_delay_ms=1.0, queue_depth_rows=1024,
        degrade_trees=SERVE_DEGRADE_TREES, degrade_queue_frac=0.25,
        f64_scores=True), device=dev)
    try:
        mv = srv.registry.current()
        deg = mv.degraded
        check(deg is not None and deg.T == SERVE_DEGRADE_TREES
              and deg._fused_engaged(),
              f"degrade predictor: {deg and deg.T} trees, fused "
              f"{deg is not None and deg._fused_engaged()}")
        calls0 = deg.call_count
        Xs = [make_rows(rng, 128) for _ in range(4)]
        res = {}
        with faults.inject(faults.FaultSpec("dispatch", mode="stall",
                                            stall_s=1.0)) as plan:
            first = threading.Thread(target=lambda: res.setdefault(
                "first", srv.submit(make_rows(rng, 8))))
            first.start()
            deadline = time.monotonic() + 60.0
            while not plan.fired and time.monotonic() < deadline:
                time.sleep(0.002)
            ths = [threading.Thread(target=lambda i=i: res.setdefault(
                i, srv.submit(Xs[i]))) for i in range(4)]
            for t in ths:
                t.start()
                time.sleep(0.05)
            for t in [first] + ths:
                t.join(timeout=300)
        flags = [res[i].degraded for i in range(4)]
        check(flags == [True, True, False, False],
              f"degraded flags {flags}")
        for i in range(4):
            want = booster.predict(
                Xs[i], raw_score=True,
                num_iteration=SERVE_DEGRADE_TREES if flags[i] else None)
            check(np.array_equal(res[i].values[:, 0], want),
                  f"degraded request {i} differs from Booster.predict")
        check(deg.call_count > calls0, "the degrade predictor never ran")
        out = {"flags": flags, "degrade_trees": deg.T,
               "degrade_calls": deg.call_count - calls0,
               "degraded": srv.metrics.value("degraded"),
               "batches": srv.metrics.value("batches")}
    finally:
        srv.close()
    log(f"  degradation: {json.dumps(out)}")
    return out


def serve_drift(dev, seed):
    """Drift: a model trained on DRIFT_ROWS rows of phase 8's generator,
    published with its training reference into a server sampling every
    batch; ``GET /drift`` stays under the PSI threshold on fresh rows of
    the same generator and goes over it on rows with feature 0 shifted
    by 3."""
    Xr, yr = make_data(DRIFT_ROWS, seed + 21)
    bref = train(TRAIN_PARAMS, Dataset(Xr, label=yr, params=TRAIN_PARAMS),
                 3, device=dev)
    ref = bref.capture_model_reference()
    srv = Server(None, ServeConfig(
        max_batch_rows=1024, max_batch_delay_ms=1.0, queue_depth_rows=8192,
        drift_sample_rows=8192, drift_per_batch_rows=1024,
        drift_min_rows=2048, drift_sample_stride=1), device=dev)
    http = ServeHTTP(srv, port=0).start()
    try:
        srv.publish(bref, model_reference=ref)
        Xc, _ = make_data(8192, seed + 22)
        for lo in range(0, 8192, 1024):
            srv.submit(Xc[lo:lo + 1024])
        _, _, body = http_call(http.port, "/drift")
        clean = json.loads(body)
        Xs = Xc.copy()
        Xs[:, 0] += 3.0
        for lo in range(0, 8192, 1024):
            srv.submit(Xs[lo:lo + 1024])
        _, _, body = http_call(http.port, "/drift")
        shifted = json.loads(body)
    finally:
        http.shutdown()
        srv.close()
    batches = srv.metrics.value("batches")
    thr = clean.get("psi_threshold")
    check(clean.get("armed") and clean.get("evaluated")
          and clean["psi_max"] < thr,
          f"drift on training-distribution rows: {clean.get('psi_max')} "
          f"(threshold {thr}, {clean.get('reason', '')})")
    check(shifted["psi_max"] >= thr and "Column_0" in shifted["alerting"],
          f"drift on shifted rows: {shifted['psi_max']} "
          f"{shifted['alerting']}")
    out = {"reference_digest": ref.digest[:16], "threshold": thr,
           "clean_psi_max": clean["psi_max"],
           "shifted_psi_max": shifted["psi_max"],
           "alerting": shifted["alerting"], "batches": batches}
    log(f"  drift: {json.dumps(out)}")
    return out


def phase_serve_http(path_a, booster_a, booster_b, dev, rng, seed) -> dict:
    """Phase 52: ``cli.run_serve`` in process on the card (phase 5's
    model, f64 lane, ``predict_method`` at its default), HTTP on a port of
    127.0.0.1 the system picks: SERVE_CLIENTS threads of 1-256-row
    requests with a publish and a rollback in mid-traffic, tenants, SLOs,
    metrics, tracing and the failure domains; then degradation and drift
    on servers of their own.  Its artifacts go to OBS_DIR (phase 54).  Launch counts are reset just before and
    read after each server (``check_k4_serving``)."""
    from lightgbmv1_tpu_torch import cli

    t_phase = time.perf_counter()
    trace_out = os.path.join(_build.BUILD_DIR, "serve_trace.json")
    config = Config.from_cli([
        "task=serve", f"input_model={path_a}", "serve_http_port=0",
        "serve_duration_s=900", "predict_f64_scores=true",
        "serve_queue_depth=65536", "serve_watchdog_ms=1000",
        "serve_breaker_failures=2", "serve_retry_max=0",
        "tenant_manifest=acme,globex", f"trace_out={trace_out}",
        f"obs_dir={OBS_DIR}", "verbosity=0"])
    obs_events.set_identity(role="serve-http")    # its artifacts' label
    pc.reset_launch_counts()
    with PreparedVersions() as prepared:
        box, ready, stop, failed = {}, threading.Event(), threading.Event(), []

        def on_ready(server, http):
            box.update(server=server, http=http)
            ready.set()

        def run():
            try:
                cli.run_serve(config, ready=on_ready, stop=stop)
            except BaseException as e:  # noqa: BLE001 — reported below
                failed.append(e)
                ready.set()

        th = threading.Thread(target=run, name="run-serve")
        try:
            th.start()
            ready.wait(600)
            check(not failed and "server" in box, f"run_serve: {failed}")
            srv, port = box["server"], box["http"].port
            t_up = time.perf_counter() - t_phase
            code, _, body = http_call(port, "/healthz")
            check(code == 200, f"/healthz {code}: {body}")
            answers, (tag_a, tag_b), secs = serve_traffic(
                port, srv, booster_b, SERVE_HTTP_REQUESTS, rng)
            check_answers(answers, {tag_a: booster_a, tag_b: booster_b},
                          "HTTP")
            snap = srv.metrics_snapshot()
            lat = sorted(a[3] for a in answers)
            line = {"requests": len(answers), "seconds": secs,
                    "requests_per_s": len(answers) / secs,
                    "p50_ms": lat[len(lat) // 2],
                    "p99_ms": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
                    "batches": snap["batches"],
                    "mean_batch_rows": snap["mean_batch_rows"],
                    "server_p50_ms": snap["p50_ms"],
                    "server_p99_ms": snap["p99_ms"]}
            log(f"  HTTP serving: {json.dumps(line)}")
            # tenants: each answers with its own version
            tag_g = srv.publish(booster_b, tenant="globex")
            Xt = make_rows(rng, 64)
            for tenant, tag, booster in (("acme", "v1", booster_a),
                                         ("globex", tag_g, booster_b)):
                code, _, body = http_predict(port, Xt, tenant=tenant)
                check(code == 200 and body["version"] == tag
                      and body.get("tenant") == tenant
                      and np.array_equal(np.asarray(body["values"])[:, 0],
                                         booster.predict(Xt, raw_score=True)),
                      f"tenant {tenant}: HTTP {code}, version "
                      f"{body.get('version')} (want {tag})")
            _, _, body = http_call(port, "/tenants")
            tenants = json.loads(body)["tenants"]
            check({"acme", "globex"} <= set(tenants),
                  f"/tenants lists {sorted(tenants)}")
            # SLOs and the Prometheus view of the one store
            _, _, body = http_call(port, "/slo")
            slo = json.loads(body)
            fast = slo["availability"]["windows"]["fast"]
            check(fast["total"] >= len(answers) and "burn_rate" in fast
                  and "burn_rate" in slo["latency"]["windows"]["slow"],
                  f"/slo: {fast}")
            now = srv.metrics_snapshot()      # no request in flight here
            code, hdr, body = http_call(port, "/metrics?format=prometheus")
            series = parse_prometheus(body.decode())
            check(code == 200 and hdr["Content-Type"].startswith("text/plain")
                  and series.get("serve_completed_total") == now["completed"]
                  >= len(answers)
                  and series.get("serve_batches_total") == now["batches"],
                  "Prometheus view: "
                  f"{ {k: v for k, v in series.items() if 'total' in k} }")
            domains = serve_failure_domains(port, srv, booster_a, booster_b,
                                            rng)
        finally:
            stop.set()
            th.join(timeout=300)
        check(not th.is_alive() and not failed, f"run_serve did not end: "
              f"{failed}")
        batches = srv.metrics_snapshot()["batches"]
        k4 = {"task=serve": check_k4_serving("task=serve", prepared,
                                             batches)}
        doc = json.load(open(trace_out))
        walked = {e["args"]["trace_id"] for e in doc["traceEvents"]
                  if e.get("name") == "serve.walk"}
        sample = [a[4] for a in answers[::max(len(answers) // 50, 1)]]
        missing = [t for t in sample if t not in walked]
        check(not missing, f"{len(missing)} sampled trace ids not in the "
              f"exported trace (e.g. {missing[:3]})")
        log(f"  K4: {json.dumps(k4['task=serve'])}; {len(sample)} sampled "
            f"trace ids in the {len(doc['traceEvents'])}-event trace; up "
            f"in {t_up:.1f} s")
        degrade = serve_degrade(booster_a, dev, rng)
        batches += degrade["batches"]
        k4["degrade"] = check_k4_serving("degradation", prepared, batches)
        drift = serve_drift(dev, seed)
        batches += drift["batches"]
        k4["drift"] = check_k4_serving("drift", prepared, batches)
    log(f"  K4 over the phase: {json.dumps(k4['drift'])}")
    out = {**line, "launches": dict(pc.launch_counts), "k4": k4,
           "server_batches": batches,
           "slo_fast_burn": fast["burn_rate"], "tenants": sorted(tenants),
           "failure_domains": domains, "degrade": degrade, "drift": drift,
           "trace_events": len(doc["traceEvents"]),
           "seconds": time.perf_counter() - t_phase}
    return out


FLEET_REPLICAS = 3          # phase 53's replicas on the one card
FLEET_TREES = 250           # its first model: phase 3's first half
FLEET_CLIENTS = 6           # its client threads of 2-row requests
FLEET_WINDOW_S = 2.5        # its traffic window; r1 closes at 40% of it
FLEET_EJECT_S = 3.0         # the gate on r1's ejection after its close


class CapturedFleets:
    """Records every ``Fleet`` built while active (``run_serve`` builds
    the one it serves and hands out only its router)."""

    def __enter__(self):
        from lightgbmv1_tpu_torch.serve import fleet as fleet_mod

        self.fleets = []
        self._cls, self._orig = fleet_mod.Fleet, fleet_mod.Fleet.__init__
        orig, seen = self._orig, self.fleets

        def init(fleet, *a, **kw):
            orig(fleet, *a, **kw)
            seen.append(fleet)

        fleet_mod.Fleet.__init__ = init
        return self

    def __exit__(self, *exc):
        self._cls.__init__ = self._orig


def fleet_traffic(port, router, fleet, rng):
    """FLEET_CLIENTS threads POST 2-row requests for FLEET_WINDOW_S; at
    40% of the window replica r1 closes and the router's health view is
    polled until it names r1 ejected.  Returns the answers ``(rows,
    version, values, latency_ms)``, the window's seconds and the seconds
    from the close to the ejection (None: not within FLEET_EJECT_S)."""
    seeds = rng.randint(1 << 30, size=FLEET_CLIENTS)
    answers, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(seed):
        r = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = make_rows(r, 2)
                t0 = time.perf_counter()
                code, _, body = http_predict(port, rows)
                lat = (time.perf_counter() - t0) * 1e3
                if code != 200:
                    raise RuntimeError(f"HTTP {code}: {body}")
                with lock:
                    answers.append((rows, body["version"],
                                    np.asarray(body["values"]), lat))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in seeds]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(0.4 * FLEET_WINDOW_S)
    fleet.replica("r1").close()
    t_close = time.perf_counter()
    eject_s = None
    while time.perf_counter() - t_close < FLEET_EJECT_S:
        if "r1" in router.health()["ejected_replicas"]:
            eject_s = time.perf_counter() - t_close
            break
        time.sleep(0.005)
    time.sleep(max(FLEET_WINDOW_S - (time.perf_counter() - t0), 0.0))
    stop.set()
    for t in threads:
        t.join(timeout=300)
    secs = time.perf_counter() - t0
    check(not errors, f"fleet: client errors {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "fleet: a client hung")
    return answers, secs, eject_s


def phase_fleet(booster, dev, rng) -> dict:
    """Phase 53: ``cli.run_serve`` with ``serve_replicas=3`` in process
    on the card, over HTTP (``measure_fleet``'s cell): the first
    FLEET_TREES trees of phase 3's model on the f64 lane, the router's
    health poll at 15 ms, two retries and hedges after 50 ms,
    FLEET_CLIENTS threads of 2-row requests for FLEET_WINDOW_S with r1
    closed at 40% of it; then the whole model published fleet-wide and
    two tenants pinned to two replicas each.  Gates: no client error,
    timeout or shed; every answer ``Booster.predict(raw_score=True)`` bit
    for bit; r1 ejected within FLEET_EJECT_S; one version tag on every
    replica after the publish; each tenant on 2 replicas; every replica's
    versions on K4, and K4's launches the replicas' batches plus the warm
    and probe batches (``check_k4_serving``), K5 none."""
    from lightgbmv1_tpu_torch import cli
    from lightgbmv1_tpu_torch.serve.router import hedge_frac

    t_phase = time.perf_counter()
    half_path = os.path.join(_build.BUILD_DIR, "fleet_model.txt")
    booster.save_model(half_path, num_iteration=FLEET_TREES)
    half = Booster(model_file=half_path)
    check(half.num_trees() == FLEET_TREES, "fleet: the half model")
    config = Config.from_cli([
        "task=serve", f"input_model={half_path}", "serve_http_port=0",
        "serve_duration_s=900", "predict_f64_scores=true",
        f"serve_replicas={FLEET_REPLICAS}", "router_health_period_ms=15",
        "router_retry_max=2", "router_hedge_ms=50",
        "tenant_manifest=acme,globex", "placement_replicas_per_tenant=2",
        f"obs_dir={OBS_DIR}", "verbosity=0"])
    obs_events.set_identity(role="serve-fleet")
    obs_trace.reset()       # phase 52's spans are its own artifact's
    pc.reset_launch_counts()
    with PreparedVersions() as prepared, CapturedFleets() as captured:
        box, ready, stop, failed = {}, threading.Event(), threading.Event(), []

        def on_ready(server, http):
            box.update(router=server, http=http)
            ready.set()

        def run():
            try:
                cli.run_serve(config, ready=on_ready, stop=stop)
            except BaseException as e:  # noqa: BLE001 — reported below
                failed.append(e)
                ready.set()

        th = threading.Thread(target=run, name="run-serve-fleet")
        try:
            th.start()
            ready.wait(600)
            check(not failed and "router" in box, f"run_serve: {failed}")
            router, port = box["router"], box["http"].port
            fleet = captured.fleets[-1]
            check(type(router).__name__ == "Router"
                  and fleet.names() == ["r0", "r1", "r2"],
                  f"fleet: {type(router).__name__} over {fleet.names()}")
            t_up = time.perf_counter() - t_phase
            tag_half = router.version()
            answers, secs, eject_s = fleet_traffic(port, router, fleet, rng)
            snap = router.metrics_snapshot()
            check(eject_s is not None, f"fleet: r1 not ejected within "
                  f"{FLEET_EJECT_S} s of its close")
            check(snap["errors"] == snap["timeouts"] == snap["shed"] == 0,
                  f"fleet: router errors {snap['errors']}, timeouts "
                  f"{snap['timeouts']}, shed {snap['shed']}")
            check(all(a[1] == tag_half for a in answers),
                  f"fleet: answers not all tagged {tag_half}")
            check_answers(answers, {tag_half: half}, "fleet")
            lat = sorted(a[3] for a in answers)
            line = {"requests": len(answers), "seconds": secs,
                    "requests_per_s": len(answers) / secs,
                    "p50_ms": lat[len(lat) // 2],
                    "p99_ms": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
                    "retries": snap["retries"],
                    "hedges": snap["router"]["hedges"],
                    "hedge_wins": snap["router"]["hedge_wins"],
                    "hedge_frac": hedge_frac(snap), "eject_s": eject_s,
                    "replica_batches": {
                        r.name: r.metrics_snapshot()["batches"]
                        for r in fleet.replicas}}
            log(f"  fleet over HTTP: {json.dumps(line)}")
            # the whole model, two-phase, on every replica (r1 included:
            # a closed replica's registry still prepares and commits)
            tag_full = fleet.publish(booster)
            tags = {r.name: r.tenant_registry().current_tag()
                    for r in fleet.replicas}
            check(set(tags.values()) == {tag_full}
                  and router.version() == tag_full,
                  f"fleet: tags after the publish {tags}")
            X = make_rows(rng, 64)
            code, _, body = http_predict(port, X)
            check(code == 200 and body["version"] == tag_full
                  and np.array_equal(np.asarray(body["values"])[:, 0],
                                     booster.predict(X, raw_score=True)),
                  f"fleet: after the publish HTTP {code}, "
                  f"{body.get('version')}")
            placement = router.placement()
            check(sorted(placement) == ["acme", "globex"]
                  and all(len(v) == 2 for v in placement.values()),
                  f"fleet: placement {placement}")
            for tenant in ("acme", "globex"):
                code, _, body = http_predict(port, X[:2], tenant=tenant)
                check(code == 200 and body["version"] == tag_half
                      and np.array_equal(np.asarray(body["values"])[:, 0],
                                         half.predict(X[:2],
                                                      raw_score=True)),
                      f"fleet: tenant {tenant} HTTP {code}, "
                      f"{body.get('version')}")
            health = router.health()
        finally:
            stop.set()
            th.join(timeout=300)
        check(not th.is_alive() and not failed,
              f"run_serve (fleet) did not end: {failed}")
        k4 = check_k4_serving("fleet", prepared, fleet.replicas)
    log(f"  publish {tag_half} -> {tag_full} on {sorted(tags)}; placement "
        f"{json.dumps(placement)}; K4 {json.dumps(k4)}; up in {t_up:.1f} s")
    return {**line, "k4": k4, "launches": dict(pc.launch_counts),
            "version": tag_full, "placement": placement,
            "ejected": health["ejected_replicas"],
            "seconds": time.perf_counter() - t_phase}


OBS_ITERS = 3               # phase 54's training iterations
# the profiler's names of K1's partial stage and of K3's route kernels
# ("void lgbm::hist_partial_kernel<1, 3, false, false>(...)")
K1_KERNEL = re.compile(r"\bhist_partial(_list)?_kernel\b")
K3_KERNEL = re.compile(r"\broute(_global)?_kernel\b")


def phase_obs() -> dict:
    """Phase 54: ``task=train`` through the CLI at the headline width
    (phase 50's 32,768-row valid file as the data and the valid set, so
    that the host binning stays short; OBS_ITERS iterations) with
    ``profile_dir``, ``obs_dir`` and ``obs_trace``, then ``aggregate_dir``
    over OBS_DIR (phases 52-54's artifacts) and the capture.  Gates: the
    merged trace has a lane for each process role and a device lane
    holding K1's and K3's CUDA kernels and their ``lgbm.*`` scopes on the
    card's timeline; the anchor is read; the memory gauges are set; the
    kernel counters equal the launch tables and every nvcc build's
    seconds are in the registry.  A capture that saw no kernel is taken
    again, up to PROFILE_TRIES (a profiler run now and then sees no
    device work)."""
    t_phase = time.perf_counter()
    bd = str(_build.BUILD_DIR)
    prof = os.path.join(bd, "profile")
    valid = os.path.join(bd, "smoke_valid.csv")
    model = os.path.join(bd, "obs_model.txt")
    for attempt in range(PROFILE_TRIES):
        shutil.rmtree(prof, ignore_errors=True)
        reset_counts()
        secs = cli_run(["task=train", f"data={valid}", f"valid={valid}",
                        "objective=binary", "num_leaves=255", "max_bin=63",
                        f"num_iterations={OBS_ITERS}",
                        f"output_model={model}", f"profile_dir={prof}",
                        f"obs_dir={OBS_DIR}", "obs_trace=true",
                        "header=true", "verbosity=0"], [])
        docs = obs_agg.load_profiler_traces(prof)
        kernels = {e["name"] for _, d in docs for e in d["traceEvents"]
                   if e.get("cat") == "kernel"}
        scopes = {e["name"] for _, d in docs for e in d["traceEvents"]
                  if e.get("cat") == "gpu_user_annotation"}
        k1 = sorted(k for k in kernels if K1_KERNEL.search(k))
        k3 = sorted(k for k in kernels if K3_KERNEL.search(k))
        if k1 and k3:
            break
        log(f"  capture {attempt + 1}: {len(kernels)} kernels, K1 {k1}, "
            f"K3 {k3}; again")
    check(len(docs) == 1 and k1 and k3,
          f"obs: the device lane lacks K1 ({k1}) or K3 ({k3}) after "
          f"{attempt + 1} captures")
    check({"lgbm.hist_leaves", "lgbm.route_rows"} <= scopes,
          f"obs: kernel scopes on the card's timeline {sorted(scopes)}")
    anchor = obs_device.read_anchor(prof)
    check(anchor is not None and anchor["identity"]["pid"] == os.getpid()
          and os.path.exists(os.path.join(prof, anchor["trace"])),
          f"obs: anchor {anchor}")
    t0 = time.perf_counter()
    summary = obs_agg.aggregate_dir(OBS_DIR, profile_dir=prof)
    agg_s = time.perf_counter() - t0
    with open(summary["merged_trace"]) as fh:
        merged = json.load(fh)
    with open(summary["merged_metrics"]) as fh:
        metrics = json.load(fh)
    roles = {s["role"]: s["lane"] for s in merged["otherData"]["sources"]}
    lanes = {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    check({"serve-http", "serve-fleet", "train", "device"} <= set(roles)
          and len(set(roles.values())) == len(roles)
          and {roles["serve-http"], roles["train"], roles["device"]}
          <= lanes and summary["device_lanes"] == 1,
          f"obs: lanes {roles}, {summary}")
    dev_lane = [e for e in merged["traceEvents"]
                if e.get("pid") == roles["device"]
                and e.get("cat") == "kernel"]
    check(any(K1_KERNEL.search(e["name"]) for e in dev_lane)
          and any(K3_KERNEL.search(e["name"]) for e in dev_lane),
          "obs: the merged device lane lacks K1's or K3's kernels")
    train_label = [k for k in metrics["processes"]
                   if k.startswith("train-")]
    check(len(train_label) == 1, f"obs: processes {metrics['processes']}")
    snap = metrics["processes"][train_label[0]]
    mem = obs_device.device_memory_stats()
    check(mem is not None and snap.get("device_bytes_in_use", 0) > 0
          and snap.get("device_peak_bytes_in_use", 0) > 0
          and snap.get("device_bytes_limit", 0) > 0,
          f"obs: memory gauges {mem}, "
          f"{ {k: v for k, v in snap.items() if k.startswith('device_')} }")
    bad = []
    for name, table in obs_device.launch_tables():
        for key, value in table.items():
            kernel = key if isinstance(key, str) else repr(key)
            got = snap.get(f'kernel_launches_total{{table="{name}",'
                           f'kernel="{kernel}"}}')
            if got != value:
                bad.append((name, kernel, got, value))
    check(not bad, f"obs: kernel counters against the tables {bad[:5]}")
    builds = {lib: snap.get(f'kernel_build_seconds{{library="{lib}"}}')
              for lib in _build.build_log}
    check(builds and all(v is not None and v > 0 for v in builds.values()),
          f"obs: nvcc build gauges {builds}")
    out = {"captures": attempt + 1, "train_s": secs,
           "sources": summary["sources"], "lanes": summary["lanes"],
           "trace_events": summary["trace_events"],
           "device_kernel_rows": len(dev_lane), "k1_kernels": k1,
           "k3_kernels": k3, "merged_events": summary["merged_events"],
           "aggregate_s": agg_s,
           "memory": {k: snap.get(k) for k in ("device_bytes_in_use",
                                               "device_peak_bytes_in_use",
                                               "device_bytes_limit")},
           "kernel_counters": sum(len(t) for _, t in
                                  obs_device.launch_tables()),
           "nvcc_seconds": builds,
           "seconds": time.perf_counter() - t_phase}
    log(f"  obs: {json.dumps(out)}")
    return out


STREAM_ROWS = 200_000       # phase 55's rows (bench.py:1836 measure_stream)
STREAM_HELD_ROWS = 65536    # its held-out rows, scored through K4
STREAM_BLOCK_ROWS = 4096    # 49 blocks, the last of 3,392 rows
STREAM_ONE_BLOCK = 262144   # (c): stream_enable with one block of them all
STREAM_ITERS = 3
STREAM_CLI_ITERS = 2
STREAM_AUC_TOL = 1e-3
# bench.py:1843-1849, measure_stream's own parameters
STREAM_PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
                 "learning_rate": 0.1, "min_data_in_leaf": 20,
                 "verbosity": -1, "tree_growth": "leafwise_masked",
                 "seed": 7, "bagging_fraction": 0.8, "bagging_freq": 2,
                 "feature_fraction": 0.9}


def auc_of(y, p) -> float:
    """The ROC AUC of scores ``p`` for labels ``y`` (ties share their
    mean rank)."""
    order = np.argsort(p, kind="mergesort")
    ps = p[order]
    ranks = np.empty(len(p), np.float64)
    edges = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1], True])
    for a, b in zip(edges[:-1], edges[1:]):
        ranks[order[a:b]] = 0.5 * (a + b - 1) + 1.0
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


class BlockRecorder:
    """Clones the inputs of K1's last one-slot call at each row count
    (a full block and the tail block): the block buffers are reused by
    the next upload, so the call's own tensors are gone by the end."""

    def __init__(self, sizes):
        self.sizes, self.last = set(sizes), {}

    def __enter__(self):
        self._orig = hc.hist_leaves

        def wrapped(binned, g3, leaf_id, num_leaves, num_bins, *a, **kw):
            n = int(binned.shape[1])
            if int(num_leaves) == 1 and n in self.sizes:
                self.last[n] = (binned.clone(), g3.clone(), leaf_id.clone(),
                                int(num_bins))
            return self._orig(binned, g3, leaf_id, num_leaves, num_bins,
                              *a, **kw)

        hc.hist_leaves = wrapped
        return self

    def __exit__(self, *exc):
        hc.hist_leaves = self._orig


def stream_bound(n, F_, B, L, block_rows) -> int:
    """bench.py:1877-1880, measure_stream's device bound in bytes: the
    leaf-sized state (the pool and three accumulators), two blocks in
    flight four times over (bins, g3, leaf ids), one (N,) draw a bagging
    period and a MiB of small state."""
    return ((L + 3) * F_ * B * 3 * 4 + 4 * block_rows * (F_ + 12 + 4)
            + 8 * n + (1 << 20))


def stream_k1_launches(booster, n_blocks) -> int:
    """K1's launches a streamed training makes: each tree's root pass and
    each split's pass fold every block once (twice without the pool)."""
    per_split = 1 if booster._gbdt._grow.use_pool else 2
    return sum(n_blocks * (1 + (int(t.num_leaves) - 1) * per_split)
               for t in booster._gbdt._device_trees)


def stream_spans(ring, iters, s_per_iter) -> dict:
    """The host's time in each ``stream.*`` span of a traced streamed
    training (obs/trace.py): count, ms an iteration and us a span, and
    the share of the iteration's wall they cover together."""
    check(ring["dropped"] == 0, f"stream: the tracer dropped "
          f"{ring['dropped']} spans")
    tot, cnt = {}, {}
    for name, _cat, _t0, dur, _tid, _args in ring["events"]:
        if name.startswith("stream."):
            tot[name] = tot.get(name, 0) + dur
            cnt[name] = cnt.get(name, 0) + 1
    out = {n: {"count": cnt[n], "ms_per_iter": tot[n] / iters / 1e6,
               "us_per_span": tot[n] / cnt[n] / 1e3} for n in sorted(tot)}
    out["share_of_wall"] = sum(tot.values()) / 1e9 / (iters * s_per_iter)
    return out


def stream_k1_row(rec, launches) -> dict:
    """K1 on (b)'s last full block and tail block: bit for bit the
    row-order version in every precision (``check_k1``), then timed at
    the full block beside its plain version, one ``index_add_`` and its
    bound: by events (at this size mostly the wrapper's enqueue) and its
    two kernels' device time by torch.profiler, warm and with the L2
    cleared (None where a profile saw no kernel)."""
    checks = [check_k1(f"streamed block N={n} L=1", binned, g3, lid, 1, B)
              for n, (binned, g3, lid, B) in sorted(rec.last.items())]
    binned, g3, lid, B = rec.last[STREAM_BLOCK_ROWS]
    Fn, N = binned.shape
    k1 = functools.partial(hc.hist_leaves, binned, g3, lid, 1, B)
    ms = time_ms(k1, 50)
    names = ("hist_partial_kernel", "hist_merge_kernel")
    device_ms = sum(kernel_device_ms(k1, names).values()) or None
    cold_ms = sum(cold_device_ms(k1, names).values()) or None
    plain_ms = time_ms(lambda: hc.hist_leaves_ref(binned, g3, lid, 1, B), 5)
    flat = (torch.arange(Fn, device=binned.device)[:, None] * B
            + binned.long()).reshape(-1)
    vals = g3.repeat(Fn, 1)
    acc = torch.zeros((Fn * B, 3), dtype=torch.float32,
                      device=binned.device)
    library_ms = time_ms(lambda: acc.index_add_(0, flat, vals), 20)
    nbytes = Fn * N + N * 12 + N * 4 + Fn * B * 3 * 4
    ops = 2 * 3 * N * Fn
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    row = {"N": N, "L": 1, "precision": "bf16x2", "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "launches": launches,
           "device_ms": device_ms, "device_ms_l2_cleared": cold_ms,
           "max_abs_err": max(c["max_abs_err"] for c in checks),
           "checks": checks}
    log(f"  K1 at a streamed block (N={N}, L=1): {ms:.4f} ms by events, "
        f"device {fmt_ms(device_ms)}, L2 cleared {fmt_ms(cold_ms)} (plain "
        f"{plain_ms:.2f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms by {row['bound_by']}); {launches} "
        "launches in (b)")
    return row


def phase_stream(seed, dev) -> dict:
    """Phase 55: out-of-core streaming training on the card at
    measure_stream's configuration (STREAM_ROWS rows of the bench
    generator, STREAM_PARAMS, STREAM_ITERS iterations, blocks of
    STREAM_BLOCK_ROWS rows).  (a) resident training; (b) the block cache
    written (``save_block_cache``) and trained from (``Dataset(dir)``),
    ``stream_prefetch`` on (timed, launch counts and the allocator's peak
    taken) and then off (K1's block inputs recorded); (c)
    ``stream_enable`` with one block of them all; (d) ``task=save_binary``
    on phase 50's 32,768-row valid file (8 blocks), then ``task=train
    data=<dir>``.  Gates: (c) is (a)
    byte for byte; (b)'s two runs agree byte for byte; K1's launches in
    (b) are every block of every pass and no plain histogram ran; K1 on a
    full and the tail block bit for bit its row-order version; the
    ledger's peak and the allocator's peak over (b) within
    measure_stream's bound; (d) streams through K1 and writes the Python
    API's text; (b)'s held-out AUC, served by K4, within STREAM_AUC_TOL of
    (a)'s."""
    t_phase = time.perf_counter()
    bd = str(_build.BUILD_DIR)
    params = dict(STREAM_PARAMS)
    X, y = make_data(STREAM_ROWS, seed + 13)
    Xh, yh = make_data(STREAM_HELD_ROWS, seed + 14)
    ds = Dataset(X, label=y, params=params)
    ds.construct()
    matrix_bytes = int(ds._binned.binned.nbytes)
    out = {"rows": STREAM_ROWS, "block_rows": STREAM_BLOCK_ROWS,
           "iters": STREAM_ITERS, "resident_matrix_bytes": matrix_bytes}

    def timed_train(p, data, iters=STREAM_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = train(dict(p), data, iters)
        torch.cuda.synchronize()
        return b, (time.perf_counter() - t0) / iters

    reset_counts()
    b_res, res_s = timed_train(params, ds)
    text_res = b_res.model_to_string()
    check(hc.launch_counts["hist_leaves"] > 0, "stream (a): K1 never "
          "launched")

    b_one, _ = timed_train(dict(params, stream_enable=True,
                                stream_block_rows=STREAM_ONE_BLOCK), ds)
    check(isinstance(b_one._gbdt, gbdt_stream.StreamingGBDT)
          and b_one._gbdt._source.num_blocks == 1,
          "stream (c): not one streamed block")
    check(b_one.model_to_string() == text_res,
          "stream (c): one streamed block is not the resident model text")
    del b_one

    cache = os.path.join(bd, "stream.blocks")
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    ds.save_block_cache(cache, block_rows=STREAM_BLOCK_ROWS)
    out["cache_write_s"] = time.perf_counter() - t0
    sds = Dataset(cache, params=params)
    source = sds.construct()._binned.source
    nb = source.num_blocks
    check(nb == 49 and source.ranges[-1][1] - source.ranges[-1][0] == 3392,
          f"stream (b): {nb} blocks, last {source.ranges[-1]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    b_str, str_s = timed_train(params, sds)
    alloc_peak = torch.cuda.max_memory_allocated() - base
    launches = hc.launch_counts["hist_leaves"]
    plain = {k: v for k, v in hc.plain_counts.items() if v}
    scans = scan_launches(STREAM_ITERS)
    text_str = b_str.model_to_string()
    gb = b_str._gbdt
    check(isinstance(gb, gbdt_stream.StreamingGBDT), "stream (b): not the "
          "streaming trainer")
    want = stream_k1_launches(b_str, nb)
    check(launches == want, f"stream (b): K1 launched {launches} times, "
          f"every block of every pass is {want}")
    check(not plain, f"stream (b): plain histograms ran {plain}")
    # the root's scan and one a split (both children in one launch)
    want_scans = sum(int(t.num_leaves) for t in gb._device_trees)
    check(scans["launches"] == want_scans, f"stream (b): the split scan "
          f"launched {scans['launches']} times, a tree's root and splits "
          f"are {want_scans}")
    obs_trace.reset()
    obs_trace.arm(1 << 16)
    with BlockRecorder((STREAM_BLOCK_ROWS, 3392)) as rec:
        b_off, off_s = timed_train(dict(params, stream_prefetch=False), sds)
    spans = stream_spans(obs_trace.drain(), STREAM_ITERS, off_s)
    obs_trace.reset()
    check(b_off.model_to_string() == text_str,
          "stream (b): prefetch on and off differ")
    check(sorted(rec.last) == [3392, STREAM_BLOCK_ROWS],
          f"stream (b): K1 block shapes {sorted(rec.last)}")
    bound = stream_bound(STREAM_ROWS, F, 64, params["num_leaves"],
                         STREAM_BLOCK_ROWS)
    peak = gb.stream_peak_device_bytes
    check(peak <= bound, f"stream (b): ledger peak {peak} > bound {bound}")
    check(alloc_peak <= bound, f"stream (b): allocator peak {alloc_peak} "
          f"> bound {bound}")
    h2d_root = STREAM_ROWS * (F + 12)
    h2d_split = STREAM_ROWS * (F + 12 + 4)
    out.update({
        "resident_s_per_iter": res_s, "stream_s_per_iter": str_s,
        "stream_noprefetch_s_per_iter": off_s,
        "stream_vs_resident_ratio": str_s / res_s,
        "ledger_peak_bytes": peak, "ledger_peak_tags": dict(gb._ledger
                                                            .peak_tags),
        "allocator_peak_bytes": int(alloc_peak), "bound_bytes": int(bound),
        "blocks": nb, "k1_launches": launches,
        "split_scan_launches": scans["launches"],
        "noprefetch_host_spans": spans,
        "h2d_bytes_root_pass": h2d_root, "h2d_bytes_split_pass": h2d_split,
        "splits": [int(t.num_leaves) - 1 for t in gb._device_trees]})
    out["k1"] = stream_k1_row(rec, launches)
    del rec, b_off

    pc.reset_launch_counts()
    p_res = b_res.predict(Xh, predict_method="fused")
    p_str = b_str.predict(Xh, predict_method="fused")
    check(pc.launch_counts["serving_fused"] > 0, "stream: K4 never served "
          "the held-out rows")
    auc_res, auc_str = auc_of(yh, p_res), auc_of(yh, p_str)
    check(abs(auc_str - auc_res) <= STREAM_AUC_TOL,
          f"stream (b): held-out AUC {auc_str} vs resident {auc_res}")
    out.update({"resident_auc": auc_res, "stream_auc": auc_str})
    del b_res, b_str, sds, ds

    csv_path = os.path.join(bd, "smoke_valid.csv")
    cli_cache = os.path.join(bd, "stream_cli.blocks")
    shutil.rmtree(cli_cache, ignore_errors=True)
    model = os.path.join(bd, "stream_cli_model.txt")
    knobs = [f"{k}={v}" for k, v in params.items() if k != "verbosity"]
    save_s = cli_run(["task=save_binary", f"data={csv_path}", "header=true",
                      "max_bin=63", f"stream_cache_dir={cli_cache}",
                      f"stream_block_rows={STREAM_BLOCK_ROWS}",
                      "verbosity=1"], [])
    reset_counts()
    lines = []
    train_s = cli_run(["task=train", f"data={cli_cache}", *knobs,
                       f"num_iterations={STREAM_CLI_ITERS}",
                       f"output_model={model}", "verbosity=1"], lines)
    k1 = hc.launch_counts["hist_leaves"]
    plain = {k: v for k, v in hc.plain_counts.items() if v}
    check(any("Streaming trainer:" in ln for ln in lines),
          "stream (d): task=train did not stream the cache")
    check(k1 > 0 and not plain, f"stream (d): K1 {k1}, plain {plain}")
    api = train(dict(params), Dataset(cli_cache, params=params),
                STREAM_CLI_ITERS)
    with open(model) as fh:
        check(fh.read() == api.model_to_string(),
              "stream (d): the CLI's model is not the Python API's")
    out["cli"] = {"save_binary_s": save_s, "train_s": train_s,
                  "k1_launches": k1,
                  "blocks": len(load_manifest(cli_cache)["blocks"])}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  stream: {json.dumps({k: v for k, v in out.items() if k != 'k1'})}")
    log(f"  streamed {str_s:.4f} s/iteration (prefetch off {off_s:.4f}), "
        f"resident {res_s:.4f}, ratio {str_s / res_s:.2f}; ledger peak "
        f"{peak} B, allocator peak {alloc_peak} B, bound {bound} B, "
        f"resident matrix {matrix_bytes} B")
    log("  host spans of the prefetch-off run: " + ", ".join(
        f"{n} {v['ms_per_iter']:.1f} ms/iteration ({v['count']} x "
        f"{v['us_per_span']:.1f} us)" for n, v in spans.items()
        if n != "share_of_wall")
        + f"; {spans['share_of_wall']:.3f} of the wall")
    return out


# ---------------------------------------------------------------------------
# the data, voting and feature learners over two gloo ranks (phase 56)
# ---------------------------------------------------------------------------

PAR_ROWS = 262144           # phase 56's rows, each rank taking half
PAR_HELD_ROWS = 65536       # its held-out rows, served through K4
PAR_ITERS = 5
PAR_CLI_ITERS = 2
PAR_AUC_TOL = 1e-3
PAR_WORLD = 2               # two ranks on the one card: gloo
PAR_TIMEOUT_S = 300         # a rank's work from the job file to its exit
PAR_WAIT_S = 1200           # a rank's wait for the job file
# (b)-(f): the learners and collectives, each over the two ranks
PAR_LEGS = (("b", {"tree_learner": "data"}),
            ("c", {"tree_learner": "data",
                   "data_parallel_collective": "allreduce"}),
            ("d", {"tree_learner": "voting", "top_k": 5}),
            ("e", {"tree_learner": "voting", "top_k": 28}),
            ("f", {"tree_learner": "feature"}))
# the legs that grow (a)'s trees: one K1 launch a round, one scan a round
PAR_SAME_TREES = ("b", "c", "e", "f")
# the legs whose last K1 and scan inputs each rank holds against the plain
# versions: a row shard (b) and a feature slice, a view of the bins (f)
PAR_CHECKED = ("b", "f")
_BIND_RACE = ("address already in use", "errno 98", "eaddrinuse")


def tree_structure(text) -> list:
    """Each tree's (leaves, split features, thresholds) of a model text."""
    from lightgbmv1_tpu_torch.io.model_text import model_from_string

    return [(t.num_leaves, tuple(int(f) for f in t.split_feature),
             tuple(float(v) for v in t.threshold))
            for t in model_from_string(text).trees]


def first_split_diff(text_a, text_b):
    """The first node whose split differs between two model texts, with
    both gains (None where the structures agree)."""
    from lightgbmv1_tpu_torch.io.model_text import model_from_string

    ta, tb = (model_from_string(t).trees for t in (text_a, text_b))
    for i, (a, b) in enumerate(zip(ta, tb)):
        n = min(a.num_leaves, b.num_leaves) - 1
        for j in range(n):
            if (a.split_feature[j], a.threshold[j]) != \
                    (b.split_feature[j], b.threshold[j]):
                return (f"tree {i} node {j}: feature {a.split_feature[j]} "
                        f"at {a.threshold[j]!r} gain {a.split_gain[j]!r} "
                        f"vs feature {b.split_feature[j]} at "
                        f"{b.threshold[j]!r} gain {b.split_gain[j]!r}")
        if a.num_leaves != b.num_leaves:
            return f"tree {i}: {a.num_leaves} vs {b.num_leaves} leaves"
    return None if len(ta) == len(tb) else "tree counts differ"


def comm_mismatches(calls, learner, collective, F_, B, top_k, world):
    """The collective calls of a leg whose payload is not the analytic
    table's (obs/metrics.comm_table_per_round) at the call's width: a
    histogram reduction of k slots (voting: of 2k children), a SplitInfo
    election or a vote of 2k children, a root sum."""
    from lightgbmv1_tpu_torch.obs.metrics import comm_table_per_round

    kw = dict(F=F_, B=B, ndev=world)
    if learner == "voting":
        kw["sel_k"] = min(2 * max(1, min(top_k, F_)), F_)
    bad, checked = [], 0
    for op, part, shape, nbytes in calls:
        if part == "hist":
            lead = shape[0] if len(shape) == 4 else 1
            k, key = (lead / 2 if learner == "voting" else lead), \
                "hist_bytes"
        elif part in ("split_sync", "vote"):
            k, key = shape[0] / 2, part + "_bytes"
        elif part == "g3":
            k, key = 1, "g3_bytes_per_tree"
        else:
            continue
        want = comm_table_per_round(learner, collective, k=k, **kw)[key]
        checked += 1
        if nbytes != want:
            bad.append([op, part, list(shape), nbytes, want])
    return bad, checked


def rank_kernel_checks(name, rank, world, hrec, srec, F_, rows) -> dict:
    """On one rank after leg ``name``: K1 on its last inputs at each
    (slots, precision) of the leg's ladder bit for bit the row-order plain
    version, and the split scan on its last inputs at each child count
    bit for bit the CPU plain scan (``check_scan``).  The shapes are the
    leg's own: (b) a shard of ``rows`` rows and all F features, (f) all
    rows and this rank's F/D features, a view of the bins at their
    storage offset; every scan's mask keeps this rank's columns only."""
    F_loc = -(-F_ // world)
    lo = rank * F_loc
    k1 = []
    check(hrec.last, f"parallel ({name}) rank {rank}: no K1 call recorded")
    for (L, prec), (binned, g3, lid, B, live) in sorted(hrec.last.items()):
        check(prec in hc.FLOAT_PRECISIONS, f"parallel ({name}): K1 at {prec}")
        Fb, N = binned.shape
        want_shape = (F_loc, rows) if name == "f" else (F_, rows)
        check((Fb, N) == want_shape, f"parallel ({name}) rank {rank}: K1 on "
              f"{(Fb, N)} bins, not {want_shape}")
        if name == "f":
            check(binned.storage_offset() == lo * N and binned.is_contiguous(),
                  f"parallel (f) rank {rank}: K1's bins are not the view of "
                  f"features {lo}-{lo + F_loc} (offset "
                  f"{binned.storage_offset()})")
        got = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        row = hc.hist_leaves_roworder_ref(binned, g3, lid, L, B, prec, live)
        check(same_bits(got, row), f"parallel ({name}) rank {rank}: K1 at "
              f"L={L} {prec} not bitwise the row-order version "
              f"({int((got != row).sum())} cells differ)")
        k1.append({"L": int(L), "precision": prec, "bins": [Fb, N],
                   "offset": int(binned.storage_offset()),
                   "live": None if live is None else int(live)})
    scans = []
    check(srec.last, f"parallel ({name}) rank {rank}: no scan recorded")
    for C, (hist, mask, csums, kw) in sorted(srec.last.items()):
        cols = mask.reshape(-1, mask.shape[-1]).any(dim=0).nonzero()
        cols = [int(c) for c in cols.flatten()]
        check(cols and all(lo <= c < lo + F_loc for c in cols),
              f"parallel ({name}) rank {rank}: the scan at C={C} searched "
              f"features {cols}, not within {lo}-{lo + F_loc}")
        scans.append(dict(check_scan(f"parallel ({name}) rank {rank} C={C}",
                                     hist, mask, csums, kw),
                          C=int(C), features=[cols[0], cols[-1]]))
    return {"k1": k1, "scan": scans}


def parallel_rank(rank: int, job_path: str) -> int:
    """One rank of phase 56 (``chip_smoke.py --parallel-rank R
    --parallel-job J``): joins the group, trains each leg of the job on
    its rows of the binned set, counts (reset just before each leg) K1's
    and the split scan's launches, the plain versions' and the
    collectives' calls, holds every collective call to the analytic
    table, then runs the CLI leg (``task=train tree_learner=data
    num_machines=2`` through the machine list) and writes its results."""
    from lightgbmv1_tpu_torch import cli
    from lightgbmv1_tpu_torch.parallel import cluster
    from lightgbmv1_tpu_torch.parallel import collectives as coll

    # started before phase 55: the context on the card, then the job
    torch.zeros(1, device="cuda")
    deadline = time.perf_counter() + PAR_WAIT_S
    while not os.path.exists(job_path):
        if time.perf_counter() > deadline:
            print(f"rank {rank}: no job file {job_path}", flush=True)
            return 3
        time.sleep(0.05)
    with open(job_path) as fh:
        job = json.load(fh)
    group = cluster.init_cluster(
        coordinator_address=f"127.0.0.1:{job['port']}",
        num_processes=PAR_WORLD, process_id=rank, device="cuda")
    params = dict(job["params"])
    ds = Dataset(job["bin"], params=params)
    ds.construct()
    B = int(ds._binned.padded_bin)
    out = {"rank": rank, "backend": group.backend, "legs": {}}
    # one untimed iteration first: the ranks' first collectives and
    # kernel loads are no leg's
    train(dict(params, tree_learner="data"), ds, 1)
    for name, extra in job["legs"]:
        p = dict(params, **extra)
        reset_counts()
        coll.reset_counts()
        coll.call_log = []
        torch.cuda.synchronize()
        group.barrier()
        with HistRecorder(clone=name in PAR_CHECKED) as hrec, \
                ScanRecorder() as srec:
            t0 = time.perf_counter()
            booster = train(p, ds, job["iters"])
            torch.cuda.synchronize()
            s_iter = (time.perf_counter() - t0) / job["iters"]
        calls = list(coll.call_log)
        coll.call_log = None
        path = os.path.join(job["out"], f"par_{name}.rank{rank}.txt")
        with open(path, "w") as fh:
            fh.write(booster.model_to_string())
        bad, checked = comm_mismatches(
            calls, p["tree_learner"],
            p.get("data_parallel_collective", "reduce_scatter"), F, B,
            p.get("top_k", 20), group.world)
        out["legs"][name] = {
            "text": path, "s_per_iter": s_iter,
            "k1": hc.launch_counts["hist_leaves"],
            "split_scan": sc.launch_counts["split_scan"],
            "plain": {k: v for k, v in list(hc.plain_counts.items())
                      + list(sc.plain_counts.items()) if v},
            "collectives": {k: dict(v) for k, v in coll.counts.items()},
            "part_bytes": dict(coll.part_bytes),
            "comm_calls_checked": checked, "comm_mismatches": bad[:5],
            "comm_mismatch_count": len(bad)}
        if name in PAR_CHECKED:         # after the leg's counts are read
            out["legs"][name]["checks"] = rank_kernel_checks(
                name, rank, group.world, hrec, srec, F,
                -(-ds.num_data() // group.world) if name != "f"
                else ds.num_data())
        del booster, hrec, srec
    cluster.shutdown()
    c = job["cli"]
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["task=train", f"data={c['csv']}", "header=true",
                   "tree_learner=data", f"num_machines={PAR_WORLD}",
                   "machines=" + ",".join(f"127.0.0.1:{p}"
                                          for p in c["ports"]),
                   f"local_listen_port={c['ports'][rank]}",
                   f"num_iterations={c['iters']}",
                   f"output_model={c['model']}", "max_bin=63",
                   "num_leaves=255", "objective=binary", "verbosity=-1"])
    torch.cuda.synchronize()
    out["cli"] = {"rc": rc, "seconds": time.perf_counter() - t0,
                  "k1": hc.launch_counts["hist_leaves"],
                  "split_scan": sc.launch_counts["split_scan"],
                  "plain": {k: v for k, v in hc.plain_counts.items() if v}}
    with open(os.path.join(job["out"], f"par_result_{rank}.json"),
              "w") as fh:
        json.dump(out, fh)
    return 0


PAR_GRACE_S = 20            # the other ranks' time to end once one failed


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _rank_log(job_path: str, r: int) -> str:
    return os.path.join(os.path.dirname(job_path), f"par_rank{r}.log")


def start_ranks(job_path: str) -> list:
    """Phase 56's two rank processes (this script with --parallel-rank),
    started before phase 55 so that their start-up (the interpreter,
    torch, the port, a context on the card) runs beside it; each waits
    for ``job_path``, which phase 56 writes, and writes its output to its
    log beside it.  Whatever happens, they are stopped when this process
    exits."""
    for stale in [job_path] + [os.path.join(os.path.dirname(job_path),
                                            f"par_result_{r}.json")
                               for r in range(PAR_WORLD)]:
        if os.path.exists(stale):
            os.remove(stale)
    here = os.path.abspath(__file__)
    procs = []
    for r in range(PAR_WORLD):
        with open(_rank_log(job_path, r), "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, here, "--parallel-rank", str(r),
                 "--parallel-job", job_path], cwd=os.path.dirname(here),
                stdout=fh, stderr=subprocess.STDOUT, text=True))
    atexit.register(_stop, procs)
    return procs


def join_ranks(procs, job_path: str) -> list:
    """Each rank's (exit code, output) once all have exited: a rank that
    fails leaves the others PAR_GRACE_S (a rank whose peer is gone waits
    on it), a rank still running PAR_TIMEOUT_S after the job was written
    is stopped."""
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            deadline = min(deadline, time.perf_counter() + PAR_GRACE_S)
        if time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    _stop(procs)
    outs = []
    for r, p in enumerate(procs):
        with open(_rank_log(job_path, r)) as fh:
            outs.append((p.returncode, fh.read()))
    return outs


def distinct_free_ports(n: int) -> list:
    """``n`` ports free now and distinct from each other."""
    ports = []
    while len(ports) < n:
        p = find_free_port()
        if p not in ports:
            ports.append(p)
    return ports


def run_ranks(ranks, job, job_path: str) -> list:
    """Writes ``job`` with fresh ports (the group's and the CLI's two, all
    distinct) for the waiting ``ranks`` and returns their results.  A port
    taken between its pick and a rank's bind fails that rank with
    EADDRINUSE: then two new ranks run the job once more on new ports.  A
    rank that fails otherwise fails the phase."""
    for attempt in range(2):
        group_port, *cli_ports = distinct_free_ports(1 + PAR_WORLD)
        job = dict(job, port=group_port, cli=dict(job["cli"],
                                                  ports=cli_ports))
        with open(job_path + ".tmp", "w") as fh:
            json.dump(job, fh)
        os.replace(job_path + ".tmp", job_path)
        outs = join_ranks(ranks, job_path)
        race = any(rc != 0 and any(w in o.lower() for w in _BIND_RACE)
                   for rc, o in outs)
        if not race or attempt:
            break
        log("  parallel: a port was taken before a rank bound it; the "
            "ranks run again on new ports")
        ranks = start_ranks(job_path)
    for r, (rc, o) in enumerate(outs):
        check(rc == 0, f"parallel: rank {r} exited {rc}:\n{o[-4000:]}")
    res = []
    for r in range(PAR_WORLD):
        with open(os.path.join(os.path.dirname(job_path),
                               f"par_result_{r}.json")) as fh:
            res.append(json.load(fh))
    return res


def phase_parallel(seed, dev, ranks, job_path) -> dict:
    """Phase 56: the parallel learners over two gloo ranks on the one
    card.  (a) the serial learner at the headline width (PAR_ROWS rows,
    TRAIN_PARAMS, PAR_ITERS iterations) in this process; then one spawn
    of two ranks, each taking its rows of the same binned set, trains
    (b) data with reduce_scatter, (c) data with allreduce, (d) voting at
    top_k 5 (2k = 10 < 28, a real vote), (e) voting at top_k 28, (f)
    feature, and runs the CLI (``task=train tree_learner=data
    num_machines=2``) on phase 50's 32,768-row file.  Gates: the ranks'
    texts byte for byte in every leg; (b), (c), (e) and (f) structurally
    identical to each other and (b) to (a); each rank's K1 and
    split-scan launches non-zero, equal across ranks, and for (b), (c),
    (e), (f) (a)'s; after (b) and (f) each rank's last K1 and scan inputs
    held against the plain versions bit for bit (``rank_kernel_checks``);
    no plain histogram or scan on a leg; every collective's payload the
    analytic table's; each leg's held-out AUC, served by K4, within
    PAR_AUC_TOL of (a)'s; the CLI's ranks launched K1 and wrote a model
    that loads.  ``ranks``: the processes ``start_ranks(job_path)``
    started, waiting for the job this writes (``run_ranks``)."""
    t_phase = time.perf_counter()
    bd = str(_build.BUILD_DIR)
    card = nvidia_smi()
    params = dict(TRAIN_PARAMS)
    X, y = make_data(PAR_ROWS, seed + 21)
    Xh, yh = make_data(PAR_HELD_ROWS, seed + 22)
    ds = Dataset(X, label=y, params=params)
    ds.construct()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = train(dict(params), ds, PAR_ITERS)
    torch.cuda.synchronize()
    serial_s = (time.perf_counter() - t0) / PAR_ITERS
    k1_a = hc.launch_counts["hist_leaves"]
    scan_a = sc.launch_counts["split_scan"]
    check(k1_a > 0 and scan_a > 0, f"parallel (a): K1 {k1_a}, scan "
          f"{scan_a}")
    text_a = serial.model_to_string()
    pc.reset_launch_counts()
    auc_a = auc_of(yh, serial.predict(Xh, predict_method="fused"))
    check(pc.launch_counts["serving_fused"] > 0, "parallel (a): K4 never "
          "served the held-out rows")
    del serial
    bin_path = os.path.join(bd, "par_train.bin")
    ds.save_binary(bin_path)
    del ds, X
    model_cli = os.path.join(bd, "par_cli_model.txt")
    if os.path.exists(model_cli):
        os.remove(model_cli)
    job = {"bin": bin_path, "params": params,
           "iters": PAR_ITERS, "legs": [[n, e] for n, e in PAR_LEGS],
           "out": bd,
           "cli": {"csv": os.path.join(bd, "smoke_valid.csv"),
                   "model": model_cli,
                   "iters": PAR_CLI_ITERS}}
    t_spawn = time.perf_counter()
    res = run_ranks(ranks, job, job_path)
    spawn_s = time.perf_counter() - t_spawn
    check([r["backend"] for r in res] == ["gloo"] * PAR_WORLD,
          f"parallel: backends {[r['backend'] for r in res]}")
    out = {"rows": PAR_ROWS, "iters": PAR_ITERS, "card": card,
           "serial": {"s_per_iter": serial_s, "k1": k1_a,
                      "split_scan": scan_a, "auc": auc_a},
           "legs": {}, "ranks_seconds": spawn_s}
    log(f"  (a) serial: {serial_s:.4f} s/iteration, K1 {k1_a}, split scan "
        f"{scan_a}, held-out AUC {auc_a:.6f} ({card})")
    struct_a = tree_structure(text_a)
    structs = {}
    for name, extra in PAR_LEGS:
        legs = [r["legs"][name] for r in res]
        texts = []
        for leg in legs:
            with open(leg["text"]) as fh:
                texts.append(fh.read())
        check(texts[0] == texts[1], f"parallel ({name}): the ranks' model "
              "texts differ")
        structs[name] = tree_structure(texts[0])
        for r, leg in enumerate(legs):
            check(leg["k1"] > 0 and leg["split_scan"] > 0,
                  f"parallel ({name}) rank {r}: K1 {leg['k1']}, scan "
                  f"{leg['split_scan']}")
            check(not leg["plain"], f"parallel ({name}) rank {r}: plain "
                  f"versions ran {leg['plain']}")
            check(leg["comm_calls_checked"] > 0
                  and leg["comm_mismatch_count"] == 0,
                  f"parallel ({name}) rank {r}: collective payloads off "
                  f"the table: {leg['comm_mismatches']}")
        check(legs[0]["k1"] == legs[1]["k1"]
              and legs[0]["split_scan"] == legs[1]["split_scan"],
              f"parallel ({name}): launches differ across ranks")
        pc.reset_launch_counts()
        auc = auc_of(yh, Booster(model_str=texts[0]).predict(
            Xh, predict_method="fused"))
        check(pc.launch_counts["serving_fused"] > 0, f"parallel ({name}): "
              "K4 never served the held-out rows")
        check(abs(auc - auc_a) <= PAR_AUC_TOL, f"parallel ({name}): "
              f"held-out AUC {auc} vs (a)'s {auc_a}")
        on_cuda = {op: c["cuda"] for op, c in legs[0]["collectives"].items()
                   if c["cuda"]}
        check(all(c["cuda"] == c["calls"]
                  for op, c in legs[0]["collectives"].items()
                  if op != "all_gather_object"),
              f"parallel ({name}): a collective left the card: "
              f"{legs[0]['collectives']}")
        out["legs"][name] = {
            "params": extra, "s_per_iter": [lg["s_per_iter"] for lg in legs],
            "k1": [lg["k1"] for lg in legs],
            "split_scan": [lg["split_scan"] for lg in legs],
            "auc": auc, "collectives": legs[0]["collectives"],
            "part_bytes": legs[0]["part_bytes"], "gloo_cuda": on_cuda,
            "comm_calls_checked": legs[0]["comm_calls_checked"]}
        log(f"  ({name}) {json.dumps(extra)}: "
            f"{max(lg['s_per_iter'] for lg in legs):.4f} s/iteration beside "
            f"(a)'s {serial_s:.4f} ({card}); K1 {legs[0]['k1']}, split scan "
            f"{legs[0]['split_scan']} a rank; AUC {auc:.6f}; gloo took "
            f"CUDA tensors for {on_cuda or 'no call'} (none staged through "
            f"the host); bytes by part {legs[0]['part_bytes']}")
    for name in PAR_CHECKED:
        chk = [r["legs"][name].get("checks") for r in res]
        check(all(c and c["k1"] and c["scan"] for c in chk),
              f"parallel ({name}): a rank held no K1 or scan input against "
              "its plain version")
        out["legs"][name]["checks"] = chk
        log(f"  ({name}) K1 bit for bit its row-order version on each "
            f"rank's last inputs: " + "; ".join(
                f"rank {r} L={[k['L'] for k in c['k1']]} bins "
                f"{c['k1'][0]['bins']} at offset {c['k1'][0]['offset']}"
                for r, c in enumerate(chk)) + "; the split scan bit for "
            "bit the CPU plain scan at C=" + "; ".join(
                f"rank {r} {[x['C'] for x in c['scan']]} on features "
                f"{c['scan'][0]['features']}" for r, c in enumerate(chk)))
    for name in PAR_SAME_TREES:
        check(structs[name] == structs["b"], f"parallel ({name}): not (b)'s "
              "trees")
        legs = [r["legs"][name] for r in res]
        check(legs[0]["k1"] == k1_a and legs[0]["split_scan"] == scan_a,
              f"parallel ({name}): K1 {legs[0]['k1']} / scan "
              f"{legs[0]['split_scan']} a rank against (a)'s {k1_a} / "
              f"{scan_a} on the same trees")
    with open(res[0]["legs"]["b"]["text"]) as fh:
        diff = first_split_diff(text_a, fh.read())
    out["b_vs_a_first_diff"] = diff
    check(structs["b"] == struct_a, f"parallel (b): not (a)'s trees: {diff}")
    for r, c in enumerate(r_["cli"] for r_ in res):
        check(c["rc"] == 0 and c["k1"] > 0 and not c["plain"],
              f"parallel CLI rank {r}: {c}")
    cli_text = open(model_cli).read()
    check(len(Booster(model_str=cli_text)._all_trees()) == PAR_CLI_ITERS,
          "parallel CLI: the model does not hold its trees")
    out["cli"] = [r["cli"] for r in res]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  CLI task=train tree_learner=data num_machines=2: "
        f"{max(c['seconds'] for c in out['cli']):.2f} s ({card}), K1 "
        f"{[c['k1'] for c in out['cli']]}; the ranks' work "
        f"{spawn_s:.1f} s of the phase's {out['seconds']:.1f} s ({card})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--train-rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reg-iters", type=int, default=20)
    # the level-wise, multiclass and lambdarank depths, cut from 100 / 50 /
    # 100 to make room for phases 49-51
    ap.add_argument("--level-iters", type=int, default=40)
    ap.add_argument("--mc-iters", type=int, default=20)
    ap.add_argument("--rank-iters", type=int, default=40)
    # phase 56 starts this script as its ranks with these two
    ap.add_argument("--parallel-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--parallel-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this runs "
              "the port on a CUDA card", file=sys.stderr)
        return 2
    if args.parallel_rank is not None:
        return parallel_rank(args.parallel_rank, args.parallel_job)
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
    gxx = {}

    def gxx_build(name):
        t0 = time.perf_counter()
        native_mod.build(name)
        gxx[name] = time.perf_counter() - t0

    gxx_threads = [threading.Thread(target=gxx_build, args=(n,))
                   for n in ("predictor", "text_parser")]
    for th in gxx_threads:
        th.start()
    secs = _build.build(["predict_walk", "hist", "wave_fused", "wave_loop",
                         "wave_loop_int8", "quantize", "split_scan",
                         "split_scan_wide", "split_scan_cat"])
    for name, rec in _build.build_log.items():
        log(f"  nvcc {name}.cu: {rec['seconds']:.1f} s")
        for k in ptxas_kernels(rec["log"]):
            log(f"    {k['kernel']}: {k.get('registers')} registers, "
                f"{k.get('spill_stores')} / {k.get('spill_loads')} bytes "
                f"spilled / reloaded, {k.get('stack')} bytes of stack")
    log(f"  built: {sorted(secs) or 'already built'}")
    for th in gxx_threads:
        th.join()
    check(set(gxx) == {"predictor", "text_parser"}, f"g++ builds: {gxx}")
    log("  g++ " + ", ".join(f"{n}.cpp {v:.1f} s" for n, v in gxx.items()))

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
    prof = phase_profile(ds, PROFILE_ITERS, dev)

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
    fprof = phase_profile(ds, PROFILE_ITERS, dev, FUSED_PARAMS)

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
    lprof = phase_profile(ds, PROFILE_ITERS, dev, LOOP_PARAMS)

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
    reg["profile"] = phase_profile(dreg, PROFILE_ITERS, dev, REG_PARAMS)
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
    lvl["profile"] = phase_profile(ds, PROFILE_ITERS, dev, LEVEL_PARAMS)
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
    mc["profile"] = phase_profile(dm, PROFILE_ITERS, dev, MC_PARAMS)
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
    rk["profile"] = phase_profile(dr, PROFILE_ITERS, dev, RANK_PARAMS)
    rk["parity"] = card_vs_cpu("lambdarank", RANK_PARAMS, Xr[:40000],
                               yr[:40000], dev, group=gr[:400])
    paths["lambdarank"] = rk
    del rec, booster_rk
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
    new_rows = new_leg_rows(legs38, extra, newer["int16"])
    k1_row["onehot"] = {
        "note": "a torch.matmul path (the JAX package's XLA one-hot "
        "product), not a kernel", **newer["onehot"]}

    log("== phase 42: GOSS, DART and RF (main path; launch counts reset)")
    t0 = time.perf_counter()
    boosting = phase_boosting(ds, dv, Xv, X, BOOST_ITERS, dev, trained)
    boosting["seconds"] = time.perf_counter() - t0
    log(f"  phase 42: {boosting['seconds']:.1f} s")

    log("== phase 43: the other objectives (main path; launch counts "
        "reset)")
    t0 = time.perf_counter()
    objectives = phase_objectives(ds, dv, X, Xv, OBJ_ITERS, dev, args.seed,
                                  (dr, drv, Xrv, Xr[:40000], yr[:40000],
                                   gr[:400]))
    objectives["seconds"] = time.perf_counter() - t0
    log(f"  phase 43: {objectives['seconds']:.1f} s")
    del X, y, dr, drv

    log("== phase 44: the model lifecycle (main path; launch counts reset)")
    lifecycle = phase_lifecycle(ds, dv, LIFE_ITERS, dev)
    log(f"  phase 44: {lifecycle['seconds']:.1f} s")

    log("== phase 45: EFB on dense and CSR data (main path; launch counts "
        "reset)")
    efb = phase_efb(dev, args.seed, rng)
    log(f"  phase 45: {efb['seconds']:.1f} s")

    log("== phase 46: the categorical leg, the CEGB leg and K3's bitset leg "
        "against their plain versions")
    t0 = time.perf_counter()
    cat = phase_cat_kernels(rng, dev)
    cat_efb = phase_cat_efb(dev, args.seed)
    log(f"  phase 46 (synthetic children, categorical EFB): "
        f"{time.perf_counter() - t0:.1f} s")
    log("== phase 47: categorical training at the headline (main path; "
        "launch counts reset)")
    cat_train = phase_cat_train(dev, args.seed)
    log(f"  phase 47: {cat_train['seconds']:.1f} s")
    log("== phase 46 (continued): the legs on phase 47's last inputs")
    t1 = time.perf_counter()
    cat["timing"] = cat_timing(cat_train["cat_rec"], cat["cat"])
    cat["cegb_timing"] = cegb_timing(cat_train["scan_last"], rng,
                                     cat["cegb"])
    k3_cat = [cat_route_check("u8 leg, phase 47's last tree",
                              cat_train["route"], dev)]
    cat["seconds"] = time.perf_counter() - t1 + (t1 - t0
                                                 - cat_train["seconds"])
    log(f"  phase 46: {cat['seconds']:.1f} s in all")
    del cat_train["booster"], cat_train["cat_rec"], cat_train["scan_last"]

    log("== phase 48: interaction constraints, CEGB and forced splits at "
        "the headline (main path; launch counts reset)")
    p16 = phase_p16(ds, dv, Xv, dev)
    log(f"  phase 48: {p16['seconds']:.1f} s")
    log("== phase 49: the native C++ walk and parser (launch counts reset)")
    t0 = time.perf_counter()
    native, csv_path, parsed = phase_native(booster, trees, bulk, args.rows,
                                            rng, args.seed)
    native["phase_seconds"] = time.perf_counter() - t0
    log(f"  phase 49: {native['phase_seconds']:.1f} s")
    log("== phase 50: the CLI and the sklearn wrapper on the card (main "
        "path; launch counts reset)")
    t0 = time.perf_counter()
    cli_out = phase_cli(csv_path, parsed, args.seed, dev)
    cli_out["phase_seconds"] = time.perf_counter() - t0
    cli_out["train"]["phase10_s_per_iter"] = trained["s_per_iter"]
    log(f"  phase 50: {cli_out['phase_seconds']:.1f} s (CLI training "
        f"{cli_out['train']['s_per_iter']:.4f} s/iteration at {PARSE_ROWS} "
        f"rows beside phase 10's {trained['s_per_iter']:.4f} at "
        f"{args.train_rows})")
    del parsed
    log("== phase 51: TreeSHAP and prediction early stopping")
    t0 = time.perf_counter()
    contrib = phase_contrib(Xv)
    contrib["phase_seconds"] = time.perf_counter() - t0
    log(f"  phase 51: {contrib['phase_seconds']:.1f} s")
    log("== phase 52: online serving over HTTP (task=serve in process; "
        "launch counts reset)")
    serve52 = phase_serve_http(path, booster, booster_b, dev, rng,
                               args.seed)
    log(f"  phase 52: {serve52['seconds']:.1f} s")
    log("== phase 53: a fleet of replicas behind the router over HTTP "
        "(task=serve serve_replicas=3 in process; launch counts reset)")
    fleet53 = phase_fleet(booster, dev, rng)
    log(f"  phase 53: {fleet53['seconds']:.1f} s")
    log("== phase 54: observability: a profiled task=train and the merged "
        "artifacts")
    obs54 = phase_obs()
    log(f"  phase 54: {obs54['seconds']:.1f} s")
    job56 = os.path.join(_build.BUILD_DIR, "par_job.json")
    ranks56 = start_ranks(str(job56))
    log("== phase 55: out-of-core streaming training (main path; launch "
        "counts reset)")
    stream55 = phase_stream(args.seed, dev)
    log(f"  phase 55: {stream55['seconds']:.1f} s")
    log("== phase 56: the data, voting and feature learners over two "
        "gloo ranks (main path; launch counts reset)")
    par56 = phase_parallel(args.seed, dev, ranks56, str(job56))
    log(f"  phase 56: {par56['seconds']:.1f} s")
    k1_row["parallel"] = {
        "launches": {n: v["k1"] for n, v in par56["legs"].items()},
        "serial_launches": par56["serial"]["k1"],
        "note": "K1's launches a rank in phase 56's legs (b)-(f), counts "
        "reset just before each: each rank's row shard (data, voting) or "
        "feature slice (feature); (b), (c), (e), (f) equal to (a)'s; "
        "after (b) and (f) each rank's last inputs at every slot bucket "
        "bit for bit the row-order plain version",
        "checked_buckets": {n: [[k["L"] for k in c["k1"]]
                                for c in par56["legs"][n]["checks"]]
                            for n in PAR_CHECKED}}
    scan_row["parallel"] = {
        "launches": {n: v["split_scan"] for n, v in par56["legs"].items()},
        "serial_launches": par56["serial"]["split_scan"],
        "note": "the split scan's launches a rank in phase 56's legs, "
        "counts reset just before each: one a find_best_split, masked to "
        "the rank's features (reduce_scatter, feature) or the elected "
        "ones (voting); after (b) and (f) each rank's last inputs at "
        "every child count bit for bit the CPU plain scan",
        "checked_children": {n: [[x["C"] for x in c["scan"]]
                                 for c in par56["legs"][n]["checks"]]
                             for n in PAR_CHECKED}}
    k1_row["stream"] = {
        "note": "K1 at one slot on phase 55's streamed blocks: launches "
        "in (b), counts reset just before it; timed at a full block",
        **stream55["k1"]}
    scan_row["stream"] = {
        "launches": stream55["split_scan_launches"],
        "note": "the split scan on phase 55's streamed trees in (b), counts "
        "reset just before it: a tree's root and one a split"}
    rows[0]["serve_http"] = {
        "launches": serve52["launches"]["serving_fused"],
        "server_batches": serve52["server_batches"],
        "note": "K4's launches in phase 52, counts reset just before it: "
        "every batch of task=serve and of the degrade and drift servers, "
        "and each publish's warm and probe batches"}
    rows[0]["serve_fleet"] = {
        "launches": fleet53["launches"]["serving_fused"],
        "replica_batches": fleet53["replica_batches"],
        "note": "K4's launches in phase 53, counts reset just before it: "
        "every batch of the three replicas, and each replica's warm and "
        "probe batches of every version"}
    k1_row["bundle"] = {
        "note": "K1 on EFB bundle columns at the bundles' bin axis",
        "launches": int(efb["train"]["launches"]["k1"]),
        "checks": efb["k1_checks"], **efb["k1_timing"]}

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
                    "boosting_train": boosting,
                    "objectives_train": objectives,
                    "lifecycle": lifecycle,
                    "efb": {k: v for k, v in efb.items()
                            if k not in ("k1_checks", "k3_checks")},
                    "categorical": {"train": cat_train["train"],
                                    "efb": cat_efb["launches"],
                                    "seconds": cat["seconds"]},
                    "part_16": p16, "native": native, "cli": cli_out,
                    "contrib": contrib,
                    "serve_http": {k: v for k, v in serve52.items()
                                   if k != "launches"},
                    "serve_fleet": {k: v for k, v in fleet53.items()
                                    if k != "launches"},
                    "obs": obs54,
                    "stream": {k: v for k, v in stream55.items()
                               if k != "k1"},
                    "parallel": par56,
                    "timing_seconds": TIMING_SECONDS,
                    "seconds": time.perf_counter() - t_start}))
    pick_row["checks"] += [{"case": c["case"], "finite": c["pick_finite"]}
                           for c in schecks["k2"]]
    by_phase: dict = {}
    for key, secs in TIMING_SECONDS.items():
        by_phase[key.split(":")[0]] = by_phase.get(key.split(":")[0],
                                                   0.0) + secs
    log(f"  timing helpers: {sum(TIMING_SECONDS.values()):.1f} s of the "
        f"run's {time.perf_counter() - t_start:.1f} s; by phase "
        + json.dumps({k: round(v, 2) for k, v in by_phase.items()})
        + "; the largest " + json.dumps(dict(sorted(
            ((k, round(v, 2)) for k, v in TIMING_SECONDS.items()),
            key=lambda kv: -kv[1])[:25])))
    print(json.dumps({"kernels": [k1_row] + fused_rows
                      + [k6_row, qrow, rnrow, scan_row, pick_row] + new_rows
                      + efb_rows(efb)
                      + p16_rows(cat, cat_train, cat_efb, p16, k3_cat)
                      + rows}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

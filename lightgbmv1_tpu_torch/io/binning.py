"""The binning constants the serving path reads (copied from
lightgbmv1_tpu/io/binning.py; the training-side bin mappers come with the
training slice)."""

# |v| <= K_ZERO_THRESHOLD counts as zero (reference kZeroThreshold)
K_ZERO_THRESHOLD = 1e-35

# per-node missing-value routing (reference MissingType)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

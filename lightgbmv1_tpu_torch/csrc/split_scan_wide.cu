// The split-scan kernel's wide leg (int16 bins, max_bin > 255) as a
// library of its own, built by ops/_build.py beside split_scan.cu and in
// parallel with it: the same source with every feature's row walked in
// chunks of kMaxBins (scan_child_wide, wave_round.cuh), so any bin count
// runs (ops/scan_cuda.py loads it for a scan past 256 bins).  The head
// note of split_scan.cu describes the kernel.

#define LGBM_SCAN_WIDE 1
#include "split_scan.cu"

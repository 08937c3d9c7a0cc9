// K6's int8 leg (hist_dtype=int8, the Pallas kernel's precision="int8")
// as a library of its own, built by ops/_build.py beside wave_loop.cu and
// in parallel with it: the same source with only the kInt8 instances of
// the loop kernel (ops/loop_cuda.py loads it for an int8 launch).  The
// head note of wave_loop.cu describes the kernel.

#define LGBM_LOOP_INT8 1
#include "wave_loop.cu"

// The split-scan kernel's categorical leg for Hopper (sm_90a), built by
// ops/_build.py with nvcc into a shared library of its own (a plain C
// interface, loaded by ctypes), so its nvcc runs beside split_scan.cu's.
//
// lgbm_split_cat — replaces the categorical branch of the staged split
//    scan, lightgbmv1_tpu/ops/split.py:281 _best_categorical and its merge
//    into find_best_split (:721-740), which the JAX package leaves to XLA
//    (the fused Pallas family refuses categorical data).  In: the (C, F, B,
//    3) f32 child histograms (optionally their (C, 3) int8sr scales), the
//    children's sums (C, 3) and feature mask (C, F), the (5, F) feature
//    table, the usable categorical features' indices (n_cat,), the legs'
//    inputs (ScanLegs of wave_round.cuh: bounds, parent outputs, contri,
//    extra_trees' uids and key) and the CEGB penalties (C, F) or null.
//    In / out: the numerical scan's (C, 10) packed rows, overwritten where
//    a categorical candidate is strictly better (cgain > best gain, the
//    JAX rule).  Out: (C, 1 + W) i32 [is_cat, the left set's W =
//    ceil(B / 32) bin-space bitset words].  Its plain version is
//    ops/split.py best_categorical + merge_categorical; this kernel
//    computes the same bits.
//
// Design: one block a child, one warp a categorical feature (a warp loops
// over the features past the block's warps).  A warp stages the
// feature's (B, 3) row in its shared memory and then
//   * one-vs-rest (num_bins <= max_cat_to_onehot): each lane evaluates its
//     bins, the other side the child's sums minus the bin;
//   * otherwise the sorted scan: the bins of at least cat_smooth rows
//     keyed g / (h + cat_smooth), the rest +inf, each bin's place in the
//     stable sort found by counting the keys before it (a NaN key after
//     every other, as torch.argsort and jnp.argsort place it; B <= 256,
//     so B^2 / 32 compares a lane); six lanes then sum the forward and
//     backward prefixes over the first min(max_cat_threshold, (used + 1)
//     / 2) places in double, each rounded to f32 (PyTorch's CPU cumulative
//     sum), the lanes evaluate the places in parallel at lambda_l2 +
//     cat_l2, and one lane a direction runs the min_data_per_group scan,
//     which is sequential by nature;
// and each lane keeps its best candidate by (gain, then the JAX flat
// order: one-vs-rest, forward, backward, each feature-major), so ties go
// where jnp.argmax sends them.  After a block barrier one thread picks
// across the warps, warp 0 rebuilds the winner's left set (the sort again
// for a sorted split) as ballots of 32 bins a word, and the thread merges
// it into the packed row.  Every f32 op rounds once (__fadd_rn and the
// rest), as each PyTorch op of the plain version does.
//
// extra_trees (kOptRand): each (child, feature) draws (u0, u1) =
// uniform(fold_in(fold_in(tree key, uid + 1_000_003 + extra_seed), 7),
// (2, F))[:, f] with the JAX package's threefry stream (csrc/prng.cuh):
// one-vs-rest keeps the bin u0 x max(num_bins - 1, 1), the sorted scan
// the place u1 x max(min(places, used) - 1, 1), both truncated.
//
// What bounds it on this card: it reads the categorical features' rows
// once (C x n_cat x B x 12 bytes) and writes C x (10 + 1 + W) words:
// about 1.5 MB at C = 126 children, 4 features of 64 bins, 0.45 us at
// 3.35 TB/s.  Its arithmetic is small (B^2 compares a sorted feature, a
// few tens of f32 ops a candidate).  The time goes to the sequential
// pieces: the prefix walk and the group scan of each sorted feature, and
// the launch.  The legs are runtime switches of one instance
// (kOptAllScan), so the leg adds one short nvcc and no template instance
// to split_scan.cu, the build's long pole.

#include <atomic>

#include "wave_round.cuh"

using namespace lgbm;

namespace {

constexpr int kCatOpts = kOptAllScan;  // every leg in, switched by opts
constexpr int kMaxCatWarps = 16;
constexpr int kMaxCatDevices = 64;
constexpr float kCatEps = 1e-15f;      // ops/split.py CAT_EPS
constexpr long long kNoKey = 0x7fffffffffffffffLL;

// A warp's shared memory at B bins, in 4-byte words: the row (B, 3), the
// sort keys (B), the sorted bins (B), the prefix sums [2][B][3], the
// places' gains [2][B] and their flags [2][B].
__host__ __device__ inline int cat_warp_words(int B) { return 15 * B; }

// The categorical knobs beside ScanParams (whose l2 is lambda_l2).
struct CatParams {
  float l2cat, cat_smooth, mdpg;
  int max_cat_threshold, max_cat_to_onehot;
};

// The categorical legs of a child: its sums, bounds, parent output,
// shift and the switches.
struct CatChild {
  float tg, th, tc, pout, lo, hi, shift;
  bool mc, smooth, contri, rand;
};

// ops/split.py _cat_split_gain: the two sides' gains, at their outputs
// smoothed toward the parent's and clamped to [lo, hi] when those legs
// are on; `p` carries the l2 of the candidate's kind.
__device__ __forceinline__ float cat_gain(float lg, float lh, float rg,
                                          float rh, float lc, float rc,
                                          const ScanParams& p,
                                          const CatChild& k) {
  if (!k.mc && !k.smooth)
    return __fadd_rn(leaf_gain<kCatOpts>(lg, lh, p),
                     leaf_gain<kCatOpts>(rg, rh, p));
  float ol = leaf_output<kCatOpts>(lg, lh, p);
  float orr = leaf_output<kCatOpts>(rg, rh, p);
  if (k.smooth) {
    ol = smooth_output(ol, lc, k.pout, p);
    orr = smooth_output(orr, rc, k.pout, p);
  }
  if (k.mc) {
    ol = clamp_nan(ol, k.lo, k.hi);
    orr = clamp_nan(orr, k.lo, k.hi);
  }
  return __fadd_rn(leaf_gain_given_output(lg, lh, ol, p),
                   leaf_gain_given_output(rg, rh, orr, p));
}

// The relative gain: minus the shift, times contri, minus the CEGB
// penalty (the plain version's op order).
__device__ __forceinline__ float cat_rel(float gain, const CatChild& k,
                                         float cf, float pen, bool cegb) {
  float g = __fsub_rn(gain, k.shift);
  if (k.contri) g = __fmul_rn(g, cf);
  if (cegb) g = __fsub_rn(g, pen);
  return g;
}

// The stable ascending order of the sort keys, NaN after every number.
__device__ __forceinline__ bool key_before(float a, int i, float b, int j) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return (!na && nb) || (na && nb && i < j);
  return a < b || (a == b && i < j);
}

// A lane's best candidate so far: the highest gain, ties to the lowest
// flat key (jnp.argmax's first maximum).
struct Best {
  float gain;
  long long key;
  float l[3];
};

__device__ __forceinline__ void offer(Best& b, float g, long long key,
                                      float l0, float l1, float l2) {
  if (g > b.gain || (g == b.gain && key < b.key)) {
    b.gain = g;
    b.key = key;
    b.l[0] = l0;
    b.l[1] = l1;
    b.l[2] = l2;
  }
}

__device__ __forceinline__ bool better(float g, long long key, float bg,
                                       long long bk) {
  return g > bg || (g == bg && key < bk);
}

// The sort of a sorted feature's bins by a warp: keys[t] for every bin,
// each valid bin's place written to sbin[place] (the invalid bins' keys
// are +inf, so the valid ones take the first `used` places); returns
// `used`.  `rank_of` (may be null) receives each bin's place.
__device__ __forceinline__ int sort_bins(const float (*row)[3], float* keys,
                                         int* sbin, int* rank_of, int B,
                                         int nb, bool fm, float cat_smooth,
                                         int lane) {
  int used = 0;
  for (int t0 = 0; t0 < B; t0 += 32) {
    const int t = t0 + lane;
    bool valid = false;
    if (t < B) {
      valid = t < nb - 1 && fm && row[t][2] >= cat_smooth;
      keys[t] = valid ? __fdiv_rn(row[t][0], __fadd_rn(row[t][1], cat_smooth))
                      : INFINITY;
    }
    used += __popc(__ballot_sync(0xffffffffu, valid));
  }
  __syncwarp();
  for (int t = lane; t < B; t += 32) {
    const float kt = keys[t];
    int r = 0;
    for (int j = 0; j < B; ++j) r += key_before(keys[j], j, kt, t);
    sbin[r] = t;
    if (rank_of) rank_of[t] = r;
  }
  __syncwarp();
  return used;
}

__global__ void __launch_bounds__(kMaxCatWarps * 32)
split_cat_kernel(const float* __restrict__ hist,
                 const float* __restrict__ hscale,
                 const float* __restrict__ csums,
                 const uint8_t* __restrict__ mask,
                 const int* __restrict__ fmeta,
                 const int* __restrict__ cat_feats, ScanLegs legs,
                 const float* __restrict__ cegb, float* packed, int* cat_out,
                 int nf, int B, int n_cat, int mstride, ScanParams prm,
                 CatParams cp) {
  // the warps' best candidates (a key and 4 floats each), then each
  // warp's scratch
  extern __shared__ long long csm_keys[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  const int words = (B + 31) >> 5;
  long long* wkey = csm_keys;
  float* wbest = reinterpret_cast<float*>(csm_keys + W);
  float* csm = wbest + 4 * W;
  float* base = csm + static_cast<size_t>(warp) * cat_warp_words(B);
  auto* row = reinterpret_cast<float(*)[3]>(base);
  float* keys = base + 3 * B;
  int* sbin = reinterpret_cast<int*>(base + 4 * B);
  auto* pre = reinterpret_cast<float(*)[3]>(base + 5 * B);  // [2B][3]
  float* g2 = base + 11 * B;                                // [2][B]
  int* ok2 = reinterpret_cast<int*>(base + 13 * B);         // [2][B]

  CatChild k;
  const float* cs = csums + 3 * c;
  k.tg = cs[0];
  k.th = cs[1];
  k.tc = cs[2];
  k.mc = leg_on<kCatOpts>(prm, kOptMc);
  k.smooth = leg_on<kCatOpts>(prm, kOptSmooth);
  k.contri = leg_on<kCatOpts>(prm, kOptContri);
  k.rand = leg_on<kCatOpts>(prm, kOptRand);
  k.pout = k.smooth && legs.pout ? legs.pout[c] : 0.f;
  k.lo = !k.mc ? 0.f : legs.constr ? legs.constr[2 * c] : kNoConstraintLo;
  k.hi = !k.mc ? 0.f : legs.constr ? legs.constr[2 * c + 1]
                                   : kNoConstraintHi;
  k.shift = gain_shift<kCatOpts>(k.tg, k.th, k.pout, prm);
  ScanParams pcat = prm;
  pcat.l2 = cp.l2cat;
  const float* sc = hscale ? hscale + 3 * c : nullptr;
  const long long FB = static_cast<long long>(nf) * B;
  uint32_t rk0 = 0, rk1 = 0;  // the child's categorical draw key
  if (k.rand) {
    rk0 = legs.key0;
    rk1 = legs.key1;
    fold_in(rk0, rk1,
            static_cast<uint32_t>(legs.uids[c]) + 1000003u +
                static_cast<uint32_t>(legs.extra_seed));
    fold_in(rk0, rk1, 7u);
  }

  Best best{-INFINITY, kNoKey, {0.f, 0.f, 0.f}};
  for (int i = warp; i < n_cat; i += W) {
    const int f = cat_feats[i];
    const int nb = fmeta[f];
    const bool fm = mask[static_cast<size_t>(c) * mstride + f] != 0;
    const float cf = k.contri ? legs.contri[f] : 1.f;
    const bool has_pen = cegb != nullptr;
    const float pen = has_pen ? cegb[static_cast<size_t>(c) * nf + f] : 0.f;
    const float* src = hist + (static_cast<size_t>(c) * nf + f) * B * 3;
    for (int j = lane; j < B * 3; j += 32) {
      const float v = src[j];
      (&row[0][0])[j] = sc ? __fmul_rn(v, sc[j % 3]) : v;
    }
    __syncwarp();
    if (nb <= cp.max_cat_to_onehot) {
      // ---- one-vs-rest ---------------------------------------------------
      int rb1 = -1;
      if (k.rand) {
        const float u0 = uniform_at(rk0, rk1, static_cast<uint64_t>(f));
        const int m = nb - 1 > 1 ? nb - 1 : 1;
        rb1 = static_cast<int>(__fmul_rn(u0, static_cast<float>(m)));
      }
      for (int t = lane; t < B; t += 32) {
        const float g = row[t][0], h = row[t][1], cnt = row[t][2];
        const float og = __fsub_rn(k.tg, g), oh = __fsub_rn(k.th, h),
                    oc = __fsub_rn(k.tc, cnt);
        bool ok = t < nb - 1 && fm && cnt >= prm.min_data &&
                  h >= prm.min_hess && oc >= prm.min_data &&
                  __fsub_rn(oh, kCatEps) >= prm.min_hess;
        if (k.rand) ok = ok && t == rb1;
        const float hl = __fadd_rn(h, kCatEps);
        const float gain = cat_gain(g, hl, og, __fsub_rn(oh, kCatEps), cnt,
                                    oc, prm, k);
        const float rel = cat_rel(gain, k, cf, pen, has_pen);
        offer(best, ok ? rel : -INFINITY, static_cast<long long>(f) * B + t,
              __fadd_rn(g, 0.f), hl, __fadd_rn(cnt, 0.f));
      }
      __syncwarp();
      continue;
    }
    // ---- the sorted two-direction scan -----------------------------------
    const int used = sort_bins(row, keys, sbin, nullptr, B, nb, fm,
                               cp.cat_smooth, lane);
    const int half = (used + 1) / 2;
    const int mnc = half < cp.max_cat_threshold ? half : cp.max_cat_threshold;
    if (lane < 6) {
      const int dir = lane / 3, ch = lane % 3;
      double acc = 0.0;
      for (int p = 0; p < mnc; ++p) {
        acc += static_cast<double>(row[sbin[dir ? used - 1 - p : p]][ch]);
        float v = static_cast<float>(acc);
        if (ch == 1) v = __fadd_rn(v, kCatEps);
        pre[dir * B + p][ch] = v;
      }
    }
    __syncwarp();
    int rp = -1;
    if (k.rand) {
      const float u1 =
          uniform_at(rk0, rk1, static_cast<uint64_t>(nf) + f);
      const int lim = mnc < used ? mnc : used;
      const int max_thr = lim - 1 > 0 ? lim - 1 : 0;
      const int m = max_thr > 1 ? max_thr : 1;
      rp = static_cast<int>(__fmul_rn(u1, static_cast<float>(m)));
    }
    for (int j = lane; j < 2 * mnc; j += 32) {
      const int dir = j >= mnc;
      const int p = j - dir * mnc;
      const float* l = pre[dir * B + p];
      const float rg = __fsub_rn(k.tg, l[0]), rh = __fsub_rn(k.th, l[1]),
                  rc = __fsub_rn(k.tc, l[2]);
      bool ok = l[2] >= prm.min_data && l[1] >= prm.min_hess &&
                rc >= prm.min_data && rc >= cp.mdpg && rh >= prm.min_hess;
      if (k.rand) ok = ok && p == rp;
      ok2[dir * B + p] = ok;
      g2[dir * B + p] = cat_rel(cat_gain(l[0], l[1], rg, rh, l[2], rc, pcat,
                                         k),
                                k, cf, pen, has_pen);
    }
    __syncwarp();
    if (lane < 2) {  // min_data_per_group, one lane a direction
      const int dir = lane;
      float grp = 0.f;
      for (int p = 0; p < mnc; ++p) {
        grp = __fadd_rn(grp, row[sbin[dir ? used - 1 - p : p]][2]);
        const bool can = ok2[dir * B + p] != 0 && grp >= cp.mdpg;
        if (can) grp = 0.f;
        ok2[dir * B + p] = can;
      }
    }
    __syncwarp();
    for (int j = lane; j < 2 * mnc; j += 32) {
      const int dir = j >= mnc;
      const int p = j - dir * mnc;
      const float* l = pre[dir * B + p];
      offer(best, ok2[dir * B + p] ? g2[dir * B + p] : -INFINITY,
            (1 + dir) * FB + static_cast<long long>(f) * B + p, l[0], l[1],
            l[2]);
    }
    __syncwarp();  // the warp's scratch is read before its next feature
  }
  // ---- the warp's best, then the block's --------------------------------
  float bg = best.gain;
  long long bk = best.key;
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, bg, o);
    const long long ok = __shfl_xor_sync(0xffffffffu, bk, o);
    if (better(og, ok, bg, bk)) {
      bg = og;
      bk = ok;
    }
  }
  if (best.key == bk && (best.gain == bg || bk == kNoKey)) {
    if (bk != kNoKey || lane == 0) {
      wbest[4 * warp] = bg;
      wbest[4 * warp + 1] = best.l[0];
      wbest[4 * warp + 2] = best.l[1];
      wbest[4 * warp + 3] = best.l[2];
      wkey[warp] = bk;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  int win = 0;
  for (int w = 1; w < W; ++w)
    if (better(wbest[4 * w], wkey[w], wbest[4 * win], wkey[win])) win = w;
  const float cgain = wbest[4 * win];
  const long long key = wkey[win];
  // the winner's left set as bin-space bitset words
  int sect = 0, f = 0, t = 0;
  if (key != kNoKey) {
    sect = static_cast<int>(key / FB);
    const long long rem = key - sect * FB;
    f = static_cast<int>(rem / B);
    t = static_cast<int>(rem - static_cast<long long>(f) * B);
  }
  int* rank_of = reinterpret_cast<int*>(g2);  // warp 0's scratch, reused
  int used = 0;
  if (sect > 0) {
    const float* src = hist + (static_cast<size_t>(c) * nf + f) * B * 3;
    for (int j = lane; j < B * 3; j += 32) {
      const float v = src[j];
      (&row[0][0])[j] = sc ? __fmul_rn(v, sc[j % 3]) : v;
    }
    __syncwarp();
    used = sort_bins(row, keys, sbin, rank_of, B, fmeta[f],
                     mask[static_cast<size_t>(c) * mstride + f] != 0,
                     cp.cat_smooth, lane);
  }
  const bool use = cgain > packed[c * kPackCols];
  int* co = cat_out + static_cast<size_t>(c) * (1 + words);
  for (int w = 0; w < words; ++w) {
    const int b = 32 * w + lane;
    bool m = false;
    if (b < B) {
      if (sect == 0) {
        m = b == t;
      } else {
        const int r = rank_of[b];
        m = sect == 1 ? r <= t : (r >= used - 1 - t && r < used);
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (lane == 0) co[1 + w] = use ? static_cast<int>(bits) : 0;
  }
  if (lane == 0) {
    float* r = packed + c * kPackCols;
    const float mx = nan_max(r[0], cgain);
    r[0] = isfinite(mx) ? mx : -INFINITY;
    co[0] = use ? 1 : 0;
    if (use) {
      const float* cl = wbest + 4 * win + 1;
      r[1] = static_cast<float>(f);
      r[2] = 0.f;
      r[3] = 0.f;
      for (int q = 0; q < 3; ++q) {
        r[4 + q] = cl[q];
        r[7 + q] = __fsub_rn(cs[q], cl[q]);
      }
    }
  }
}

// The dynamic shared memory a block may take: the device's largest block
// less the kernel's static words, opted into once a device; 0 on an
// error.
int cat_smem_cap() {
  static std::atomic<int> cap[kMaxCatDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxCatDevices)
    return 0;
  int v = cap[dev].load(std::memory_order_relaxed);
  if (v > 0) return v;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, split_cat_kernel) != cudaSuccess)
    return 0;
  v -= static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(split_cat_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           v) != cudaSuccess)
    return 0;
  cap[dev].store(v, std::memory_order_relaxed);
  return v;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).  `hist` (C, nf, B,
// 3) f32, `hscale` (C, 3) f32 or null, `csums` (C, 3) f32, `mask` (C, nf)
// bytes, its rows `mask_stride` bytes apart (nf, or 0: one row for every
// child), `fmeta` (5, nf) i32, `cat_feats` (n_cat,) i32; `constr` (C, 2)
// (null: NO_CONSTRAINT) read under kOptMc, `pout` (C,) (null: 0) under
// kOptSmooth, `contri` (nf,) under kOptContri, `cegb` (C, nf) f32 or
// null; under kOptRand `uids` (C,) i32, the tree key (key0, key1) and
// extra_seed.  In / out `packed` (C, 10) f32; out `cat_out` (C, 1 +
// ceil(B / 32)) i32.  B <= kMaxBins.
int lgbm_split_cat(const void* hist, const void* hscale, const void* csums,
                   const void* mask, const void* fmeta, const void* cat_feats,
                   const void* constr, const void* pout, const void* contri,
                   const void* cegb, const void* uids, void* packed,
                   void* cat_out, int C, int nf, int B, int n_cat,
                   int mask_stride, float l1, float l2, float min_data,
                   float min_hess, float min_gain, float max_delta_step,
                   float path_smooth, float l2cat, float cat_smooth,
                   float min_data_per_group, int max_cat_threshold,
                   int max_cat_to_onehot, int opts, unsigned key0,
                   unsigned key1, int extra_seed, void* stream) {
  if (B < 1 || B > kMaxBins || C < 1 || nf < 1 || n_cat < 0 ||
      (mask_stride != nf && mask_stride != 0) || !packed || !cat_out ||
      ((opts & kOptContri) && !contri) || ((opts & kOptRand) && !uids) ||
      (opts & ~kCatOpts) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = cat_smem_cap();
  const size_t warp_bytes = sizeof(float) * cat_warp_words(B);
  // each warp's best: 4 floats and a key
  const size_t slot_bytes = 4 * sizeof(float) + sizeof(long long);
  int W = cap > 0 ? static_cast<int>(cap / (warp_bytes + slot_bytes)) : 0;
  W = W < kMaxCatWarps ? W : kMaxCatWarps;
  W = W < n_cat ? W : n_cat;
  W = W < 1 ? 1 : W;
  const size_t bytes = W * warp_bytes + W * slot_bytes;
  if (cap <= 0 || bytes > static_cast<size_t>(cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanLegs legs{static_cast<const float*>(constr),
                      nullptr,
                      static_cast<const float*>(pout),
                      nullptr,
                      static_cast<const float*>(contri),
                      static_cast<const int*>(uids),
                      key0,
                      key1,
                      extra_seed};
  const ScanParams prm{l1,         l2,   min_data,       min_hess, min_gain,
                       max_delta_step, path_smooth, 0.f, opts};
  const CatParams cp{l2cat, cat_smooth, min_data_per_group,
                     max_cat_threshold, max_cat_to_onehot};
  split_cat_kernel<<<C, W * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(hscale),
      static_cast<const float*>(csums), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(fmeta), static_cast<const int*>(cat_feats),
      legs, static_cast<const float*>(cegb), static_cast<float*>(packed),
      static_cast<int*>(cat_out), nf, B, n_cat, mask_stride, prm, cp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

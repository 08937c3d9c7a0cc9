// The device code of one wave round, shared by the fused round K2 / K3
// (csrc/wave_fused.cu) and the persistent wave loop K6
// (csrc/wave_loop.cu).  Each stage is a __device__ function that takes its
// work item as an argument — a row or a 256-row tile (route_leaf,
// route_row, route_label_tile, list_tile), a (feature, chunk, slot group)
// (hist_partial_list_item, in hist_tile.cuh) or a (slot, feature)
// (scan_item) — so the kernels compute the same values from the same
// inputs whatever grid runs them.  ops/_build.py hashes every csrc/*.cuh
// a source includes into the library's name.  The two stages that read
// bins (route_leaf's decision bin, hist_partial_list_item's ring) take a
// PACKED leg for 4-bit packed bins (bin_layout=packed4); every stage after
// the load is the same code.
//
// Buffers the loop rewrites inside one launch (leaf ids, labels, tile
// counts, lists, partials, the round's slots, mask and sums, the pool,
// the residue) are plain pointers here, never const __restrict__: the
// loop reads them again after a grid barrier, so they must not go
// through the read-only cache.

#pragma once

#include <math.h>

#include "hist_tile.cuh"
#include "prng.cuh"

namespace lgbm {

constexpr int kRmetaCols = 8;
constexpr int kMissingNone = 0;  // io/binning.py MISSING_*
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr int kMaxBins = 256;
constexpr float kTieRtol = 4e-6f;  // ops/split.py TIE_RTOL

// One slot of a round: its split (leaf, new leaf, threshold, default
// left, the feature's missing type, NaN bin and zero bin, smaller is
// left) and the split's feature.
struct Slot {
  int leaf, nl, thr, dl, mt, nanb, zb, sml, feat;
};

// rmeta (ns, kRmetaCols) i32 + feats (ns,) -> slots, by the block.
__device__ __forceinline__ void load_slots(const int* rmeta, const int* feats,
                                           int ns, Slot* slots) {
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int* m = rmeta + static_cast<size_t>(s) * kRmetaCols;
    slots[s] = Slot{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                    feats[s]};
  }
}

// ops/split.py go_left_rule on one bin.
__device__ __forceinline__ bool go_left(int bin, const Slot& m) {
  const bool na = (m.mt == kMissingNan && bin == m.nanb) ||
                  (m.mt == kMissingZero && bin == m.zb);
  return na ? m.dl != 0 : bin <= m.thr;
}

// The place of slot s among ns slots in leaf order, ties in slot order:
// the slots' leaves are leaf0[t * stride], t < ns.
__device__ __forceinline__ int slot_rank(const int* leaf0, int stride, int ns,
                                         int s) {
  const int lf = leaf0[static_cast<size_t>(s) * stride];
  int rank = 0;
  for (int t = 0; t < ns; ++t) {
    const int o = leaf0[static_cast<size_t>(t) * stride];
    rank += o < lf || (o == lf && t < s);
  }
  return rank;
}

// The leaf-sorted order of a round's ns slots, by the block: sleaf[k] is
// the k-th smallest slot leaf (ties in slot order), sidx[k] its slot.
__device__ __forceinline__ void sort_slots(const Slot* slots, int ns,
                                           int* sleaf, int* sidx) {
  constexpr int kSlotInts = sizeof(Slot) / sizeof(int);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const int rank = slot_rank(&slots[0].leaf, kSlotInts, ns, s);
    sleaf[rank] = slots[s].leaf;
    sidx[rank] = s;
  }
}

// Slot s's terms of route_tile on a row of leaf lf whose bin of the
// slot's feature is `bin`: the new leaf id's and, WANT_LABEL, the label's.
template <bool WANT_LABEL, bool SUB>
__device__ __forceinline__ void slot_terms(int s, const Slot& m, int bin,
                                           int lf, int nslots, int& dleaf,
                                           int& dlab) {
  const bool g = go_left(bin, m);
  if (!g) dleaf += m.nl - lf;
  if (WANT_LABEL) {
    if (SUB) {
      if (g == (m.sml != 0)) dlab += s - nslots;
    } else {
      dlab += 2 * s + (g ? 0 : 1) - nslots;
    }
  }
}

// route_tile on row r of leaf lf: the sums over the slots its leaf
// matches (one at most: live slots hold distinct leaves, dead slots a leaf
// no row has), term for term, those slots found by a binary search of the
// leaf-sorted order (sort_slots), so a row costs log2(ns) steps, not ns.
// Returns the row's new leaf id and adds the label's terms to `dlab`
// (WANT_LABEL).  PACKED: `binned` holds the packed bytes, and the
// decision bin is the nibble of the slot's feature (bin_column / bin_of,
// hist_tile.cuh).  BinT int16_t: `binned` holds (F, n) int16 bins (K3's
// 16-bit leg, max_bin > 255; never PACKED).  The one decision of K2, K3
// and K6.
template <bool WANT_LABEL, bool SUB, bool PACKED, typename BinT = uint8_t>
__device__ __forceinline__ int route_leaf(
    int r, int lf, const BinT* __restrict__ binned, const Slot* slots,
    const int* sleaf, const int* sidx, int n, int ns, int nslots,
    int& dlab) {
  static_assert(sizeof(BinT) == 1 || !PACKED, "packed bins are bytes");
  int lo = 0, hi = ns;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sleaf[mid] < lf) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int dleaf = 0;
  for (int p = lo; p < ns && sleaf[p] == lf; ++p) {
    const int s = sidx[p];
    const Slot& m = slots[s];
    int bin;
    if constexpr (sizeof(BinT) == 1) {
      bin = bin_of<PACKED>(bin_column<PACKED>(binned, m.feat, n)[r], m.feat);
    } else {
      bin = static_cast<int>(binned[static_cast<size_t>(m.feat) * n + r]);
    }
    slot_terms<WANT_LABEL, SUB>(s, m, bin, lf, nslots, dleaf, dlab);
  }
  return lf + dleaf;
}

// route_leaf on row r of the leaf ids `oleaf`.  Reads the row's leaf id
// before it writes the new one, so `new_leaf` may be `oleaf`.  WANT_LABEL
// (K2 and K6) also writes and returns the label: the smaller child's slot
// in subtraction mode, 2s + right pool-free, nslots for a row of no split.
template <bool WANT_LABEL, bool SUB, bool PACKED>
__device__ __forceinline__ int route_row(
    int r, const uint8_t* __restrict__ binned, const int* oleaf,
    const Slot* slots, const int* sleaf, const int* sidx, int n, int ns,
    int nslots, int* new_leaf, int* label) {
  int dlab = 0;
  new_leaf[r] = route_leaf<WANT_LABEL, SUB, PACKED>(
      r, oleaf[r], binned, slots, sleaf, sidx, n, ns, nslots, dlab);
  if (WANT_LABEL) label[r] = nslots + dlab;
  return nslots + dlab;
}

// route_row with the label on the rows of 256-row tile t, by all
// kThreads threads of the block, and the tile's live rows (label below
// nslots: the rows the round's histograms add) into tile_cnt[t].
template <bool SUB, bool PACKED>
__device__ __forceinline__ void route_label_tile(
    int t, const uint8_t* __restrict__ binned, const int* oleaf,
    const Slot* slots, const int* sleaf, const int* sidx, int n, int ns,
    int nslots, int* new_leaf, int* label, int* tile_cnt) {
  const int r = t * kThreads + threadIdx.x;
  bool live = false;
  if (r < n)
    live = route_row<true, SUB, PACKED>(r, binned, oleaf, slots, sleaf,
                                        sidx, n, ns, nslots, new_leaf,
                                        label) < nslots;
  const int c = __syncthreads_count(live);
  if (threadIdx.x == 0) tile_cnt[t] = c;
}

// The list stage on 256-row tile t, by all kThreads threads of the block
// (K2 and K6, after the route and its tile counts): the tile's live rows,
// in row order, after those of the earlier tiles of its row chunk
// (ops/hist_cuda.plan's chunks of chunk_rows, a multiple of the tile), at
// lrow[chunk * chunk_rows + offset + rank], each one's slot beside it in
// lslot; the chunk's last tile writes the chunk's count to lcnt (with no
// rows there is no tile: the caller zeroes lcnt).  A stable ballot ranks
// a warp's rows, the warps' counts rank the warps, and the earlier tiles'
// counts give the offset, so the list is in row order whatever block runs
// which tile.  A tile with no live row reads no label.
__device__ __forceinline__ void list_tile(int t, const int* label,
                                          const int* tile_cnt, int* lrow,
                                          int* lslot, int* lcnt, int n,
                                          int nslots, int chunk_rows) {
  __shared__ int red[2 * kWarps];  // the warps' offset parts, live counts
  const int tpc = chunk_rows / kThreads;
  const int chunk = t / tpc;
  const int t0 = chunk * tpc;
  const int t_last = min(t0 + tpc, (n + kThreads - 1) / kThreads) - 1;
  if (tile_cnt[t] == 0 && t != t_last) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int part = 0;  // the live rows of the chunk's tiles before t
  for (int i = t0 + tid; i < t; i += kThreads) part += tile_cnt[i];
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  const int r = t * kThreads + tid;
  const int lab = r < n ? label[r] : nslots;
  const bool live = lab < nslots;
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (lane == 0) {
    red[warp] = part;
    red[kWarps + warp] = __popc(m);
  }
  __syncthreads();
  int offset = 0, before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    offset += red[w];
    tot += red[kWarps + w];
    if (w < warp) before += red[kWarps + w];
  }
  if (live) {
    const size_t p = static_cast<size_t>(chunk) * chunk_rows + offset +
                     before + __popc(m & ((1u << lane) - 1u));
    lrow[p] = r;
    lslot[p] = lab;
  }
  if (t == t_last && tid == 0) lcnt[chunk] = offset + tot;
  __syncthreads();  // red is read before the next tile writes it
}


// The scan's options (the reference GetSplitGains<USE_MC, USE_MAX_OUTPUT,
// USE_SMOOTHING>, feature_histogram.hpp:740-839, and the feature_contri
// multiply): bits of the OPTS template of scan_child and of
// ScanParams::opts (ops/scan_cuda.py OPT_*).  A kernel instantiated with
// a bit compiles that leg in and runs it when the launch's opts has the
// bit too; OPTS = 0 is the unconstrained scan's code alone.
constexpr int kOptMc = 1;      // monotone constraints
constexpr int kOptSmooth = 2;  // path_smooth
constexpr int kOptMaxOut = 4;  // max_delta_step
constexpr int kOptContri = 8;  // feature_contri
constexpr int kOptAll = 15;
// extra_trees: one random threshold a (child, feature), drawn in the
// kernel (rand_bin).  Only the split-scan kernel compiles it in (its
// kOptAllScan instance); K2 and K6 stop at kOptAll, as the fused family
// refuses extra_trees.
constexpr int kOptRand = 16;
constexpr int kOptAllScan = kOptAll | kOptRand;

struct ScanParams {
  float l1, l2, min_data, min_hess, min_gain;
  float max_delta_step, path_smooth, monotone_penalty;
  int opts;  // the kOpt* legs this launch runs
};

// The options' per-child and per-feature inputs (null where off): the
// children's [min, max] output bounds (C, 2) and monotone penalty
// factors (C,) (ops/split.py monotone_penalty_factors, read when
// ScanParams::monotone_penalty > 0), the parents' outputs (C,) the
// children smooth toward, the features' monotone types (nf,) i32
// (kOptMc) and contri multipliers (nf,).  A null `constr` under kOptMc
// is [kNoConstraintLo, kNoConstraintHi] (ops/split.py NO_CONSTRAINT)
// and a null `pout` under kOptSmooth 0, as ops/split.py scan_inputs
// leaves them.  Under kOptRand: the children's uids (C,) i32, the tree's
// key (key0, key1) and extra_seed (rand_bin).
constexpr float kNoConstraintLo = -3.0e38f;
constexpr float kNoConstraintHi = 3.0e38f;
struct ScanLegs {
  const float* constr;
  const float* pfac;
  const float* pout;
  const int* mono;
  const float* contri;
  const int* uids;
  uint32_t key0, key1;
  int extra_seed;
};

template <int OPTS>
__device__ __forceinline__ bool leg_on(const ScanParams& p, int bit) {
  return (OPTS & bit) != 0 && (p.opts & bit) != 0;
}

// torch.clamp(x, lo, hi): max then min, a NaN passes.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// ops/split.py threshold_l1: sign(s) * clamp(|s| - l1, min=0).
__device__ __forceinline__ float threshold_l1(float s, float l1) {
  const float sg = static_cast<float>(0.f < s) - static_cast<float>(s < 0.f);
  float a = __fsub_rn(fabsf(s), l1);
  a = a < 0.f ? 0.f : a;  // a NaN passes, as torch.clamp lets it
  return __fmul_rn(sg, a);
}

// ops/split.py leaf_output: -threshold_l1(g) / (h + l2), clamped to
// +-max_delta_step under kOptMaxOut.
template <int OPTS>
__device__ __forceinline__ float leaf_output(float g, float h,
                                             const ScanParams& p) {
  const float out = __fdiv_rn(-threshold_l1(g, p.l1), __fadd_rn(h, p.l2));
  if (leg_on<OPTS>(p, kOptMaxOut))
    return clamp_nan(out, -p.max_delta_step, p.max_delta_step);
  return out;
}

// ops/split.py leaf_gain_given_output: -(2 t out + (h + l2) out out).
__device__ __forceinline__ float leaf_gain_given_output(float g, float h,
                                                        float out,
                                                        const ScanParams& p) {
  const float t = threshold_l1(g, p.l1);
  return -__fadd_rn(__fmul_rn(__fmul_rn(2.f, t), out),
                    __fmul_rn(__fmul_rn(__fadd_rn(h, p.l2), out), out));
}

// ops/split.py leaf_gain: t * t / (h + l2); under kOptMaxOut the gain at
// the clamped output.
template <int OPTS>
__device__ __forceinline__ float leaf_gain(float g, float h,
                                           const ScanParams& p) {
  if (leg_on<OPTS>(p, kOptMaxOut))
    return leaf_gain_given_output(g, h, leaf_output<OPTS>(g, h, p), p);
  const float t = threshold_l1(g, p.l1);
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(h, p.l2));
}

// ops/split.py smooth_output: out w / (w + 1) + parent / (w + 1), w =
// count / path_smooth.
__device__ __forceinline__ float smooth_output(float out, float count,
                                               float parent,
                                               const ScanParams& p) {
  const float w = __fdiv_rn(count, p.path_smooth);
  const float w1 = __fadd_rn(w, 1.f);
  return __fadd_rn(__fdiv_rn(__fmul_rn(out, w), w1), __fdiv_rn(parent, w1));
}

// ops/split.py child_leaf_output without a bound: a child's output from
// its sums, smoothed toward the parent's output `parent` under
// kOptSmooth (K6's commit; the loop runs no monotone leg).
template <int OPTS>
__device__ __forceinline__ float child_output(float g, float h, float c,
                                              float parent,
                                              const ScanParams& p) {
  const float out = leaf_output<OPTS>(g, h, p);
  return leg_on<OPTS>(p, kOptSmooth) ? smooth_output(out, c, parent, p) : out;
}

// ops/split.py gain_shift: the parent's gain (under kOptSmooth at its
// output `pout`) + min_gain_to_split.
template <int OPTS>
__device__ __forceinline__ float gain_shift(float g, float h, float pout,
                                            const ScanParams& p) {
  const float pg = leg_on<OPTS>(p, kOptSmooth)
                       ? leaf_gain_given_output(g, h, pout, p)
                       : leaf_gain<OPTS>(g, h, p);
  return __fadd_rn(pg, p.min_gain);
}

// max that lets a NaN through, as torch's max reduction does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The per-(child, feature) constants of scan_direction_gains: the
// child's sums, parent output, bounds, shift and multipliers and the
// feature's missing rules, bins and random threshold (kOptRand; -1: none).
struct ScanConsts {
  float tg, th, tc, pout, lo, hi, cf, pf, shift;
  int nbins_f, mono, rbin;
  bool mc, smooth, contri, pen, usable, has_miss;
};

// extra_trees' threshold of feature f for a child whose uid is `uid`
// (ops/split.py extra_rand_bins, the JAX package's split.py:602-607):
// uniform(fold_in(tree key, uid + 1_000_003 + extra_seed), (F,))[f] times
// max(num_bins - 1, 1) in one f32 multiply, truncated.
__device__ __forceinline__ int rand_bin(uint32_t k0, uint32_t k1, int uid,
                                        int extra_seed, int f, int nbins_f) {
  fold_in(k0, k1,
          static_cast<uint32_t>(uid) + 1000003u +
              static_cast<uint32_t>(extra_seed));
  const float u = uniform_at(k0, k1, static_cast<uint64_t>(f));
  const int m = nbins_f - 1 > 1 ? nbins_f - 1 : 1;
  return static_cast<int>(__fmul_rn(u, static_cast<float>(m)));
}

template <int OPTS>
__device__ __forceinline__ ScanConsts scan_consts(
    int child, int f, int nf, const int* __restrict__ fmeta, bool usable,
    const float* cs, const ScanParams& prm, const ScanLegs& legs) {
  ScanConsts k;
  k.nbins_f = fmeta[f];
  const int mt = fmeta[nf + f];
  k.has_miss = mt == kMissingNan || mt == kMissingZero;
  k.usable = usable;
  k.mc = leg_on<OPTS>(prm, kOptMc);
  k.smooth = leg_on<OPTS>(prm, kOptSmooth);
  k.tg = cs[0];
  k.th = cs[1];
  k.tc = cs[2];
  k.pout = k.smooth && legs.pout ? legs.pout[child] : 0.f;
  k.lo = !k.mc ? 0.f : legs.constr ? legs.constr[2 * child] : kNoConstraintLo;
  k.hi = !k.mc ? 0.f
               : legs.constr ? legs.constr[2 * child + 1] : kNoConstraintHi;
  k.mono = k.mc ? legs.mono[f] : 0;
  // the relative-gain multipliers of finite gains: contri, then the
  // monotone depth penalty on a monotone feature
  k.contri = leg_on<OPTS>(prm, kOptContri);
  k.cf = k.contri ? legs.contri[f] : 1.f;
  k.pen = k.mc && prm.monotone_penalty > 0.f && k.mono != 0;
  k.pf = k.pen ? legs.pfac[child] : 1.f;
  k.shift = gain_shift<OPTS>(k.tg, k.th, k.pout, prm);
  k.rbin = leg_on<OPTS>(prm, kOptRand)
               ? rand_bin(legs.key0, legs.key1, legs.uids[child],
                          legs.extra_seed, f, k.nbins_f)
               : -1;
  return k;
}

// The relative gain of candidate (dir, t) with left sums (lg, lh, lc):
// scan_direction_gains' value for it, -inf where it is not a candidate or
// misses a gate.
template <int OPTS>
__device__ __forceinline__ float candidate_gain(const ScanConsts& k, int dir,
                                                int t, float lg, float lh,
                                                float lc,
                                                const ScanParams& prm) {
  const float rg = __fsub_rn(k.tg, lg), rh = __fsub_rn(k.th, lh),
              rc = __fsub_rn(k.tc, lc);
  bool ok = lc >= prm.min_data && rc >= prm.min_data && lh >= prm.min_hess &&
            rh >= prm.min_hess;
  float gain;
  if (!k.mc && !k.smooth) {
    gain = __fadd_rn(leaf_gain<OPTS>(lg, lh, prm), leaf_gain<OPTS>(rg, rh, prm));
  } else {
    float ol = leaf_output<OPTS>(lg, lh, prm);
    float orr = leaf_output<OPTS>(rg, rh, prm);
    if (k.smooth) {
      ol = smooth_output(ol, lc, k.pout, prm);
      orr = smooth_output(orr, rc, k.pout, prm);
    }
    if (k.mc) {
      ol = clamp_nan(ol, k.lo, k.hi);
      orr = clamp_nan(orr, k.lo, k.hi);
    }
    gain = __fadd_rn(leaf_gain_given_output(lg, lh, ol, prm),
                     leaf_gain_given_output(rg, rh, orr, prm));
    if (k.mc && ((k.mono > 0 && ol > orr) || (k.mono < 0 && ol < orr)))
      ok = false;
  }
  bool valid = t <= k.nbins_f - 2 && k.usable && (dir == 0 || k.has_miss);
  if (leg_on<OPTS>(prm, kOptRand)) valid = valid && t == k.rbin;
  float g = __fsub_rn((valid && ok) ? gain : -INFINITY, k.shift);
  if (isfinite(g)) {
    if (k.contri) g = __fmul_rn(g, k.cf);
    if (k.pen) g = __fmul_rn(g, k.pf);
  }
  return g;
}

// Candidate j's place in scan_pick_feature's preference (the reverse
// scan's highest threshold first for a missing-none or 2-bin feature,
// else the forward scan's lowest; direction 1 after them).
__device__ __forceinline__ int candidate_pref(int j, int B, bool rev_like_a) {
  const int dir = j >= B;
  const int t = j - dir * B;
  return (dir || rev_like_a) ? 2 * B + t : B - 1 - t;
}

// The tie band's floor of a feature whose best gain is fbest.
__device__ __forceinline__ float band_floor(float fbest, float shift) {
  const float babs = isfinite(fbest) ? fabsf(fbest) : 0.f;
  return __fsub_rn(fbest, __fmul_rn(kTieRtol, __fadd_rn(fabsf(shift), babs)));
}

// The missing-mass adjustments of both scan directions' left sums at bin
// b, from the inclusive prefix `cum` of channel ch.
__device__ __forceinline__ void left_pair(float cum, int b, bool is_nan_f,
                                          bool is_zero_f, int zb, float nan_c,
                                          float zero_c, float& l0, float& l1) {
  l0 = __fsub_rn(cum, (is_zero_f && b >= zb) ? zero_c : 0.f);
  l1 = __fadd_rn(cum,
                 is_nan_f ? nan_c : ((is_zero_f && b < zb) ? zero_c : 0.f));
}

// One child's split scan of feature f by one warp (lane its thread):
// ops/split.py scan_residue on the child's (B, 3) row `h` in shared
// memory, with `left` [2][kMaxBins][3] and `gains` [2 kMaxBins] its
// shared scratch.  `sc` (null: none) holds the child's 3 scales, which
// multiply the prefix sums after the cumulative sum and the
// missing-mass reads (an int8sr child pool-free); `cs` its sums.  Writes
// the residue row [best gain, gain at the pick, pick, left g/h/c] of
// (child, f).  The split-scan kernel (split_scan.cu), K2 and K6 run this
// one function; B <= kMaxBins (scan_child_wide takes wider rows).
template <int OPTS>
__device__ __forceinline__ void scan_child(
    const float (*h)[3], float (*left)[kMaxBins][3], float* gains, int lane,
    int child, int f, int nf, int B, const int* __restrict__ fmeta,
    bool usable, const float* sc, const float* cs, const ScanParams& prm,
    const ScanLegs& legs, float* residue) {
  const int mt = fmeta[nf + f];
  const int nanb = fmeta[2 * nf + f];
  const int zb = fmeta[3 * nf + f];
  const bool is_nan_f = mt == kMissingNan;
  const bool is_zero_f = mt == kMissingZero;

  // ---- scan_left_sums: both directions' left sums in bin order ---------
  if (lane < 3) {
    const int ch = lane;
    float nan_c = h[nanb < 0 ? 0 : nanb][ch];
    float zero_c = h[zb][ch];
    if (sc) {
      nan_c = __fmul_rn(nan_c, sc[ch]);
      zero_c = __fmul_rn(zero_c, sc[ch]);
    }
    double acc = 0.0;
    for (int b = 0; b < B; ++b) {
      acc += static_cast<double>(h[b][ch]);
      float cum = static_cast<float>(acc);
      if (sc) cum = __fmul_rn(cum, sc[ch]);
      left_pair(cum, b, is_nan_f, is_zero_f, zb, nan_c, zero_c,
                left[0][b][ch], left[1][b][ch]);
    }
  }
  __syncwarp();

  // ---- scan_direction_gains ---------------------------------------------
  const ScanConsts k =
      scan_consts<OPTS>(child, f, nf, fmeta, usable, cs, prm, legs);
  float fbest = -INFINITY;
  for (int j = lane; j < 2 * B; j += 32) {
    const int dir = j >= B;
    const int t = j - dir * B;
    const float g = candidate_gain<OPTS>(k, dir, t, left[dir][t][0],
                                         left[dir][t][1], left[dir][t][2],
                                         prm);
    gains[j] = g;
    fbest = nan_max(fbest, g);
  }
  for (int o = 16; o > 0; o >>= 1)
    fbest = nan_max(fbest, __shfl_xor_sync(0xffffffffu, fbest, o));
  __syncwarp();

  // ---- scan_pick_feature: the tie-band preference pick ------------------
  const float floor_g = band_floor(fbest, k.shift);
  const bool rev_like_a = mt == kMissingNone || k.nbins_f <= 2;
  int best_pref = -2, best_j = 0;
  for (int j = lane; j < 2 * B; j += 32) {
    const int v = gains[j] >= floor_g ? candidate_pref(j, B, rev_like_a) : -1;
    if (v > best_pref) {  // strictly: the first index of the best wins
      best_pref = v;
      best_j = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int op = __shfl_xor_sync(0xffffffffu, best_pref, o);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
    if (op > best_pref || (op == best_pref && oj < best_j)) {
      best_pref = op;
      best_j = oj;
    }
  }
  if (lane == 0) {
    const int dir = best_j >= B;
    const int t = best_j - dir * B;
    float* r = residue + (static_cast<size_t>(child) * nf + f) * 6;
    r[0] = fbest;
    r[1] = gains[best_j];
    r[2] = static_cast<float>(best_j);
    r[3] = left[dir][t][0];
    r[4] = left[dir][t][1];
    r[5] = left[dir][t][2];
  }
}

// scan_child on a row of any B (int16 bins: B up to 32,768), walking the
// bins in chunks of kMaxBins with the running prefix (a double a channel)
// carried across chunks, so its shared scratch is scan_child's at
// kMaxBins: `row` [kMaxBins][3] stages a chunk of the child's (B, 3) row
// `hrow` (device memory), `left` is scan_child's.  Two passes:
// the first takes the feature's best gain over every chunk, the second
// walks the chunks again (the same prefixes, the same gains) and keeps
// each lane's preferred in-band candidate with its gain and left sums.
// Each candidate's value, the best gain and the pick (the highest
// preference, then the lowest index) are scan_child's, so at B <= kMaxBins
// the residue row is scan_child's bit for bit.
template <int OPTS>
__device__ __forceinline__ void scan_child_wide(
    const float* __restrict__ hrow, float (*row)[3],
    float (*left)[kMaxBins][3], int lane, int child, int f,
    int nf, int B, const int* __restrict__ fmeta, bool usable,
    const float* sc, const float* cs, const ScanParams& prm,
    const ScanLegs& legs, float* residue) {
  const int mt = fmeta[nf + f];
  const int nanb = fmeta[2 * nf + f];
  const int zb = fmeta[3 * nf + f];
  const bool is_nan_f = mt == kMissingNan;
  const bool is_zero_f = mt == kMissingZero;
  const ScanConsts k =
      scan_consts<OPTS>(child, f, nf, fmeta, usable, cs, prm, legs);
  const bool rev_like_a = mt == kMissingNone || k.nbins_f <= 2;
  float nan_c = 0.f, zero_c = 0.f;
  if (lane < 3) {
    nan_c = hrow[(nanb < 0 ? 0 : nanb) * 3 + lane];
    zero_c = hrow[zb * 3 + lane];
    if (sc) {
      nan_c = __fmul_rn(nan_c, sc[lane]);
      zero_c = __fmul_rn(zero_c, sc[lane]);
    }
  }
  float fbest = -INFINITY, floor_g = 0.f;
  int best_pref = -2, best_j = 0;
  float best_g = 0.f, best_l[3] = {0.f, 0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    double acc = 0.0;
    for (int c0 = 0; c0 < B; c0 += kMaxBins) {
      const int cn = B - c0 < kMaxBins ? B - c0 : kMaxBins;
      for (int i = lane; i < cn * 3; i += 32)
        (&row[0][0])[i] = hrow[static_cast<size_t>(c0) * 3 + i];
      __syncwarp();
      if (lane < 3) {
        for (int b = 0; b < cn; ++b) {
          acc += static_cast<double>(row[b][lane]);
          float cum = static_cast<float>(acc);
          if (sc) cum = __fmul_rn(cum, sc[lane]);
          left_pair(cum, c0 + b, is_nan_f, is_zero_f, zb, nan_c, zero_c,
                    left[0][b][lane], left[1][b][lane]);
        }
      }
      __syncwarp();
      for (int i = lane; i < 2 * cn; i += 32) {
        const int dir = i >= cn;
        const int tl = i - dir * cn;
        const int t = c0 + tl;
        const float lg = left[dir][tl][0], lh = left[dir][tl][1],
                    lc = left[dir][tl][2];
        const float g = candidate_gain<OPTS>(k, dir, t, lg, lh, lc, prm);
        if (pass == 0) {
          fbest = nan_max(fbest, g);
          continue;
        }
        const int j = dir * B + t;
        const int v = g >= floor_g ? candidate_pref(j, B, rev_like_a) : -1;
        if (v > best_pref || (v == best_pref && j < best_j)) {
          best_pref = v;
          best_j = j;
          best_g = g;
          best_l[0] = lg;
          best_l[1] = lh;
          best_l[2] = lc;
        }
      }
      __syncwarp();  // the chunk's scratch is read before the next one
    }
    if (pass == 0) {
      for (int o = 16; o > 0; o >>= 1)
        fbest = nan_max(fbest, __shfl_xor_sync(0xffffffffu, fbest, o));
      floor_g = band_floor(fbest, k.shift);
    }
  }
  int win_pref = best_pref, win_j = best_j;
  for (int o = 16; o > 0; o >>= 1) {
    const int op = __shfl_xor_sync(0xffffffffu, win_pref, o);
    const int oj = __shfl_xor_sync(0xffffffffu, win_j, o);
    if (op > win_pref || (op == win_pref && oj < win_j)) {
      win_pref = op;
      win_j = oj;
    }
  }
  // the lane that holds the winning candidate writes the row
  if (best_pref == win_pref && best_j == win_j) {
    float* r = residue + (static_cast<size_t>(child) * nf + f) * 6;
    r[0] = fbest;
    r[1] = best_g;
    r[2] = static_cast<float>(best_j);
    r[3] = best_l[0];
    r[4] = best_l[1];
    r[5] = best_l[2];
  }
}

// The columns of a packed split row (ops/split.py pick_pack): gain,
// feature, threshold, default left, left g/h/c, right g/h/c.
constexpr int kPackCols = 10;

// One child's cross-feature pick by one thread: ops/split.py pick_pack on
// its (nf, 6) residue `res` (scan_child's rows), its sums `cs` and its
// parent output `pout` (the shift's, read under kOptSmooth) -> its packed
// row `row` [kPackCols].  The shift is gain_shift's, the tie band
// kTieRtol's as in scan_child; the first feature in the band wins (0 when
// none is: a NaN best), and a non-finite gain there becomes -inf.  Every
// f32 op rounds once, as each PyTorch op of pick_pack does, so the row is
// pick_pack's bit for bit.  The split-scan kernel's pick (split_scan.cu,
// on the residue in shared memory), its pick-only kernel (the fused
// round's) and K6's stage 5 run this one function.
template <int OPTS>
__device__ __forceinline__ void pick_child(const float* res, const float* cs,
                                           float pout,
                                           const int* __restrict__ fmeta,
                                           int nf, int B,
                                           const ScanParams& prm,
                                           float* row) {
  float gbest = res[0];
  for (int f = 1; f < nf; ++f) gbest = nan_max(gbest, res[f * 6]);
  const float shift = gain_shift<OPTS>(cs[0], cs[1], pout, prm);
  const float babs = isfinite(gbest) ? fabsf(gbest) : 0.f;
  const float floor_g =
      __fsub_rn(gbest, __fmul_rn(kTieRtol, __fadd_rn(fabsf(shift), babs)));
  int feature = 0;  // the first feature in the band (0 if none)
  for (int f = 0; f < nf; ++f) {
    if (res[f * 6] >= floor_g) {
      feature = f;
      break;
    }
  }
  const float* rf = res + feature * 6;
  const float best = rf[1];
  const int sc = static_cast<int>(rf[2]);
  const int dir = sc / B;
  const int mt = fmeta[nf + feature];
  const bool dl = (mt == kMissingNan || mt == kMissingZero) && dir == 1;
  row[0] = isfinite(best) ? best : -INFINITY;
  row[1] = static_cast<float>(feature);
  row[2] = static_cast<float>(sc % B);
  row[3] = dl ? 1.f : 0.f;
  row[4] = rf[3];
  row[5] = rf[4];
  row[6] = rf[5];
  row[7] = __fsub_rn(cs[0], rf[3]);
  row[8] = __fsub_rn(cs[1], rf[4]);
  row[9] = __fsub_rn(cs[2], rf[5]);
}

// Shared memory of scan_item: h2 [2][kMaxBins][3], left2
// [2][2][kMaxBins][3], gains [2][2 kMaxBins] floats.
constexpr int kScanSmemFloats =
    2 * kMaxBins * 3 + 2 * 2 * kMaxBins * 3 + 2 * 2 * kMaxBins;
// The threads of a scan group: two warps, one a child.
constexpr int kScanGroup = 64;

// A barrier of the kScanGroup threads of scan group `id` - 1 (named
// barrier `id`, 1..15; 0 is __syncthreads'), so groups of one block run
// their items apart.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kScanGroup) : "memory");
}

// Work item (s, f): the children 2s and 2s + 1 of feature f, by one scan
// group (gtid its thread, `bar` its named barrier, `sm` its
// kScanSmemFloats of shared memory): its kScanGroup threads merge the
// partials (merge_cell, in chunk order), then warp 0 scans the left child
// and warp 1 the right (scan_child).  It opens with a group barrier, so a
// group may run items back to back.  In subtraction mode `par`
// is the slot's parent histogram of feature f ((B, 3), or null for a zero
// parent) and `sml` says the smaller child is the left one; `hs` (the
// smaller child) and `out_l` / `out_r` (the children) receive their
// (B, 3) rows when not null — `out_l` may be `par`.  Writes the residue
// rows [best gain, gain at the pick, pick, left g/h/c] of both children.
// `scale` (null: none) dequantizes an int8sr round (PREC kInt8sr: the
// partials are int32) or carries a quantized grow's ones: in subtraction
// mode the slot's 3 scales multiply the smaller child before the
// subtraction (the Pallas kernel's apply_scale, hsmall stays raw);
// pool-free the two children's 3 scales each multiply the prefix sums
// after the cumulative sum and the missing-mass reads (child_scale).
// Every scale is a power of two, so each multiply is exact.  OPTS /
// prm.opts / legs: the scan's options (scan_child).
template <int PREC, int NC, bool SUB, int OPTS>
__device__ __forceinline__ void scan_item(
    int s, int f, int gtid, int bar, const float* partial, int n_chunks,
    int nf, int nl, int nb, int B, const int* __restrict__ fmeta,
    const uint8_t* mask,
    const float* csums, bool sml, const float* par, const float* scale,
    float* hs, float* out_l, float* out_r, float* residue,
    const ScanParams& prm, const ScanLegs& legs, float* sm) {
  float(*h2)[kMaxBins][3] = reinterpret_cast<float(*)[kMaxBins][3]>(sm);
  float(*left2)[2][kMaxBins][3] =
      reinterpret_cast<float(*)[2][kMaxBins][3]>(sm + 2 * kMaxBins * 3);
  float(*gains)[2 * kMaxBins] = reinterpret_cast<float(*)[2 * kMaxBins]>(
      sm + 2 * kMaxBins * 3 + 2 * 2 * kMaxBins * 3);
  const int tid = gtid;
  const size_t stride = static_cast<size_t>(nf) * nl * nb * NC;
  group_sync(bar);  // the group's last item no longer reads `sm`

  // ---- merge the partials; subtraction mode subtracts from the parent --
  if (SUB) {
    for (int i = tid; i < B * 3; i += kScanGroup) {
      const int b = i / 3, c = i % 3;
      const float v = merge_cell<PREC, NC>(
          partial + ((static_cast<size_t>(f) * nl + s) * nb + b) * NC + c,
          stride, n_chunks);
      if (hs) hs[i] = v;
      const float vs = scale ? __fmul_rn(v, scale[c]) : v;
      const float p = par ? par[i] : 0.f;
      const float hl = sml ? vs : __fsub_rn(p, vs);
      const float hr = __fsub_rn(p, hl);
      h2[0][b][c] = hl;
      h2[1][b][c] = hr;
      if (out_l) {
        out_l[i] = hl;
        out_r[i] = hr;
      }
    }
  } else {
    for (int i = tid; i < 2 * B * 3; i += kScanGroup) {
      const int w = i / (B * 3), b = (i / 3) % B, c = i % 3;
      h2[w][b][c] = merge_cell<PREC, NC>(
          partial +
              ((static_cast<size_t>(f) * nl + 2 * s + w) * nb + b) * NC + c,
          stride, n_chunks);
    }
  }
  group_sync(bar);

  const int w = tid >> 5;
  const int child = 2 * s + w;
  const bool usable = fmeta[4 * nf + f] != 0 && mask[child * nf + f] != 0;
  scan_child<OPTS>(h2[w], left2[w], gains[w], tid & 31, child, f, nf, B,
                   fmeta, usable, !SUB && scale ? scale + 3 * w : nullptr,
                   csums + 3 * child, prm, legs, residue);
}

}  // namespace lgbm

// Native batch ensemble predictor (C ABI, ctypes-loaded); the port's copy
// of lightgbmv1_tpu/native/predictor.cpp.
//
// The reference's deployment predictor is C++ with OMP row parallelism
// (src/application/predictor.hpp:29-160 + Tree::Predict tree walks,
// include/LightGBM/tree.h:132,302-339).  This is the same role for this
// framework: a tight per-row root-to-leaf walk over flattened tree arrays,
// row-partitioned across std::threads.  Semantics mirror
// models/tree.py HostTree._go_left exactly:
//   - missing NaN  -> default direction when missing_type == NaN
//   - missing Zero -> NaN or |v| <= 1e-35 -> default direction
//   - otherwise NaN is treated as 0.0 and compared numerically
//   - categorical: C-truncated value, membership in the node's raw-category
//     bitset; negatives/NaN/out-of-range go right.
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {
constexpr double kZeroThreshold = 1e-35;

struct Ensemble {
  const double* X;
  int64_t n, F;
  int T, K;
  const int64_t* node_off;   // T+1 node offsets
  const int64_t* leaf_off;   // T+1 leaf offsets
  const int* feat;
  const double* thr;
  const unsigned char* flags;  // bit0 default_left, bits1-2 missing type,
                               // bit3 categorical
  const int* lc;
  const int* rc;
  const double* leaf_val;
  const int64_t* cat_off;    // per NODE offset into cat_words (-1 if none)
  const int* cat_len;     // per NODE word count
  const unsigned int* cat_words;
  const int* tree_k;      // class index per tree
  double* out;            // (n, K) row-major, pre-zeroed by the caller
};

inline bool go_left(const Ensemble& e, int64_t node, double v) {
  const unsigned char fl = e.flags[node];
  const bool is_nan = std::isnan(v);
  const double v0 = is_nan ? 0.0 : v;
  if (fl & 8u) {  // categorical
    if (is_nan) return false;
    // C truncation FIRST (values in (-1, 0) truncate to category 0, like
    // the numpy walk's np.trunc); negatives after truncation go right
    const int64_t c = static_cast<int64_t>(v0);
    if (c < 0) return false;
    const int64_t off = e.cat_off[node];
    const int64_t w = static_cast<int64_t>(c >> 5);
    if (off < 0 || w >= e.cat_len[node]) return false;
    return (e.cat_words[off + w] >> (c & 31)) & 1u;
  }
  const int mt = (fl >> 1) & 3;  // 0 none, 1 zero, 2 nan
  const bool miss =
      mt == 2 ? is_nan : (mt == 1 && (is_nan || std::fabs(v0) <= kZeroThreshold));
  if (miss) return fl & 1u;
  return v0 <= e.thr[node];
}

void predict_rows(const Ensemble& e, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const double* row = e.X + i * e.F;
    double* orow = e.out + i * e.K;
    for (int t = 0; t < e.T; ++t) {
      const int64_t nb = e.node_off[t];
      const int64_t lb = e.leaf_off[t];
      if (e.node_off[t + 1] == nb) {  // single-leaf tree
        orow[e.tree_k[t]] += e.leaf_val[lb];
        continue;
      }
      int64_t node = nb;
      for (;;) {
        const bool left = go_left(e, node, row[e.feat[node]]);
        const int c = left ? e.lc[node] : e.rc[node];
        if (c < 0) {
          orow[e.tree_k[t]] += e.leaf_val[lb + (~c)];
          break;
        }
        node = nb + c;
      }
    }
  }
}
}  // namespace

extern "C" {

int64_t pd_predict(const double* X, int64_t n, int64_t F, int T, int K,
                const int64_t* node_off, const int64_t* leaf_off, const int* feat,
                const double* thr, const unsigned char* flags, const int* lc,
                const int* rc, const double* leaf_val, const int64_t* cat_off,
                const int* cat_len, const unsigned int* cat_words,
                const int* tree_k, double* out, int nthreads) {
  Ensemble e{X,  n,  F,  T,  K,  node_off, leaf_off, feat,    thr, flags,
             lc, rc, leaf_val, cat_off, cat_len, cat_words, tree_k, out};
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int nt = nthreads > 0 ? nthreads : hw;
  if (static_cast<int64_t>(nt) > n) nt = static_cast<int>(n > 0 ? n : 1);
  if (nt <= 1) {
    predict_rows(e, 0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  const int64_t per = (n + nt - 1) / nt;
  for (int w = 0; w < nt; ++w) {
    const int64_t lo = w * per;
    const int64_t hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&e, lo, hi] { predict_rows(e, lo, hi); });
  }
  for (auto& th : threads) th.join();
  return 0;
}
}

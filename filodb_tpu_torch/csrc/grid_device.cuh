// The device code that the grid kernels share: the row sources, the
// cursor, the window-op paths lane_windows and lane_windows_ext with
// their families, the grouped kernels' sinks, and the shared-memory
// ring (mbarriers, cp.async, consumer_sync, stage_rows, SmemPackedSrc,
// RingWaits, RingStoreSink, and the warp-shuffle group sum's GroupPlan,
// SmemLinearSrc, SmemDenseSrc, RingWarpSumSink).  grid_kernels.cu (B3,
// B6, and the direct paths of B1, B2, B4 and B5), series_staged.cu (B1
// staged), hist_staged.cu (B5 staged), grouped_staged.cu (B4 staged) and
// dense_staged.cu (B2 staged) each include it and are compiled as
// separate translation units, in parallel (ops/kernels.py); the designs
// are noted in those files.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op { SUM = 0, COUNT = 1, AVG = 2, MIN = 3, MAX = 4, LAST = 5,
          RATE = 6, INCREASE = 7, DELTA = 8, IRATE = 9, IDELTA = 10,
          CHANGES = 11, RESETS = 12, STDDEV = 13, STDVAR = 14, ZSCORE = 15,
          DERIV = 16, PREDICT_LINEAR = 17, TIMESTAMP = 18, QUANTILE = 19,
          MAD = 20, HOLT_WINTERS = 21 };
enum Mode { FREE = 0, PHASE = 1, TS = 2 };

constexpr int kBlock = 128;
constexpr int kIBig = 1 << 30;
constexpr int kSortMaxK = 32;      // quantile/mad window cap (SORT_OPS_MAX_K)

struct Params {
  int T, K, stride, g, steps0, op, dense, is_rate;
  float farg, farg2;   // predict_linear's horizon; holt_winters' factors
  int rank_lo, rank_hi;        // quantile/mad interpolation ranks
  float w_lo, w_hi, fill;      // their weights; rank_lo < 0: fill
};

// One lane of a decoded f32 plane, read row by row.
struct DenseSrc {
  const float* p;
  long ld;
  __device__ float next() {
    float v = *p;
    p += ld;
    return v;
  }
};

// One lane of an XOR-class plane: widen -> shift -> running XOR ->
// XOR the first-row bits -> bitcast.  W is the stored word (uint8,
// uint16, uint32; raw f32 planes are read as their uint32 bits).
template <typename W>
struct PackedSrc {
  const W* p;
  long ld;
  uint32_t shift;
  uint32_t first;
  uint32_t x;
  __device__ float next() {
    uint32_t u = static_cast<uint32_t>(*p) << shift;
    p += ld;
    x ^= u;
    return __uint_as_float(x ^ first);
  }
};

// A row cursor: the source plus the running counter-correction state.
// After step(), raw is the row's value and val its corrected value.
template <class Src>
struct Cursor {
  Src src;
  int r;
  float prev, acc, raw, val;

  __device__ explicit Cursor(Src s)
      : src(s), r(0), prev(0.f), acc(0.f), raw(0.f), val(0.f) {}

  // correct: add the running sum of counter drops.  ffill: the previous
  // sample is the last FINITE one (row 0's before any); otherwise it is
  // the previous row.  NaN compares false, so it never drops.
  __device__ void step(bool correct, bool ffill) {
    float v = src.next();
    if (correct) {
      if (r == 0) prev = v;
      float drop = (v < prev) ? prev : 0.f;
      acc = acc + drop;
      val = v + acc;
      if (!ffill || isfinite(v)) prev = v;
    } else {
      val = v;
    }
    raw = v;
    ++r;
  }

  __device__ void advance_to(int row_end, bool correct, bool ffill) {
    while (r < row_end) step(correct, ffill);
  }
};

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b < a ? b : a);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : (b > a ? b : a);
}

// Window t's end, epoch-relative int32 ms (wrapping as int32 does).
__device__ __forceinline__ int window_end(int t, const Params& P) {
  return static_cast<int>(static_cast<unsigned>(P.steps0)
      + static_cast<unsigned>(t) * static_cast<unsigned>(P.g * P.stride));
}

// Prometheus extrapolatedRate (RateFunctions.scala:37-80) for window t.
__device__ float extrapolate(float nf, int t1, int t2, float v1, float v2,
                             int t, const Params& P) {
  float hi = static_cast<float>(window_end(t, P));
  float window = static_cast<float>(P.K * P.g);
  float lo = hi - window;
  float t1f = static_cast<float>(t1);
  float t2f = static_cast<float>(t2);
  float dur_start = (t1f - lo) / 1000.0f;
  float dur_end = (hi - t2f) / 1000.0f;
  float sampled = (t2f - t1f) / 1000.0f;
  float avg_dur = sampled / fmaxf(nf - 1.0f, 1.0f);
  float delta = v2 - v1;
  if (P.op != DELTA) {  // counter zero-point clamp (rate/increase)
    float dur_zero = sampled * v1 / (delta == 0.f ? 1.f : delta);
    if (delta > 0.f && v1 >= 0.f && dur_zero < dur_start)
      dur_start = dur_zero;
  }
  float thresh = avg_dur * 1.1f;
  float half = avg_dur / 2.0f;
  float extrap = sampled + (dur_start < thresh ? dur_start : half)
      + (dur_end < thresh ? dur_end : half);
  float scaled = delta * extrap / (sampled == 0.f ? 1.f : sampled);
  if (P.op == RATE && P.is_rate) scaled = scaled / (window / 1000.0f);
  return (nf >= 2.f && sampled > 0.f) ? scaled : NAN;
}

// rate/increase/delta under dense + uniform phase: the geometry is a
// per-lane constant, the formula divide-free (grid.py _phase_block_raw).
__device__ float phase_rate(float v1, float delta, float phase,
                            const Params& P) {
  const int K = P.K, g = P.g;
  if (P.op == DELTA)
    return delta * static_cast<float>(static_cast<double>(K) / (K - 1));
  float sampled = static_cast<float>(static_cast<double>((K - 1) * g) * 1e-3);
  float phase_s = phase * static_cast<float>(1e-3);
  float g_s = static_cast<float>(static_cast<double>(g) * 1e-3);
  float num = (P.op == RATE && P.is_rate)
      ? static_cast<float>(1e3 / static_cast<double>(K * g)) : 1.0f;
  float scale = num / sampled;
  float end_sc = (sampled + g_s - phase_s) * scale;
  float sv1 = sampled * v1;
  float pd = phase_s * delta;
  float start_num = (sv1 < pd && v1 >= 0.f) ? sv1 : pd;
  return delta * end_sc + start_num * scale;
}

// Sink of the per-lane kernels: step t's value to out[t * ld].
struct StoreSink {
  float* out;
  long ld;
  __device__ void operator()(int t, float v, bool) { out[t * ld] = v; }
};

// The grouped kernels' sinks.  Each CTA owns one group and takes its lanes
// blockDim at a time (a pass); begin() opens a pass, the sink is called
// at every step of every lane, and finish() writes the group's (sum,
// count) rows, slot j's step t at sum[j * T + t].  Both keep their
// running sums in shared memory, zeroed by make() (BucketSink in the
// zeroed output rows when they do not fit), and add in a fixed order,
// with no atomics.

// One bucket a group (hb = 1).  Each warp reduces its 32 lanes by
// shuffles and its lane 0 adds the result to the warp's own row of
// partials [T] (sum, then count), so warps never wait for each other;
// finish() adds the warps' rows in warp order.  Shared: 2 * T floats a
// warp.
struct WarpSumSink {
  float* part;
  int T;
  bool active;

  __device__ static int warp() { return static_cast<int>(threadIdx.x) >> 5; }

  __device__ static WarpSumSink make(float* sh, int T, int, float*, float*,
                                     bool) {
    const int n = 2 * T * static_cast<int>(blockDim.x >> 5);
    for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = 0.f;
    __syncthreads();
    return WarpSumSink{sh + warp() * 2 * T, T, false};
  }

  __device__ void begin(int first_col, int group_lanes) {
    active = first_col + static_cast<int>(threadIdx.x) < group_lanes;
  }

  __device__ void operator()(int t, float v, bool ok) {
    ok = ok && active;
    float x = ok ? v : 0.f;
    float c = ok ? 1.f : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) {
      part[t] = part[t] + x;
      part[T + t] = part[T + t] + c;
    }
  }

  __device__ void finish(float* sum, float* cnt) {
    __syncthreads();
    const float* rows = part - warp() * 2 * T;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float s = 0.f, n = 0.f;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
        s = s + rows[w * 2 * T + t];
        n = n + rows[w * 2 * T + T + t];
      }
      sum[t] = s;
      cnt[t] = n;
    }
  }
};

// hb buckets a group, column c of the group into bucket c % hb (any hb).
// At each step the CTA's lanes write their values to a shared row, and
// thread j adds bucket j's lanes to its running sum in lane order, across
// passes too: bucket j's sum is the plain left-to-right sum of its
// series, which a reference can repeat bit for bit.  The row is
// double-buffered by step parity, so one barrier a step suffices.  The
// running sums [2][hb][T] sit in shared memory when they fit, else in
// the zeroed output rows.  Shared: 4 * blockDim floats, + 2 * hb * T.
struct BucketSink {
  float* row;
  float* acc_s;
  float* acc_c;
  int T, hb;
  bool in_shared;
  int first;       // group column of this pass's thread 0
  int nvalid;      // threads of this pass that own a lane
  bool active;
  int k;           // calls so far: the row's parity

  __device__ static BucketSink make(float* sh, int T, int hb, float* sum,
                                    float* cnt, bool acc_shared) {
    float* acc = sh + 4 * static_cast<int>(blockDim.x);
    if (acc_shared) {
      for (int i = threadIdx.x; i < 2 * hb * T; i += blockDim.x) acc[i] = 0.f;
      __syncthreads();
      return BucketSink{sh, acc, acc + hb * T, T, hb, true, 0, 0, false, 0};
    }
    return BucketSink{sh, sum, cnt, T, hb, false, 0, 0, false, 0};
  }

  __device__ void begin(int first_col, int group_lanes) {
    first = first_col;
    nvalid = min(static_cast<int>(blockDim.x), group_lanes - first_col);
    active = static_cast<int>(threadIdx.x) < nvalid;
  }

  __device__ void operator()(int t, float v, bool ok) {
    ok = ok && active;
    const int nb = blockDim.x;
    float* bv = row + (k & 1) * 2 * nb;
    float* bc = bv + nb;
    ++k;
    const int tid = threadIdx.x;
    bv[tid] = ok ? v : 0.f;
    bc[tid] = ok ? 1.f : 0.f;
    __syncthreads();
    if (tid < hb) {
      float s = acc_s[tid * T + t], n = acc_c[tid * T + t];
      // from the first row slot whose group column lies in bucket tid
      for (int i = (tid - first % hb + hb) % hb; i < nvalid; i += hb) {
        s = s + bv[i];
        n = n + bc[i];
      }
      acc_s[tid * T + t] = s;
      acc_c[tid * T + t] = n;
    }
  }

  __device__ void finish(float* sum, float* cnt) {
    if (!in_shared) return;
    __syncthreads();
    for (int i = threadIdx.x; i < hb * T; i += blockDim.x) {
      sum[i] = acc_s[i];
      cnt[i] = acc_c[i];
    }
  }
};

// A template argument that is never deduced (C++20's type_identity_t):
// the window paths take their timestamps as a const int* unless a caller
// names another accessor.
template <class T>
struct same_type {
  using type = T;
};

// Row r of a lane's timestamps: p[r * ld], in device memory or in a ring
// whose rows lie in order (the staged kernels' linear layout).
__device__ __forceinline__ int ts_at(const int* p, int r, long ld) {
  return p[r * ld];
}

// A lane's timestamps in a ring of Tile-word rows whose rows wrap (the
// staged kernels' wrapping layout): plane row r at ring row (r0 + r) &
// mask.
template <int Tile>
struct RingTs {
  const int* col;
  int mask;
  int r0;
};

template <int Tile>
__device__ __forceinline__ int ts_at(const RingTs<Tile>& t, int r, long) {
  return t.col[((t.r0 + r) & t.mask) * Tile];
}

// The shared window-op path: every output step of one lane, handed to
// sink(t, value, ok) where ok says whether the group reduce takes the
// value: the lane's row-0 liveness in phase mode, finiteness otherwise.
// Timestamps are read as ts_at(ts, row, ts_ld).
template <class Src, class Sink, class Ts = const int*>
__device__ void lane_windows(Src src, typename same_type<Ts>::type ts,
                             long ts_ld, float phase, int mode,
                             const Params& P, Sink& sink) {
  const int K = P.K;
  if (mode == PHASE) {
    const bool correct = P.op != DELTA;
    Cursor<Src> a(src), b(src);
    a.step(correct, false);
    const bool live = isfinite(a.raw);     // liveness is row 0's
    for (int t = 0; t < P.T; ++t) {
      const int base = t * P.stride;
      a.advance_to(base + 1, correct, false);
      b.advance_to(base + K, correct, false);
      float o = phase_rate(a.val, b.val - a.val, phase, P);
      sink(t, live ? o : NAN, live);
    }
    return;
  }
  if (mode == TS) {
    const bool correct = P.op != DELTA;
    Cursor<Src> a(src), b(src);
    for (int t = 0; t < P.T; ++t) {
      const int base = t * P.stride;
      float nf, v1, v2;
      int t1, t2;
      if (P.dense) {
        a.advance_to(base + 1, correct, false);
        b.advance_to(base + K, correct, false);
        nf = isfinite(a.raw) ? static_cast<float>(K) : 0.f;
        t1 = ts_at(ts, base, ts_ld);
        t2 = ts_at(ts, base + K - 1, ts_ld);
        v1 = a.val;
        v2 = b.val;
      } else {
        a.advance_to(base, correct, true);
        Cursor<Src> c = a;
        nf = 0.f;
        t1 = t2 = kIBig;
        v1 = v2 = NAN;
        for (int d = 0; d < K; ++d) {
          c.step(correct, true);
          if (isfinite(c.raw)) {
            const int tt = ts_at(ts, base + d, ts_ld);
            if (nf == 0.f) {
              t1 = tt;
              v1 = c.val;
            }
            nf = nf + 1.f;
            t2 = tt;
            v2 = c.val;
          }
        }
      }
      const float o = extrapolate(nf, t1, t2, v1, v2, t, P);
      sink(t, o, isfinite(o));
    }
    return;
  }
  // FREE: the *_over_time family, values only
  Cursor<Src> a(src), b(src);
  for (int t = 0; t < P.T; ++t) {
    const int base = t * P.stride;
    float o;
    if (P.dense && P.op == LAST) {
      b.advance_to(base + K, false, false);
      o = b.raw;
    } else if (P.dense) {
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      c.step(false, false);
      const bool live = isfinite(c.raw);
      float acc = c.raw;
      if (P.op == COUNT) {
        acc = static_cast<float>(K);
      } else {
        for (int d = 1; d < K; ++d) {
          c.step(false, false);
          if (P.op == MIN) acc = min_nan(acc, c.raw);
          else if (P.op == MAX) acc = max_nan(acc, c.raw);
          else acc = acc + c.raw;
        }
        if (P.op == AVG) acc = acc / static_cast<float>(K);
      }
      o = live ? acc : NAN;
    } else {
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      float cnt = 0.f, last = NAN;
      float acc = (P.op == MIN) ? INFINITY : (P.op == MAX) ? -INFINITY : 0.f;
      for (int d = 0; d < K; ++d) {
        c.step(false, false);
        const float v = c.raw;
        const bool fin = isfinite(v);
        if (fin) {
          cnt = cnt + 1.f;
          last = v;
        }
        if (P.op == SUM || P.op == AVG) acc = acc + (fin ? v : 0.f);
        else if (P.op == MIN) acc = min_nan(acc, fin ? v : INFINITY);
        else if (P.op == MAX) acc = max_nan(acc, fin ? v : -INFINITY);
      }
      if (P.op == LAST) o = last;
      else if (P.op == COUNT) o = cnt > 0.f ? cnt : NAN;
      else if (P.op == AVG) o = cnt > 0.f ? acc / fmaxf(cnt, 1.f) : NAN;
      else if (P.op == MIN || P.op == MAX) o = isfinite(acc) ? acc : NAN;
      else o = cnt > 0.f ? acc : NAN;
    }
    sink(t, o, isfinite(o));
  }
}

// The second op set: the window functions beyond the nine above, each
// family its own instantiation of lane_windows_ext, so that the nine ops'
// code (lane_windows, shared with the grouped kernels) compiles as it did
// and no family's registers or sort array weigh on another's.  Each
// repeats its plain version in filodb_tpu_torch/ops/grid.py op for op.
//   F_PAIR    irate, idelta (ts, dense): the window's last two rows.
//   F_LINREG  deriv, predict_linear (ts): least squares over the window.
//   F_STAMP   timestamp (ts): the last finite row's ts before window end.
//   F_CHANGES changes, resets (free, dense): consecutive-row pairs.
//   F_MOMENTS stddev, stdvar, zscore (free): window moments.
// The moments and the regression's y are taken relative to the window's
// first finite value: a counter near 1e6 moving a few a step then keeps
// its f32 answer within a few ulps (the TPU kernel's lane-wide centre
// loses 1e-4 of a variance there, and 1e-3 of a zscore or a slope).
//   F_SORT    quantile, mad (free, dense, K <= 32): a sorted window, in
//             registers up to K = kSortRegK (one instantiation a K); mad
//             merges the deviations' two monotone runs instead of sorting
//             them again.
//   F_HOLT    holt_winters (free, dense): double exponential smoothing.
enum Family { F_BASE = 0, F_PAIR, F_LINREG, F_STAMP, F_CHANGES, F_MOMENTS,
              F_SORT, F_HOLT };

inline int family_of(int op) {
  switch (op) {
    case IRATE: case IDELTA: return F_PAIR;
    case DERIV: case PREDICT_LINEAR: return F_LINREG;
    case TIMESTAMP: return F_STAMP;
    case CHANGES: case RESETS: return F_CHANGES;
    case STDDEV: case STDVAR: case ZSCORE: return F_MOMENTS;
    case QUANTILE: case MAD: return F_SORT;
    case HOLT_WINTERS: return F_HOLT;
    default: return F_BASE;
  }
}

inline bool reads_ts(int fam) {
  return fam == F_PAIR || fam == F_LINREG || fam == F_STAMP;
}

// Insertion sort of s[0..K): any correct sort gives the plain version's
// sorting network's values.
__device__ void sort_window(float* s, int K) {
  for (int i = 1; i < K; ++i) {
    const float v = s[i];
    int j = i - 1;
    while (j >= 0 && s[j] > v) {
      s[j + 1] = s[j];
      --j;
    }
    s[j + 1] = v;
  }
}

// Linear interpolation at the host's fixed ranks (grid.py
// _interp_weights).
__device__ __forceinline__ float interp_sorted(const float* s,
                                               const Params& P) {
  if (P.rank_lo < 0) return P.fill;
  if (P.rank_lo == P.rank_hi) return s[P.rank_lo];
  return s[P.rank_lo] * P.w_lo + s[P.rank_hi] * P.w_hi;
}

// quantile and mad over a window s[0..K) in local memory, sorted in
// place.  mad takes the median of the deviations |s[d] - q| from the
// median q without a second sort: over a sorted window they are two
// monotone runs, descending below q and ascending from it, and a merge of
// the two gives them in sorted order.  fabsf(a - b) == fabsf(b - a) in
// IEEE arithmetic and the deviations carry no -0.0, so the merged floats
// are the ones a sort gives, bit for bit.  A NaN breaks the runs (and the
// insertion sort's order, which the plain version's sorting network does
// not share), so a window with a NaN deviation sorts them as before.
__device__ float sort_op_local(float* s, int K, const Params& P) {
  sort_window(s, K);
  const float q = interp_sorted(s, P);
  if (P.op != MAD) return q;
  int below = 0;                       // s[0..below) < q
  bool nan = false;
  for (int d = 0; d < K; ++d) {
    if (s[d] < q) below = d + 1;
    s[d] = fabsf(s[d] - q);
    nan = nan || isnan(s[d]);
  }
  if (nan) {
    sort_window(s, K);
    return interp_sorted(s, P);
  }
  float m[kSortMaxK];
  const int need = P.rank_lo < 0 ? 0 : P.rank_hi + 1;
  int i = below - 1, j = below;
  for (int k = 0; k < need; ++k)
    m[k] = (j >= K || (i >= 0 && s[i] <= s[j])) ? s[i--] : s[j++];
  return interp_sorted(m, P);
}

constexpr int kSortRegK = 8;   // windows this short stay in registers

// A compare-exchange that swaps only a pair strictly out of order, so
// equal floats (+0.0 and -0.0) keep their order, as in the insertion sort.
__device__ __forceinline__ void order_pair(float& lo, float& hi) {
  const bool swap = lo > hi;
  const float l = swap ? hi : lo;
  hi = swap ? lo : hi;
  lo = l;
}

// v[i] for a run-time i, by selects, so that v stays in registers.
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = (i == k) ? v[k] : r;
  return r;
}

template <int N>
__device__ __forceinline__ float interp_regs(const float (&v)[N],
                                             const Params& P) {
  if (P.rank_lo < 0) return P.fill;
  const float lo = pick(v, P.rank_lo);
  if (P.rank_lo == P.rank_hi) return lo;
  return lo * P.w_lo + pick(v, P.rank_hi) * P.w_hi;
}

// quantile and mad over the N = K <= kSortRegK rows that cursor c walks,
// in registers (every index a compile-time one): an odd-even
// transposition sort of order_pair (stable, so it gives the insertion
// sort's floats), and for mad the deviations, a V-shaped (bitonic)
// sequence, padded with +Inf to a power of two and put in order by a
// bitonic merge.  A window or deviation holding a NaN goes through
// sort_op_local, the code that served it before.  first: row 0's value.
template <int N, class Src>
__device__ float sort_op_regs(Cursor<Src>& c, const Params& P,
                              float& first) {
  static_assert(N >= 1 && N <= kSortRegK, "a register window");
  constexpr int M = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : 8;
  float v[N];
  bool nan = false;
#pragma unroll
  for (int d = 0; d < N; ++d) {
    c.step(false, false);
    v[d] = c.raw;
    nan = nan || isnan(v[d]);
  }
  first = v[0];
  if (nan) {
    float s[N];
#pragma unroll
    for (int d = 0; d < N; ++d) s[d] = v[d];
    return sort_op_local(s, N, P);
  }
#pragma unroll
  for (int round = 0; round < N; ++round) {
#pragma unroll
    for (int i = round & 1; i + 1 < N; i += 2) order_pair(v[i], v[i + 1]);
  }
  const float q = interp_regs(v, P);
  if (P.op != MAD) return q;
  float dev[M];
  bool bad = false;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    dev[d] = d < N ? fabsf(v[d] - q) : INFINITY;
    bad = bad || isnan(dev[d]);
  }
  if (bad) {
    float s[N];
#pragma unroll
    for (int d = 0; d < N; ++d) s[d] = dev[d];
    sort_window(s, N);
    return interp_sorted(s, P);
  }
#pragma unroll
  for (int k = M / 2; k > 0; k >>= 1) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      if ((i & k) == 0) order_pair(dev[i], dev[i + k]);
  }
  return interp_regs(dev, P);
}

template <int Fam, class Src, class Sink, class Ts = const int*>
__device__ void lane_windows_ext(Src src,
                                 typename same_type<Ts>::type ts,
                                 long ts_ld, const Params& P, Sink& sink) {
  const int K = P.K;
  Cursor<Src> a(src), b(src);
  for (int t = 0; t < P.T; ++t) {
    const int base = t * P.stride;
    float o = NAN;
    if constexpr (Fam == F_PAIR) {
      if (K >= 2) {
        a.advance_to(base + K - 1, false, false);   // row base+K-2
        b.advance_to(base + K, false, false);       // row base+K-1
        const float v1 = a.raw, v2 = b.raw;
        const int t1 = ts_at(ts, base + K - 2, ts_ld);
        const int t2 = ts_at(ts, base + K - 1, ts_ld);
        float delta = v2 - v1;
        if (P.op == IRATE && v2 < v1) delta = v2;   // adjacent-pair reset
        const float dts = static_cast<float>(t2 - t1) / 1000.0f;
        if (isfinite(v2) && dts > 0.f)
          o = (P.op == IDELTA) ? delta : delta / dts;
      }
    } else if constexpr (Fam == F_STAMP) {
      const unsigned hi = static_cast<unsigned>(window_end(t, P));
      int sel = kIBig;
      if (P.dense) {
        a.advance_to(base + 1, false, false);       // liveness: row base
        if (isfinite(a.raw)) sel = ts_at(ts, base + K - 1, ts_ld);
      } else {
        a.advance_to(base, false, false);
        Cursor<Src> c = a;
        for (int d = 0; d < K; ++d) {                // last finite wins
          c.step(false, false);
          if (isfinite(c.raw)) sel = ts_at(ts, base + d, ts_ld);
        }
      }
      if (sel != kIBig)
        o = static_cast<float>(static_cast<int>(
                static_cast<unsigned>(sel) - hi)) / 1000.0f;
    } else if constexpr (Fam == F_LINREG) {
      const float hi = static_cast<float>(window_end(t, P));
      const float shift = static_cast<float>(
          static_cast<double>(K * P.g) / 1000.0 / 2.0);
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      float n = 0.f, sx = 0.f, sy = 0.f, sxx = 0.f, sxy = 0.f, y0 = NAN;
      for (int d = 0; d < K; ++d) {
        c.step(false, false);
        if (!isfinite(c.raw)) continue;
        if (n == 0.f) y0 = c.raw;           // y from the first finite value
        const float x = (static_cast<float>(ts_at(ts, base + d, ts_ld)) - hi)
            / 1000.0f + shift;
        const float y = c.raw - y0;
        n = n + 1.f;
        sx = sx + x;
        sy = sy + y;
        sxx = sxx + x * x;
        sxy = sxy + x * y;
      }
      const float nsafe = fmaxf(n, 1.f);
      const float cov = sxy - sx * sy / nsafe;
      const float var = sxx - sx * sx / nsafe;
      const float slope = cov / (var == 0.f ? 1.f : var);
      if (n >= 2.f && var > 0.f) {
        if (P.op == DERIV) {
          o = slope;
        } else {
          const float intercept = sy / nsafe - slope * (sx / nsafe - shift);
          o = (intercept + slope * P.farg) + y0;
        }
      }
    } else if constexpr (Fam == F_CHANGES) {
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      c.step(false, false);
      float prev = c.raw;
      const bool live = isfinite(prev);
      float cnt = 0.f;
      for (int d = 1; d < K; ++d) {
        c.step(false, false);
        const float cur = c.raw;
        const bool hit = (P.op == CHANGES) ? (cur != prev) : (cur < prev);
        cnt = cnt + (hit ? 1.f : 0.f);
        prev = cur;
      }
      if (live) o = cnt;
    } else if constexpr (Fam == F_MOMENTS) {
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      float s1 = 0.f, s2 = 0.f, n = 0.f, c0 = NAN, lastv = NAN;
      for (int d = 0; d < K; ++d) {
        c.step(false, false);
        const float v = c.raw;
        if (!isfinite(v)) continue;
        if (n == 0.f) c0 = v;               // x from the first finite value
        const float xd = v - c0;
        s1 = s1 + xd;
        s2 = s2 + xd * xd;
        n = n + 1.f;
        lastv = v;
      }
      const float nsafe = fmaxf(n, 1.f);
      const float mean_x = s1 / nsafe;
      const float var = max_nan(s2 / nsafe - mean_x * mean_x, 0.f);
      if (P.op == ZSCORE) {
        const float sd = sqrtf(var);
        const float z = ((lastv - c0) - mean_x) / (sd == 0.f ? 1.f : sd);
        if (n >= 2.f && sd > 0.f) o = z;
      } else if (n > 0.f) {
        o = (P.op == STDDEV) ? sqrtf(var) : var;
      }
    } else if constexpr (Fam == F_SORT) {
      a.advance_to(base, false, false);
      Cursor<Src> c = a;
      float first, q;
      switch (K) {                        // K <= kSortRegK: in registers
        case 1: q = sort_op_regs<1>(c, P, first); break;
        case 2: q = sort_op_regs<2>(c, P, first); break;
        case 3: q = sort_op_regs<3>(c, P, first); break;
        case 4: q = sort_op_regs<4>(c, P, first); break;
        case 5: q = sort_op_regs<5>(c, P, first); break;
        case 6: q = sort_op_regs<6>(c, P, first); break;
        case 7: q = sort_op_regs<7>(c, P, first); break;
        case 8: q = sort_op_regs<8>(c, P, first); break;
        default: {
          float s[kSortMaxK];
          for (int d = 0; d < K; ++d) {
            c.step(false, false);
            s[d] = c.raw;
          }
          first = s[0];
          q = sort_op_local(s, K, P);
        }
      }
      if (isfinite(first)) o = q;
    } else if constexpr (Fam == F_HOLT) {
      if (K >= 2) {
        a.advance_to(base, false, false);
        Cursor<Src> c = a;
        c.step(false, false);
        float lvl = c.raw;
        const bool live = isfinite(lvl);
        const float sf = P.farg, tf = P.farg2;
        const float osf = 1.f - sf, otf = 1.f - tf;
        float trend = 0.f;
        for (int i = 1; i < K; ++i) {
          c.step(false, false);
          const float y = c.raw;
          const float b_eff = (i == 1) ? y - lvl : trend;
          const float xn = sf * y + osf * (lvl + b_eff);
          trend = tf * (xn - lvl) + otf * b_eff;
          lvl = xn;
        }
        if (live) o = lvl;
      }
    }
    sink(t, o, isfinite(o));
  }
}

// One lane of a packed plane, positioned at the query's first row: the
// XOR prefix starts at block row 0, the query reads from row0.
template <typename W>
__device__ PackedSrc<W> packed_lane(const W* plane, const int* meta, int n,
                                    int lane, int row0) {
  PackedSrc<W> src{plane + lane, n, static_cast<uint32_t>(meta[lane]),
                   static_cast<uint32_t>(meta[n + lane]), 0u};
  for (int r = 0; r < row0; ++r) src.next();
  return src;
}

constexpr size_t kShared48 = 48 * 1024;

// Dynamic shared memory above 48 KB must be allowed before a launch.
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= kShared48) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr int kTile = 128;        // lanes a CTA: one consumer thread each
constexpr int kStages = 4;        // ring stages
constexpr int kProducers = 32;    // the producer warp
constexpr int kMaxPlanes = 4;     // p8, p16, p32, raw
constexpr int kRingMin = 16 * 1024;
constexpr int kRingMax = 64 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that never
// ends is a fault in the ring protocol: trap after 2^22 polls (a stage
// arrives within microseconds), so the launch fails rather than hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// One arrival on bar once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// A barrier over the consumer threads [0, nthreads) only: a warp-
// specialised CTA's producer warp may be spinning on an "empty" mbarrier
// or gone, so a CTA-wide __syncthreads() there could deadlock.
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" :: "r"(nthreads) : "memory");
}

struct RingBars {
  uint64_t full[kStages];    // the stage's rows have landed (kProducers)
  uint64_t empty[kStages];   // every consumer is done with it
};

// log2 of the rows a ring stage of `ring_bytes` holds in words of
// `word` bytes for a tile of `tile` lanes, and whether a step of stride +
// K rows fits in three stages.
__host__ __device__ inline int stage_shift(int ring_bytes, int word,
                                           int tile = kTile) {
  int rows = ring_bytes / (kStages * tile * word), shift = 0;
  while ((2 << shift) <= rows) ++shift;
  return shift;
}

__host__ __device__ inline bool step_fits(int ring_bytes, int word,
                                          int stride, int K,
                                          int tile = kTile) {
  return ring_bytes >= kRingMin
      && stride + K <= (kStages - 1) << stage_shift(ring_bytes, word, tile);
}

// One lane of an XOR-class plane, read from its column of a ring of
// Tile-word rows (the decode of PackedSrc); r is the ring row, the block
// row plus the rows of any earlier pass over the ring.  It never waits:
// the sink waits, once a step, for every row the next step reads, so
// that nothing in a window's loop stops the compiler from batching its
// reads.
template <typename W, int Tile = kTile>
struct SmemPackedSrc {
  const W* col;
  int mask;          // ring rows - 1
  int r;
  uint32_t shift;
  uint32_t first;
  uint32_t x;
  __device__ float next() {
    const uint32_t u = static_cast<uint32_t>(col[(r & mask) * Tile]) << shift;
    ++r;
    x ^= u;
    return __uint_as_float(x ^ first);
  }
};

// The consumer's side of the ring.  Step t reads only rows [row0 + (t -
// 1) * stride, row0 + t * stride + K): after step t a sink frees the
// stages below row0 + t * stride and waits for the stages below row0 +
// (t + 1) * stride + K, the next step's rows.  `base` counts the ring
// chunks of earlier passes (a CTA that walks several tiles in turn).
struct RingWaits {
  RingBars* bars;
  int cshift;        // log2 rows a stage
  int row0, stride, K, rows;
  int base;          // ring chunks before this pass's
  int freed;         // this pass's stages freed so far, in ring order
  int ready;         // this pass's stages waited for so far
  __device__ void free_below(int row) {
    for (; (freed + 1) << cshift <= row; ++freed)
      mbar_arrive(bars->empty + (base + freed) % kStages);
  }
  __device__ void ready_below(int row) {
    row = min(row, rows);
    for (; ready << cshift < row; ++ready) {
      const int c = base + ready;
      mbar_wait(bars->full + c % kStages, (c / kStages) & 1);
    }
  }
};

// StoreSink that also runs the consumer's side of the ring.
struct RingStoreSink : RingWaits {
  float* out;
  long ld;
  bool store;        // a thread past the plane's last lane stores nothing
  __device__ void operator()(int t, float v, bool) {
    if (store) out[t * ld] = v;
    free_below(row0 + t * stride);
    ready_below(row0 + (t + 1) * stride + K);
  }
};

constexpr int kGroupTileMax = 256;    // consumer threads a CTA, at most
// the dynamic shared memory a CTA may use beside its static barriers
constexpr int kGroupSharedCta = 232448 - static_cast<int>(sizeof(RingBars));

// The staged grouped kernels with the warp-shuffle group sum (B4,
// grouped_staged.cu; B2, dense_staged.cu): a CTA a group, Tile consumer
// threads walking it in passes of Tile lanes and a producer warp.
//
// A launch's plan (grid.grouped_staged_plan, grid.dense_staged_plan):
// consumer threads and lanes a pass, ring bytes, and whether a pass's
// rows lie in the ring without wrapping (linear).
struct GroupPlan {
  int tile, ring_bytes, linear;
};

// Dynamic shared bytes of a plan: the ring, then a row of T partial sums
// and T partial counts for each consumer warp.
inline long group_shared_bytes(const GroupPlan& p, int T) {
  return static_cast<long>(p.ring_bytes) + 8L * (p.tile / 32) * T;
}

// Ring chunks a pass takes in the linear layout: its own, rounded up to a
// divisor of kStages, so that every pass starts on a stage where the last
// one's chunks ended and none wraps the ring.
__host__ __device__ inline int linear_chunks(int nchunks) {
  return nchunks <= 1 ? 1 : nchunks <= 2 ? 2 : kStages;
}

// One lane of an XOR-class plane in the linear layout: its column of the
// ring from the pass's first row on, read with no wrap (a pointer step a
// row, where SmemPackedSrc masks the row into the ring).  It never waits,
// as SmemPackedSrc does not.
template <typename W, int Tile>
struct SmemLinearSrc {
  const W* p;
  uint32_t shift;
  uint32_t first;
  uint32_t x;
  __device__ float next() {
    const uint32_t u = static_cast<uint32_t>(*p) << shift;
    p += Tile;
    x ^= u;
    return __uint_as_float(x ^ first);
  }
};

// One lane of a decoded f32 plane in the ring (DenseSrc's interface, so
// that Cursor copies it): in the linear layout its column from the pass's
// first row on, a pointer step a row; else (Linear false) ring row r & mask,
// r the plane row plus the rows of the earlier passes over the ring.  It
// never waits, as SmemPackedSrc does not.
template <int Tile, bool Linear>
struct SmemDenseSrc {
  const float* col;
  int mask;          // ring rows - 1 (the wrapping layout)
  int r;
  __device__ float next() {
    if constexpr (Linear) {
      const float v = *col;
      col += Tile;
      return v;
    } else {
      const float v = col[(r & mask) * Tile];
      ++r;
      return v;
    }
  }
};

// WarpSumSink on the consumer's side of the ring.  part is this warp's
// row of partials; finish() meets the consumers only, and counts Tile /
// 32 warps (blockDim also holds the producer warp).  Two things take
// fewer instructions a step than WarpSumSink and RingStoreSink, with the
// same bits:
// - with Ballot, a warp's count is the popcount of its ballot of taken
//   lanes: an integer of at most 32, which WarpSumSink's shuffle tree of
//   0/1 floats also sums exactly.  The base family takes it (2% off rate
//   at the north-star widths); it made the second op set's families 1-2%
//   slower, and they keep WarpSumSink's (PERF.md section 6);
// - a step compares its rows with two thresholds, the row from which the
//   next stage is freed and the row below which the ring has landed, and
//   calls RingWaits only where one is crossed (about once a stage).
template <int Tile, bool Ballot>
struct RingWarpSumSink : RingWaits, WarpSumSink {
  int free_row;      // (freed + 1) << cshift
  int ready_row;     // ready << cshift, or kIBig once every row has landed

  __device__ void begin(int first_col, int group_lanes) {
    WarpSumSink::begin(first_col, group_lanes);
    freed = ready = 0;
  }
  // Free the stages below row lo, await those below row hi, and move the
  // thresholds on.
  __device__ void sync_rows(int lo, int hi) {
    free_below(lo);
    ready_below(hi);
    free_row = (freed + 1) << cshift;
    ready_row = (ready << cshift) < rows ? ready << cshift : kIBig;
  }
  // After a pass's last step: free its remaining stages.
  __device__ void end(int nchunks) {
    free_below(nchunks << cshift);
    base += nchunks;
  }
  __device__ void operator()(int t, float v, bool ok) {
    if constexpr (Ballot) {
      ok = ok && active;
      float x = ok ? v : 0.f;
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      const float c =
          static_cast<float>(__popc(__ballot_sync(0xffffffffu, ok)));
      if ((threadIdx.x & 31) == 0) {
        part[t] = part[t] + x;
        part[T + t] = part[T + t] + c;
      }
    } else {
      WarpSumSink::operator()(t, v, ok);
    }
    const int lo = row0 + t * stride, hi = lo + stride + K;
    if (lo >= free_row || hi > ready_row) sync_rows(lo, hi);
  }
  __device__ void finish(float* sum, float* cnt) {
    consumer_sync(Tile);
    const float* parts = part - warp() * 2 * T;
    for (int t = threadIdx.x; t < T; t += Tile) {
      float s = 0.f, n = 0.f;
      for (int w = 0; w < Tile / 32; ++w) {
        s = s + parts[w * 2 * T + t];
        n = n + parts[w * 2 * T + T + t];
      }
      sum[t] = s;
      cnt[t] = n;
    }
  }
};

// Whether a plan is one the staged kernels take: a tile of 128 or 256
// lanes, a ring of 16, 32 or 64 KB in which the step fits three stages
// (and, in the linear layout, a pass's rows its four), and shared bytes
// within a CTA's.
inline bool group_plan_ok(const GroupPlan& p, int word, int row0,
                          const Params& P) {
  const int rows = row0 + (P.T - 1) * P.stride + P.K;
  return (p.tile == kTile || p.tile == kGroupTileMax)
      && (p.ring_bytes == kRingMin || p.ring_bytes == 2 * kRingMin
          || p.ring_bytes == kRingMax)
      && step_fits(p.ring_bytes, word, P.stride, P.K, p.tile)
      && (!p.linear
          || rows <= kStages << stage_shift(p.ring_bytes, word, p.tile))
      && group_shared_bytes(p, P.T) <= kGroupSharedCta;
}

// The producer warp (threads [Tile, Tile + 32) of the CTA): rows [0,
// rows) of the nl lanes from lane0 into a ring of Tile-word rows, a stage
// of 1 << cshift rows at a time, as the ring's chunks [c0, c0 + nchunks)
// (a CTA that stages several tiles in turn carries its chunk count on,
// so that no tile drains the ring).  Rows go by 16-byte cp.async where
// the plane and its rows are 16-byte aligned and `lanes_aligned` says the
// tile's lanes start and end on 16-byte boundaries (a tile of a multiple
// of 16 bytes from lane 0 does), else by plain loads.  Returns nchunks;
// does not wait for its copies to land (the caller's cp.async.wait_all).
template <typename W, int Tile = kTile>
__device__ int stage_rows(const W* plane, long n, int lane0, int nl,
                          int rows, int cshift, W* ring, RingBars& bars,
                          int c0 = 0, bool lanes_aligned = true) {
  const int pt = static_cast<int>(threadIdx.x) - Tile;
  const bool aligned = reinterpret_cast<uintptr_t>(plane) % 16 == 0
      && (n * static_cast<long>(sizeof(W))) % 16 == 0 && lanes_aligned;
  const int pieces = nl * static_cast<int>(sizeof(W)) / 16;   // a row
  const int chunk = 1 << cshift;
  const int nchunks = (rows + chunk - 1) >> cshift;
  for (int lc = 0; lc < nchunks; ++lc) {
    const int c = c0 + lc;
    const int s = c % kStages;
    if (c >= kStages) mbar_wait(&bars.empty[s], (c / kStages - 1) & 1);
    const int nr = min(chunk, rows - (lc << cshift));
    W* dst = ring + (s << cshift) * Tile;
    const W* src = plane + (static_cast<long>(lc) << cshift) * n + lane0;
    if (aligned) {
      for (int i = pt; i < nr * pieces; i += kProducers) {
        const int r = i / pieces, k = i - r * pieces;
        cp_async16(reinterpret_cast<char*>(dst + r * Tile) + 16 * k,
                   reinterpret_cast<const char*>(src + r * n) + 16 * k);
      }
      cp_async_arrive(&bars.full[s]);
    } else {
      for (int i = pt; i < nr * nl; i += kProducers) {
        const int r = i / nl, j = i - r * nl;
        dst[r * Tile + j] = src[r * n + j];
      }
      mbar_arrive(&bars.full[s]);
    }
  }
  return nchunks;
}

// One lane's windows of a decoded f32 plane from its sources into the
// sink: the phase ops and the first nine in lane_windows, the second op
// set in lane_windows_ext<Fam>; the lane's timestamps as ts_at(ts, row,
// ts_ld), its phase phase[lane] (phase mode).
template <int Fam, class Src, class Ts, class Sink>
__device__ void dense_windows(Src src, Ts ts, long ts_ld, const int* phase,
                              long lane, const Params& P, int mode,
                              Sink& sink) {
  if constexpr (Fam == F_BASE) {
    const float ph = (mode == PHASE) ? static_cast<float>(phase[lane]) : 0.f;
    lane_windows<Src, Sink, Ts>(src, ts, ts_ld, ph, mode, P, sink);
  } else {
    lane_windows_ext<Fam, Src, Sink, Ts>(src, ts, ts_ld, P, sink);
  }
}

// One lane's windows from its own decoding source into the [T, n] out.
template <int Fam, class Src, class Sink>
__device__ void packed_windows(Src src, const int* meta, int n, int lane,
                               const Params& P, int mode, Sink& sink) {
  if constexpr (Fam == F_BASE) {
    const float ph =
        (mode == PHASE) ? static_cast<float>(meta[2 * n + lane]) : 0.f;
    lane_windows(src, nullptr, 0, ph, mode, P, sink);
  } else {
    lane_windows_ext<Fam>(src, nullptr, 0, P, sink);
  }
}

// Bytes a word of a class plane's kind: 0 uint8, 1 uint16, 2 uint32, 3
// raw f32 bits.
inline int word_bytes(int kind) { return kind == 0 ? 1 : kind == 1 ? 2 : 4; }

inline bool args_ok(int op, int K) {
  return op >= SUM && op <= HOLT_WINTERS
      && (family_of(op) != F_SORT || (K >= 1 && K <= kSortMaxK));
}

// B1's member axis (the reference's vmap of rate_grid over the members of
// a co-arrival batch, filodb_tpu/ops/grid.py:1539-1556).  A batched
// launch reads M members' windows from ONE shared plane: member m =
// blockIdx.y starts at plane row row0s[m] (its values and, in ts mode,
// its timestamps), ends its first window at steps0s[m], and writes
// [T, ns] rows [m*T, (m+1)*T) of the [M*T, ns] output; the phase row is
// shared.  A solo launch passes no arrays and is member 0 at row 0.  The
// member's arithmetic is its solo launch's, so its bits are too.
struct MemberOffsets {
  long rows;     // elements of the plane before the member's first row
  long out;      // elements of the output before the member's rows
};

__device__ __forceinline__ MemberOffsets member_offsets(const int* row0s,
                                                        const int* steps0s,
                                                        long ns,
                                                        Params& P) {
  if (row0s == nullptr) return {0, 0};
  const int m = static_cast<int>(blockIdx.y);
  P.steps0 = steps0s[m];
  return {static_cast<long>(row0s[m]) * ns,
          static_cast<long>(m) * P.T * ns};
}

// The member arrays a launch takes: none (a solo launch, one member), or
// both, for 1 to 65,535 members (grid.y's limit).
inline bool members_ok(const void* row0s, const void* steps0s,
                       int members) {
  return row0s == nullptr
      ? steps0s == nullptr && members == 1
      : steps0s != nullptr && members >= 1 && members <= 65535;
}

}  // namespace

// Function arguments of the second op set: predict_linear's horizon
// (farg), holt_winters' factors (farg, farg2), and quantile/mad's
// interpolation ranks, weights and out-of-range fill.
#define FN_ARGS float farg, float farg2, int rank_lo, int rank_hi, \
    float w_lo, float w_hi, float fill

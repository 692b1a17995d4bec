// Aligned-grid window kernels, their grouped forms and the M4 selection
// kernel for Hopper (sm_90a), bound with ctypes.  The M4 kernel's note
// stands above it.
//
// rate_grid_kernel replaces the TPU kernel rate_grid
// (filodb_tpu/ops/grid.py:848-898, bodies _series_kernel,
// _series_kernel_free, _series_kernel_phase).  rate_grid_packed_kernel
// replaces rate_grid_packed (filodb_tpu/ops/grid.py:1086-1127, body
// _series_kernel_packed with the in-VMEM decode _decode_packed).  Both
// compute all 22 ops of the TPU kernels' window dispatch (_rate_block,
// :734-766): the nine of lane_windows below, and the thirteen of
// lane_windows_ext (rate_grid_ext_kernel, rate_grid_packed_ext_kernel).
//
// What bounds them on the card: bytes.  Each reads its input planes once
// and writes a [T, lanes] f32 output, a handful of flops per sample, so
// the least time is (bytes read + bytes written) / 3.35 TB/s, with
// R = (T-1)*stride + K the rows the windows cover:
//   rate_grid, phase mode:  R*S*4 + S*4 + T*S*4 bytes
//   rate_grid, ts mode:     R*S*4 + R*S*4 + T*S*4 bytes
//   rate_grid_packed:       (row0+R)*n*word bytes per class plane (the XOR
//                           prefix starts at block row 0) + 2*n*4 meta
//                           (3*n*4 in phase mode) + T*n*4 bytes
// The K-free dense ops read fewer rows: irate and idelta each window's
// last two (value and ts), timestamp one value row and one ts row.  Only
// the sort ops at K = 32 (a sorting network of 191 compare-exchanges)
// are bound by operations.
//
// Design.  The TPU kernels turn the per-lane sequential parts (counter-
// correction prefix, forward fill, prefix-XOR decode) into log-step roll
// scans or triangular matmuls, because a TPU tile wants whole-array ops.
// Here one thread owns one series lane and walks down the bucket axis
// serially: the grid is time-major [B, S], so the 32 threads of a warp
// read 32 neighbouring addresses of one row and every load is coalesced.
// The prefix correction, forward fill and XOR decode are running
// registers.  A window needs its first and last rows (dense lanes) or
// every row (gappy lanes, K <= 64): a "cursor" (row pointer plus the
// running decode and correction state) sits at the window start, and a
// second cursor at the window end for dense lanes, or a copy of the
// first walks the K rows of the window for gappy lanes.  The re-read rows
// are L1/L2 hits; device memory sees each input byte about once.
//
// Both kernels share one __device__ window-op path (lane_windows), fed
// by a row source: a decoded f32 plane, or an XOR-class packed plane
// decoded on the fly, and handing each step's value to a sink: a store
// to the [T, lanes] output here, the group reduce in the grouped kernels
// below.  The f32 arithmetic repeats the plain PyTorch versions
// (filodb_tpu_torch/ops/grid.py) op for op; the library is built with
// -fmad=false so no multiply-add is contracted.  Only the order of the
// correction prefix sum may differ from the plain version on the card
// (serial here, a parallel scan in torch.cumsum).
//
// The grouped kernels.  rate_grid_grouped_kernel replaces the TPU kernel
// rate_grid_grouped (filodb_tpu/ops/grid.py:904-957, bodies
// _grouped_kernel{,_free,_phase}); grouped_packed_kernel replaces both
// rate_grid_grouped_packed (:1130-1202, body _grouped_kernel_packed) with
// one bucket per group (hb = 1) and hist_grid_grouped_packed (:1266-1339,
// body _hist_grouped_kernel_packed) with hb buckets, column c of a group
// reducing into bucket c % hb.  Each runs the window path above per lane
// and reduces the group's lanes per step into (sum, count) rows, so only
// [G*hb, T] partials reach device memory.  Phase mode sums every lane
// live at row 0 (its value as it is, finite or not) and counts the live
// lanes; free and ts modes sum and count the finite results.  Like B1/B3
// they compute all 22 ops: the nine of lane_windows in the kernels
// above, the thirteen of lane_windows_ext in rate_grid_grouped_ext_kernel
// and grouped_packed_ext_kernel, one instantiation a family (the packed
// ones the four families that read no timestamps).
//
// What bounds them: bytes, as above, less the [T, lanes] output: at the
// north-star widths (59 rows of 1,024,000 lanes; 1,048,576 bucket
// columns) 246 MB for rate_grid_grouped in phase mode, 133 MB for
// rate_grid_grouped_packed and 143.5 MB for hist_grid_grouped_packed,
// 0.04-0.07 ms at 3.35 TB/s.
//
// Design.  The TPU kernels carry 8 groups per output tile and reduce
// buckets with a banded 0/1 matmul on the MXU; both are TPU layout
// choices.  Here one CTA owns one group: its threads take the group's
// lanes blockDim at a time (a thread past the group's end walks the last
// lane again and contributes nothing, so every thread reaches every
// shuffle and barrier), and a sink reduces the lanes' values at every
// step in a fixed order, with no atomics, so a run's answer never
// depends on the schedule.  One bucket (WarpSumSink): warp shuffles, each
// warp adding into its own shared row of partials, so warps never wait
// for each other, and the warps' rows added in warp order at the end.
// hb buckets (BucketSink, any hb): a shared row of the lanes' values a
// step, which thread j adds to bucket j's running sum in lane order, one
// barrier a step.

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

// The shared window-op path: every output step of one lane, handed to
// sink(t, value, ok) where ok says whether the group reduce takes the
// value: the lane's row-0 liveness in phase mode, finiteness otherwise.
template <class Src, class Sink>
__device__ void lane_windows(Src src, const int* ts, long ts_ld,
                             float phase, int mode, const Params& P,
                             Sink& sink) {
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
        t1 = ts[base * ts_ld];
        t2 = ts[(base + K - 1) * ts_ld];
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
            const int tt = ts[(base + d) * ts_ld];
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
//   F_SORT    quantile, mad (free, dense, K <= 32): a sorted window.
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

template <int Fam, class Src, class Sink>
__device__ void lane_windows_ext(Src src, const int* ts, long ts_ld,
                                 const Params& P, Sink& sink) {
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
        const int t1 = ts[(base + K - 2) * ts_ld];
        const int t2 = ts[(base + K - 1) * ts_ld];
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
        if (isfinite(a.raw)) sel = ts[(base + K - 1) * ts_ld];
      } else {
        a.advance_to(base, false, false);
        Cursor<Src> c = a;
        for (int d = 0; d < K; ++d) {                // last finite wins
          c.step(false, false);
          if (isfinite(c.raw)) sel = ts[(base + d) * ts_ld];
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
        const float x = (static_cast<float>(ts[(base + d) * ts_ld]) - hi)
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
      float s[kSortMaxK];
      for (int d = 0; d < K; ++d) {
        c.step(false, false);
        s[d] = c.raw;
      }
      const bool live = isfinite(s[0]);
      sort_window(s, K);
      float q = interp_sorted(s, P);
      if (P.op == MAD) {                  // the median of |x - median|
        for (int d = 0; d < K; ++d) s[d] = fabsf(s[d] - q);
        sort_window(s, K);
        q = interp_sorted(s, P);
      }
      if (live) o = q;
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

__global__ void rate_grid_kernel(const float* __restrict__ vals,
                                 const int* __restrict__ ts,
                                 const int* __restrict__ phase,
                                 float* __restrict__ out, int ns, Params P,
                                 int mode) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= ns) return;
  DenseSrc src{vals + lane, ns};
  const float ph = (mode == PHASE) ? static_cast<float>(phase[lane]) : 0.f;
  StoreSink sink{out + lane, ns};
  lane_windows(src, ts ? ts + lane : nullptr, ns, ph, mode, P, sink);
}

template <int Fam>
__global__ void rate_grid_ext_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ ts,
                                     float* __restrict__ out, int ns,
                                     Params P) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= ns) return;
  DenseSrc src{vals + lane, ns};
  StoreSink sink{out + lane, ns};
  lane_windows_ext<Fam>(src, ts ? ts + lane : nullptr, ns, P, sink);
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

template <typename W>
__global__ void rate_grid_packed_kernel(const W* __restrict__ plane,
                                        const int* __restrict__ meta,
                                        float* __restrict__ out, int n,
                                        int out_ld, int row0, Params P,
                                        int mode) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PackedSrc<W> src = packed_lane(plane, meta, n, lane, row0);
  const float ph =
      (mode == PHASE) ? static_cast<float>(meta[2 * n + lane]) : 0.f;
  StoreSink sink{out + lane, out_ld};
  lane_windows(src, nullptr, 0, ph, mode, P, sink);
}

template <typename W, int Fam>
__global__ void rate_grid_packed_ext_kernel(const W* __restrict__ plane,
                                            const int* __restrict__ meta,
                                            float* __restrict__ out, int n,
                                            int out_ld, int row0, Params P) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PackedSrc<W> src = packed_lane(plane, meta, n, lane, row0);
  StoreSink sink{out + lane, out_ld};
  lane_windows_ext<Fam>(src, nullptr, 0, P, sink);
}

// One class plane through the packed kernel of the op's family (the
// free families only: a packed plane has no ts).
template <typename W>
cudaError_t packed_run(const W* plane, const int* meta, float* out, int n,
                       int out_ld, int row0, const Params& P, int mode,
                       cudaStream_t s) {
  const int grid = (n + kBlock - 1) / kBlock;
  switch (family_of(P.op)) {
    case F_BASE:
      rate_grid_packed_kernel<W><<<grid, kBlock, 0, s>>>(
          plane, meta, out, n, out_ld, row0, P, mode);
      break;
    case F_CHANGES:
      rate_grid_packed_ext_kernel<W, F_CHANGES><<<grid, kBlock, 0, s>>>(
          plane, meta, out, n, out_ld, row0, P);
      break;
    case F_MOMENTS:
      rate_grid_packed_ext_kernel<W, F_MOMENTS><<<grid, kBlock, 0, s>>>(
          plane, meta, out, n, out_ld, row0, P);
      break;
    case F_SORT:
      rate_grid_packed_ext_kernel<W, F_SORT><<<grid, kBlock, 0, s>>>(
          plane, meta, out, n, out_ld, row0, P);
      break;
    case F_HOLT:
      rate_grid_packed_ext_kernel<W, F_HOLT><<<grid, kBlock, 0, s>>>(
          plane, meta, out, n, out_ld, row0, P);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One CTA per group of group_lanes contiguous lanes of vals [nb, ns]; the
// group's (sum, count) rows at sum/cnt + blockIdx.x * T.  A thread past
// the group's end walks its last lane again and contributes nothing.
__global__ void rate_grid_grouped_kernel(const float* __restrict__ vals,
                                         const int* __restrict__ ts,
                                         const int* __restrict__ phase,
                                         float* __restrict__ sum,
                                         float* __restrict__ cnt, int ns,
                                         int group_lanes, Params P,
                                         int mode) {
  extern __shared__ float sh[];
  const long g0 = static_cast<long>(blockIdx.x) * group_lanes;
  const long rows = static_cast<long>(blockIdx.x) * P.T;
  WarpSumSink sink = WarpSumSink::make(sh, P.T, 1, nullptr, nullptr, true);
  for (int c0 = 0; c0 < group_lanes; c0 += blockDim.x) {
    sink.begin(c0, group_lanes);
    const long lane = g0 + min(c0 + static_cast<int>(threadIdx.x),
                               group_lanes - 1);
    DenseSrc src{vals + lane, ns};
    const float ph =
        (mode == PHASE) ? static_cast<float>(phase[lane]) : 0.f;
    lane_windows(src, ts ? ts + lane : nullptr, ns, ph, mode, P, sink);
  }
  sink.finish(sum + rows, cnt + rows);
}

// One CTA per group of group_lanes contiguous lanes of one class plane;
// the group's hb (sum, count) rows at sum/cnt + blockIdx.x * hb * T.
template <typename W, class Sink>
__global__ void grouped_packed_kernel(const W* __restrict__ plane,
                                      const int* __restrict__ meta,
                                      float* __restrict__ sum,
                                      float* __restrict__ cnt, int n,
                                      int group_lanes, int hb, int row0,
                                      Params P, int mode, int acc_shared) {
  extern __shared__ float sh[];
  const int g0 = blockIdx.x * group_lanes;
  const long rows = static_cast<long>(blockIdx.x) * hb * P.T;
  Sink sink = Sink::make(sh, P.T, hb, sum + rows, cnt + rows, acc_shared);
  for (int c0 = 0; c0 < group_lanes; c0 += blockDim.x) {
    sink.begin(c0, group_lanes);
    const int lane = g0 + min(c0 + static_cast<int>(threadIdx.x),
                              group_lanes - 1);
    PackedSrc<W> src = packed_lane(plane, meta, n, lane, row0);
    const float ph =
        (mode == PHASE) ? static_cast<float>(meta[2 * n + lane]) : 0.f;
    lane_windows(src, nullptr, 0, ph, mode, P, sink);
  }
  sink.finish(sum + rows, cnt + rows);
}

// The second op set into the group reduce: the two kernels above with
// lane_windows_ext<Fam> for lane_windows, one instantiation a family, so
// that the nine ops' kernels compile as they did.  lane_windows_ext calls
// the sink once a step for every thread, whatever its lane holds, as the
// sinks' shuffles and barriers need.
template <int Fam>
__global__ void rate_grid_grouped_ext_kernel(const float* __restrict__ vals,
                                             const int* __restrict__ ts,
                                             float* __restrict__ sum,
                                             float* __restrict__ cnt, int ns,
                                             int group_lanes, Params P) {
  extern __shared__ float sh[];
  const long g0 = static_cast<long>(blockIdx.x) * group_lanes;
  const long rows = static_cast<long>(blockIdx.x) * P.T;
  WarpSumSink sink = WarpSumSink::make(sh, P.T, 1, nullptr, nullptr, true);
  for (int c0 = 0; c0 < group_lanes; c0 += blockDim.x) {
    sink.begin(c0, group_lanes);
    const long lane = g0 + min(c0 + static_cast<int>(threadIdx.x),
                               group_lanes - 1);
    DenseSrc src{vals + lane, ns};
    lane_windows_ext<Fam>(src, ts ? ts + lane : nullptr, ns, P, sink);
  }
  sink.finish(sum + rows, cnt + rows);
}

template <typename W, class Sink, int Fam>
__global__ void grouped_packed_ext_kernel(const W* __restrict__ plane,
                                          const int* __restrict__ meta,
                                          float* __restrict__ sum,
                                          float* __restrict__ cnt, int n,
                                          int group_lanes, int hb, int row0,
                                          Params P, int acc_shared) {
  extern __shared__ float sh[];
  const int g0 = blockIdx.x * group_lanes;
  const long rows = static_cast<long>(blockIdx.x) * hb * P.T;
  Sink sink = Sink::make(sh, P.T, hb, sum + rows, cnt + rows, acc_shared);
  for (int c0 = 0; c0 < group_lanes; c0 += blockDim.x) {
    sink.begin(c0, group_lanes);
    const int lane = g0 + min(c0 + static_cast<int>(threadIdx.x),
                              group_lanes - 1);
    PackedSrc<W> src = packed_lane(plane, meta, n, lane, row0);
    lane_windows_ext<Fam>(src, nullptr, 0, P, sink);
  }
  sink.finish(sum + rows, cnt + rows);
}

// A grouped launch's shape: threads a CTA (a warp multiple) and dynamic
// shared bytes.  hb = 1: up to 8 warps, fewer while their partial rows
// would pass 48 KB (one warp holds T <= 6,144 in it, and past that the
// kernel is allowed more).  hb > 1: up to 256 threads and at least hb
// (thread j sums bucket j), the running sums in shared memory when the
// total stays within 48 KB.
struct GroupShape {
  int threads;
  size_t shared;
  bool acc_shared;
};

constexpr size_t kShared48 = 48 * 1024;

GroupShape group_shape(int group_lanes, int hb, int T) {
  if (hb == 1) {
    int warps = (group_lanes + 31) / 32;
    if (warps > 8) warps = 8;
    while (warps > 1 && warps * 2 * T * sizeof(float) > kShared48) --warps;
    return {32 * warps, warps * 2 * T * sizeof(float), true};
  }
  int threads = group_lanes < 256 ? group_lanes : 256;
  if (hb > threads) threads = hb;
  threads = (threads + 31) / 32 * 32;
  const size_t row = 4 * threads * sizeof(float);
  const size_t acc = 2 * static_cast<size_t>(hb) * T * sizeof(float);
  if (row + acc <= kShared48) return {threads, row + acc, true};
  return {threads, row, false};
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= kShared48) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One grouped kernel launched at shape g (its shared memory allowed
// first where it passes 48 KB): cudaGetLastError() after the launch.
template <typename Kern, typename... Args>
int launch_grouped(Kern kernel, int grid, const GroupShape& g,
                   cudaStream_t s, Args... args) {
  const cudaError_t rc = allow_shared(kernel, g.shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, g.threads, g.shared, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// One class plane's groups through the grouped packed kernel of the op's
// family (the free families only: a packed plane has no ts).
template <typename W, class Sink>
int grouped_packed_family(const W* plane, const int* meta, float* sum,
                          float* cnt, int n, int group_lanes, int hb,
                          int row0, const Params& P, int mode,
                          cudaStream_t s) {
  const GroupShape g = group_shape(group_lanes, hb, P.T);
  const int grid = n / group_lanes;
  const int acc = g.acc_shared;
  switch (family_of(P.op)) {
    case F_BASE:
      return launch_grouped(grouped_packed_kernel<W, Sink>, grid, g, s,
                            plane, meta, sum, cnt, n, group_lanes, hb, row0,
                            P, mode, acc);
    case F_CHANGES:
      return launch_grouped(grouped_packed_ext_kernel<W, Sink, F_CHANGES>,
                            grid, g, s, plane, meta, sum, cnt, n,
                            group_lanes, hb, row0, P, acc);
    case F_MOMENTS:
      return launch_grouped(grouped_packed_ext_kernel<W, Sink, F_MOMENTS>,
                            grid, g, s, plane, meta, sum, cnt, n,
                            group_lanes, hb, row0, P, acc);
    case F_SORT:
      return launch_grouped(grouped_packed_ext_kernel<W, Sink, F_SORT>,
                            grid, g, s, plane, meta, sum, cnt, n,
                            group_lanes, hb, row0, P, acc);
    case F_HOLT:
      return launch_grouped(grouped_packed_ext_kernel<W, Sink, F_HOLT>,
                            grid, g, s, plane, meta, sum, cnt, n,
                            group_lanes, hb, row0, P, acc);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename W>
int grouped_packed_run(const W* plane, const int* meta, float* sum,
                       float* cnt, int n, int group_lanes, int hb, int row0,
                       const Params& P, int mode, cudaStream_t s) {
  if (hb == 1)
    return grouped_packed_family<W, WarpSumSink>(
        plane, meta, sum, cnt, n, group_lanes, 1, row0, P, mode, s);
  return grouped_packed_family<W, BucketSink>(
      plane, meta, sum, cnt, n, group_lanes, hb, row0, P, mode, s);
}

// M4 pixel-bin selection.  m4_grid_kernel replaces the TPU kernel m4_grid
// (filodb_tpu/ops/grid.py:1692-1729, body _m4_kernel over _m4_planes).
//
// What it computes: time-major vals [T, S] split into P bins of
// W = ceil(T/P) rows (the last bins may be short or empty); per (bin,
// series) the min, max, first and last finite value and their bin-local
// row indices, as out [P, 8, S] in the plane order vmin vmax vfirst vlast
// imin imax ifirst ilast.  Ties on min/max go to the first occurrence; a
// bin with no finite sample gives NaN values and -1 indices.  Selection
// only, so the kernel and the plain version are bit-equal.
//
// What bounds it on the card: bytes.  It reads T*S*4 bytes once and
// writes P*8*S*4, with a compare or two per sample; at the main path's
// [T=260, S=102,400], P=32 that is 211 MB, about 0.063 ms at 3.35 TB/s.
//
// Design.  The TPU kernel pads each bin to a multiple of 8 rows and needs
// S % 128 == 0 (one aligned VMEM tile per bin and lane block); here one
// thread owns one (series, bin) pair and walks the bin's W rows with the
// running selection in registers.  Consecutive threads take consecutive
// series, so every row load and every plane store is coalesced; the bins
// ride blockIdx.y (strided past 65,535).  Any S >= 1 and P >= 1 work.
__global__ void m4_grid_kernel(const float* __restrict__ vals,
                               float* __restrict__ out, int T, int S, int P,
                               int W) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const long r0 = static_cast<long>(p) * W;
    const long r1 = r0 + W < T ? r0 + W : T;
    float vmin = NAN, vmax = NAN, vfirst = NAN, vlast = NAN;
    int imin = -1, imax = -1, ifirst = -1, ilast = -1;
    for (long r = r0; r < r1; ++r) {
      const float v = vals[r * S + s];
      if (!isfinite(v)) continue;
      const int i = static_cast<int>(r - r0);
      if (ifirst < 0) {
        ifirst = imin = imax = i;
        vfirst = vmin = vmax = v;
      } else {
        if (v < vmin) {
          vmin = v;
          imin = i;
        }
        if (v > vmax) {
          vmax = v;
          imax = i;
        }
      }
      ilast = i;
      vlast = v;
    }
    float* o = out + static_cast<long>(p) * 8 * S + s;
    o[0] = vmin;
    o[S] = vmax;
    o[2L * S] = vfirst;
    o[3L * S] = vlast;
    o[4L * S] = static_cast<float>(imin);
    o[5L * S] = static_cast<float>(imax);
    o[6L * S] = static_cast<float>(ifirst);
    o[7L * S] = static_cast<float>(ilast);
  }
}

}  // namespace

extern "C" {

int m4_grid_launch(const void* vals, void* out, int T, int S, int P, int W,
                   void* stream) {
  const dim3 grid((S + kBlock - 1) / kBlock, P < 65535 ? P : 65535);
  m4_grid_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(out), T, S, P, W);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// Function arguments of the second op set: predict_linear's horizon
// (farg), holt_winters' factors (farg, farg2), and quantile/mad's
// interpolation ranks, weights and out-of-range fill.
#define FN_ARGS float farg, float farg2, int rank_lo, int rank_hi, \
    float w_lo, float w_hi, float fill

static bool args_ok(int op, int K) {
  return op >= SUM && op <= HOLT_WINTERS
      && (family_of(op) != F_SORT || (K >= 1 && K <= kSortMaxK));
}

int rate_grid_launch(const void* vals, const void* ts, const void* phase,
                     void* out, int nb, int ns, int T, int K, int stride,
                     int g, int steps0, int op, int mode, int dense,
                     int is_rate, FN_ARGS, void* stream) {
  if (!args_ok(op, K)) return static_cast<int>(cudaErrorInvalidValue);
  (void)nb;
  Params P{T, K, stride, g, steps0, op, dense, is_rate, farg, farg2,
           rank_lo, rank_hi, w_lo, w_hi, fill};
  const int grid = (ns + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* t = static_cast<const int*>(ts);
  float* o = static_cast<float*>(out);
  const int fam = family_of(op);
  if (reads_ts(fam) && t == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (fam) {
    case F_BASE:
      rate_grid_kernel<<<grid, kBlock, 0, s>>>(
          v, t, static_cast<const int*>(phase), o, ns, P, mode);
      break;
    case F_PAIR:
      rate_grid_ext_kernel<F_PAIR><<<grid, kBlock, 0, s>>>(v, t, o, ns, P);
      break;
    case F_LINREG:
      rate_grid_ext_kernel<F_LINREG><<<grid, kBlock, 0, s>>>(v, t, o, ns, P);
      break;
    case F_STAMP:
      rate_grid_ext_kernel<F_STAMP><<<grid, kBlock, 0, s>>>(v, t, o, ns, P);
      break;
    case F_CHANGES:
      rate_grid_ext_kernel<F_CHANGES><<<grid, kBlock, 0, s>>>(v, t, o, ns,
                                                              P);
      break;
    case F_MOMENTS:
      rate_grid_ext_kernel<F_MOMENTS><<<grid, kBlock, 0, s>>>(v, t, o, ns,
                                                              P);
      break;
    case F_SORT:
      rate_grid_ext_kernel<F_SORT><<<grid, kBlock, 0, s>>>(v, t, o, ns, P);
      break;
    case F_HOLT:
      rate_grid_ext_kernel<F_HOLT><<<grid, kBlock, 0, s>>>(v, t, o, ns, P);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int rate_grid_packed_launch(const void* plane, const void* meta, void* out,
                            int kind, int nb, int n, int out_ld, int col,
                            int row0, int T, int K, int stride, int g,
                            int op, int use_phase, int dense, int is_rate,
                            FN_ARGS, void* stream) {
  (void)nb;
  if (!args_ok(op, K) || reads_ts(family_of(op)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, 0, op, dense, is_rate, farg, farg2, rank_lo,
           rank_hi, w_lo, w_hi, fill};
  const int mode = use_phase ? PHASE : FREE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  float* o = static_cast<float*>(out) + col;
  cudaError_t rc;
  switch (kind) {
    case 0:
      rc = packed_run(static_cast<const uint8_t*>(plane), m, o, n, out_ld,
                      row0, P, mode, s);
      break;
    case 1:
      rc = packed_run(static_cast<const uint16_t*>(plane), m, o, n, out_ld,
                      row0, P, mode, s);
      break;
    case 2:
    case 3:
      rc = packed_run(static_cast<const uint32_t*>(plane), m, o, n, out_ld,
                      row0, P, mode, s);
      break;
    default:
      rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

// sum and cnt: [ns / group_lanes, T] f32.
int rate_grid_grouped_launch(const void* vals, const void* ts,
                             const void* phase, void* sum, void* cnt,
                             int nb, int ns, int group_lanes, int T, int K,
                             int stride, int g, int steps0, int op, int mode,
                             int dense, int is_rate, FN_ARGS, void* stream) {
  (void)nb;
  if (!args_ok(op, K)) return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, steps0, op, dense, is_rate, farg, farg2,
           rank_lo, rank_hi, w_lo, w_hi, fill};
  const GroupShape gs = group_shape(group_lanes, 1, T);
  const int grid = ns / group_lanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* t = static_cast<const int*>(ts);
  float* so = static_cast<float*>(sum);
  float* co = static_cast<float*>(cnt);
  const int fam = family_of(op);
  if (reads_ts(fam) && t == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (fam) {
    case F_BASE:
      return launch_grouped(rate_grid_grouped_kernel, grid, gs, s, v, t,
                            static_cast<const int*>(phase), so, co, ns,
                            group_lanes, P, mode);
    case F_PAIR:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_PAIR>, grid, gs,
                            s, v, t, so, co, ns, group_lanes, P);
    case F_LINREG:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_LINREG>, grid, gs,
                            s, v, t, so, co, ns, group_lanes, P);
    case F_STAMP:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_STAMP>, grid, gs,
                            s, v, t, so, co, ns, group_lanes, P);
    case F_CHANGES:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_CHANGES>, grid,
                            gs, s, v, t, so, co, ns, group_lanes, P);
    case F_MOMENTS:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_MOMENTS>, grid,
                            gs, s, v, t, so, co, ns, group_lanes, P);
    case F_SORT:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_SORT>, grid, gs,
                            s, v, t, so, co, ns, group_lanes, P);
    case F_HOLT:
      return launch_grouped(rate_grid_grouped_ext_kernel<F_HOLT>, grid, gs,
                            s, v, t, so, co, ns, group_lanes, P);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One class plane's groups: sum and cnt point at zeroed [G_all * hb, T]
// f32, this plane's first group at slot0 (a group index).
int grouped_packed_launch(const void* plane, const void* meta, void* sum,
                          void* cnt, int kind, int nb, int n,
                          int group_lanes, int hb, int slot0, int row0,
                          int T, int K, int stride, int g, int op,
                          int use_phase, int dense, int is_rate, FN_ARGS,
                          void* stream) {
  (void)nb;
  if (!args_ok(op, K) || reads_ts(family_of(op)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, 0, op, dense, is_rate, farg, farg2, rank_lo,
           rank_hi, w_lo, w_hi, fill};
  const int mode = use_phase ? PHASE : FREE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  const long off = static_cast<long>(slot0) * hb * T;
  float* so = static_cast<float*>(sum) + off;
  float* co = static_cast<float*>(cnt) + off;
  switch (kind) {
    case 0:
      return grouped_packed_run(static_cast<const uint8_t*>(plane), m, so, co,
                                n, group_lanes, hb, row0, P, mode, s);
    case 1:
      return grouped_packed_run(static_cast<const uint16_t*>(plane), m, so,
                                co, n, group_lanes, hb, row0, P, mode, s);
    case 2:
    case 3:
      return grouped_packed_run(static_cast<const uint32_t*>(plane), m, so,
                                co, n, group_lanes, hb, row0, P, mode, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

// Aligned-grid window kernels and the M4 selection kernel for Hopper
// (sm_90a), bound with ctypes.  The M4 kernel's note stands above it.
//
// rate_grid_kernel replaces the TPU kernel rate_grid
// (filodb_tpu/ops/grid.py:848-898, bodies _series_kernel,
// _series_kernel_free, _series_kernel_phase).  rate_grid_packed_kernel
// replaces rate_grid_packed (filodb_tpu/ops/grid.py:1086-1127, body
// _series_kernel_packed with the in-VMEM decode _decode_packed).
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
// decoded on the fly.  The f32 arithmetic repeats the plain PyTorch
// versions (filodb_tpu_torch/ops/grid.py) op for op; the library is built
// with -fmad=false so no multiply-add is contracted.  Only the order of
// the correction prefix sum may differ from the plain version on the
// card (serial here, a parallel scan in torch.cumsum).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op { SUM = 0, COUNT = 1, AVG = 2, MIN = 3, MAX = 4, LAST = 5,
          RATE = 6, INCREASE = 7, DELTA = 8 };
enum Mode { FREE = 0, PHASE = 1, TS = 2 };

constexpr int kBlock = 128;
constexpr int kIBig = 1 << 30;

struct Params {
  int T, K, stride, g, steps0, op, dense, is_rate;
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

// Prometheus extrapolatedRate (RateFunctions.scala:37-80) for window t.
__device__ float extrapolate(float nf, int t1, int t2, float v1, float v2,
                             int t, const Params& P) {
  unsigned hi_u = static_cast<unsigned>(P.steps0)
      + static_cast<unsigned>(t) * static_cast<unsigned>(P.g * P.stride);
  float hi = static_cast<float>(static_cast<int>(hi_u));
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

// The shared window-op path: every output step of one lane.
template <class Src>
__device__ void lane_windows(Src src, const int* ts, long ts_ld,
                             float phase, int mode, const Params& P,
                             float* out, long out_ld) {
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
      out[t * out_ld] = live ? o : NAN;
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
      out[t * out_ld] = extrapolate(nf, t1, t2, v1, v2, t, P);
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
    out[t * out_ld] = o;
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
  lane_windows(src, ts ? ts + lane : nullptr, ns, ph, mode, P, out + lane,
               ns);
}

template <typename W>
__global__ void rate_grid_packed_kernel(const W* __restrict__ plane,
                                        const int* __restrict__ meta,
                                        float* __restrict__ out, int n,
                                        int out_ld, int row0, Params P,
                                        int mode) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PackedSrc<W> src{plane + lane, n, static_cast<uint32_t>(meta[lane]),
                   static_cast<uint32_t>(meta[n + lane]), 0u};
  // the XOR prefix starts at block row 0; the query reads from row0
  for (int r = 0; r < row0; ++r) src.next();
  const float ph =
      (mode == PHASE) ? static_cast<float>(meta[2 * n + lane]) : 0.f;
  lane_windows(src, nullptr, 0, ph, mode, P, out + lane, out_ld);
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

int rate_grid_launch(const void* vals, const void* ts, const void* phase,
                     void* out, int nb, int ns, int T, int K, int stride,
                     int g, int steps0, int op, int mode, int dense,
                     int is_rate, void* stream) {
  (void)nb;
  Params P{T, K, stride, g, steps0, op, dense, is_rate};
  const int grid = (ns + kBlock - 1) / kBlock;
  rate_grid_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ts),
      static_cast<const int*>(phase), static_cast<float*>(out), ns, P, mode);
  return static_cast<int>(cudaGetLastError());
}

int rate_grid_packed_launch(const void* plane, const void* meta, void* out,
                            int kind, int nb, int n, int out_ld, int col,
                            int row0, int T, int K, int stride, int g,
                            int op, int use_phase, int dense, int is_rate,
                            void* stream) {
  (void)nb;
  Params P{T, K, stride, g, 0, op, dense, is_rate};
  const int mode = use_phase ? PHASE : FREE;
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  float* o = static_cast<float*>(out) + col;
  switch (kind) {
    case 0:
      rate_grid_packed_kernel<uint8_t><<<grid, kBlock, 0, s>>>(
          static_cast<const uint8_t*>(plane), m, o, n, out_ld, row0, P, mode);
      break;
    case 1:
      rate_grid_packed_kernel<uint16_t><<<grid, kBlock, 0, s>>>(
          static_cast<const uint16_t*>(plane), m, o, n, out_ld, row0, P,
          mode);
      break;
    case 2:
    case 3:
      rate_grid_packed_kernel<uint32_t><<<grid, kBlock, 0, s>>>(
          static_cast<const uint32_t*>(plane), m, o, n, out_ld, row0, P,
          mode);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

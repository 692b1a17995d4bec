// B1 on Hopper: series_staged_kernel replaces the TPU kernel rate_grid
// (filodb_tpu/ops/grid.py:848-898, bodies _series_kernel,
// _series_kernel_free, _series_kernel_phase), and serves all 22 ops of
// that kernel in its three modes (free, phase, ts), dense and gappy,
// through lane_windows and lane_windows_ext (grid_device.cuh).  Each lane
// of a decoded f32 plane [nb, ns] gets its T windows, the [T, ns] f32
// out.
//
// What bounds it: bytes.  It must read rows [0, (T-1)*stride + K) = R of
// the plane, the phase row (phase mode) or R ts rows (ts mode), and write
// the [T, ns] out: R*S*4 + S*4 + T*S*4 bytes in phase mode, R*S*4 more in
// ts mode (the K-free dense ops read fewer rows: irate and idelta each
// window's last two, timestamp one value row and one ts row).  At the
// store's Q2 ([49, 102400], T = 45, phase) 38.9 MB, 0.0116 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel stages a lane tile's rows in VMEM and turns the
// per-lane sequential parts (the counter-correction prefix, the forward
// fill) into log-step roll scans.  The kernel before this one
// (rate_grid_kernel, grid_kernels.cu, kept as the direct path) has a
// thread walk a lane serially, reading its f32 of each row from device
// memory with one load in flight (DenseSrc) and, in ts mode, each
// timestamp by a load of its own; at the store's 102,400-110,592 lanes
// that is about 25 warps an SM, each with about two 128-byte loads in
// flight, far too few for 3.35 TB/s.
//
// Here a CTA is a tile of kTile = 128 lanes: 128 consumer threads, one a
// lane, and a producer warp.  The producer streams the tile's rows [0, R)
// of the plane into a ring of kStages stages in shared memory (stage_rows:
// 16-byte cp.async, plain loads where the rows are not 16-byte aligned,
// each stage's arrival on an mbarrier) and, where the launch reads
// timestamps, the same rows of the ts plane into a second ring of the
// same bytes beside it (a chunk's stage awaits both planes' arrivals), so
// that up to three stages of each are in flight while the consumers read
// the fourth.  Each consumer hands its lane's column of the ring
// (SmemDenseSrc) and of the ts ring (RingTs), each row masked into the
// ring, to the window code lane_windows / lane_windows_ext<Fam>, so every
// op's arithmetic is the code it was and its answers keep their bits; the
// sink (RingStoreSink) stores step t's value, frees the stages behind the
// step and awaits the next step's.  Output stores stay coalesced: a warp
// writes 32 neighbouring floats of one [T, ns] row a step.
//
// The host's plan (grid.series_staged_plan): a ring a plane, the least of
// 8, 16, 32 and 64 KB (four stages of 4 to 32 rows) in whose three stages
// a step's stride + K rows fit, so that seven CTAs share an SM and the
// store's 800-864 tiles run in one wave (two 16 KB rings leave six CTAs
// an SM, and the eighth of 800 tiles a second wave: 20-30% slower in ts
// mode).  A step that fits no ring (the K-free dense ops go up to K =
// 1,024) takes the direct kernel, as irate and the moments do, which it
// serves faster at the store's widths.  A wait that never ends traps
// (mbar_wait).
//
// On the card (PERF.md section 6) this is not bound by bytes either: at
// the store's launches it runs 2-5 times its byte bound, 4-40% under the
// direct kernel, most where the direct kernel waited on timestamps
// (timestamp 30-40%, deriv and predict_linear 7-10%).  The walk is bound
// by the instruction rate and latency of its serial steps at about 24
// consumer warps an SM, which the lane count caps.

// The launch is laid out over blockIdx.x (tiles) and blockIdx.y
// (members): a co-arrival batch of M queries over the same resident plane
// (grid.rate_grid_batch) is one launch of M x tiles CTAs, each member's
// CTAs reading its own rows of the one plane (member_offsets,
// grid_device.cuh), with no copied [M, rows, ns] input.  Members share
// the plan: their q, ns and rows are the same.

#include "grid_device.cuh"

namespace {

constexpr int kSeriesRingMin = 8 * 1024;   // a plane's ring, at least
// CTAs an SM: seven hold a launch of up to 118,272 lanes (the store's
// 102,400-110,592) in one wave
constexpr int kSeriesCtas = 7;

// Rows a launch covers: [0, (T-1) * stride + K).
__host__ __device__ inline long series_rows(const Params& P) {
  return static_cast<long>(P.T - 1) * P.stride + P.K;
}

// Whether the staged kernel takes a ring of ring_bytes a plane: 8, 16, 32
// or 64 KB, in whose three stages a step of stride + K rows fits.
inline bool series_plan_ok(int ring_bytes, const Params& P) {
  return (ring_bytes == kSeriesRingMin || ring_bytes == 2 * kSeriesRingMin
          || ring_bytes == 4 * kSeriesRingMin || ring_bytes == kRingMax)
      && P.stride + P.K <= (kStages - 1) << stage_shift(ring_bytes, 4);
}

// One CTA per tile of kTile lanes of vals [nb, ns] (its f32 bits) and,
// in ts mode, ts [nb, ns]; the lanes' windows into out [T, ns].  Threads
// [0, kTile) consume, the warp after them produces.
template <int Fam>
__global__ void __launch_bounds__(kTile + kProducers, kSeriesCtas)
series_staged_kernel(const uint32_t* __restrict__ vals,
                     const int* __restrict__ ts,
                     const int* __restrict__ phase, float* __restrict__ out,
                     const int* __restrict__ row0s,
                     const int* __restrict__ steps0s, int ns, Params P,
                     int mode, int ring_bytes) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ RingBars bars;
  const int tid = static_cast<int>(threadIdx.x);
  const MemberOffsets mo = member_offsets(row0s, steps0s, ns, P);
  vals += mo.rows;
  if (ts) ts += mo.rows;
  out += mo.out;
  // the values' ring; in ts mode, theirs beside it
  uint32_t* ring = reinterpret_cast<uint32_t*>(sh);
  int* ts_ring = reinterpret_cast<int*>(sh + ring_bytes);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], (ts ? 2 : 1) * kProducers);
      mbar_init(&bars.empty[s], kTile);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the producer starts here
  const int cshift = stage_shift(ring_bytes, 4);
  const int rows = static_cast<int>(series_rows(P));
  const int lane0 = static_cast<int>(blockIdx.x) * kTile;
  const int nl = min(kTile, ns - lane0);
  if (tid >= kTile) {
    // a chunk at a time: its value rows, then its ts rows, each plane's
    // copies arriving once on the chunk's stage
    const int nchunks = (rows + (1 << cshift) - 1) >> cshift;
    for (int lc = 0; lc < nchunks; ++lc) {
      const long off = static_cast<long>(lc << cshift) * ns;
      const int nr = min(1 << cshift, rows - (lc << cshift));
      stage_rows<uint32_t>(vals + off, ns, lane0, nl, nr, cshift, ring,
                           bars, lc);
      if (ts)
        stage_rows<int>(ts + off, ns, lane0, nl, nr, cshift, ts_ring, bars,
                        lc);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  // a thread past the tile's last lane walks that lane again and stores
  // nothing
  const int j = min(tid, nl - 1);
  const long lane = static_cast<long>(lane0) + j;
  RingStoreSink sink{{&bars, cshift, 0, P.stride, P.K, rows, 0, 0, 0},
                     out + lane, ns, tid < nl};
  sink.ready_below(P.K);                 // the first step's rows
  const int mask = (kStages << cshift) - 1;
  dense_windows<Fam>(
      SmemDenseSrc<kTile, false>{reinterpret_cast<const float*>(sh) + j,
                                 mask, 0},
      RingTs<kTile>{ts_ring + j, mask, 0}, 0, phase, lane, P, mode, sink);
}

// Where a launch's member arrays live: none for a solo launch.
struct Members {
  const int* row0s;
  const int* steps0s;
  int count;
};

template <int Fam>
int staged_launch(const uint32_t* vals, const int* ts, const int* phase,
                  float* out, Members mb, int ns, const Params& P, int mode,
                  int ring_bytes, cudaStream_t s) {
  const size_t shared = static_cast<size_t>(ring_bytes) * (ts ? 2 : 1);
  const cudaError_t rc = allow_shared(series_staged_kernel<Fam>, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((ns + kTile - 1) / kTile, mb.count);
  series_staged_kernel<Fam><<<grid, kTile + kProducers, shared, s>>>(
      vals, ts, phase, out, mb.row0s, mb.steps0s, ns, P, mode, ring_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Both entries' checks and launch: nb is the rows each member may read
// from its first row on (the plane's rows for a solo launch).
int series_staged(const void* vals, const void* ts, const void* phase,
                  void* out, Members mb, int nb, int ns, int T, int K,
                  int stride, int g, int steps0, int op, int mode,
                  int dense, int is_rate, int ring_bytes, FN_ARGS,
                  void* stream) {
  const int fam = family_of(op);
  if (!args_ok(op, K) || ns < 1 || T < 1 || stride < 1 || mode < FREE
      || mode > TS || nb < static_cast<long>(T - 1) * stride + K
      || ((reads_ts(fam) || (fam == F_BASE && mode == TS)) && !ts)
      || (fam == F_BASE && mode == PHASE && !phase)
      || !members_ok(mb.row0s, mb.steps0s, mb.count))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, steps0, op, dense, is_rate, farg, farg2,
           rank_lo, rank_hi, w_lo, w_hi, fill};
  if (!series_plan_ok(ring_bytes, P))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  const int* t = static_cast<const int*>(ts);
  const int* ph = static_cast<const int*>(phase);
  float* o = static_cast<float*>(out);
  switch (fam) {
    case F_BASE:
      return staged_launch<F_BASE>(v, t, ph, o, mb, ns, P, mode, ring_bytes,
                                   s);
    case F_PAIR:
      return staged_launch<F_PAIR>(v, t, ph, o, mb, ns, P, mode, ring_bytes,
                                   s);
    case F_LINREG:
      return staged_launch<F_LINREG>(v, t, ph, o, mb, ns, P, mode,
                                     ring_bytes, s);
    case F_STAMP:
      return staged_launch<F_STAMP>(v, t, ph, o, mb, ns, P, mode,
                                    ring_bytes, s);
    case F_CHANGES:
      return staged_launch<F_CHANGES>(v, t, ph, o, mb, ns, P, mode,
                                      ring_bytes, s);
    case F_MOMENTS:
      return staged_launch<F_MOMENTS>(v, t, ph, o, mb, ns, P, mode,
                                      ring_bytes, s);
    case F_SORT:
      return staged_launch<F_SORT>(v, t, ph, o, mb, ns, P, mode, ring_bytes,
                                   s);
    case F_HOLT:
      return staged_launch<F_HOLT>(v, t, ph, o, mb, ns, P, mode, ring_bytes,
                                   s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The lanes of vals [nb, ns] through the staged kernel at the host's plan
// (ring_bytes a plane): out is [T, ns] f32.  The arguments before the
// plan are rate_grid_launch's.
int series_staged_launch(const void* vals, const void* ts, const void* phase,
                         void* out, int nb, int ns, int T, int K, int stride,
                         int g, int steps0, int op, int mode, int dense,
                         int is_rate, int ring_bytes, FN_ARGS, void* stream) {
  return series_staged(vals, ts, phase, out, Members{nullptr, nullptr, 1},
                       nb, ns, T, K, stride, g, steps0, op, mode, dense,
                       is_rate, ring_bytes, farg, farg2, rank_lo, rank_hi,
                       w_lo, w_hi, fill, stream);
}

// A co-arrival batch of `members` queries over ONE plane vals [*, ns] (and
// ts, phase) through the staged kernel, in one launch: member m's windows
// start at plane row row0s[m] and end first at steps0s[m] (int32 arrays
// on the device), its answer rows [m*T, (m+1)*T) of out [members*T, ns].
// nrows is the rows a member reads from its first row on (the host checks
// that each member's lie inside the plane).  The other arguments are
// series_staged_launch's.
int series_staged_batch_launch(const void* vals, const void* ts,
                               const void* phase, void* out,
                               const void* row0s, const void* steps0s,
                               int members, int nrows, int ns, int T, int K,
                               int stride, int g, int op, int mode,
                               int dense, int is_rate, int ring_bytes,
                               FN_ARGS, void* stream) {
  if (row0s == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return series_staged(
      vals, ts, phase, out,
      Members{static_cast<const int*>(row0s),
              static_cast<const int*>(steps0s), members},
      nrows, ns, T, K, stride, g, 0, op, mode, dense, is_rate, ring_bytes,
      farg, farg2, rank_lo, rank_hi, w_lo, w_hi, fill, stream);
}

}  // extern "C"

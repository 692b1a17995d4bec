// B2 on Hopper: dense_staged_kernel replaces the TPU kernel
// rate_grid_grouped (filodb_tpu/ops/grid.py:906-957, bodies
// _grouped_kernel{,_free,_phase}), and serves all 22 ops of that kernel in
// its three modes (free, phase, ts) through lane_windows and
// lane_windows_ext (grid_device.cuh).  The lanes of a decoded f32 plane
// [nb, ns] come in groups of group_lanes, and group g's lanes reduce into
// output row g of the [G, T] (sum, count): free and ts modes sum and
// count the finite answers, phase mode every lane live at row 0.
//
// What bounds it: bytes.  It must read rows [0, (T-1)*stride + K) = R of
// the plane, the phase row (phase mode) or R ts rows (ts mode), and write
// the [G, T] sums and counts: R*S*4 + S*4 bytes in phase mode, R*S*4 more
// in ts mode.  At the north-star widths (1,024,000 lanes in 1,000 groups
// of 1,024, 59 rows, T = 55, K = 5, phase mode) 246 MB, 0.0735 ms at
// 3.35 TB/s.
//
// Design.  The TPU kernel reduces a group's lanes with a 0/1 matmul on
// the MXU.  The kernel before this one (rate_grid_grouped_kernel,
// grid_kernels.cu, kept as the direct path) has a thread walk a lane,
// reading its f32 of each row from device memory with one load in flight
// (DenseSrc).
//
// Here, as in B4 (grouped_staged.cu), a CTA is one group: Tile consumer
// threads and one producer warp, Tile 128 for a group of at most 128
// lanes, else 256 (the host's plan; each an instantiation).  The group is
// walked in passes of Tile lanes.  The producer streams each pass's rows
// [0, R) of the plane into a ring of kStages stages in shared memory
// (stage_rows: 16-byte cp.async, plain loads where a group's row slice is
// not 16-byte aligned, each stage's arrival on an mbarrier) and carries
// its chunk count on into the next pass's tile, so that no pass drains
// the ring.  A launch that reads timestamps (ts mode, and irate, idelta,
// deriv, predict_linear, timestamp) stages their rows the same way, a
// chunk at a time, into a second ring of the same bytes beside the first
// (the chunk's stage awaits both planes' arrivals).  There is no decode
// and no XOR prefix: the windows start at plane row 0.  Each consumer
// hands its lane's column of the ring (SmemDenseSrc) and of the ts ring
// (a pointer step a row, or RingTs) to the window code lane_windows /
// lane_windows_ext<Fam>, so every op's arithmetic is the code it was and
// its per-lane values keep their bits; phase mode reads the lane's phase
// once a pass.  The sink is B4's RingWarpSumSink (grid_device.cuh): at
// every step each warp reduces its 32 lanes' values by shuffles and counts
// them (by a ballot in the base family) into its own shared row of
// partials, the stages behind the step are freed and the next step's
// awaited, no step meets a barrier, and after the last pass the consumers
// meet at a named barrier over themselves only and add the rows in warp
// order.
//
// Two ring layouts, as in B4: where a pass's rows fit the ring's four
// stages a pass takes 1, 2 or 4 whole stages (the producer arrives on the
// stages past its rows with no copy) and a consumer reads with a pointer
// step a row; else a pass's rows wrap the ring and each row read is
// masked into it.  The host takes the linear layout where it can
// (grid.dense_staged_plan): at the north-star widths a pass's 59 rows of
// 1 KB take the 64 KB ring, with 3.5 KB of partials 69 KB a CTA, so
// shared memory caps it at three CTAs an SM.  A launch that reads
// timestamps takes the least ring instead (two 16 KB rings there, which
// wrap: four CTAs an SM): the first version read its timestamps from
// device memory at three CTAs an SM, and was up to 75% slower than the
// direct kernel, which keeps 48-64 warps an SM waiting on those loads
// (PERF.md section 6).
//
// The sum order is the direct kernel's: lane c0 + tid of a pass adds into
// warp tid / 32's row, pass after pass, and the rows add in warp order
// (the direct kernel runs eight warps over a group of more than 224 lanes,
// in passes of 256; fewer over a smaller group, where the staged kernel's
// extra warps add exact zeros to rows that are never -0.0).  The counts are
// integers of at most 32 either way.  So the staged and the direct kernel
// are bit-equal, except where group_shape (grid_kernels.cu) cuts the
// direct kernel's warps for T > 768: there the passes split the lanes
// otherwise, and the two agree within rounding.
//
// The ring is the least of 16, 32 and 64 KB in which a step's stride + K
// rows fit in three stages and, for the linear layout, a pass's rows in
// four; a step that fits no ring (the K-free dense ops go up to K =
// 1,024), or partial rows and rings past a CTA's shared memory, take the
// direct kernel.  A wait that never ends traps (mbar_wait).
//
// On the card (PERF.md section 6) this is not bound by bytes: at the
// north-star widths it runs rate at about 5 times the byte bound, 10%
// under the direct kernel, ts-mode rate, deriv and predict_linear 6-16%
// under it, holt_winters and quantile 2-4%.  The issue of the per-lane
// walk and of the per-step warp sum bounds it, as it does B3-B5: warps
// an SM moved it little where its rows were already in shared memory
// (five CTAs of the timestamp families: 0-3%, with spills).  Where the
// direct kernel reads few rows a step from L1 at 48-64 warps an SM, it
// stays ahead: irate, idelta and timestamp (two rows a window) by
// 16-20%, changes, resets and the moments by 2-6%, mad by 1%.

#include "grid_device.cuh"

namespace {

// Dynamic shared bytes of a plan: the ring, the ts ring of the same
// bytes where the launch reads timestamps, then the partial rows.
inline long dense_shared_bytes(const GroupPlan& p, int T, bool ts) {
  return group_shared_bytes(p, T) + (ts ? p.ring_bytes : 0);
}

// One CTA per group of group_lanes contiguous lanes of vals [nb, ns] (its
// f32 bits); the group's (sum, count) row at sum/cnt + blockIdx.x * T.
// Threads [0, Tile) consume, [Tile, Tile + 32) produce.  At most 56
// registers a thread, four CTAs an SM (the linear layout's 69 KB CTAs fit
// three; (288, 3) was no faster there).
template <int Fam, int Tile, bool Linear>
__global__ void __launch_bounds__(kGroupTileMax + kProducers, 4)
dense_staged_kernel(const uint32_t* __restrict__ vals,
                    const int* __restrict__ ts,
                    const int* __restrict__ phase, float* __restrict__ sum,
                    float* __restrict__ cnt, int ns, int group_lanes,
                    Params P, int mode, int ring_bytes) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ RingBars bars;
  const int T = P.T;
  const int tid = static_cast<int>(threadIdx.x);
  // the values' ring; where the launch reads timestamps, theirs beside it
  uint32_t* ring = reinterpret_cast<uint32_t*>(sh);
  int* ts_ring = reinterpret_cast<int*>(sh + ring_bytes);
  const int planes = ts ? 2 : 1;
  float* part = reinterpret_cast<float*>(sh + planes * ring_bytes);
  for (int i = tid; i < 2 * T * (Tile / 32); i += blockDim.x) part[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], planes * kProducers);
      mbar_init(&bars.empty[s], Tile);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the producer starts here
  const int cshift = stage_shift(ring_bytes, 4, Tile);
  const int rows = (T - 1) * P.stride + P.K;
  const int nchunks = (rows + (1 << cshift) - 1) >> cshift;
  // ring chunks a pass takes: its own, or in the linear layout a divisor
  // of kStages, the chunks past its own arriving empty
  const int pchunks = Linear ? linear_chunks(nchunks) : nchunks;
  const int g0 = static_cast<int>(blockIdx.x) * group_lanes;
  if (tid >= Tile) {
    // a group of a multiple of 4 lanes keeps every tile's lanes aligned
    const bool lanes_aligned = group_lanes % 4 == 0;
    for (int f = 0, c0 = 0; f < group_lanes; f += Tile, c0 += pchunks) {
      const int nl = min(Tile, group_lanes - f);
      // a chunk at a time: its value rows, then its ts rows, each plane's
      // copies arriving once on the chunk's stage
      for (int lc = 0; lc < nchunks; ++lc) {
        const long off = static_cast<long>(lc << cshift) * ns;
        const int nr = min(1 << cshift, rows - (lc << cshift));
        stage_rows<uint32_t, Tile>(vals + off, ns, g0 + f, nl, nr, cshift,
                                   ring, bars, c0 + lc, lanes_aligned);
        if (ts)
          stage_rows<int, Tile>(ts + off, ns, g0 + f, nl, nr, cshift,
                                ts_ring, bars, c0 + lc, lanes_aligned);
      }
      for (int c = c0 + nchunks; c < c0 + pchunks; ++c) {
        const int s = c % kStages;
        if (c >= kStages) mbar_wait(&bars.empty[s], (c / kStages - 1) & 1);
        for (int k = 0; k < planes; ++k) mbar_arrive(&bars.full[s]);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  const float* fring = reinterpret_cast<const float*>(sh);
  RingWarpSumSink<Tile, Fam == F_BASE> sink{
      {&bars, cshift, 0, P.stride, P.K, rows, 0, 0, 0},
      {part + (tid >> 5) * 2 * T, T, false}, 0, 0};
  for (int f = 0; f < group_lanes; f += Tile) {
    sink.begin(f, group_lanes);
    // past the group's end: walk its last lane, contribute nothing
    const int j = min(tid, group_lanes - f - 1);
    const long lane = static_cast<long>(g0) + f + j;
    sink.sync_rows(0, P.K);                // step 0's rows
    // this pass's row 0 is the ring row after the earlier passes'; the
    // ts ring (read only where the launch has one) lies as the values'
    if constexpr (Linear) {
      const int at = (((sink.base % kStages) << cshift) * Tile) + j;
      dense_windows<Fam>(SmemDenseSrc<Tile, true>{fring + at, 0, 0},
                         static_cast<const int*>(ts_ring + at), Tile, phase,
                         lane, P, mode, sink);
    } else {
      const int mask = (kStages << cshift) - 1, r0 = sink.base << cshift;
      dense_windows<Fam>(SmemDenseSrc<Tile, false>{fring + j, mask, r0},
                         RingTs<Tile>{ts_ring + j, mask, r0}, 0, phase, lane,
                         P, mode, sink);
    }
    sink.end(pchunks);
  }
  const long out0 = static_cast<long>(blockIdx.x) * T;
  sink.finish(sum + out0, cnt + out0);
}

template <int Fam, int Tile, bool Linear>
int mode_launch(const uint32_t* vals, const int* ts, const int* phase,
                float* sum, float* cnt, int ns, int group_lanes,
                const Params& P, int mode, const GroupPlan& plan,
                cudaStream_t s) {
  const size_t shared = static_cast<size_t>(
      dense_shared_bytes(plan, P.T, ts != nullptr));
  const cudaError_t rc =
      allow_shared(dense_staged_kernel<Fam, Tile, Linear>, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dense_staged_kernel<Fam, Tile, Linear><<<ns / group_lanes,
                                           Tile + kProducers, shared, s>>>(
      vals, ts, phase, sum, cnt, ns, group_lanes, P, mode, plan.ring_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <int Fam, int Tile>
int tile_launch(const uint32_t* vals, const int* ts, const int* phase,
                float* sum, float* cnt, int ns, int group_lanes,
                const Params& P, int mode, const GroupPlan& plan,
                cudaStream_t s) {
  if (plan.linear)
    return mode_launch<Fam, Tile, true>(vals, ts, phase, sum, cnt, ns,
                                        group_lanes, P, mode, plan, s);
  return mode_launch<Fam, Tile, false>(vals, ts, phase, sum, cnt, ns,
                                       group_lanes, P, mode, plan, s);
}

template <int Fam>
int staged_launch(const uint32_t* vals, const int* ts, const int* phase,
                  float* sum, float* cnt, int ns, int group_lanes,
                  const Params& P, int mode, const GroupPlan& plan,
                  cudaStream_t s) {
  if (plan.tile == kTile)
    return tile_launch<Fam, kTile>(vals, ts, phase, sum, cnt, ns,
                                   group_lanes, P, mode, plan, s);
  return tile_launch<Fam, kGroupTileMax>(vals, ts, phase, sum, cnt, ns,
                                         group_lanes, P, mode, plan, s);
}

}  // namespace

extern "C" {

// The groups of vals [nb, ns] through the staged kernel at the host's
// plan (tile, ring_bytes, linear): sum and cnt are [ns / group_lanes, T]
// f32.  The arguments before the plan are rate_grid_grouped_launch's.
int dense_staged_launch(const void* vals, const void* ts, const void* phase,
                        void* sum, void* cnt, int nb, int ns,
                        int group_lanes, int T, int K, int stride, int g,
                        int steps0, int op, int mode, int dense,
                        int is_rate, int tile, int ring_bytes, int linear,
                        FN_ARGS, void* stream) {
  const int fam = family_of(op);
  if (!args_ok(op, K) || group_lanes < 1 || ns % group_lanes != 0 || T < 1
      || stride < 1 || mode < FREE || mode > TS
      || nb < (T - 1) * stride + K
      || ((reads_ts(fam) || (fam == F_BASE && mode == TS)) && !ts)
      || (fam == F_BASE && mode == PHASE && !phase))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, steps0, op, dense, is_rate, farg, farg2,
           rank_lo, rank_hi, w_lo, w_hi, fill};
  const GroupPlan plan{tile, ring_bytes, linear};
  if (!group_plan_ok(plan, 4, 0, P)
      || dense_shared_bytes(plan, T, ts != nullptr) > kGroupSharedCta)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  const int* t = static_cast<const int*>(ts);
  const int* ph = static_cast<const int*>(phase);
  float* so = static_cast<float*>(sum);
  float* co = static_cast<float*>(cnt);
  switch (fam) {
    case F_BASE:
      return staged_launch<F_BASE>(v, t, ph, so, co, ns, group_lanes, P,
                                   mode, plan, s);
    case F_PAIR:
      return staged_launch<F_PAIR>(v, t, ph, so, co, ns, group_lanes, P,
                                   mode, plan, s);
    case F_LINREG:
      return staged_launch<F_LINREG>(v, t, ph, so, co, ns, group_lanes, P,
                                     mode, plan, s);
    case F_STAMP:
      return staged_launch<F_STAMP>(v, t, ph, so, co, ns, group_lanes, P,
                                    mode, plan, s);
    case F_CHANGES:
      return staged_launch<F_CHANGES>(v, t, ph, so, co, ns, group_lanes, P,
                                      mode, plan, s);
    case F_MOMENTS:
      return staged_launch<F_MOMENTS>(v, t, ph, so, co, ns, group_lanes, P,
                                      mode, plan, s);
    case F_SORT:
      return staged_launch<F_SORT>(v, t, ph, so, co, ns, group_lanes, P,
                                   mode, plan, s);
    case F_HOLT:
      return staged_launch<F_HOLT>(v, t, ph, so, co, ns, group_lanes, P,
                                   mode, plan, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

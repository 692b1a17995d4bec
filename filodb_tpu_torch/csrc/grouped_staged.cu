// B4 on Hopper: grouped_staged_kernel replaces the TPU kernel
// rate_grid_grouped_packed (filodb_tpu/ops/grid.py:1130-1202, body
// _grouped_kernel_packed), and serves all 22 ops of that kernel that read
// no ts plane, through lane_windows and lane_windows_ext
// (grid_device.cuh).  A class plane's columns come in groups of
// group_lanes, and group g's lanes reduce into output row g of the [G, T]
// (sum, count): free mode sums and counts the finite answers, phase mode
// every lane live at row 0.
//
// What bounds it: bytes.  It must read rows [0, row0 + R) of the plane
// (the XOR prefix starts at block row 0), the meta rows, and write the
// [G, T] sums and counts: at the north-star widths (1,024,000 lanes of one
// p16 plane in 1,000 groups of 1,024, 59 rows, T = 55, K = 5, phase mode)
// 133 MB, 0.0399 ms at 3.35 TB/s.
//
// Design.  The TPU kernel reduces a group's lanes with a 0/1 matmul on
// the MXU.  The kernel before this one (grouped_packed_kernel with
// WarpSumSink, grid_kernels.cu, kept as the direct path) has a thread
// walk a lane, reading its 1- to 4-byte words of each row from device
// memory with one load in flight, and is bound by that load latency.
//
// Here, as in B5 (hist_staged.cu), a CTA is one group: Tile consumer
// threads and one producer warp, Tile 128 for a group of at most 128
// lanes, else 256 (the host's plan; each an instantiation).  The group is
// walked in passes of Tile lanes.  The producer streams each pass's rows
// [0, row0 + R) into a ring of kStages stages in shared memory
// (stage_rows: 16-byte cp.async, plain loads where a row slice is not
// 16-byte aligned, each stage's arrival on an mbarrier) and carries its
// chunk count on into the next pass's tile, so that no pass drains the
// ring.  Each consumer decodes its lane's column of the ring, so every
// op's arithmetic is the code it was and its per-lane values keep their
// bits.  The sink (RingWarpSumSink) is WarpSumSink on the ring protocol of
// RingWaits: at every step each warp reduces its 32 lanes' values by
// shuffles and counts them (by a ballot in the base family), lane 0 adds
// both to the warp's own shared row of partials, and the stages behind
// the step are freed and the next step's awaited.  No step meets a
// barrier.  After the last pass the consumers meet at a named barrier
// over themselves only (consumer_sync: the producer warp may be gone or
// spinning on an "empty" mbarrier), and the rows are added in warp order.
//
// Two ring layouts.  Where a pass's rows fit the ring's four stages, a
// pass takes 1, 2 or 4 whole stages (a divisor of kStages; the producer
// arrives on the stages past its rows with no copy), so that it starts
// where the last one's stages ended and never wraps: a consumer reads its
// column through SmemLinearSrc, a pointer step a row.  Else a pass's rows
// wrap the ring and SmemPackedSrc masks each row into it (B3's and B5's
// source: a mask, a multiply and a shift-add a row read where a pointer
// steps); the windows that walk their rows again (moments, sort, holt)
// read six rows a step, and that cost made them slower than the direct
// kernel at the north-star widths (PERF.md section 6).  The host takes the linear layout where it
// can (grid.grouped_staged_plan).
//
// The sum order is the direct kernel's: lane c0 + tid of a pass adds into
// warp tid / 32's row, pass after pass, and the rows add in warp order.
// At Tile 256 that is the direct kernel's eight warps; where the direct
// kernel runs fewer (a group of at most 224 lanes, one pass) the extra
// warps add exact zeros to rows that are never -0.0.  The counts are
// integers of at most 32 either way.  So the staged and the direct kernel
// are bit-equal, except where group_shape (grid_kernels.cu) cuts the
// direct kernel's warps for T > 768 below the group's: there the passes
// split the lanes otherwise, and the two agree within rounding.
//
// The ring is the least of 16, 32 and 64 KB in which the plane's stride +
// K rows fit in three stages and, for the linear layout, a pass's rows in
// four; a plane whose step fits no ring (the K-free dense ops go up to K
// = 1,024), or whose partial rows and ring pass a CTA's shared memory,
// takes the direct kernel.  A wait that never ends traps (mbar_wait).
//
// On the card (PERF.md section 6) this is not bound by bytes: at the
// north-star widths (the linear layout, a 32 KB ring, 56 registers and
// four CTAs an SM, 32 consumer warps) it runs at about 9.5 times the
// byte bound, 9% under the direct kernel in rate.  The issue of the
// per-lane walk bounds it, as it does B3 and B5: instructions a row read
// moved it (the wrapping layout's made the window-walking ops slower
// than the direct kernel), warps an SM hardly did (five CTAs at 40
// registers: 2%, with spills, and the sort family slower).

#include "grid_device.cuh"

namespace {

// One pass of a consumer thread: the XOR prefix, a stage at a time, then
// the lane's windows into the sink.
template <int Fam, class Src, class Sink>
__device__ void consume_pass(Src src, const int* meta, int n, int lane,
                             int row0, const Params& P, int mode,
                             Sink& sink) {
  for (int r = 0; r < row0;) {
    const int end = min(row0, ((r >> sink.cshift) + 1) << sink.cshift);
    sink.ready_below(end);
    for (; r < end; ++r) src.next();
    sink.free_below(r);
  }
  sink.sync_rows(row0, row0 + P.K);      // step 0's rows
  packed_windows<Fam>(src, meta, n, lane, P, mode, sink);
}

// One CTA per group of group_lanes contiguous lanes of one class plane;
// the group's (sum, count) row at sum/cnt + blockIdx.x * T.  Threads [0,
// Tile) consume, [Tile, Tile + 32) produce.  Four CTAs an SM: at most 56
// registers a thread.
template <typename W, int Fam, int Tile, bool Linear>
__global__ void __launch_bounds__(kGroupTileMax + kProducers, 4)
grouped_staged_kernel(const W* __restrict__ plane,
                      const int* __restrict__ meta, float* __restrict__ sum,
                      float* __restrict__ cnt, int n, int group_lanes,
                      int row0, Params P, int mode, int ring_bytes) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ RingBars bars;
  const int T = P.T;
  const int tid = static_cast<int>(threadIdx.x);
  W* ring = reinterpret_cast<W*>(sh);
  float* part = reinterpret_cast<float*>(sh + ring_bytes);
  for (int i = tid; i < 2 * T * (Tile / 32); i += blockDim.x) part[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], kProducers);
      mbar_init(&bars.empty[s], Tile);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the producer starts here
  const int cshift = stage_shift(ring_bytes, sizeof(W), Tile);
  const int rows = row0 + (T - 1) * P.stride + P.K;
  const int nchunks = (rows + (1 << cshift) - 1) >> cshift;
  // ring chunks a pass takes: its own, or in the linear layout a divisor
  // of kStages, the chunks past its own arriving empty
  const int pchunks = Linear ? linear_chunks(nchunks) : nchunks;
  const int g0 = static_cast<int>(blockIdx.x) * group_lanes;
  if (tid >= Tile) {
    // a group of a multiple of 16 bytes keeps every tile's lanes aligned
    const bool lanes_aligned =
        (group_lanes * static_cast<long>(sizeof(W))) % 16 == 0;
    for (int f = 0, c0 = 0; f < group_lanes; f += Tile, c0 += pchunks) {
      stage_rows<W, Tile>(plane, n, g0 + f, min(Tile, group_lanes - f), rows,
                          cshift, ring, bars, c0, lanes_aligned);
      for (int c = c0 + nchunks; c < c0 + pchunks; ++c) {
        const int s = c % kStages;
        if (c >= kStages) mbar_wait(&bars.empty[s], (c / kStages - 1) & 1);
        mbar_arrive(&bars.full[s]);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  RingWarpSumSink<Tile, Fam == F_BASE> sink{
      {&bars, cshift, row0, P.stride, P.K, rows, 0, 0, 0},
      {part + (tid >> 5) * 2 * T, T, false}, 0, 0};
  for (int f = 0; f < group_lanes; f += Tile) {
    sink.begin(f, group_lanes);
    // past the group's end: walk its last lane, contribute nothing
    const int j = min(tid, group_lanes - f - 1);
    const int lane = g0 + f + j;
    const uint32_t shift = static_cast<uint32_t>(meta[lane]);
    const uint32_t first = static_cast<uint32_t>(meta[n + lane]);
    // this pass's block row 0 is the ring row after the earlier passes'
    if constexpr (Linear) {
      const W* col = ring + (((sink.base % kStages) << cshift) * Tile) + j;
      consume_pass<Fam>(SmemLinearSrc<W, Tile>{col, shift, first, 0u}, meta,
                        n, lane, row0, P, mode, sink);
    } else {
      consume_pass<Fam>(SmemPackedSrc<W, Tile>{ring + j,
                                               (kStages << cshift) - 1,
                                               sink.base << cshift, shift,
                                               first, 0u},
                        meta, n, lane, row0, P, mode, sink);
    }
    sink.end(pchunks);
  }
  const long out0 = static_cast<long>(blockIdx.x) * T;
  sink.finish(sum + out0, cnt + out0);
}

template <typename W, int Fam, int Tile, bool Linear>
int mode_launch(const W* plane, const int* meta, float* sum, float* cnt,
                int n, int group_lanes, int row0, const Params& P, int mode,
                const GroupPlan& plan, cudaStream_t s) {
  const size_t shared = static_cast<size_t>(group_shared_bytes(plan, P.T));
  const cudaError_t rc =
      allow_shared(grouped_staged_kernel<W, Fam, Tile, Linear>, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  grouped_staged_kernel<W, Fam, Tile, Linear><<<n / group_lanes,
                                                Tile + kProducers, shared,
                                                s>>>(
      plane, meta, sum, cnt, n, group_lanes, row0, P, mode, plan.ring_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int Fam, int Tile>
int tile_launch(const W* plane, const int* meta, float* sum, float* cnt,
                int n, int group_lanes, int row0, const Params& P, int mode,
                const GroupPlan& plan, cudaStream_t s) {
  if (plan.linear)
    return mode_launch<W, Fam, Tile, true>(plane, meta, sum, cnt, n,
                                           group_lanes, row0, P, mode, plan,
                                           s);
  return mode_launch<W, Fam, Tile, false>(plane, meta, sum, cnt, n,
                                          group_lanes, row0, P, mode, plan, s);
}

template <typename W, int Fam>
int staged_launch(const W* plane, const int* meta, float* sum, float* cnt,
                  int n, int group_lanes, int row0, const Params& P, int mode,
                  const GroupPlan& plan, cudaStream_t s) {
  if (plan.tile == kTile)
    return tile_launch<W, Fam, kTile>(plane, meta, sum, cnt, n, group_lanes,
                                      row0, P, mode, plan, s);
  return tile_launch<W, Fam, kGroupTileMax>(plane, meta, sum, cnt, n,
                                            group_lanes, row0, P, mode, plan,
                                            s);
}

template <typename W>
int staged_family(const W* plane, const int* meta, float* sum, float* cnt,
                  int n, int group_lanes, int row0, const Params& P, int mode,
                  const GroupPlan& plan, cudaStream_t s) {
  switch (family_of(P.op)) {
    case F_BASE:
      return staged_launch<W, F_BASE>(plane, meta, sum, cnt, n, group_lanes,
                                      row0, P, mode, plan, s);
    case F_CHANGES:
      return staged_launch<W, F_CHANGES>(plane, meta, sum, cnt, n,
                                         group_lanes, row0, P, mode, plan, s);
    case F_MOMENTS:
      return staged_launch<W, F_MOMENTS>(plane, meta, sum, cnt, n,
                                         group_lanes, row0, P, mode, plan, s);
    case F_SORT:
      return staged_launch<W, F_SORT>(plane, meta, sum, cnt, n, group_lanes,
                                      row0, P, mode, plan, s);
    case F_HOLT:
      return staged_launch<W, F_HOLT>(plane, meta, sum, cnt, n, group_lanes,
                                      row0, P, mode, plan, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One class plane's groups through the staged kernel at the host's plan
// (tile, ring_bytes, linear): sum and cnt point at [G_all, T] f32, this
// plane's first group at slot0 (a group index).  The arguments before the
// plan are grouped_packed_launch's; hb must be 1.
int grouped_staged_launch(const void* plane, const void* meta, void* sum,
                          void* cnt, int kind, int nb, int n,
                          int group_lanes, int hb, int slot0, int row0,
                          int T, int K, int stride, int g, int op,
                          int use_phase, int dense, int is_rate, int tile,
                          int ring_bytes, int linear, FN_ARGS,
                          void* stream) {
  (void)nb;
  if (!args_ok(op, K) || reads_ts(family_of(op)) || hb != 1
      || group_lanes < 1 || n % group_lanes != 0 || T < 1 || stride < 1
      || row0 < 0 || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, 0, op, dense, is_rate, farg, farg2, rank_lo,
           rank_hi, w_lo, w_hi, fill};
  const GroupPlan plan{tile, ring_bytes, linear};
  if (!group_plan_ok(plan, word_bytes(kind), row0, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = use_phase ? PHASE : FREE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  const long off = static_cast<long>(slot0) * T;
  float* so = static_cast<float*>(sum) + off;
  float* co = static_cast<float*>(cnt) + off;
  switch (kind) {
    case 0:
      return staged_family(static_cast<const uint8_t*>(plane), m, so, co, n,
                           group_lanes, row0, P, mode, plan, s);
    case 1:
      return staged_family(static_cast<const uint16_t*>(plane), m, so, co, n,
                           group_lanes, row0, P, mode, plan, s);
    default:
      return staged_family(static_cast<const uint32_t*>(plane), m, so, co, n,
                           group_lanes, row0, P, mode, plan, s);
  }
}

}  // extern "C"

// B5 on Hopper: hist_grouped_staged_kernel replaces the TPU kernel
// hist_grid_grouped_packed (filodb_tpu/ops/grid.py:1266-1339, body
// _hist_grouped_kernel_packed), and serves all 22 ops of that kernel that
// read no ts plane, through lane_windows and lane_windows_ext
// (grid_device.cuh).  A class plane's columns come in groups of
// group_lanes, column c of a group a series' bucket c % hb (the stride
// pack), and group g's bucket j reduces into output slot g * hb + j of
// the [G * hb, T] (sum, count) rows.
//
// What bounds it: bytes.  It must read rows [0, row0 + R) of the plane
// (the XOR prefix starts at block row 0), the meta rows, and write the
// [G * hb, T] sums and counts: at the north-star widths (1,048,576 bucket
// columns of one p16 plane, 59 rows, T = 55, K = 5, hb = 16) 143.5 MB,
// 0.0428 ms at 3.35 TB/s.
//
// Design.  The TPU kernel reduces buckets with a banded 0/1 matmul on the
// MXU.  Bucket j's sum must stay the plain left-to-right sum of its
// series (histogram_quantile over independent bucket counters is
// ill-conditioned: another order moves the quantile), so one CTA owns one
// group and adds every bucket's lanes in lane order.  The kernel before
// this one read each lane's words from device memory (one 1- to 4-byte
// load in flight a thread) and met at a CTA-wide barrier at every step,
// after which hb threads each added their bucket's lanes serially.
//
// Here a CTA is Tile consumer threads and one producer warp: Tile is
// 128 lanes (B3's tile) for a group of at most 128 lanes, else 256 (the
// host's plan; each an instantiation of the kernel).  The group is walked
// in passes of a lane tile.  The producer streams each pass's rows [0,
// row0 + R) into a ring of kStages stages in shared memory (stage_rows:
// 16-byte cp.async, plain loads where a row slice is not 16-byte aligned,
// each stage's arrival on an mbarrier), and carries its chunk count
// straight on into the next pass's tile, so that a pass's end does not
// drain the ring.  Each consumer decodes its lane's column through
// SmemPackedSrc, its ring row starting after the earlier passes' rows,
// so every op's arithmetic is the code it was and its per-lane values
// keep their bits.  At every step the sink (HistChunkSink, on
// RingWaits, the ring protocol of B3's RingStoreSink) writes the lane's
// value into a double-buffered shared [C, Tile] chunk (kSkip where the
// reduce does not take it), frees the stages behind the step and waits
// for the next step's.  Every C steps, and at a pass's last step, the
// consumers meet at one named barrier over the consumer threads only
// (bar.sync 1, Tile: the producer warp may be spinning on an "empty"
// mbarrier or gone, so a CTA-wide barrier would deadlock); then every
// consumer thread takes (bucket, step) pairs of the chunk and adds the
// bucket's lanes of the tile, in lane order, onto the running [hb][T]
// sums.  Those sit in shared memory when they fit, else in the zeroed
// output rows.  The double buffer lets one barrier a chunk suffice: a
// chunk's buffer is written again only two barriers later, after every
// consumer has reduced it.  A wait that never ends traps (mbar_wait).
//
// The ring holds the same bytes a launch, the least of 16, 32 and 64 KB
// in which the plane's stride + K rows fit in three stages
// (grid.hist_staged_plan builds the plan on the host); a plane whose step
// fits no ring (the K-free dense ops go up to K = 1,024) takes the direct
// kernel, grouped_packed_kernel with BucketSink (grid_kernels.cu).
//
// On the card (PERF.md section 6) this is not bound by bytes: at the
// north-star widths four CTAs of 288 threads an SM (56 registers and 56
// KB of shared memory each bound it there), 32 consumer warps, walk their
// rows through lane_windows, two cursors decoding and correcting a row
// each a step; the issue of that walk bounds it, and the chunk reduce
// and the barrier take a smaller share.  There the 256-lane tile beats
// the 128-lane one, whose CTAs hold four consumer warps.

#include "grid_device.cuh"

namespace {

constexpr int kHistTileMax = 256;     // consumer threads a CTA, at most
constexpr int kChunkMax = 32;         // steps a chunk, at most
// the dynamic shared memory a CTA may use beside its static barriers
constexpr int kSharedCta = 232448 - static_cast<int>(sizeof(RingBars));

// The launch's plan (grid.hist_staged_plan): consumer threads and lanes
// a pass, ring bytes, steps a chunk, and whether the running sums sit in
// shared memory.
struct HistPlan {
  int tile, ring_bytes, chunk, acc_shared;
};

// A chunk cell the reduce does not take: a NaN no step value has.  A taken
// value is finite in the free ops; in phase mode it may be NaN, but the
// card's arithmetic and NAN give the canonical 0x7fffffff, never these
// bits.  One word a cell, where a value and a flag took two, leaves the
// shared memory for a fourth CTA an SM.
constexpr uint32_t kSkip = 0xffffffffu;

// Dynamic shared bytes of a plan: the ring, the double-buffered chunk of
// values, and the running sums when they are shared.
inline long hist_shared_bytes(const HistPlan& p, int hb, int T) {
  return static_cast<long>(p.ring_bytes) + 8L * p.chunk * p.tile
      + (p.acc_shared ? 8L * hb * T : 0L);
}

// The consumers' sink: the ring protocol of RingWaits, and the bucket
// sum a chunk of C steps at a time.  buf is [2][C][Tile]: two chunks of
// C steps' values.
template <int Tile>
struct HistChunkSink : RingWaits {
  float* buf;
  float* acc_s;      // [hb][T] running sums and counts
  float* acc_c;
  int T, hb, C, tid;
  int first;         // group column of this pass's first lane
  int nvalid;        // lanes of this pass
  int slot;          // steps of the open chunk written
  int k;             // chunks reduced so far: the open chunk's buffer

  __device__ void begin(int first_col, int group_lanes) {
    first = first_col;
    nvalid = min(Tile, group_lanes - first_col);
    freed = ready = slot = 0;
  }
  // After a pass's last step: free its remaining stages.
  __device__ void end(int nchunks) {
    free_below(nchunks << cshift);
    base += nchunks;
  }
  // The chunk's (bucket, step) pairs over the consumer threads: a pair
  // adds its bucket's lanes of this pass, in lane order, onto the running
  // sum.  The bucket whose first lane in the pass is i: (first + i) % hb.
  __device__ void reduce(const float* b, int t0, int steps) {
    const int nb = min(hb, nvalid), np = nb * steps;
    for (int p = tid; p < np; p += Tile) {
      const int s = p / nb, i = p - s * nb;
      const int at = ((first + i) % hb) * T + t0 + s;
      const float* bv = b + s * Tile;
      float sum = acc_s[at], cnt = acc_c[at];
      for (int l = i; l < nvalid; l += hb) {
        const float v = bv[l];
        const bool take = __float_as_uint(v) != kSkip;
        sum = sum + (take ? v : 0.f);
        cnt = cnt + (take ? 1.f : 0.f);
      }
      acc_s[at] = sum;
      acc_c[at] = cnt;
    }
  }
  __device__ void operator()(int t, float v, bool ok) {
    float* b = buf + (k & 1) * C * Tile;
    b[slot * Tile + tid] = ok ? v : __uint_as_float(kSkip);
    free_below(row0 + t * stride);
    if (++slot == C || t == T - 1) {
      consumer_sync(Tile);
      reduce(b, t + 1 - slot, slot);
      slot = 0;
      ++k;
    }
    ready_below(row0 + (t + 1) * stride + K);
  }
};

// One CTA per group of group_lanes contiguous lanes of one class plane;
// the group's hb (sum, count) rows at sum/cnt + blockIdx.x * hb * T
// (zeroed by the caller).  Threads [0, Tile) consume, [Tile, Tile + 32)
// produce.  Four CTAs an SM: at most 56 registers a thread (left to
// itself ptxas gives the base family 72, which leaves three).
template <typename W, int Fam, int Tile>
__global__ void __launch_bounds__(kHistTileMax + kProducers, 4)
hist_grouped_staged_kernel(const W* __restrict__ plane,
                           const int* __restrict__ meta,
                           float* __restrict__ sum, float* __restrict__ cnt,
                           int n, int group_lanes, int hb, int row0,
                           Params P, int mode, HistPlan plan) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ RingBars bars;
  const int C = plan.chunk, T = P.T;
  const int tid = static_cast<int>(threadIdx.x);
  W* ring = reinterpret_cast<W*>(sh);
  float* buf = reinterpret_cast<float*>(sh + plan.ring_bytes);
  const long out0 = static_cast<long>(blockIdx.x) * hb * T;
  float* acc_s = sum + out0;
  float* acc_c = cnt + out0;
  if (plan.acc_shared) {
    acc_s = buf + 2 * C * Tile;
    acc_c = acc_s + hb * T;
    for (int i = tid; i < 2 * hb * T; i += blockDim.x) acc_s[i] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], kProducers);
      mbar_init(&bars.empty[s], Tile);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the producer starts here
  const int cshift = stage_shift(plan.ring_bytes, sizeof(W), Tile);
  const int rows = row0 + (T - 1) * P.stride + P.K;
  const int nchunks = (rows + (1 << cshift) - 1) >> cshift;
  const int g0 = static_cast<int>(blockIdx.x) * group_lanes;
  if (tid >= Tile) {
    // a group of a multiple of 16 bytes keeps every tile's lanes aligned
    const bool lanes_aligned =
        (group_lanes * static_cast<long>(sizeof(W))) % 16 == 0;
    for (int f = 0, c0 = 0; f < group_lanes; f += Tile)
      c0 += stage_rows<W, Tile>(plane, n, g0 + f,
                                min(Tile, group_lanes - f), rows, cshift,
                                ring, bars, c0, lanes_aligned);
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  HistChunkSink<Tile> sink{{&bars, cshift, row0, P.stride, P.K, rows, 0, 0,
                            0},
                           buf, acc_s, acc_c, T, hb, C, tid, 0, 0, 0, 0};
  for (int f = 0; f < group_lanes; f += Tile) {
    sink.begin(f, group_lanes);
    const int j = min(tid, sink.nvalid - 1);   // past the end: walk the last
    const int lane = g0 + f + j;
    // the ring row of this pass's block row 0 follows the earlier passes'
    SmemPackedSrc<W, Tile> src{ring + j, (kStages << cshift) - 1,
                               sink.base << cshift,
                               static_cast<uint32_t>(meta[lane]),
                               static_cast<uint32_t>(meta[n + lane]), 0u};
    for (int r = 0; r < row0;) {         // the XOR prefix, a stage at a time
      const int end = min(row0, ((r >> cshift) + 1) << cshift);
      sink.ready_below(end);
      for (; r < end; ++r) src.next();
      sink.free_below(r);
    }
    sink.ready_below(row0 + P.K);        // step 0's rows
    packed_windows<Fam>(src, meta, n, lane, P, mode, sink);
    sink.end(nchunks);
  }
  if (plan.acc_shared) {
    consumer_sync(Tile);
    for (int i = tid; i < hb * T; i += Tile) {
      sum[out0 + i] = acc_s[i];
      cnt[out0 + i] = acc_c[i];
    }
  }
}

template <typename W, int Fam, int Tile>
int tile_launch(const W* plane, const int* meta, float* sum, float* cnt,
                int n, int group_lanes, int hb, int row0, const Params& P,
                int mode, const HistPlan& plan, cudaStream_t s) {
  const size_t shared = static_cast<size_t>(hist_shared_bytes(plan, hb, P.T));
  const cudaError_t rc =
      allow_shared(hist_grouped_staged_kernel<W, Fam, Tile>, shared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  hist_grouped_staged_kernel<W, Fam, Tile><<<n / group_lanes,
                                             Tile + kProducers, shared, s>>>(
      plane, meta, sum, cnt, n, group_lanes, hb, row0, P, mode, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int Fam>
int staged_launch(const W* plane, const int* meta, float* sum, float* cnt,
                  int n, int group_lanes, int hb, int row0, const Params& P,
                  int mode, const HistPlan& plan, cudaStream_t s) {
  if (plan.tile == kTile)
    return tile_launch<W, Fam, kTile>(plane, meta, sum, cnt, n, group_lanes,
                                      hb, row0, P, mode, plan, s);
  return tile_launch<W, Fam, kHistTileMax>(plane, meta, sum, cnt, n,
                                           group_lanes, hb, row0, P, mode,
                                           plan, s);
}

template <typename W>
int staged_family(const W* plane, const int* meta, float* sum, float* cnt,
                  int n, int group_lanes, int hb, int row0, const Params& P,
                  int mode, const HistPlan& plan, cudaStream_t s) {
  switch (family_of(P.op)) {
    case F_BASE:
      return staged_launch<W, F_BASE>(plane, meta, sum, cnt, n, group_lanes,
                                      hb, row0, P, mode, plan, s);
    case F_CHANGES:
      return staged_launch<W, F_CHANGES>(plane, meta, sum, cnt, n,
                                         group_lanes, hb, row0, P, mode,
                                         plan, s);
    case F_MOMENTS:
      return staged_launch<W, F_MOMENTS>(plane, meta, sum, cnt, n,
                                         group_lanes, hb, row0, P, mode,
                                         plan, s);
    case F_SORT:
      return staged_launch<W, F_SORT>(plane, meta, sum, cnt, n, group_lanes,
                                      hb, row0, P, mode, plan, s);
    case F_HOLT:
      return staged_launch<W, F_HOLT>(plane, meta, sum, cnt, n, group_lanes,
                                      hb, row0, P, mode, plan, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether a plan is one the kernel takes: a tile of 128 or 256 lanes, a
// ring of 16, 32 or 64 KB in which the step fits three stages, a chunk of
// 1 to kChunkMax steps, and shared bytes within a CTA's.
bool plan_ok(const HistPlan& p, int word, int hb, const Params& P) {
  return (p.tile == kTile || p.tile == kHistTileMax)
      && (p.ring_bytes == kRingMin || p.ring_bytes == 2 * kRingMin
          || p.ring_bytes == kRingMax)
      && step_fits(p.ring_bytes, word, P.stride, P.K, p.tile)
      && p.chunk >= 1 && p.chunk <= kChunkMax
      && hist_shared_bytes(p, hb, P.T) <= kSharedCta;
}

}  // namespace

extern "C" {

// One class plane's groups through the staged kernel at the host's plan
// (tile, ring_bytes, chunk, acc_shared): sum and cnt point at zeroed
// [G_all * hb, T] f32, this plane's first group at slot0 (a group index).
int hist_staged_launch(const void* plane, const void* meta, void* sum,
                       void* cnt, int kind, int nb, int n, int group_lanes,
                       int hb, int slot0, int row0, int T, int K, int stride,
                       int g, int op, int use_phase, int dense, int is_rate,
                       int tile, int ring_bytes, int chunk, int acc_shared,
                       FN_ARGS, void* stream) {
  (void)nb;
  if (!args_ok(op, K) || reads_ts(family_of(op)) || hb < 2
      || group_lanes < 1 || group_lanes % hb != 0 || n % group_lanes != 0
      || T < 1 || stride < 1 || row0 < 0 || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, 0, op, dense, is_rate, farg, farg2, rank_lo,
           rank_hi, w_lo, w_hi, fill};
  const HistPlan plan{tile, ring_bytes, chunk, acc_shared};
  if (!plan_ok(plan, word_bytes(kind), hb, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = use_phase ? PHASE : FREE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  const long off = static_cast<long>(slot0) * hb * T;
  float* so = static_cast<float*>(sum) + off;
  float* co = static_cast<float*>(cnt) + off;
  switch (kind) {
    case 0:
      return staged_family(static_cast<const uint8_t*>(plane), m, so, co, n,
                           group_lanes, hb, row0, P, mode, plan, s);
    case 1:
      return staged_family(static_cast<const uint16_t*>(plane), m, so, co, n,
                           group_lanes, hb, row0, P, mode, plan, s);
    default:
      return staged_family(static_cast<const uint32_t*>(plane), m, so, co, n,
                           group_lanes, hb, row0, P, mode, plan, s);
  }
}

}  // extern "C"

// Aligned-grid window kernels, their grouped forms and the M4 selection
// kernel for Hopper (sm_90a), bound with ctypes.  The M4 kernel's note
// stands above it.
//
// rate_grid_kernel replaces the TPU kernel rate_grid
// (filodb_tpu/ops/grid.py:848-898, bodies _series_kernel,
// _series_kernel_free, _series_kernel_phase).
// rate_grid_packed_kernel replaces rate_grid_packed
// (filodb_tpu/ops/grid.py:1086-1127, body _series_kernel_packed with the
// in-VMEM decode _decode_packed).  Both compute all 22 ops of the TPU
// kernels' window dispatch (_rate_block, :734-766): the nine of
// lane_windows below, and the thirteen of lane_windows_ext
// (rate_grid_ext_kernel, and the packed kernels' Fam parameter).
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
// rate_grid_packed stages its rows in shared memory (the note above
// rate_grid_packed_kernel), and so does rate_grid's staged kernel
// (series_staged.cu); rate_grid_kernel, its direct path, reads device
// memory directly, as described next.
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
// barrier a step.  hist_grid_grouped_packed takes this kernel only where
// a step fits no shared-memory ring; every other plane goes to the
// staged kernel of hist_staged.cu, which replaces it there.

#include "grid_device.cuh"

namespace {

// The direct kernels take B1's member axis as the staged one does
// (member_offsets, grid_device.cuh): blockIdx.y is the member of a
// co-arrival batch, none for a solo launch.
__global__ void rate_grid_kernel(const float* __restrict__ vals,
                                 const int* __restrict__ ts,
                                 const int* __restrict__ phase,
                                 float* __restrict__ out,
                                 const int* __restrict__ row0s,
                                 const int* __restrict__ steps0s, int ns,
                                 Params P, int mode) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= ns) return;
  const MemberOffsets mo = member_offsets(row0s, steps0s, ns, P);
  vals += mo.rows;
  if (ts) ts += mo.rows;
  out += mo.out;
  DenseSrc src{vals + lane, ns};
  const float ph = (mode == PHASE) ? static_cast<float>(phase[lane]) : 0.f;
  StoreSink sink{out + lane, ns};
  lane_windows(src, ts ? ts + lane : nullptr, ns, ph, mode, P, sink);
}

template <int Fam>
__global__ void rate_grid_ext_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ ts,
                                     float* __restrict__ out,
                                     const int* __restrict__ row0s,
                                     const int* __restrict__ steps0s,
                                     int ns, Params P) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= ns) return;
  const MemberOffsets mo = member_offsets(row0s, steps0s, ns, P);
  vals += mo.rows;
  if (ts) ts += mo.rows;
  out += mo.out;
  DenseSrc src{vals + lane, ns};
  StoreSink sink{out + lane, ns};
  lane_windows_ext<Fam>(src, ts ? ts + lane : nullptr, ns, P, sink);
}

// B3 on Hopper: rate_grid_packed_kernel replaces the TPU kernel
// rate_grid_packed (filodb_tpu/ops/grid.py:1086-1127, body
// _series_kernel_packed with the in-VMEM decode _decode_packed), and
// serves all 22 ops of that kernel that read no ts plane, through
// lane_windows and lane_windows_ext.
//
// What bounds it: bytes.  It must read rows [0, row0 + R) of each class
// plane (the XOR prefix starts at block row 0), 1- to 4-byte words, the
// meta rows, and write the [T, n] f32 output: at the main path's Q1
// (102,400 lanes, T = 60, K = 5) about 41.6 MB, 0.0124 ms at 3.35 TB/s,
// of which the output is 24.6 MB.
//
// Design.  The TPU kernel stages a lane tile's whole [nb, lt] block in
// VMEM before it decodes.  A thread that reads its own lane's words from
// device memory instead (one thread a lane, the design before this one)
// has one 1- to 4-byte load in flight at a time and waits a memory
// latency a row: a warp's load is 32 to 128 bytes, far too few in flight
// for 3.35 TB/s.  Here a CTA owns a tile of kTile = 128 lanes of one class
// plane: four consumer warps, one thread a lane, and one producer warp.
// The producer streams rows [0, row0 + R) of the tile into a ring of
// kStages stages in shared memory, by 16-byte cp.async (plain loads where
// a row slice is not 16-byte aligned), each stage's arrival signalled on
// an mbarrier, so up to three stages are in flight while the consumers
// decode the fourth.  Each consumer reads its column of the ring through
// SmemPackedSrc, the row source lane_windows and lane_windows_ext already
// take, so every op's arithmetic is the code it was and its answers keep
// their bits; the XOR prefix rows [0, row0) pass through the same source
// once.  Every lane walks the same rows in the same order, so step t of
// every lane reads only rows [row0 + (t - 1) * stride, row0 + t * stride
// + K): at the end of a step the sink frees the stages behind it (an
// arrival on each one's "empty" mbarrier) and waits for the next step's
// stages, so the window loops themselves hold no barrier; the producer
// refills a stage once all 128 consumers have freed it.
//
// The ring has the same bytes for every plane of a launch, the least of
// 16, 32 and 64 KB in which every plane's step fits: a stage holds
// ring / (4 * 128 * word) rows, and a step's stride + K rows must fit in
// three stages.  At Q1 (stride + K = 6) that is 16 KB a CTA whatever the
// word, so shared memory does not bound the CTAs an SM holds.  A
// CTA whose plane's step fits no ring (the K-free dense ops go up to
// K = 1,024) reads device memory directly, one thread a lane, as before.
// One launch serves every class plane of a pack: a table gives each
// plane's words, meta, width, output column and word kind, and each CTA
// finds its plane from blockIdx.x, so only the decode depends on the word
// type.  Output stores stay coalesced: a warp writes 32 neighbouring
// floats of one [T, n] row a step.
//
// On the card (PERF.md section 6) this is no longer bound by bytes at
// Q1's width: 102,400 lanes give an SM about 24 consumer warps, each
// walking its rows serially (cursor steps, the counter correction, in the
// free ops a cursor copy that re-walks each window), so the instruction
// rate of that walk bounds it.

// One CTA's tile of one class plane.  Staged: the producer warp stages,
// each consumer thread runs its lane's windows from the ring (a thread
// past the plane's last lane walks the last lane again and stores
// nothing, so that every consumer frees every stage).  Direct (the step
// fits no ring): each consumer thread reads its lane from device memory.
template <typename W, int Fam>
__device__ void packed_tile(const W* plane, const int* meta, int n,
                            int tile, float* out, int out_ld, int row0,
                            const Params P, int mode, int ring_bytes,
                            W* ring, RingBars& bars) {
  const int lane0 = tile * kTile;
  const int nl = min(kTile, n - lane0);
  const int word = static_cast<int>(sizeof(W));
  if (!step_fits(ring_bytes, word, P.stride, P.K)) {
    const int lane = lane0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x >= kTile || lane >= n) return;
    StoreSink sink{out + lane, out_ld};
    packed_windows<Fam>(packed_lane(plane, meta, n, lane, row0), meta, n,
                        lane, P, mode, sink);
    return;
  }
  const int cshift = stage_shift(ring_bytes, word);
  const int rows = row0 + (P.T - 1) * P.stride + P.K;
  if (threadIdx.x >= kTile) {
    stage_rows(plane, n, lane0, nl, rows, cshift, ring, bars);
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  const int j = min(static_cast<int>(threadIdx.x), nl - 1);
  const int lane = lane0 + j;
  SmemPackedSrc<W> src{ring + j, (kStages << cshift) - 1, 0,
                       static_cast<uint32_t>(meta[lane]),
                       static_cast<uint32_t>(meta[n + lane]), 0u};
  RingStoreSink sink{{&bars, cshift, row0, P.stride, P.K, rows, 0, 0, 0},
                     out + lane, out_ld,
                     static_cast<int>(threadIdx.x) < nl};
  for (int r = 0; r < row0;) {           // the XOR prefix, a stage at a time
    const int end = min(row0, ((r >> cshift) + 1) << cshift);
    sink.ready_below(end);
    for (; r < end; ++r) src.next();
    sink.free_below(r);
  }
  sink.ready_below(row0 + P.K);          // step 0's rows
  packed_windows<Fam>(src, meta, n, lane, P, mode, sink);
}

// The class planes of one pack, in packed order; plane p's tiles are CTAs
// [cta0[p], cta0[p + 1]).  kind: 0 uint8, 1 uint16, 2 uint32, 3 raw f32
// read as its uint32 bits.
struct PlaneTable {
  const void* plane[kMaxPlanes];
  const int* meta[kMaxPlanes];
  int n[kMaxPlanes], col[kMaxPlanes], kind[kMaxPlanes];
  int cta0[kMaxPlanes + 1];
  int count;
};

template <int Fam>
__global__ void __launch_bounds__(kTile + kProducers)
rate_grid_packed_kernel(const PlaneTable tab, float* __restrict__ out,
                        int out_ld, int row0, Params P, int mode,
                        int ring_bytes) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ RingBars bars;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars.full[s], kProducers);
      mbar_init(&bars.empty[s], kTile);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int p = 0;
  while (p + 1 < tab.count && static_cast<int>(blockIdx.x) >= tab.cta0[p + 1])
    ++p;
  const int tile = static_cast<int>(blockIdx.x) - tab.cta0[p];
  float* o = out + tab.col[p];
  switch (tab.kind[p]) {
    case 0:
      packed_tile<uint8_t, Fam>(static_cast<const uint8_t*>(tab.plane[p]),
                                tab.meta[p], tab.n[p], tile, o, out_ld, row0,
                                P, mode, ring_bytes,
                                reinterpret_cast<uint8_t*>(ring), bars);
      break;
    case 1:
      packed_tile<uint16_t, Fam>(static_cast<const uint16_t*>(tab.plane[p]),
                                 tab.meta[p], tab.n[p], tile, o, out_ld,
                                 row0, P, mode, ring_bytes,
                                 reinterpret_cast<uint16_t*>(ring), bars);
      break;
    default:
      packed_tile<uint32_t, Fam>(static_cast<const uint32_t*>(tab.plane[p]),
                                 tab.meta[p], tab.n[p], tile, o, out_ld,
                                 row0, P, mode, ring_bytes,
                                 reinterpret_cast<uint32_t*>(ring), bars);
  }
}

// The ring for a launch: the least of 16, 32 and 64 KB in which every
// plane's step fits, or none when no plane's step fits even in 64 KB.
int ring_bytes_for(const PlaneTable& tab, const Params& P) {
  int need = 0;
  for (int i = 0; i < tab.count; ++i) {
    const int w = word_bytes(tab.kind[i]);
    int b = kRingMin;
    while (b <= kRingMax && !step_fits(b, w, P.stride, P.K)) b *= 2;
    if (b <= kRingMax && b > need) need = b;
  }
  return need;
}

template <int Fam>
int packed_launch(const PlaneTable& tab, float* out, int out_ld, int row0,
                  const Params& P, int mode, cudaStream_t s) {
  const int ring_bytes = ring_bytes_for(tab, P);
  const cudaError_t rc =
      allow_shared(rate_grid_packed_kernel<Fam>, ring_bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rate_grid_packed_kernel<Fam><<<tab.cta0[tab.count], kTile + kProducers,
                                 ring_bytes, s>>>(
      tab, out, out_ld, row0, P, mode, ring_bytes);
  return static_cast<int>(cudaGetLastError());
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

// rate_grid_launch and rate_grid_batch_launch: the member arrays (none
// for a solo launch) on grid.y.
static int rate_grid_members(const void* vals, const void* ts,
                             const void* phase, void* out, const int* row0s,
                             const int* steps0s, int members, int ns, int T,
                             int K, int stride, int g, int steps0, int op,
                             int mode, int dense, int is_rate, FN_ARGS,
                             void* stream) {
  if (!args_ok(op, K) || !members_ok(row0s, steps0s, members))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, steps0, op, dense, is_rate, farg, farg2,
           rank_lo, rank_hi, w_lo, w_hi, fill};
  const dim3 grid((ns + kBlock - 1) / kBlock, members);
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
          v, t, static_cast<const int*>(phase), o, row0s, steps0s, ns, P,
          mode);
      break;
    case F_PAIR:
      rate_grid_ext_kernel<F_PAIR><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_LINREG:
      rate_grid_ext_kernel<F_LINREG><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_STAMP:
      rate_grid_ext_kernel<F_STAMP><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_CHANGES:
      rate_grid_ext_kernel<F_CHANGES><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_MOMENTS:
      rate_grid_ext_kernel<F_MOMENTS><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_SORT:
      rate_grid_ext_kernel<F_SORT><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    case F_HOLT:
      rate_grid_ext_kernel<F_HOLT><<<grid, kBlock, 0, s>>>(
          v, t, o, row0s, steps0s, ns, P);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int rate_grid_launch(const void* vals, const void* ts, const void* phase,
                     void* out, int nb, int ns, int T, int K, int stride,
                     int g, int steps0, int op, int mode, int dense,
                     int is_rate, FN_ARGS, void* stream) {
  (void)nb;
  return rate_grid_members(vals, ts, phase, out, nullptr, nullptr, 1, ns, T,
                           K, stride, g, steps0, op, mode, dense, is_rate,
                           farg, farg2, rank_lo, rank_hi, w_lo, w_hi, fill,
                           stream);
}

// A co-arrival batch of `members` queries over ONE plane through the
// direct kernel in one launch: member m's windows start at plane row
// row0s[m] and end first at steps0s[m] (int32 arrays on the device), its
// answer rows [m*T, (m+1)*T) of out [members*T, ns].  The other arguments
// are rate_grid_launch's, less nb and steps0 (the host checks that each
// member's rows lie inside the plane).
int rate_grid_batch_launch(const void* vals, const void* ts,
                           const void* phase, void* out, const void* row0s,
                           const void* steps0s, int members, int ns, int T,
                           int K, int stride, int g, int op, int mode,
                           int dense, int is_rate, FN_ARGS, void* stream) {
  if (row0s == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return rate_grid_members(vals, ts, phase, out,
                           static_cast<const int*>(row0s),
                           static_cast<const int*>(steps0s), members, ns, T,
                           K, stride, g, 0, op, mode, dense, is_rate, farg,
                           farg2, rank_lo, rank_hi, w_lo, w_hi, fill,
                           stream);
}

// Every class plane of a pack in one launch: nplanes (1 to 4) planes in
// packed order, plane i's words at planes[i] (kinds[i]: 0 uint8, 1
// uint16, 2 uint32, 3 raw f32 bits), its [8, widths[i]] int32 meta at
// metas[i], its output columns [cols[i], cols[i] + widths[i]) of the
// [T, out_ld] f32 out.
int rate_grid_packed_launch(const void* const* planes,
                            const void* const* metas, const int* widths,
                            const int* cols, const int* kinds, int nplanes,
                            void* out, int out_ld, int row0, int T, int K,
                            int stride, int g, int op, int use_phase,
                            int dense, int is_rate, FN_ARGS, void* stream) {
  if (!args_ok(op, K) || reads_ts(family_of(op)) || nplanes < 1
      || nplanes > kMaxPlanes || T < 1 || stride < 1 || row0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{T, K, stride, g, 0, op, dense, is_rate, farg, farg2, rank_lo,
           rank_hi, w_lo, w_hi, fill};
  PlaneTable tab{};
  int ctas = 0;
  for (int i = 0; i < nplanes; ++i) {
    if (kinds[i] < 0 || kinds[i] > 3 || widths[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    tab.plane[i] = planes[i];
    tab.meta[i] = static_cast<const int*>(metas[i]);
    tab.n[i] = widths[i];
    tab.col[i] = cols[i];
    tab.kind[i] = kinds[i];
    tab.cta0[i] = ctas;
    ctas += (widths[i] + kTile - 1) / kTile;
  }
  tab.cta0[nplanes] = ctas;
  tab.count = nplanes;
  const int mode = use_phase ? PHASE : FREE;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family_of(op)) {
    case F_BASE:
      return packed_launch<F_BASE>(tab, o, out_ld, row0, P, mode, s);
    case F_CHANGES:
      return packed_launch<F_CHANGES>(tab, o, out_ld, row0, P, mode, s);
    case F_MOMENTS:
      return packed_launch<F_MOMENTS>(tab, o, out_ld, row0, P, mode, s);
    case F_SORT:
      return packed_launch<F_SORT>(tab, o, out_ld, row0, P, mode, s);
    case F_HOLT:
      return packed_launch<F_HOLT>(tab, o, out_ld, row0, P, mode, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

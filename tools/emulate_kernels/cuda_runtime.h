// CPU emulation of the CUDA names the grid kernels use: every CUDA thread
// a std::thread, CTAs one at a time.  build.py compiles rewritten copies
// of filodb_tpu_torch/csrc/ against this header with g++ (README.md).
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim;
inline dim3 gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline void __trap() { fprintf(stderr, "emu: trap\n"); abort(); }

alignas(16) inline unsigned char emu_dyn[256 * 1024];

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, gen = 0;
  void wait(int n) {
    std::unique_lock<std::mutex> l(m);
    int g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); return; }
    if (!cv.wait_for(l, std::chrono::seconds(20), [&] { return gen != g; })) {
      fprintf(stderr, "emu: barrier of %d stuck at %d\n", n, count); abort();
    }
  }
};
inline EmuBarrier emu_bar0, emu_bar1;
inline void __syncthreads() { emu_bar0.wait(blockDim.x); }
inline void emu_named_sync(int n) { emu_bar1.wait(n); }

// __shfl_down_sync over a full warp: each thread posts its value in its
// slot, the warp meets, reads lane + off's slot (its own past the warp's
// end), and meets again before any slot is written anew.
inline float emu_shfl_slot[1024];
inline EmuBarrier emu_warp_bar[32];
inline float __shfl_down_sync(unsigned, float v, int off) {
  const int t = static_cast<int>(threadIdx.x);
  emu_shfl_slot[t] = v;
  emu_warp_bar[t >> 5].wait(32);
  const float r = (t & 31) + off < 32 ? emu_shfl_slot[t + off] : v;
  emu_warp_bar[t >> 5].wait(32);
  return r;
}

// __ballot_sync over a full warp, the same way.
inline unsigned emu_vote_slot[1024];
inline unsigned __ballot_sync(unsigned, int pred) {
  const int t = static_cast<int>(threadIdx.x);
  emu_vote_slot[t] = pred ? 1u : 0u;
  emu_warp_bar[t >> 5].wait(32);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= emu_vote_slot[(t & ~31) + l] << l;
  emu_warp_bar[t >> 5].wait(32);
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

struct EmuMbar { int expected = 0, pending = 0, phase = 0; };
inline std::mutex emu_mb_m;
inline std::condition_variable emu_mb_cv;
inline std::unordered_map<const void*, EmuMbar> emu_mb;
inline void emu_mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> l(emu_mb_m);
  emu_mb[bar] = EmuMbar{static_cast<int>(count), static_cast<int>(count), 0};
}
inline void emu_mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(emu_mb_m);
  EmuMbar& b = emu_mb.at(bar);
  if (--b.pending == 0) { b.phase ^= 1; b.pending = b.expected; emu_mb_cv.notify_all(); }
  if (b.pending < 0) { fprintf(stderr, "emu: over-arrival\n"); abort(); }
}
inline void emu_mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> l(emu_mb_m);
  if (!emu_mb_cv.wait_for(l, std::chrono::seconds(20), [&] {
        return emu_mb.at(bar).phase != static_cast<int>(parity); })) {
    fprintf(stderr, "emu: mbarrier wait never ends (trap)\n"); abort();
  }
}

template <class F>
void emu_launch(dim3 g, dim3 b, F f) {
  gridDim = g;
  for (unsigned by = 0; by < g.y; ++by)
    for (unsigned bx = 0; bx < g.x; ++bx) {
      std::vector<std::thread> th;
      th.reserve(b.x);
      for (unsigned t = 0; t < b.x; ++t)
        th.emplace_back([&, bx, by, t] {
          threadIdx = dim3(t); blockIdx = dim3(bx, by); blockDim = b; f();
        });
      for (auto& x : th) x.join();
    }
}

// A CPU stand-in for the parts of the CUDA runtime and of cooperative
// groups that the sources in ops/csrc/ use, so that g++ can build the
// kernels and tests/test_torch_cuda_emulation.py and
// tests/test_torch_int8_emulation.py can run them: every CUDA thread is an
// OS thread, __syncthreads and cluster.sync are std::barriers, a block's
// dynamic shared memory is a heap buffer (poisoned with NaN),
// map_shared_rank maps an address into another block's buffer, a cluster
// launch runs its clusters one after another, and atomicMax is a
// compare-and-swap loop. The lanes of a warp exchange values through
// per-warp slots and a per-warp barrier (emu_warp_share), on which
// __reduce_max_sync and int8_mma.cuh's product are built. The test
// rewrites `extern __shared__ float4 smem[];` into `float4* smem =
// emu_smem();` and a `<<<grid, threads, smem, stream>>>` launch into
// `emu_launch(grid, threads, smem, kernel, ...)`.
// cp_async.cuh and int8_mma.cuh beside this file stand in for the ones
// in ops/csrc/.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <memory>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) int2 { int x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
template <class T> T __ldg(const T* p) { return *p; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline int2 make_int2(int x, int y) { return {x, y}; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
// round to nearest, ties to even (the default rounding mode)
inline int __float2int_rn(float x) { return static_cast<int>(std::nearbyint(x)); }
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) { float x; std::memcpy(&x, &u, 4); return x; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
template <class T> T max(T a, T b) { return a < b ? b : a; }
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
template <class F> cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
template <class F> cudaError_t cudaOccupancyMaxActiveClusters(int* out, F*, const cudaLaunchConfig_t* cfg) {
  *out = 132 / cfg->attrs[0].val.clusterDim.x;
  return cudaSuccess;
}

// One warp's exchange: each lane's slot of up to 8 words, double-buffered
// (a lane writes slot buffer p again only after every lane passed the
// barrier of the exchange in between, i.e. finished reading buffer p).
struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t slot[2][32][8];
};

struct EmuCluster {
  std::unique_ptr<std::barrier<>> cbar;
  std::vector<std::unique_ptr<std::barrier<>>> bbar;
  std::vector<std::vector<float4>> smem;
  std::vector<std::unique_ptr<EmuWarp>> warps;  // [rank][warp]
  unsigned warps_per_block = 0;
  void add_block(unsigned nt, size_t smem_bytes);
};
inline thread_local EmuCluster* emu_cluster = nullptr;
inline thread_local unsigned emu_rank = 0;
inline thread_local unsigned emu_warp_phase = 0;
inline void __syncthreads() { emu_cluster->bbar[emu_rank]->arrive_and_wait(); }
inline float4* emu_smem() { return emu_cluster->smem[emu_rank].data(); }

// Put this lane's n words in its slot, wait for the warp, and return the
// warp's slots [32][8]; valid until the lane's next exchange but one.
inline const uint32_t (*emu_warp_share(const uint32_t* v, int n))[8] {
  EmuWarp& w = *emu_cluster->warps[emu_rank * emu_cluster->warps_per_block
                                    + threadIdx.x / 32];
  auto& buf = w.slot[emu_warp_phase];
  emu_warp_phase ^= 1;
  std::memcpy(buf[threadIdx.x % 32], v, 4 * n);
  w.bar.arrive_and_wait();
  return buf;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const uint32_t (*all)[8] = emu_warp_share(&v, 1);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m = all[l][0] > m ? all[l][0] : m;
  return m;
}

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_rank; }
  void sync() const { emu_cluster->cbar->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* addr, unsigned rank) const {
    char* base = reinterpret_cast<char*>(emu_cluster->smem[emu_rank].data());
    char* other = reinterpret_cast<char*>(emu_cluster->smem.at(rank).data());
    std::ptrdiff_t off = reinterpret_cast<char*>(addr) - base;
    if (off < 0 || static_cast<size_t>(off) >= emu_cluster->smem[rank].size() * 16) std::abort();
    return reinterpret_cast<T*>(other + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// Dynamic shared memory of one block, poisoned with NaN so that reads of
// unwritten words show.
inline std::vector<float4> emu_block_smem(size_t bytes) {
  std::vector<float4> s(bytes / 16 + 1);
  std::memset(s.data(), 0xff, s.size() * 16);
  return s;
}

// one block of nt threads: its barrier, its shared memory, its warps
inline void EmuCluster::add_block(unsigned nt, size_t smem_bytes) {
  bbar.push_back(std::make_unique<std::barrier<>>(nt));
  smem.push_back(emu_block_smem(smem_bytes));
  warps_per_block = (nt + 31) / 32;
  for (unsigned w = 0; w < warps_per_block; ++w)
    warps.push_back(std::make_unique<EmuWarp>());
}

template <class F, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, F* kernel, Args&&... args) {
  const unsigned n = cfg->attrs[0].val.clusterDim.x;
  const unsigned nt = cfg->blockDim.x;
  if (cfg->gridDim.x % n) return cudaErrorInvalidValue;
  for (unsigned y = 0; y < cfg->gridDim.y; ++y)
    for (unsigned cl = 0; cl < cfg->gridDim.x / n; ++cl) {
      EmuCluster c;
      c.cbar = std::make_unique<std::barrier<>>(n * nt);
      for (unsigned r = 0; r < n; ++r) c.add_block(nt, cfg->dynamicSmemBytes);
      std::vector<std::thread> th;
      for (unsigned r = 0; r < n; ++r)
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([&, r, t] {
            emu_cluster = &c; emu_rank = r;
            threadIdx = dim3(t); blockIdx = dim3(cl * n + r, y);
            gridDim = cfg->gridDim;
            kernel(args...);
          });
      for (auto& x : th) x.join();
    }
  return cudaSuccess;
}

// a plain <<<grid, threads, smem>>> launch: blocks one after another
template <class F, class... Args>
void emu_launch(dim3 grid, unsigned nt, size_t smem, F* kernel, Args... args) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        EmuCluster c;
        c.add_block(nt, smem);
        std::vector<std::thread> th;
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([&, t] {
            emu_cluster = &c; emu_rank = 0;
            threadIdx = dim3(t); blockIdx = dim3(x, y, z); gridDim = grid;
            kernel(args...);
          });
        for (auto& q : th) q.join();
      }
}

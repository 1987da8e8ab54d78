// What the thread-block-cluster LSTM scans for Hopper (sm_90a) share:
// lstm_scan.cu and multicell_scan.cu (through scan_body.cuh),
// lstm_scan_int8.cu and lstm_train.cu. A cluster of n = H / 32 CTAs of
// kThreads threads owns a tile of batch rows; CTA c owns the hidden units
// [32c, 32c + 32) and their 128 gate columns g*H + 32c + u, and holds its
// part of w_hh (the float slice w_hh[:, those columns] in shared memory,
// or the int8 columns in registers) for all T steps. Each source's design
// note says how its kernels use it. Tensors in global memory are float32
// or, for the bf16-I/O instantiations of the float and the int8 bodies
// and of the training kernels, bfloat16: every value read is widened to
// float32 (`to_f32`, exact), everything held in shared memory and
// registers is float32, and every value written is rounded to the I/O
// type (`from_f32`, nearest even).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;      // 16 warps per CTA
constexpr int kUnits = 32;         // hidden units per CTA
constexpr int kCols = 4 * kUnits;  // gate columns per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v stored as IO: float32 as it is, bf16 rounded to nearest even
template <class IO>
__device__ __forceinline__ IO from_f32(float v) {
  if constexpr (std::is_same_v<IO, float>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// v as IO holds it, widened back to float32
template <class IO>
__device__ __forceinline__ float round_io(float v) {
  return to_f32(from_f32<IO>(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// m*a + (1-m)*b rounded as written (no fused multiply-add), as the TPU
// kernel and the plain version compute it.
__device__ __forceinline__ float blend(float m, float a, float b) {
  return __fadd_rn(__fmul_rn(m, a), __fmul_rn(__fsub_rn(1.0f, m), b));
}

// Offset of (k, col) in a CTA's slice [H][kCols]: float4 groups swizzled
// by k % 8, so that a warp reading one k across 32 columns and a warp
// reading one float4 of columns across 32 consecutive k both hit 32
// distinct banks.
__device__ __forceinline__ int swizzle(int k, int col) {
  return k * kCols + ((((col >> 2) ^ (k & 7)) << 2) | (col & 3));
}

// CTA `cta`'s slice of w_hh [H, 4H]: columns g*H + 32*cta + u, as float32
// (a bf16 w_hh widened once, here).
template <class W>
__device__ __forceinline__ void load_w_slice(const W* __restrict__ w_hh,
                                             float* w_s, int H, int cta) {
  const int n = H * kCols;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int k = idx / kCols, col = idx % kCols;
    w_s[swizzle(k, col)] = to_f32(__ldg(w_hh + static_cast<size_t>(k) * 4 * H
                                        + (col / kUnits) * H + cta * kUnits
                                        + col % kUnits));
  }
}

// One past the last step at which a row of the tile [b0, b0 + R) has a
// nonzero mask [T, B] (float32 or bf16); the same in every CTA that reads
// the same tile. `slot` is one int of shared memory, free until the
// function returns.
template <class M>
__device__ __forceinline__ int tile_end(const M* __restrict__ mask,
                                        int T, int B, int b0, int R,
                                        int* slot) {
  const int tid = threadIdx.x;
  if (tid == 0) *slot = 0;
  __syncthreads();
  // item idx is (step, row) = (idx / R, idx % R); from the last step
  // down, so a thread's first hit is its latest
  for (int idx = T * R - 1 - tid; idx >= 0; idx -= kThreads) {
    const int b = b0 + idx % R;
    if (b < B
        && to_f32(__ldg(mask + static_cast<size_t>(idx / R) * B + b))
               != 0.0f) {
      atomicMax(slot, idx / R + 1);
      break;
    }
  }
  __syncthreads();
  const int t_end = *slot;
  __syncthreads();  // every thread has read the slot
  return t_end;
}

// Launch `kernel` as `clusters` x `n_dir` clusters of n CTAs (grid x, grid
// y) with `smem` bytes of dynamic shared memory; returns the launch's
// error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster_grid(void (*kernel)(Params...), size_t smem,
                                int n, int clusters, int n_dir,
                                cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * clusters),
                     static_cast<unsigned>(n_dir));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch `kernel` as clusters of H / 32 CTAs over ceil(B / R) batch tiles
// (grid x) and `n_dir` directions (grid y).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), size_t smem, int B,
                            int H, int R, int n_dir, cudaStream_t stream,
                            Args... args) {
  return launch_cluster_grid(kernel, smem, H / kUnits, (B + R - 1) / R,
                             n_dir, stream, args...);
}

// Clusters of H / 32 CTAs of `kernel` with `smem` bytes each that fit on
// the card at once.
template <typename... Params>
cudaError_t max_clusters(void (*kernel)(Params...), size_t smem, int H,
                         int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned n = static_cast<unsigned>(H / kUnits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace

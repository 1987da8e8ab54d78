// optax's Adam / AdamW step on bf16 params, in place, for every tensor of
// one optimizer step in one launch (`ops/optax_adam_cuda.py`,
// `train/trainer.py` `OptaxAdam`).
//
// What it replaces: no Pallas kernel. In the JAX package the update is
// optax's `adam` / `adamw` (`scale_by_adam`, `add_decayed_weights`,
// `scale_by_learning_rate`, `apply_updates`; `mobileposer_tpu/train/
// trainer.py`), which XLA fuses inside the jitted train step. The port's
// plain version issues 17 torch ops a tensor (19 with the weight decay):
// 72 bf16 tensors make ~1,270 launches a step, each of a few microseconds
// of work, and the card idles while the host issues them.
//
// What bounds it: bytes. Each element reads p, g, mu and nu and writes p,
// mu and nu, 14 bytes in bf16, against ~20 float32 operations: the four
// modules' 6,674,994 elements are 93.4 MB, 0.028 ms at 3.35 TB/s.
//
// Design: one launch per module step. The tensors' four pointers, sizes
// and first chunks travel in one by-value struct in the kernel's parameter
// space (`__grid_constant__`, read in place), so nothing is allocated or
// copied to the card, and the grads' pointers may change every step. Each
// tensor is cut into chunks of CHUNK elements; blocks stride over the
// chunks of all tensors, and each thread takes 8 elements with one 16-byte
// load per array where all four of its tensor's pointers are 16-byte
// aligned (element by element otherwise, and at a tensor's ragged end).
// The launch takes at most `max_blocks` blocks (a few a multiprocessor).
//
// Roundings: the kernel gives the plain version's bits. Each operation of
// the chain widens its bf16 operands to float32, computes, and rounds the
// result to bf16 before the next operation, as torch's bf16 elementwise
// ops do and as JAX rounds each op of optax's update to the params' dtype:
//   mu = c1*g + d1*mu;  nu = c2*(g*g) + d2*nu;
//   u = (mu/bc1) / (sqrt(nu/bc2) + eps);  u = u + wd*p (AdamW);
//   p = p + neg_lr*u.
// The constants arrive rounded to bf16 (1 - b1, b1, 1 - b2, b2, the two
// bias corrections, eps, wd, -lr), as the plain version rounds them. The
// float32 operations are the `_rn` intrinsics: IEEE round to nearest
// whatever the compiler flags, and never contracted into an FMA (every
// product is also rounded to bf16 before it meets an add).
//
// Entry (plain C; returns cudaGetLastError()):
//   optax_adam_bf16(p, g, mu, nu, sizes, count, consts, decay, max_blocks,
//                   stream)
// p, g, mu, nu: host arrays of `count` device pointers (bf16, contiguous);
// sizes: host array of their element counts; consts: host array of the 9
// constants' bf16 bits in the order above; decay: 1 for AdamW's term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_TENSORS = 32;   // a launch's tensors (the wrapper splits)
constexpr int THREADS = 256;
constexpr int VEC = 8;            // bf16 elements in 16 bytes
constexpr int CHUNK = THREADS * VEC;

struct AdamArgs {
  unsigned short* p[MAX_TENSORS];  // bf16 tensors, as their bits
  const unsigned short* g[MAX_TENSORS];
  unsigned short* mu[MAX_TENSORS];
  unsigned short* nu[MAX_TENSORS];
  int size[MAX_TENSORS];
  int first[MAX_TENSORS + 1];     // each tensor's first chunk; [count] all
  int vec[MAX_TENSORS];           // 1: all four pointers 16-byte aligned
  int count;
  int decay;
  float c1, d1, c2, d2, bc1, bc2, eps, wd, neg_lr;  // bf16 values, widened
};

// a bf16 value widened to float32 (exact), and a float32 rounded to bf16
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ unsigned short narrow(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mul(float a, float b) {
  return widen(narrow(__fmul_rn(a, b)));
}

__device__ __forceinline__ float add(float a, float b) {
  return widen(narrow(__fadd_rn(a, b)));
}

__device__ __forceinline__ float div(float a, float b) {
  return widen(narrow(__fdiv_rn(a, b)));
}

// One element's step on its bf16 bits, in place.
__device__ __forceinline__ void adam_element(const AdamArgs& a,
                                             unsigned short g_bits,
                                             unsigned short& p_bits,
                                             unsigned short& mu_bits,
                                             unsigned short& nu_bits) {
  const float g = widen(g_bits), p = widen(p_bits);
  const float mu = add(mul(a.c1, g), mul(a.d1, widen(mu_bits)));
  const float nu = add(mul(a.c2, mul(g, g)), mul(a.d2, widen(nu_bits)));
  const float root = widen(narrow(__fsqrt_rn(div(nu, a.bc2))));
  float u = div(div(mu, a.bc1), add(root, a.eps));
  if (a.decay) u = add(u, mul(a.wd, p));
  p_bits = narrow(add(p, mul(a.neg_lr, u)));
  mu_bits = narrow(mu);
  nu_bits = narrow(nu);
}

union Pack {
  uint4 v;
  unsigned short h[VEC];
};

__global__ void __launch_bounds__(THREADS)
optax_adam_kernel(const __grid_constant__ AdamArgs a) {
  for (int c = blockIdx.x; c < a.first[a.count]; c += gridDim.x) {
    int t = 0;
    while (c >= a.first[t + 1]) ++t;
    const int n = a.size[t];
    const int i0 = (c - a.first[t]) * CHUNK + threadIdx.x * VEC;
    if (a.vec[t] && i0 + VEC <= n) {
      Pack p, g, mu, nu;
      p.v = *reinterpret_cast<const uint4*>(a.p[t] + i0);
      g.v = *reinterpret_cast<const uint4*>(a.g[t] + i0);
      mu.v = *reinterpret_cast<const uint4*>(a.mu[t] + i0);
      nu.v = *reinterpret_cast<const uint4*>(a.nu[t] + i0);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        adam_element(a, g.h[k], p.h[k], mu.h[k], nu.h[k]);
      *reinterpret_cast<uint4*>(a.p[t] + i0) = p.v;
      *reinterpret_cast<uint4*>(a.mu[t] + i0) = mu.v;
      *reinterpret_cast<uint4*>(a.nu[t] + i0) = nu.v;
    } else {
      for (int i = i0; i < i0 + VEC && i < n; ++i)
        adam_element(a, a.g[t][i], a.p[t][i], a.mu[t][i], a.nu[t][i]);
    }
  }
}

// a bf16 value's bits widened to float32 (exact)
float widen_bits(unsigned short bits) {
  const uint32_t u = static_cast<uint32_t>(bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

}  // namespace

extern "C" int optax_adam_bf16(void* const* p, void* const* g,
                               void* const* mu, void* const* nu,
                               const long long* sizes, int count,
                               const unsigned short* consts, int decay,
                               int max_blocks, cudaStream_t stream) {
  if (count < 1 || count > MAX_TENSORS || max_blocks < 1)
    return cudaErrorInvalidValue;
  AdamArgs a;
  a.count = count;
  a.decay = decay;
  a.first[0] = 0;
  for (int t = 0; t < count; ++t) {
    if (sizes[t] < 1 || sizes[t] > (1LL << 30)) return cudaErrorInvalidValue;
    a.p[t] = static_cast<unsigned short*>(p[t]);
    a.g[t] = static_cast<const unsigned short*>(g[t]);
    a.mu[t] = static_cast<unsigned short*>(mu[t]);
    a.nu[t] = static_cast<unsigned short*>(nu[t]);
    a.size[t] = static_cast<int>(sizes[t]);
    a.first[t + 1] = a.first[t] + static_cast<int>((sizes[t] + CHUNK - 1) / CHUNK);
    const uintptr_t any = reinterpret_cast<uintptr_t>(p[t])
        | reinterpret_cast<uintptr_t>(g[t]) | reinterpret_cast<uintptr_t>(mu[t])
        | reinterpret_cast<uintptr_t>(nu[t]);
    a.vec[t] = (any % 16) == 0;
  }
  float* k[] = {&a.c1, &a.d1, &a.c2, &a.d2, &a.bc1, &a.bc2, &a.eps, &a.wd,
                &a.neg_lr};
  for (int i = 0; i < 9; ++i) *k[i] = widen_bits(consts[i]);
  const int chunks = a.first[count];
  const int blocks = chunks < max_blocks ? chunks : max_blocks;
  optax_adam_kernel<<<blocks, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* optax_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

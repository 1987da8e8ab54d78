// W8A8 int8 LSTM layer scans for Hopper (sm_90a): float32 activations and
// carry, int8 recurrent weights with a per-column scale, the hidden state
// re-quantized per row at every step.
//
// Replaces three TPU kernels of mobileposer_tpu/ops/lstm_pallas.py:
//   lstm_scan_int8           <- lstm_layer_pallas_int8 (_lstm_step_kernel_int8):
//                               one unidirectional full-length layer (the
//                               velocity module);
//   bilstm_scan_int8         <- bilstm_layer_pallas_int8
//                               (_bilstm_step_kernel_int8): both directions
//                               of a bidirectional layer in one launch,
//                               blockIdx.y selecting the direction;
//   lstm_scan_masked_int8    <- lstm_layer_masked_pallas_int8
//   bilstm_scan_masked_int8     (_masked_step_kernel_int8): one direction,
//                               or both directions sharing one [T, B] mask
//                               (the backward input is reversed per
//                               length), of a ragged batch.
// Contract (the float kernels' of lstm_scan.cu, with the recurrent term of
// mobileposer_tpu/ops/quant.py int8_recurrent_gates): x_proj [T, B, 4H]
// already holds the int8 input projection plus b; w_hh comes as int32
// words [H/4, 4H], word (k4, col) holding the int8 w_hh[4k4 .. 4k4+3, col]
// in bytes 0..3 (ops/quant.py pack_w_hh); w_scale [4H]; gate order
// (i, f, g, o); the carry stays float32. Per step and row, with h the
// previous hidden state:
//   scale = max(max_j |h_j| * f32(1/127), 1e-12)
//   q_j   = clamp(round_half_even(h_j / scale), -127, 127)
//   gate  = x_proj + f32(sum_k q_k * w[k, col]) * (scale * w_scale[col])
// which is what the plain version computes, in the same order and with
// the same roundings: the int32 sum is exact, and every product and sum,
// the cell update's too, is written with __fmul_rn/__fadd_rn so nvcc
// cannot contract them into an FMA. The nonlinearities are expf and tanhf
// as in torch's CUDA sigmoid and tanh, so on the card the kernel can agree
// with the plain version to the bit, and no h/scale lands on the other
// side of a rounding boundary. XLA turns the JAX package's `amax / 127`
// into a multiply by the float32 reciprocal; the kernel does the same.
// Masked entries blend as the masked float kernel does (exact zeros at
// masked steps).
//
// Design. As lstm_scan.cu: a block owns kRows batch rows for all T steps,
// thread j owns hidden unit j and its four gate columns j, H+j, 2H+j,
// 3H+j, so the cell update needs no exchange. h and c stay in registers
// (thread j alone reads its h); the block shares only the quantized h
// (int8, kRows x H bytes of shared memory) and the per-warp row maxima.
// A step: (1) each warp reduces |h| per row with shuffles, lane 0 writes
// its maxima; barrier; (2) every thread folds the <= 8 warp maxima of each
// row (max is exact in any order), computes the scale and quantizes its
// own h_j; barrier; (3) acc[r][g] += __dp4a(h_q word, w word), one 32-bit
// w load per four k, coalesced across j; (4) dequantize, cell update,
// blend. Two barriers a step suffice: the next step's row maxima are
// written after every thread passed barrier (2), and the next h_q after
// every thread passed the next barrier (1), i.e. after this step's (3).
// An all-zero row (every row at t = 0 with zero h0, and padding rows)
// gets scale 1e-12 and q = 0, so no NaN.
//
// What bounds it on this card (worked out from the shapes, not measured):
// per step and direction 2*B*H*4H integer operations against 1,979 TOP/s
// of int8 tensor cores, and the bytes of x_proj/ys (f32), w_hh (int8),
// the state and the mask against 3.35 TB/s. Streaming (T = 45, B = 256,
// H = 256, both directions): ~12.1 G int8 ops (6 us) against ~118 MB of
// x_proj, ys and state (35 us), so bytes bound it. This first version
// multiplies with __dp4a on the CUDA cores, not the tensor cores, and,
// like the float kernels, it is
// per-step latency bound: every block re-reads w_hh (256 KiB at H = 256,
// a quarter of the float kernels' 1 MiB; still too large for 227 KB of
// shared memory) from L2 every step, and only ceil(B/kRows) blocks per
// direction are in flight. int8 mma.sync/wgmma, a cluster-split w_hh and
// TMA loads of x_proj are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;         // batch rows per block
constexpr int kMaxHidden = 256;  // one thread per hidden unit
constexpr int kWarps = kMaxHidden / 32;
constexpr float kInvQmax = 1.0f / 127.0f;  // the float32 reciprocal

struct Dir {
  const float* x_proj;   // [T, B, 4H]
  const int* w_hh;       // [H/4, 4H] k-packed int8 words
  const float* w_scale;  // [4H]
  const float* h0;       // [B, H]
  const float* c0;       // [B, H]
  float* ys;             // [T, B, H]
  float* h_t;            // [B, H]
  float* c_t;            // [B, H]
};

// torch's CUDA sigmoid, 1 / (1 + exp(-x)) in float32, with each operation
// rounded on its own
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// m*a + (1-m)*b rounded as written (no fused multiply-add), as the TPU
// kernel and the plain version compute it.
__device__ __forceinline__ float blend(float m, float a, float b) {
  return __fadd_rn(__fmul_rn(m, a), __fmul_rn(__fsub_rn(1.0f, m), b));
}

template <bool kMasked>
__device__ __forceinline__ void scan_int8(const Dir& d, const float* mask,
                                          int T, int B, int H) {
  // quantized h_{t-1}, [kRows][H] int8, as int32 words for the dp4a reads
  __shared__ int hq_s[kRows * kMaxHidden / 4];
  __shared__ float amax_s[kWarps][kRows];  // per-warp row maxima of |h|
  int8_t* hq_b = reinterpret_cast<int8_t*>(hq_s);
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = H >> 5;
  const int K4 = H >> 2;
  const int b0 = blockIdx.x * kRows;
  const size_t H4 = 4 * static_cast<size_t>(H);

  float h[kRows], c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    const bool ok = b < B;
    h[r] = ok ? d.h0[static_cast<size_t>(b) * H + j] : 0.0f;
    c[r] = ok ? d.c0[static_cast<size_t>(b) * H + j] : 0.0f;
  }
  float ws[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) ws[g] = d.w_scale[g * H + j];

  for (int t = 0; t < T; ++t) {
    // (1) per-row max |h| within the warp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = fabsf(h[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) amax_s[warp][r] = m;
    }
    __syncthreads();

    // (2) row scales, and this thread's h_j quantized
    float hs[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float amax = amax_s[0][r];
      for (int w = 1; w < n_warps; ++w) amax = fmaxf(amax, amax_s[w][r]);
      hs[r] = fmaxf(__fmul_rn(amax, kInvQmax), 1e-12f);
      const int q = __float2int_rn(__fdiv_rn(h[r], hs[r]));  // half to even
      hq_b[r * H + j] = static_cast<int8_t>(min(max(q, -127), 127));
    }
    __syncthreads();

    // (3) acc = h_q @ w_hh, exact int32, four k per dp4a
    int acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0;
    const int* wp = d.w_hh + j;
    for (int k4 = 0; k4 < K4; ++k4) {
      int w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g] = __ldg(wp + static_cast<size_t>(k4) * H4 + g * H);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int hw = hq_s[r * K4 + k4];  // one word, broadcast
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = __dp4a(hw, w[g], acc[r][g]);
      }
    }

    // (4) dequantize in the plain version's order, cell update, blend
    const float* xt = d.x_proj + static_cast<size_t>(t) * B * H4;
    float* yt = d.ys + static_cast<size_t>(t) * B * H;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float x = b < B ? xt[static_cast<size_t>(b) * H4 + g * H + j]
                              : 0.0f;
        // |acc| <= 127^2 * H < 2^24: the conversion is exact
        gate[g] = __fadd_rn(x, __fmul_rn(__int2float_rn(acc[r][g]),
                                         __fmul_rn(hs[r], ws[g])));
      }
      const float i = sigmoid(gate[0]);
      const float f = sigmoid(gate[1]);
      const float gg = tanhf(gate[2]);
      const float o = sigmoid(gate[3]);
      // as _gate_update computes it, one rounding per operation
      const float c_new = __fadd_rn(__fmul_rn(f, c[r]), __fmul_rn(i, gg));
      const float h_new = __fmul_rn(o, tanhf(c_new));
      if (kMasked) {
        const float m = b < B ? __ldg(mask + static_cast<size_t>(t) * B + b)
                              : 0.0f;
        c[r] = blend(m, c_new, c[r]);
        h[r] = blend(m, h_new, h[r]);
        if (b < B) yt[static_cast<size_t>(b) * H + j] = __fmul_rn(m, h_new);
      } else {
        c[r] = c_new;
        h[r] = h_new;
        if (b < B) yt[static_cast<size_t>(b) * H + j] = h_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      d.h_t[static_cast<size_t>(b) * H + j] = h[r];
      d.c_t[static_cast<size_t>(b) * H + j] = c[r];
    }
  }
}

__global__ void __launch_bounds__(kMaxHidden)
lstm_scan_int8_kernel(Dir d0, Dir d1, int T, int B, int H) {
  scan_int8<false>(blockIdx.y == 0 ? d0 : d1, nullptr, T, B, H);
}

__global__ void __launch_bounds__(kMaxHidden)
lstm_scan_masked_int8_kernel(Dir d0, Dir d1, const float* __restrict__ mask,
                             int T, int B, int H) {
  scan_int8<true>(blockIdx.y == 0 ? d0 : d1, mask, T, B, H);
}

int launch(const Dir& d0, const Dir& d1, const float* mask, int n_dir,
           int T, int B, int H, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, n_dir);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr)
    lstm_scan_int8_kernel<<<grid, H, 0, s>>>(d0, d1, T, B, H);
  else
    lstm_scan_masked_int8_kernel<<<grid, H, 0, s>>>(d0, d1, mask, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The caller guarantees: x_proj/h0/c0/mask/w_scale float32, w_hh the
// int32 words of pack_w_hh, all contiguous, T >= 1, B >= 1, H a multiple
// of 32 in [32, 256], all pointers on the current device; mask is [T, B].
int lstm_scan_int8(const float* x_proj, const int* w_hh, const float* w_scale,
                   const float* h0, const float* c0,
                   float* ys, float* h_t, float* c_t,
                   int T, int B, int H, void* stream) {
  const Dir d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
  return launch(d, d, nullptr, 1, T, B, H, stream);
}

int bilstm_scan_int8(const float* x_proj_f, const float* x_proj_b,
                     const int* w_hh_f, const int* w_hh_b,
                     const float* w_scale_f, const float* w_scale_b,
                     const float* h0_f, const float* c0_f,
                     const float* h0_b, const float* c0_b,
                     float* ys_f, float* ys_b,
                     float* h_f, float* c_f, float* h_b, float* c_b,
                     int T, int B, int H, void* stream) {
  const Dir f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b, ys_b, h_b, c_b};
  return launch(f, b, nullptr, 2, T, B, H, stream);
}

int lstm_scan_masked_int8(const float* x_proj, const int* w_hh,
                          const float* w_scale, const float* h0,
                          const float* c0, const float* mask,
                          float* ys, float* h_t, float* c_t,
                          int T, int B, int H, void* stream) {
  const Dir d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
  return launch(d, d, mask, 1, T, B, H, stream);
}

int bilstm_scan_masked_int8(const float* x_proj_f, const float* x_proj_b,
                            const int* w_hh_f, const int* w_hh_b,
                            const float* w_scale_f, const float* w_scale_b,
                            const float* h0_f, const float* c0_f,
                            const float* h0_b, const float* c0_b,
                            const float* mask,
                            float* ys_f, float* ys_b,
                            float* h_f, float* c_f, float* h_b, float* c_b,
                            int T, int B, int H, void* stream) {
  const Dir f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b, ys_b, h_b, c_b};
  return launch(f, b, mask, 2, T, B, H, stream);
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

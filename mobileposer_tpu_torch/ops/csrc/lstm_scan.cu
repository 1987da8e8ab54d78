// LSTM layer scans for Hopper (sm_90a), float32.
//
// Replaces three TPU kernels of mobileposer_tpu/ops/lstm_pallas.py:
//   lstm_scan_f32          <- lstm_layer_pallas   (_lstm_step_kernel): one
//                             unidirectional full-length layer;
//   bilstm_scan_f32        <- bilstm_layer_pallas (_bilstm_step_kernel):
//                             both directions of a bidirectional layer in
//                             one launch, blockIdx.y selecting the
//                             direction, as the TPU kernel advances both
//                             directions together;
//   lstm_scan_masked_f32   <- lstm_layer_masked_pallas (_masked_step_kernel):
//   bilstm_scan_masked_f32    one direction, or both directions in one
//                             launch, of a ragged batch: a [T, B] mask of
//                             1.0 / 0.0 marks the valid frames. Both
//                             directions share the one mask: the backward
//                             input is reversed per length, so each row's
//                             valid frames stay at the front. Each
//                             direction computes exactly what the TPU
//                             kernel computes; fusing two directions into
//                             one launch is a layout choice.
// Contract (same as the Pallas kernels): x_proj [T, B, 4H] already holds
// x @ w_ih + b_ih + b_hh; w_hh is [H, 4H] row-major (input-major, the JAX
// layout); gate order (i, f, g, o); the carry stays float32; the backward
// direction consumes a pre-reversed x_proj and emits ys still reversed;
// the final (h, c) is written after the last step. Masked variant, per
// step and row with m = mask[t, b]: h <- m*h_new + (1-m)*h and
// c <- m*c_new + (1-m)*c (no branch, so a fractional mask blends as the
// TPU kernel does), ys[t] = m*h_new (exactly zero at a masked step), and
// the final (h, c) is each row's state at its last valid frame.
//
// Design. The TPU runs the grid's time axis in order on one core and keeps
// the carry and w_hh in VMEM across grid steps. Hopper blocks run in
// parallel and in no order, so the time loop runs inside the block: a
// block owns kRows batch rows for all T steps, keeping their h in shared
// memory and c in registers. Thread j owns hidden unit j and computes the
// four gate columns j, H+j, 2H+j, 3H+j for its rows, so the cell update
// needs no exchange; neighbouring threads read neighbouring columns of
// w_hh, so its loads coalesce. Ragged batch edges are masked. The masked
// kernel repeats this loop and blends after the cell update; the
// full-length kernel is left as the streaming path measured it.
//
// What bounds it on this card (worked out from the shapes, not measured):
// the recurrent product is 2*B*H*4H FLOPs per step and direction, against
// float32 outside the tensor cores (67 TFLOP/s) and 3.35 TB/s of HBM.
//   * streaming (B = 256 streams, T = 45, H = 256): a bidirectional layer
//     is ~12.1 GFLOP against ~120 MB of x_proj/ys/w_hh traffic, so FLOPs
//     bound it at ~0.18 ms; bytes alone would take ~36 us.
//   * evaluation, masked (B = 64, T = 512, every frame valid): a
//     bidirectional layer at H = 256 is ~34.4 GFLOP (bound 0.51 ms)
//     against ~338 MB (0.10 ms); the unidirectional velocity layer half
//     that (0.26 ms); footcontact at H = 64 ~2.15 GFLOP (0.032 ms)
//     against ~84 MB (0.025 ms). FLOPs bound all three.
//
// What this simple design leaves on the table: w_hh (1 MiB at H=256) does
// not fit in a block's 227 KB of shared memory, so every block re-reads it
// from L2 every step, and only ceil(B/kRows) blocks per direction are in
// flight on 132 SMs (8 at the evaluation batch of 64). A step costs about
// the same at any batch, so a 512-step masked layer costs ~17x a 45-step
// streaming one and reaches a few percent of its bound. Splitting w_hh
// across a thread-block cluster (distributed shared memory), TF32/bf16
// tensor cores through wgmma, TMA loads of x_proj, and skipping steps past
// the longest row of a block are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kMaxHidden = 256; // one thread per hidden unit

struct Dir {
  const float* x_proj;  // [T, B, 4H]
  const float* w_hh;    // [H, 4H]
  const float* h0;      // [B, H]
  const float* c0;      // [B, H]
  float* ys;            // [T, B, H]
  float* h_t;           // [B, H]
  float* c_t;           // [B, H]
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxHidden)
lstm_scan_kernel(Dir d0, Dir d1, int T, int B, int H) {
  const Dir d = blockIdx.y == 0 ? d0 : d1;
  extern __shared__ float4 smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [kRows][H]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const size_t H4 = 4 * static_cast<size_t>(H);

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    const bool ok = b < B;
    h_s[r * H + j] = ok ? d.h0[static_cast<size_t>(b) * H + j] : 0.0f;
    c[r] = ok ? d.c0[static_cast<size_t>(b) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xt = d.x_proj + static_cast<size_t>(t) * B * H4;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = b < B ? xt[static_cast<size_t>(b) * H4 + g * H + j]
                          : 0.0f;
    }

    // gates += h_{t-1} @ w_hh, four k at a time (one float4 of h per row)
    for (int k = 0; k < H; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w[kk][g] = __ldg(d.w_hh + (k + kk) * H4 + g * H + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(h_s + r * H + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = fmaf(h.x, w[0][g], acc[r][g]);
          acc[r][g] = fmaf(h.y, w[1][g], acc[r][g]);
          acc[r][g] = fmaf(h.z, w[2][g], acc[r][g]);
          acc[r][g] = fmaf(h.w, w[3][g], acc[r][g]);
        }
      }
    }
    __syncthreads();  // every thread has read h_{t-1}

    float* yt = d.ys + static_cast<size_t>(t) * B * H;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float i = sigmoid(acc[r][0]);
      const float f = sigmoid(acc[r][1]);
      const float g = tanhf(acc[r][2]);
      const float o = sigmoid(acc[r][3]);
      c[r] = f * c[r] + i * g;
      const float h = o * tanhf(c[r]);
      h_s[r * H + j] = h;
      const int b = b0 + r;
      if (b < B) yt[static_cast<size_t>(b) * H + j] = h;
    }
    __syncthreads();  // h_t is complete before step t+1 reads it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      d.h_t[static_cast<size_t>(b) * H + j] = h_s[r * H + j];
      d.c_t[static_cast<size_t>(b) * H + j] = c[r];
    }
  }
}

int launch(const Dir& d0, const Dir& d1, int n_dir, int T, int B, int H,
           void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, n_dir);
  const size_t smem = sizeof(float) * kRows * H;
  lstm_scan_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      d0, d1, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

// m*a + (1-m)*b rounded as written (no fused multiply-add), as the TPU
// kernel and the plain version compute it.
__device__ __forceinline__ float blend(float m, float a, float b) {
  return __fadd_rn(__fmul_rn(m, a), __fmul_rn(__fsub_rn(1.0f, m), b));
}

// lstm_scan_kernel with a [T, B] validity mask. The full-length kernel
// above is left exactly as it was (its register allocation and time are
// the streaming path's numbers); this one repeats its loop and adds the
// blend after the cell update.
__global__ void __launch_bounds__(kMaxHidden)
lstm_scan_masked_kernel(Dir d0, Dir d1, const float* __restrict__ mask,
                        int T, int B, int H) {
  const Dir d = blockIdx.y == 0 ? d0 : d1;
  extern __shared__ float4 smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [kRows][H]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const size_t H4 = 4 * static_cast<size_t>(H);

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    const bool ok = b < B;
    h_s[r * H + j] = ok ? d.h0[static_cast<size_t>(b) * H + j] : 0.0f;
    c[r] = ok ? d.c0[static_cast<size_t>(b) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xt = d.x_proj + static_cast<size_t>(t) * B * H4;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = b < B ? xt[static_cast<size_t>(b) * H4 + g * H + j]
                          : 0.0f;
    }

    // gates += h_{t-1} @ w_hh, four k at a time (one float4 of h per row)
    for (int k = 0; k < H; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w[kk][g] = __ldg(d.w_hh + (k + kk) * H4 + g * H + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(h_s + r * H + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[r][g] = fmaf(h.x, w[0][g], acc[r][g]);
          acc[r][g] = fmaf(h.y, w[1][g], acc[r][g]);
          acc[r][g] = fmaf(h.z, w[2][g], acc[r][g]);
          acc[r][g] = fmaf(h.w, w[3][g], acc[r][g]);
        }
      }
    }
    __syncthreads();  // every thread has read h_{t-1}

    float* yt = d.ys + static_cast<size_t>(t) * B * H;
    const float* mt = mask + static_cast<size_t>(t) * B;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float i = sigmoid(acc[r][0]);
      const float f = sigmoid(acc[r][1]);
      const float g = tanhf(acc[r][2]);
      const float o = sigmoid(acc[r][3]);
      const float c_new = f * c[r] + i * g;
      const float h_new = o * tanhf(c_new);
      const int b = b0 + r;
      const float m = b < B ? __ldg(mt + b) : 0.0f;
      c[r] = blend(m, c_new, c[r]);
      // thread j alone reads and writes h_s[r][j] between the barriers
      h_s[r * H + j] = blend(m, h_new, h_s[r * H + j]);
      if (b < B) yt[static_cast<size_t>(b) * H + j] = __fmul_rn(m, h_new);
    }
    __syncthreads();  // h_t is complete before step t+1 reads it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      d.h_t[static_cast<size_t>(b) * H + j] = h_s[r * H + j];
      d.c_t[static_cast<size_t>(b) * H + j] = c[r];
    }
  }
}

int launch_masked(const Dir& d0, const Dir& d1, const float* mask, int n_dir,
                  int T, int B, int H, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, n_dir);
  const size_t smem = sizeof(float) * kRows * H;
  lstm_scan_masked_kernel<<<grid, H, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      d0, d1, mask, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The caller guarantees: float32, contiguous, T >= 1, B >= 1,
// H a multiple of 32 in [32, 256], all pointers on the current device;
// for the masked entries, mask is [T, B].
int lstm_scan_f32(const float* x_proj, const float* w_hh, const float* h0,
                  const float* c0, float* ys, float* h_t, float* c_t,
                  int T, int B, int H, void* stream) {
  const Dir d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
  return launch(d, d, 1, T, B, H, stream);
}

int bilstm_scan_f32(const float* x_proj_f, const float* x_proj_b,
                    const float* w_hh_f, const float* w_hh_b,
                    const float* h0_f, const float* c0_f,
                    const float* h0_b, const float* c0_b,
                    float* ys_f, float* ys_b,
                    float* h_f, float* c_f, float* h_b, float* c_b,
                    int T, int B, int H, void* stream) {
  const Dir f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
  return launch(f, b, 2, T, B, H, stream);
}

int lstm_scan_masked_f32(const float* x_proj, const float* w_hh,
                         const float* h0, const float* c0, const float* mask,
                         float* ys, float* h_t, float* c_t,
                         int T, int B, int H, void* stream) {
  const Dir d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
  return launch_masked(d, d, mask, 1, T, B, H, stream);
}

int bilstm_scan_masked_f32(const float* x_proj_f, const float* x_proj_b,
                           const float* w_hh_f, const float* w_hh_b,
                           const float* h0_f, const float* c0_f,
                           const float* h0_b, const float* c0_b,
                           const float* mask,
                           float* ys_f, float* ys_b,
                           float* h_f, float* c_f, float* h_b, float* c_b,
                           int T, int B, int H, void* stream) {
  const Dir f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
  return launch_masked(f, b, mask, 2, T, B, H, stream);
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// LSTM layer scans for TRAINING on Hopper (sm_90a), float32.
//
// Replaces the two TPU kernels of mobileposer_tpu/ops/lstm_train_pallas.py:
//   lstm_train_fwd_f32  <- _fwd_call (_fwd_kernel): one layer-direction
//                          forward over a [T, B] mask that also stores the
//                          residuals of the backward pass;
//   lstm_train_bwd_f32  <- _bwd_call (_bwd_kernel): BPTT of one
//   + lstm_train_dw_f32    layer-direction in reversed time. The TPU kernel
//                          keeps a [H, 4H] dw_hh accumulator in VMEM across
//                          its time grid; here the scan kernel stores the
//                          gate gradients and a second kernel, launched
//                          right after by the same wrapper, reduces
//                          h_prev^T @ dgates over the T*B rows.
//
// Contract (the Pallas kernels'): x_proj [T, B, 4H] already holds
// x @ w_ih + b_ih + b_hh; w_hh is [H, 4H] row-major (input-major, the JAX
// layout); gate order (i, f, g, o); mask [T, B] with 1.0 at valid frames.
// Forward, per step and row with m = mask[t, b]:
//   gates = x_proj[t] + h @ w_hh;  i, f, o = sigmoid(.), g = tanh(.)
//   c_new = f*c + i*g;  h_new = o*tanh(c_new)
//   h <- m*h_new + (1-m)*h;  c <- m*c_new + (1-m)*c
//   ys[t] = m*h_new;  acts[t] = (i, f, g, o);  hseq[t] = h;  cseq[t] = c
// and (h_T, c_T) = the held carry after the last step. cseq holds the
// HELD carry, which the backward reads as c_new: at valid steps the two
// agree, and at masked steps m = 0 zeroes every use (as on the TPU).
// Backward, t = T-1 .. 0, with (dh, dc) starting at (dh_T, dc_T):
//   dh_new = m*(dh + dy[t]);  dc_new = m*dc;  tc = tanh(c_new)
//   do = dh_new*tc;  dc_cur = dc_new + dh_new*o*(1 - tc*tc)
//   di = dc_cur*g;  dg = dc_cur*i;  df = dc_cur*c_prev;  dcp = dc_cur*f
//   dgates = (di*i(1-i), df*f(1-f), dg*(1-g*g), do*o(1-o)) -> dx_proj[t]
//   dh <- (1-m)*dh + dgates @ w_hh^T;  dc <- (1-m)*dc + dcp
// then (dh0, dc0) = (dh, dc), and dw_hh = sum_t h_prev[t]^T @ dgates[t].
//
// Design. As in lstm_scan.cu, the TPU's sequential time grid becomes a
// loop inside the block: a block owns kRows batch rows for all T steps,
// thread j owns hidden unit j and its four gate columns j, H+j, 2H+j,
// 3H+j, so the cell update and its derivative need no exchange.
//   * forward: h in shared memory, c in registers; w_hh read column-wise
//     (coalesced across j) from L2 every step; the blend is rounded as
//     written (__fmul_rn/__fadd_rn, no FMA) so ys is exactly zero at a
//     masked step and the carry rounds as the TPU kernel's does.
//   * backward: dh and dc in registers; each step the block writes its
//     dgates [kRows, 4H] to shared memory (32 KB at H = 256), then thread
//     j computes dh[:, j] = dgates @ w_hh^T[:, j] reading the [4H, H]
//     transpose column-wise, again coalesced across j.
//   * dW: the [H, 4H] sum over T*B rows fits neither a block's shared
//     memory nor its registers (1 MiB at H = 256), and blocks cannot share
//     an accumulator, so a second kernel computes it as a tiled
//     shared-memory product with float32 accumulation: each block owns a
//     64 x 64 tile of dw_hh for one contiguous slab of rows, and writes
//     its partial tile to slab s of a [S, H, 4H] output. No atomics: the
//     wrapper sums the slabs in a fixed order, as the TPU sums its
//     per-batch-tile slabs, so the result is the same from run to run.
//
// What bounds it on this card (worked out from the shapes, not measured),
// at the training shape T = 125, B = 256, per layer-direction, against
// float32 outside the tensor cores (67 TFLOP/s) and 3.35 TB/s of HBM:
//   * forward, H = 256: 16.8 GFLOP of recurrent products (0.25 ms) against
//     ~361 MB of x_proj, acts, ys, hseq and cseq (0.108 ms): FLOPs bound.
//     At H = 64: 1.05 GFLOP (0.016 ms) against ~90 MB (0.027 ms): bytes.
//   * backward + dW, H = 256: 2 x 16.8 GFLOP (0.50 ms) against ~393 MB
//     (0.117 ms): FLOPs. At H = 64: 2.1 GFLOP (0.031 ms) against ~98 MB
//     (0.029 ms): FLOPs.
// The scans are per-step latency bound like the inference kernels (every
// block re-reads w_hh from L2 each step, and only ceil(B/kRows) blocks
// run), so they reach a few percent of that bound; a cluster-split w_hh
// and tensor-core products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kMaxHidden = 256; // one thread per hidden unit

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// m*a + (1-m)*b rounded as written (no fused multiply-add), as the TPU
// kernel and the plain version compute it.
__device__ __forceinline__ float blend(float m, float a, float b) {
  return __fadd_rn(__fmul_rn(m, a), __fmul_rn(__fsub_rn(1.0f, m), b));
}

// ---------------------------------------------------------------------------
// #7 forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxHidden)
lstm_train_fwd_kernel(const float* __restrict__ x_proj,
                      const float* __restrict__ w_hh,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ mask,
                      float* __restrict__ ys, float* __restrict__ acts,
                      float* __restrict__ hseq, float* __restrict__ cseq,
                      float* __restrict__ h_t, float* __restrict__ c_t,
                      int T, int B, int H) {
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
    h_s[r * H + j] = ok ? h0[static_cast<size_t>(b) * H + j] : 0.0f;
    c[r] = ok ? c0[static_cast<size_t>(b) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row0 = static_cast<size_t>(t) * B;
    const float* xt = x_proj + row0 * H4;
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
          w[kk][g] = __ldg(w_hh + (k + kk) * H4 + g * H + j);
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

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      const float i = sigmoid(acc[r][0]);
      const float f = sigmoid(acc[r][1]);
      const float g = tanhf(acc[r][2]);
      const float o = sigmoid(acc[r][3]);
      const float c_new = f * c[r] + i * g;
      const float h_new = o * tanhf(c_new);
      const float m = b < B ? __ldg(mask + row0 + b) : 0.0f;
      c[r] = blend(m, c_new, c[r]);
      // thread j alone reads and writes h_s[r][j] between the barriers
      const float h_keep = blend(m, h_new, h_s[r * H + j]);
      h_s[r * H + j] = h_keep;
      if (b < B) {
        const size_t row = row0 + b;
        float* a = acts + row * H4;
        a[j] = i;
        a[H + j] = f;
        a[2 * H + j] = g;
        a[3 * H + j] = o;
        ys[row * H + j] = __fmul_rn(m, h_new);
        hseq[row * H + j] = h_keep;
        cseq[row * H + j] = c[r];
      }
    }
    __syncthreads();  // h_t is complete before step t+1 reads it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      h_t[static_cast<size_t>(b) * H + j] = h_s[r * H + j];
      c_t[static_cast<size_t>(b) * H + j] = c[r];
    }
  }
}

// ---------------------------------------------------------------------------
// #8 backward scan
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxHidden)
lstm_train_bwd_kernel(const float* __restrict__ dy,
                      const float* __restrict__ dh_T,
                      const float* __restrict__ dc_T,
                      const float* __restrict__ acts,
                      const float* __restrict__ c_new_seq,
                      const float* __restrict__ c_prev_seq,
                      const float* __restrict__ w_hh_t,   // [4H, H]
                      const float* __restrict__ mask,
                      float* __restrict__ dx_proj,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      int T, int B, int H) {
  extern __shared__ float4 smem[];
  float* dg_s = reinterpret_cast<float*>(smem);  // [kRows][4H]
  const int j = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const int H4 = 4 * H;

  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    const bool ok = b < B;
    dh[r] = ok ? dh_T[static_cast<size_t>(b) * H + j] : 0.0f;
    dc[r] = ok ? dc_T[static_cast<size_t>(b) * H + j] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B;
    float keep[kRows], dcp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      float* dgr = dg_s + r * H4;
      if (b >= B) {
        keep[r] = 1.0f;
        dcp[r] = 0.0f;
        dgr[j] = dgr[H + j] = dgr[2 * H + j] = dgr[3 * H + j] = 0.0f;
        continue;
      }
      const size_t row = row0 + b;
      const float m = __ldg(mask + row);
      const float* a = acts + row * H4;
      const float i = a[j], f = a[H + j], g = a[2 * H + j], o = a[3 * H + j];
      const float tc = tanhf(c_new_seq[row * H + j]);
      const float c_prev = c_prev_seq[row * H + j];
      const float dh_new = m * (dh[r] + dy[row * H + j]);
      const float dc_new = m * dc[r];
      const float d_o = dh_new * tc;
      const float dc_cur = dc_new + dh_new * o * (1.0f - tc * tc);
      const float di = dc_cur * g;
      const float dg = dc_cur * i;
      const float df = dc_cur * c_prev;
      dcp[r] = dc_cur * f;
      keep[r] = 1.0f - m;
      const float gi = di * i * (1.0f - i);
      const float gf = df * f * (1.0f - f);
      const float gg = dg * (1.0f - g * g);
      const float go = d_o * o * (1.0f - o);
      float* dx = dx_proj + row * H4;
      dx[j] = gi;
      dx[H + j] = gf;
      dx[2 * H + j] = gg;
      dx[3 * H + j] = go;
      dgr[j] = gi;
      dgr[H + j] = gf;
      dgr[2 * H + j] = gg;
      dgr[3 * H + j] = go;
    }
    __syncthreads();  // every row's dgates are in shared memory

    // rec[r] = dgates[r] @ w_hh^T[:, j], four k at a time
    float rec[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) rec[r] = 0.0f;
    for (int k = 0; k < H4; k += 4) {
      float w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w[kk] = __ldg(w_hh_t + static_cast<size_t>(k + kk) * H + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(dg_s + r * H4 + k);
        rec[r] = fmaf(d.x, w[0], rec[r]);
        rec[r] = fmaf(d.y, w[1], rec[r]);
        rec[r] = fmaf(d.z, w[2], rec[r]);
        rec[r] = fmaf(d.w, w[3], rec[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      dh[r] = keep[r] * dh[r] + rec[r];
      dc[r] = keep[r] * dc[r] + dcp[r];
    }
    __syncthreads();  // every thread has read dgates before they change
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      dh0[static_cast<size_t>(b) * H + j] = dh[r];
      dc0[static_cast<size_t>(b) * H + j] = dc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// #8 dW reduction: slabs[s] = h_prev[rows of s]^T @ dgates[rows of s]
// ---------------------------------------------------------------------------

constexpr int kTileM = 64;   // rows of dw_hh (hidden inputs) per block
constexpr int kTileN = 64;   // columns of dw_hh (gate columns) per block
constexpr int kTileK = 16;   // T*B rows per shared-memory stage

// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4
// outputs at rows 4*ty.., columns 4*tx.. of the block's tile.
__global__ void __launch_bounds__(256)
lstm_train_dw_kernel(const float* __restrict__ h_prev,   // [N, H]
                     const float* __restrict__ dgates,   // [N, 4H]
                     float* __restrict__ slabs,          // [S, H, 4H]
                     int N, int H, int rows_per_slab) {
  __shared__ __align__(16) float a_s[kTileK][kTileM];
  __shared__ __align__(16) float b_s[kTileK][kTileN];
  const int H4 = 4 * H;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int s = blockIdx.z;
  const int k_begin = s * rows_per_slab;
  const int k_end = min(N, k_begin + rows_per_slab);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // loader: each thread moves 4 consecutive floats of one row per operand
  const int lk = tid / 16, lc = (tid % 16) * 4;

  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int k = k0 + lk;
    const bool k_ok = k < k_end;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + lc + q;
      const int n = n0 + lc + q;
      a_s[lk][lc + q] = (k_ok && m < H)
          ? h_prev[static_cast<size_t>(k) * H + m] : 0.0f;
      b_s[lk][lc + q] = (k_ok && n < H4)
          ? dgates[static_cast<size_t>(k) * H4 + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* out = slabs + static_cast<size_t>(s) * H * H4;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ty * 4 + p;
    if (m >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < H4) out[static_cast<size_t>(m) * H4 + n] = acc[p][q];
    }
  }
}

}  // namespace

extern "C" {

// The caller guarantees: float32, contiguous, T >= 1, B >= 1, H a multiple
// of 32 in [32, 256], all pointers on the current device.

int lstm_train_fwd_f32(const float* x_proj, const float* w_hh,
                       const float* h0, const float* c0, const float* mask,
                       float* ys, float* acts, float* hseq, float* cseq,
                       float* h_t, float* c_t, int T, int B, int H,
                       void* stream) {
  const dim3 grid((B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * H;
  lstm_train_fwd_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      x_proj, w_hh, h0, c0, mask, ys, acts, hseq, cseq, h_t, c_t, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

// w_hh_t is the [4H, H] transpose of w_hh.
int lstm_train_bwd_f32(const float* dy, const float* dh_T, const float* dc_T,
                       const float* acts, const float* c_new_seq,
                       const float* c_prev_seq, const float* w_hh_t,
                       const float* mask, float* dx_proj, float* dh0,
                       float* dc0, int T, int B, int H, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * 4 * H;   // <= 32 KB
  lstm_train_bwd_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      dy, dh_T, dc_T, acts, c_new_seq, c_prev_seq, w_hh_t, mask, dx_proj,
      dh0, dc0, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

// h_prev [N, H], dgates [N, 4H] with N = T*B; slabs [n_slabs, H, 4H],
// slab s summing rows [s*rows_per_slab, (s+1)*rows_per_slab).
int lstm_train_dw_f32(const float* h_prev, const float* dgates, float* slabs,
                      int N, int H, int n_slabs, int rows_per_slab,
                      void* stream) {
  const dim3 grid((4 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM,
                  n_slabs);
  lstm_train_dw_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      h_prev, dgates, slabs, N, H, rows_per_slab);
  return static_cast<int>(cudaGetLastError());
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

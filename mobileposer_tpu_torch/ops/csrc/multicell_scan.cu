// Multicell LSTM scan for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel multicell_lstm_pallas (_make_kernel) of
// mobileposer_tpu/ops/multicell_pallas.py: n independent LSTM cells of
// different hidden sizes advanced over the same T steps in one launch.
// The fused inference path (models/fused.py) runs one launch per
// layer-row of the poser / footcontact / velocity trio: five cells, poser
// fwd/bwd at H=256, footcontact fwd/bwd at H=64, velocity at H=256.
//
// Contract (same as the Pallas kernel): x_proj [T, B, sum_i 4H_i] holds
// each cell's input projection x @ w_ih + b_ih + b_hh, concatenated along
// features in cell order (cell i at feature offset sum_{k<i} 4H_k), the
// backward cells pre-reversed in time; w_hh_i is [H_i, 4H_i] row-major
// (the JAX layout); h0_i / c0_i are [B, H_i]. For each cell and step:
//   gates = x_proj[t, :, off_i : off_i + 4H_i] + h_i @ w_hh_i
//   c_i = f * c_i + i * g;  h_i = o * tanh(c_i)     (gates i, f, g, o)
// ys_i[t] = h_i; (h_T, c_T) after the last step. The carry stays float32.
// A backward cell's ys come out still reversed; the caller un-reverses.
//
// Design. The TPU kernel advances the five cells one after another inside
// one grid step, because one TPU core runs one thing at a time. Here the
// cells are independent blocks that run at the same time on different
// SMs: the grid is (batch tiles of kRows rows) x (cells), blockIdx.y
// picking a cell descriptor (its H, feature offset, pointers). The time
// loop runs inside the block: h in shared memory, c in registers, thread j
// owning gate columns j, H+j, 2H+j, 3H+j of its kRows rows. The order of
// summation is the per-module kernels' (lstm_scan_f32, bilstm_scan_f32 in
// lstm_scan.cu, whose layout differs): x_proj first, then k ascending, one
// fmaf each; and nvcc compiles this cell update to the rounding those
// kernels write out (f*c rounded, then fmaf(i, g, .)), so each cell
// computes bit for bit what they compute for it.
//
// Mixed widths: the block has max_i H_i threads. In a narrower cell's
// block the threads past its H shadow its last unit: they load and
// compute what thread H-1 does and store nothing, and every thread reaches
// every __syncthreads() (no thread returns early). Wrapping the loads and
// FMAs in a branch on j < H instead cost ~18% a step on an H100, at any
// width, because the compiler then schedules the loop worse; the shadow
// loads hit the addresses thread H-1's warp reads. The H=64 blocks finish
// their steps far sooner than the H=256 ones, so the shadow threads cost
// no time on the critical path, only registers. The launcher orders the
// descriptors by H, widest first: the hardware hands out blocks in order
// of their linear index, so when there are more blocks than SMs (160 at
// B=256 on 132 SMs) the ones that share an SM are the narrow cells', not a
// second H=256 block beside a first.
//
// What bounds it on this card (worked out from the shapes, not measured):
// at T=45, B=256 and H=(256, 256, 64, 64, 256) the recurrent products are
// 2*B*T*sum_i 4H_i^2 = 18.9 GFLOP, 0.28 ms at 67 TFLOP/s float32 outside
// the tensor cores; the bytes (x_proj, w_hh, the carries, ys, each once)
// are ~215 MB, 0.064 ms at 3.35 TB/s. So operations bound it.
//
// What this simple design leaves on the table: w_hh (1 MiB at H=256) does
// not fit in a block's shared memory, so every block re-reads its w_hh from
// L2 every step. Five cells at once put three 1 MiB matrices under 96
// blocks' reads per step, more L2 traffic at one time than one
// bidirectional layer (64 blocks) did. A block's step costs about the same
// at any batch (~29 us at H=256), so the launch costs about as much as its
// slowest cell alone, if L2 keeps up (measured on an H100: ~1.07x the
// slowest cell's layer kernel at B=256). The k loop keeps one float4 row
// of w_hh loads in flight per thread; unrolling it twice measured ~17%
// faster a step, with a small stack spill; any such change must keep the
// order above. Holding w_hh in the shared memory of a thread-block cluster,
// as the per-module kernels now do, TF32/bf16 tensor cores through wgmma
// and TMA loads of x_proj are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kMaxHidden = 256; // one thread per hidden unit
constexpr int kMaxCells = 8;

struct Cell {
  const float* w_hh;    // [H, 4H]
  const float* h0;      // [B, H]
  const float* c0;      // [B, H]
  float* ys;            // [T, B, H]
  float* h_t;           // [B, H]
  float* c_t;           // [B, H]
  int H;
  int off;              // feature offset of this cell in x_proj's rows
};

struct Cells {
  Cell cell[kMaxCells];
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxHidden)
multicell_scan_kernel(const float* __restrict__ x_proj,
                      const __grid_constant__ Cells cells, int T, int B,
                      int width) {
  const Cell d = cells.cell[blockIdx.y];
  const int H = d.H;
  extern __shared__ float4 smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [kRows][H]
  const int j = threadIdx.x;
  const bool active = j < H;
  const int u = active ? j : H - 1;   // the unit this thread computes
  const int b0 = blockIdx.x * kRows;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const size_t row = static_cast<size_t>(width);

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    const bool ok = b < B;
    if (active) h_s[r * H + j] = ok ? d.h0[static_cast<size_t>(b) * H + j]
                                    : 0.0f;
    c[r] = ok ? d.c0[static_cast<size_t>(b) * H + u] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xt = x_proj + static_cast<size_t>(t) * B * row + d.off;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = b < B ? xt[static_cast<size_t>(b) * row + g * H + u]
                          : 0.0f;
    }

    // gates += h_{t-1} @ w_hh, four k at a time (one float4 of h per row)
    for (int k = 0; k < H; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w[kk][g] = __ldg(d.w_hh + (k + kk) * H4 + g * H + u);
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
      const int b = b0 + r;
      if (active) {
        h_s[r * H + j] = h;
        if (b < B) yt[static_cast<size_t>(b) * H + j] = h;
      }
    }
    __syncthreads();  // h_t is complete before step t+1 reads it
  }

  if (!active) return;  // after the last barrier
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b < B) {
      d.h_t[static_cast<size_t>(b) * H + j] = h_s[r * H + j];
      d.c_t[static_cast<size_t>(b) * H + j] = c[r];
    }
  }
}

}  // namespace

extern "C" {

// n_cells cells; the pointer arrays and `hidden` are host arrays of
// n_cells entries, in the caller's cell order (x_proj's feature order).
// The caller guarantees: float32, contiguous, T >= 1, B >= 1,
// 1 <= n_cells <= 8, each H a multiple of 32 in [32, 256], all pointers on
// the current device. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments outside that range).
int multicell_scan_f32(const float* x_proj, const float* const* w_hh,
                       const float* const* h0, const float* const* c0,
                       float* const* ys, float* const* h_t,
                       float* const* c_t, const int* hidden, int n_cells,
                       int T, int B, void* stream) {
  if (n_cells < 1 || n_cells > kMaxCells || T < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cells cells{};
  int order[kMaxCells];
  int width = 0, max_h = 0;
  for (int i = 0; i < n_cells; ++i) {
    const int H = hidden[i];
    if (H < 32 || H > kMaxHidden || H % 32)
      return static_cast<int>(cudaErrorInvalidValue);
    order[i] = i;
    max_h = H > max_h ? H : max_h;
    width += 4 * H;
  }
  // widest cells first (stable): see the design note above
  for (int i = 1; i < n_cells; ++i)
    for (int k = i; k > 0 && hidden[order[k]] > hidden[order[k - 1]]; --k) {
      const int tmp = order[k];
      order[k] = order[k - 1];
      order[k - 1] = tmp;
    }
  int offs[kMaxCells];
  for (int i = 0, off = 0; i < n_cells; ++i) {
    offs[i] = off;
    off += 4 * hidden[i];
  }
  for (int s = 0; s < n_cells; ++s) {
    const int i = order[s];
    cells.cell[s] = Cell{w_hh[i], h0[i], c0[i], ys[i], h_t[i], c_t[i],
                         hidden[i], offs[i]};
  }
  const dim3 grid((B + kRows - 1) / kRows, n_cells);
  const size_t smem = sizeof(float) * kRows * max_h;
  multicell_scan_kernel<<<grid, max_h, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x_proj, cells, T, B, width);
  return static_cast<int>(cudaGetLastError());
}

const char* multicell_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

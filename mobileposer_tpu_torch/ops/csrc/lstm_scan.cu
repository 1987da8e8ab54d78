// LSTM layer scans for Hopper (sm_90a), float32.
//
// Replaces three TPU kernels of mobileposer_tpu/ops/lstm_pallas.py:
//   lstm_scan_f32          <- lstm_layer_pallas   (_lstm_step_kernel): one
//                             unidirectional full-length layer;
//   bilstm_scan_f32        <- bilstm_layer_pallas (_bilstm_step_kernel):
//                             both directions of a bidirectional layer in
//                             one launch, grid y selecting the direction,
//                             as the TPU kernel advances both directions
//                             together;
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
// Full-length design. The TPU keeps w_hh and the carry in VMEM across its
// sequential time grid; here w_hh stays in the shared memory of a
// thread-block cluster for all T steps (cluster_scan.cuh). A cluster of
// n = H / 32 CTAs of 512 threads owns R batch rows of one direction (R
// from 1 to 40, chosen by the wrapper: the fewest with which all
// n_dir * ceil(B / R) clusters are resident at once; an H100 holds 15
// clusters of 8 CTAs, so a bidirectional layer at B = 256, H = 256 takes
// R = 37). CTA c loads the swizzled slice w_hh[:, its 128 gate columns]
// (H x 128 floats, 128 KiB at H = 256) once. Per step:
//   * products: four warps, one row group of RT = ceil(R / 4) rows each
//     (a template parameter, so the accumulators are registers). A lane
//     owns C gate columns (C = 4, one float4 of the slice; C = 1 at R <= 2,
//     where four warps share a row) for its group's rows, and sums each
//     column over the whole k range in order: the gate starts at x_proj and
//     adds h[k] * w[k][col] with fmaf for k = 0 .. H-1. That is the order of
//     the block-per-tile kernel this replaces and of multicell_scan.cu, so
//     forward(backend='fused') stays bit-identical to 'auto'. The lanes of
//     a warp share their rows, so h is read as broadcast float4s; past the
//     group's last row a lane repeats that row and stores nothing, so the
//     k loop has no branch.
//   * the four gates of one (row, unit) sit in different lanes: they go
//     through a [R][128] shared buffer, and after one CTA barrier one
//     thread per (row, unit) of all 512 does the cell update, writes ys
//     (128-byte runs per warp), pushes its h to the double-buffered h of
//     EVERY CTA of the cluster through distributed shared memory, and puts
//     its four x_proj values of step t+1 (read into registers before step
//     t's products, so their latency hides behind them) into its gate
//     slots, where the next products start from;
//   * one cluster barrier ends the step.
// Rows past B read zeros and write nothing. Shared memory per CTA:
// 4 * (128 H + 2 R H + 128 R) bytes (w slice, h double-buffered, gates),
// so R <= 39 at H = 256 under the 227 KB limit.
//   Why four columns a lane: a warp-wide shared-memory read delivers at
// most 128 bytes a cycle to an SM's lanes, broadcast or not. With one
// column a lane, each h value a warp reads (one cycle) feeds one FMA a
// lane (a quarter of a cycle of the SM's FMA issue), so shared memory
// bounds the products at 4x the FMA time; four columns feed four FMAs
// from each h read. On an H100 (scan_variants.py), at R = 37 a step takes
// ~14.5 us with four columns against ~20 us with one: ~11 us are the
// products (~1.4 shared-memory bytes a FMA, the bound of a 4 x 10
// register tile, plus latency: one product warp per SM scheduler),
// ~3.4 us the cell update and the x_proj fetch, ~0.3 us the cluster
// barrier; the remote h pushes cost no measurable time. At R <= 2 one
// column a lane is ~1.6x faster: the step is a chain of latencies, which
// four warps per row shorten.
//
// Masked variant (lstm_scan_masked_kernel): the same body, the same
// geometry (rows per cluster from the wrapper, residency queried for the
// masked instantiation) and the same summation order, plus:
//   * at the start, the cluster finds t_end, one past the last step at
//     which any of its R rows has m != 0 (each CTA scans the tile's mask
//     columns from the last step down and the CTA takes the largest hit;
//     every CTA reads the same columns, so all agree on the number of
//     steps and on the cluster barriers). Steps from t_end on leave every
//     row's carry as it is and only write zeros to ys, so a tile whose
//     rows all end early stops there. For finite inputs that is exact:
//     at m = 0 the blend keeps h and c, and ys is +-0. It assumes no
//     prefix shape of the mask. One difference from running every step:
//     a NaN or an infinity in x_proj at a step from t_end on no longer
//     reaches h and c through 0 * NaN (before t_end it still does, as in
//     the TPU kernel);
//   * each cell item reads its row's m for step t+1 beside x_proj, before
//     step t's products, and after the cell update blends, rounded as
//     written (cluster_scan.cuh `blend`): c <- blend(m, c_new, c),
//     h <- blend(m, h_new, h), ys[t] = __fmul_rn(m, h_new). The blended h
//     is what goes to every CTA. With every m = 1, blend(1, a, b) = a and
//     1 * h = h, so the masked entries give the full-length entries'
//     outputs bit for bit.
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
// The scan is a chain of T dependent steps (see "Why four columns a lane"
// above), so at evaluation's B = 64 a cluster holds few rows (10 at
// H = 256, bidirectional) and a step is mostly latency and the cluster
// barrier. TF32/bf16 tensor cores through wgmma and TMA loads of x_proj
// are later work.

#include "cluster_scan.cuh"

namespace {

constexpr int kGroups = 4;                 // row groups of the products
constexpr int kMaxRowsPerLane = 10;        // RT templates 1 .. 10
constexpr int kMaxRows = kGroups * kMaxRowsPerLane;

struct Dir {
  const float* x_proj;  // [T, B, 4H]
  const float* w_hh;    // [H, 4H]
  const float* h0;      // [B, H]
  const float* c0;      // [B, H]
  float* ys;            // [T, B, H]
  float* h_t;           // [B, H]
  float* c_t;           // [B, H]
};

size_t scan_smem_bytes(int H, int R) {
  // w slice, h double-buffered [2][R][H], gates [R][kCols]
  return sizeof(float) * (static_cast<size_t>(H) * kCols + 2 * R * H
                          + R * kCols);
}

// C consecutive gate columns of the slice at `p` (C = 1, or 4: one float4)
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[C]) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// One past the last step at which a row of the tile [b0, b0 + R) has a
// nonzero mask; the same in every CTA of the cluster. `slot` is one int
// of shared memory, free until the function returns.
__device__ __forceinline__ int tile_end(const float* __restrict__ mask,
                                        int T, int B, int b0, int R,
                                        int* slot) {
  const int tid = threadIdx.x;
  if (tid == 0) *slot = 0;
  __syncthreads();
  // item idx is (step, row) = (idx / R, idx % R); from the last step
  // down, so a thread's first hit is its latest
  for (int idx = T * R - 1 - tid; idx >= 0; idx -= kThreads) {
    const int b = b0 + idx % R;
    if (b < B && __ldg(mask + static_cast<size_t>(idx / R) * B + b) != 0.0f) {
      atomicMax(slot, idx / R + 1);
      break;
    }
  }
  __syncthreads();
  const int t_end = *slot;
  __syncthreads();  // every thread has read the slot
  return t_end;
}

// The scan of one direction (see the design notes above); with kMasked,
// the masked variant over mask [T, B]. `d` by value: a reference to the
// kernel's parameters would put both directions' in local memory.
template <int RT, int C, bool kMasked>
__device__ __forceinline__ void scan_body(const Dir d,
                                          const float* __restrict__ mask,
                                          int T, int B, int H, int R) {
  constexpr int CPT = (kGroups * RT * kUnits + kThreads - 1) / kThreads;
  constexpr int kWarpsPerGroup = 4 / C;  // warps covering the 128 columns
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = H / kUnits;
  const int cta = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / n_cta) * R;
  const int unit0 = cta * kUnits;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int tid = threadIdx.x;

  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);   // [H][kCols], swizzled
  float* h_s = w_s + H * kCols;                  // [2][R][H]
  float* gates = h_s + 2 * R * H;                // [R][kCols]

  // products: the lane sums the gate columns col0 .. col0 + C - 1 of the
  // slice for the tile rows [r_begin, r_begin + rows) of its row group;
  // past `rows` it repeats the last row and stores nothing, so that the k
  // loop has no branch
  const int lane = tid % 32, grp = tid / 32 / kWarpsPerGroup;
  const int col0 = C * (32 * (tid / 32 % kWarpsPerGroup) + lane);
  const int r_begin = grp * RT;
  const int rows = grp < kGroups ? min(RT, R - r_begin) : 0;

  // the steps this cluster runs: all T, or (masked) up to the tile's last
  // valid step; the gate buffer serves as the reduction's slot
  int t_end = T;
  if constexpr (kMasked)
    t_end = tile_end(mask, T, B, b0, R, reinterpret_cast<int*>(gates));

  // cells: item tid + p*kThreads is (row, unit) = (item / 32, item % 32);
  // it also fetches that (row, unit)'s four x_proj columns (and, masked,
  // its mask value) of the next step
  load_w_slice(d.w_hh, w_s, H, cta);
  for (int idx = tid; idx < R * H; idx += kThreads) {
    const int b = b0 + idx / H;
    h_s[idx] = b < B ? d.h0[static_cast<size_t>(b) * H + idx % H] : 0.0f;
  }
  float c[CPT];
  float xn[CPT][4] = {};  // x_proj of the next step, per item and gate
  float m[CPT] = {}, mn[CPT] = {};  // mask of this step and of the next
#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int r = item / kUnits, u = item % kUnits, b = b0 + r;
    const bool ok = item < R * kUnits && b < B;
    c[p] = ok ? d.c0[static_cast<size_t>(b) * H + unit0 + u] : 0.0f;
    if (item < R * kUnits) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[r * kCols + g * kUnits + u] =
            ok ? __ldg(d.x_proj + b * H4 + g * H + unit0 + u) : 0.0f;
    }
    if constexpr (kMasked) m[p] = ok && t_end > 0 ? __ldg(mask + b) : 0.0f;
  }
  cluster.sync();  // every CTA started; w_s, h_s[0], x_proj[0] loaded

  int cur = 0;
  for (int t = 0; t < t_end; ++t) {
    if (t + 1 < t_end) {  // step t+1's x_proj, in flight during the products
      const size_t row0 = static_cast<size_t>(t + 1) * B;
#pragma unroll
      for (int p = 0; p < CPT; ++p) {
        const int item = tid + p * kThreads;
        const int b = b0 + item / kUnits, u = item % kUnits;
        const bool ok = item < R * kUnits && b < B;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xn[p][g] = ok ? __ldg(d.x_proj + (row0 + b) * H4 + g * H + unit0 + u)
                        : 0.0f;
        if constexpr (kMasked) mn[p] = ok ? __ldg(mask + row0 + b) : 0.0f;
      }
    }
    if (rows > 0) {
      // gates = x_proj + h_{t-1}[rows] @ w_slice[:, C columns], k
      // ascending, four k at a time (one float4 of h per row)
      int ro[RT];
      float acc[RT][C];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ro[i] = r_begin + min(i, rows - 1);
        load_cols<C>(gates + ro[i] * kCols + col0, acc[i]);
      }
      const float* hb = h_s + cur * R * H;
      auto k_group = [&](int k) {
        float w[4][C];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          load_cols<C>(w_s + swizzle(k + kk, col0), w[kk]);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(hb + ro[i] * H
                                                            + k);
          const float hk[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < C; ++j)
              acc[i][j] = fmaf(hk[kk], w[kk][j], acc[i][j]);
        }
      };
      if constexpr (RT == 3) {
        // nvcc leaves this loop rolled at three rows a lane; unrolled four
        // times, a step of the masked bi layer at B = 64 (R = 10) takes
        // ~23% less on an H100, with the same bits
#pragma unroll 4
        for (int k = 0; k < H; k += 4) k_group(k);
      } else {
        for (int k = 0; k < H; k += 4) k_group(k);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (i < rows) store_cols<C>(gates + ro[i] * kCols + col0, acc[i]);
    }
    __syncthreads();  // every gate of the tile is in shared memory

    float* h_next = h_s + (cur ^ 1) * R * H;
    float* yt = d.ys + static_cast<size_t>(t) * B * H;
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      if (item >= R * kUnits) continue;
      const int r = item / kUnits, u = item % kUnits, b = b0 + r;
      float* gr = gates + r * kCols + u;
      const float i = sigmoid(gr[0]);
      const float f = sigmoid(gr[kUnits]);
      const float g = tanhf(gr[2 * kUnits]);
      const float o = sigmoid(gr[3 * kUnits]);
      // f*c + i*g with the rounding nvcc gives it in multicell_scan.cu
      // (f*c rounded, then one FMA), written out: left to the compiler it
      // contracts the other product in some instantiations of this kernel
      const float c_new = fmaf(i, g, __fmul_rn(f, c[p]));
      const float h_new = o * tanhf(c_new);
      float h = h_new, y = h_new;
      if constexpr (kMasked) {
        c[p] = blend(m[p], c_new, c[p]);
        h = blend(m[p], h_new, h_s[cur * R * H + r * H + unit0 + u]);
        y = __fmul_rn(m[p], h_new);  // exactly zero at a masked step
        m[p] = mn[p];
      } else {
        c[p] = c_new;
      }
      if (b < B) yt[static_cast<size_t>(b) * H + unit0 + u] = y;
      // the new h of this unit, into the next h buffer of every CTA
      for (int q = 0; q < n_cta; ++q)
        cluster.map_shared_rank(h_next, q)[r * H + unit0 + u] = h;
      // the next step's x_proj into this (row, unit)'s gate slots
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) gr[gi * kUnits] = xn[p][gi];
    }
    // h_t and x_proj[t+1] are in place everywhere, and nobody reads h_{t-1}
    // any more
    cluster.sync();
    cur ^= 1;
  }

#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int r = item / kUnits, u = item % kUnits, b = b0 + r;
    if (item < R * kUnits && b < B) {
      d.h_t[static_cast<size_t>(b) * H + unit0 + u] =
          h_s[cur * R * H + r * H + unit0 + u];
      d.c_t[static_cast<size_t>(b) * H + unit0 + u] = c[p];
      if constexpr (kMasked)  // the steps past the tile's last valid one
        for (int t = t_end; t < T; ++t)
          d.ys[(static_cast<size_t>(t) * B + b) * H + unit0 + u] = 0.0f;
    }
  }
}

template <int RT, int C>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_kernel(Dir d0, Dir d1, int T, int B, int H, int R) {
  scan_body<RT, C, false>(blockIdx.y == 0 ? d0 : d1, nullptr, T, B, H, R);
}

template <int RT, int C>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_masked_kernel(Dir d0, Dir d1, const float* __restrict__ mask,
                        int T, int B, int H, int R) {
  scan_body<RT, C, true>(blockIdx.y == 0 ? d0 : d1, mask, T, B, H, R);
}

template <int RT, int C>
cudaError_t scan_rows(const Dir& d0, const Dir& d1, int n_dir, int T, int B,
                      int H, int R, cudaStream_t stream) {
  return launch_clusters(lstm_scan_kernel<RT, C>, scan_smem_bytes(H, R), B,
                         H, R, n_dir, stream, d0, d1, T, B, H, R);
}

template <int RT, int C>
cudaError_t masked_rows(const Dir& d0, const Dir& d1, const float* mask,
                        int n_dir, int T, int B, int H, int R,
                        cudaStream_t stream) {
  return launch_clusters(lstm_scan_masked_kernel<RT, C>,
                         scan_smem_bytes(H, R), B, H, R, n_dir, stream, d0,
                         d1, mask, T, B, H, R);
}

template <int RT, int C>
cudaError_t max_clusters_rows(int H, int R, int* out) {
  return max_clusters(lstm_scan_kernel<RT, C>, scan_smem_bytes(H, R), H,
                      out);
}

template <int RT, int C>
cudaError_t masked_max_clusters_rows(int H, int R, int* out) {
  return max_clusters(lstm_scan_masked_kernel<RT, C>, scan_smem_bytes(H, R),
                      H, out);
}

}  // namespace

// Dispatch a scan of `rows` rows per cluster on its rows per
// lane RT = ceil(rows / 4) and columns per lane C: one column at two rows
// or fewer, where a step is a chain of latencies and four warps per row
// shorten it; else four, so that each h read feeds four FMAs. Rows
// outside [1, kMaxRows] are refused with cudaErrorInvalidValue.
#define LSTM_SCAN_ROWS(rows, CALL)                                     \
  if (rows < 1 || rows > kMaxRows)                                     \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  if (rows <= 2) return static_cast<int>(CALL(1, 1));                  \
  switch ((rows + kGroups - 1) / kGroups) {                            \
    case 1: return static_cast<int>(CALL(1, 4));                       \
    case 2: return static_cast<int>(CALL(2, 4));                       \
    case 3: return static_cast<int>(CALL(3, 4));                       \
    case 4: return static_cast<int>(CALL(4, 4));                       \
    case 5: return static_cast<int>(CALL(5, 4));                       \
    case 6: return static_cast<int>(CALL(6, 4));                       \
    case 7: return static_cast<int>(CALL(7, 4));                       \
    case 8: return static_cast<int>(CALL(8, 4));                       \
    case 9: return static_cast<int>(CALL(9, 4));                       \
    default: return static_cast<int>(CALL(10, 4));                     \
  }
static_assert(kMaxRowsPerLane == 10, "LSTM_SCAN_ROWS cases");

extern "C" {

// The caller guarantees: float32, contiguous, T >= 1, B >= 1,
// H a multiple of 32 in [32, 256], all pointers on the current device;
// for the masked entries, mask is [T, B]. `rows` is the batch rows per
// cluster (the wrapper's `scan_geometry`).
int lstm_scan_f32(const float* x_proj, const float* w_hh, const float* h0,
                  const float* c0, float* ys, float* h_t, float* c_t,
                  int T, int B, int H, int rows, void* stream) {
  const Dir d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
#define SCAN(RT, C) \
  scan_rows<RT, C>(d, d, 1, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_f32(const float* x_proj_f, const float* x_proj_b,
                    const float* w_hh_f, const float* w_hh_b,
                    const float* h0_f, const float* c0_f,
                    const float* h0_b, const float* c0_b,
                    float* ys_f, float* ys_b,
                    float* h_f, float* c_f, float* h_b, float* c_b,
                    int T, int B, int H, int rows, void* stream) {
  const Dir f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
#define SCAN(RT, C) \
  scan_rows<RT, C>(f, b, 2, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

// The clusters of the full-length scan at (H, rows) that the current
// device holds at once, into *out.
int lstm_scan_max_clusters(int H, int rows, int* out) {
#define MAXC(RT, C) max_clusters_rows<RT, C>(H, rows, out)
  LSTM_SCAN_ROWS(rows, MAXC)
#undef MAXC
}

// The clusters of the masked scan at (H, rows) that the current device
// holds at once, into *out.
int lstm_scan_masked_max_clusters(int H, int rows, int* out) {
#define MAXC(RT, C) masked_max_clusters_rows<RT, C>(H, rows, out)
  LSTM_SCAN_ROWS(rows, MAXC)
#undef MAXC
}

int lstm_scan_masked_f32(const float* x_proj, const float* w_hh,
                         const float* h0, const float* c0, const float* mask,
                         float* ys, float* h_t, float* c_t,
                         int T, int B, int H, int rows, void* stream) {
  const Dir d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
#define SCAN(RT, C)                                                \
  masked_rows<RT, C>(d, d, mask, 1, T, B, H, rows,                 \
                     static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_masked_f32(const float* x_proj_f, const float* x_proj_b,
                           const float* w_hh_f, const float* w_hh_b,
                           const float* h0_f, const float* c0_f,
                           const float* h0_b, const float* c0_b,
                           const float* mask,
                           float* ys_f, float* ys_b,
                           float* h_f, float* c_f, float* h_b, float* c_b,
                           int T, int B, int H, int rows, void* stream) {
  const Dir f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
#define SCAN(RT, C)                                                \
  masked_rows<RT, C>(f, b, mask, 2, T, B, H, rows,                 \
                     static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// LSTM layer scans for Hopper (sm_90a), float32 or bf16 I/O.
//
// Replaces three TPU kernels of mobileposer_tpu/ops/lstm_pallas.py, each
// in both of their I/O dtypes (float32: the *_f32 entries; bf16: the
// *_bf16 entries, with the float32 carry and sums of scan_body.cuh):
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
// Full-length design (the body is scan_body.cuh, which multicell_scan.cu
// runs too). The TPU keeps w_hh and the carry in VMEM across its
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
//     adds h[k] * w[k][col] with fmaf for k = 0 .. H-1, the order of the
//     block-per-tile kernel this replaces; multicell_scan.cu runs the same
//     body, so forward(backend='fused') stays bit-identical to 'auto'. The
//     lanes of a warp share their rows, so h is read as broadcast float4s;
//     past the group's last row a lane repeats that row and stores nothing,
//     so the k loop has no branch.
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
// bf16 I/O (the *_bf16 entries): the same instantiations over
// __nv_bfloat16 tensors, the same geometry (rows per cluster from the
// wrapper's float32 residency query: the shared memory and the threads
// are the same), the same products and the same order of summation, so
// forward(backend='fused') stays bit-identical to 'auto' in bf16 too.
// w_hh is widened to float32 once, into the same shared-memory slice;
// x_proj, the mask, h0 and c0 as they are read; h is rounded to bf16 where
// it is pushed to the h buffers (scan_body.cuh says why that gives the
// TPU kernel's products), and ys, h_T and c_T are rounded to bf16 where
// they are stored. The carry stays float32 in registers; the masked body
// keeps each item's float32 h beside c for the hold of a masked step.
// Holding w_hh as bf16 in shared memory (half the slice) is later work.
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

#include "scan_body.cuh"

namespace {

constexpr int kGroups = 4;                 // row groups of the products
constexpr int kMaxRowsPerLane = 10;        // RT templates 1 .. 10
constexpr int kMaxRows = kGroups * kMaxRowsPerLane;

// The layer scans' group is the whole cluster: CTA rank c owns the units
// [32c, 32c + 32) of the cluster's batch tile
__device__ __forceinline__ Group whole_cluster(int H, int R) {
  const int n_cta = H / kUnits;
  return Group{static_cast<int>(cg::this_cluster().block_rank()), 0,
               static_cast<int>(blockIdx.x / n_cta) * R};
}

template <int RT, int C, class IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_kernel(Dir<IO> d0, Dir<IO> d1, int T, int B, int H, int R) {
  scan_body<RT, C, kGroups, false, false, IO>(
      blockIdx.y == 0 ? d0 : d1, nullptr, T, B, H, R, whole_cluster(H, R),
      4 * static_cast<size_t>(H));
}

template <int RT, int C, class IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_masked_kernel(Dir<IO> d0, Dir<IO> d1, const IO* __restrict__ mask,
                        int T, int B, int H, int R) {
  scan_body<RT, C, kGroups, true, false, IO>(
      blockIdx.y == 0 ? d0 : d1, mask, T, B, H, R, whole_cluster(H, R),
      4 * static_cast<size_t>(H));
}

template <int RT, int C, class IO>
cudaError_t scan_rows(const Dir<IO>& d0, const Dir<IO>& d1, int n_dir, int T,
                      int B, int H, int R, cudaStream_t stream) {
  return launch_clusters(lstm_scan_kernel<RT, C, IO>,
                         scan_smem_bytes(H, R, 2), B, H, R, n_dir, stream,
                         d0, d1, T, B, H, R);
}

template <int RT, int C, class IO>
cudaError_t masked_rows(const Dir<IO>& d0, const Dir<IO>& d1, const IO* mask,
                        int n_dir, int T, int B, int H, int R,
                        cudaStream_t stream) {
  return launch_clusters(lstm_scan_masked_kernel<RT, C, IO>,
                         scan_smem_bytes(H, R, 2), B, H, R, n_dir, stream,
                         d0, d1, mask, T, B, H, R);
}

// residency of the float32 instantiations: the bf16 ones have the same
// threads, the same shared memory and one CTA an SM (the geometry is the
// same for both dtypes)
template <int RT, int C>
cudaError_t max_clusters_rows(int H, int R, int* out) {
  return max_clusters(lstm_scan_kernel<RT, C, float>,
                      scan_smem_bytes(H, R, 2), H, out);
}

template <int RT, int C>
cudaError_t masked_max_clusters_rows(int H, int R, int* out) {
  return max_clusters(lstm_scan_masked_kernel<RT, C, float>,
                      scan_smem_bytes(H, R, 2), H, out);
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

// The caller guarantees (all entries): float32 (the *_f32 entries) or
// bf16 (the *_bf16 entries), contiguous, T >= 1, B >= 1,
// H a multiple of 32 in [32, 256], all pointers on the current device;
// for the masked entries, mask is [T, B]. `rows` is the batch rows per
// cluster (the wrapper's `scan_geometry`).
int lstm_scan_f32(const float* x_proj, const float* w_hh, const float* h0,
                  const float* c0, float* ys, float* h_t, float* c_t,
                  int T, int B, int H, int rows, void* stream) {
  const Dir<float> d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
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
  const Dir<float> f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir<float> b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
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
  const Dir<float> d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
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
  const Dir<float> f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir<float> b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
#define SCAN(RT, C)                                                \
  masked_rows<RT, C>(f, b, mask, 2, T, B, H, rows,                 \
                     static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

// The bf16-I/O entries: the float32 entries' contract with x_proj,
// w_hh, h0, c0 and the outputs in bf16 (__nv_bfloat16, raw bits), the
// carry and the sums float32 (scan_body.cuh). The masked ones take the
// mask [T, B] in bf16, the I/O dtype, as the TPU kernel does.
typedef __nv_bfloat16 bf16;

int lstm_scan_bf16(const bf16* x_proj, const bf16* w_hh, const bf16* h0,
                   const bf16* c0, bf16* ys, bf16* h_t, bf16* c_t,
                   int T, int B, int H, int rows, void* stream) {
  const Dir<bf16> d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
#define SCAN(RT, C) \
  scan_rows<RT, C>(d, d, 1, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_bf16(const bf16* x_proj_f, const bf16* x_proj_b,
                     const bf16* w_hh_f, const bf16* w_hh_b,
                     const bf16* h0_f, const bf16* c0_f,
                     const bf16* h0_b, const bf16* c0_b,
                     bf16* ys_f, bf16* ys_b,
                     bf16* h_f, bf16* c_f, bf16* h_b, bf16* c_b,
                     int T, int B, int H, int rows, void* stream) {
  const Dir<bf16> f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir<bf16> b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
#define SCAN(RT, C) \
  scan_rows<RT, C>(f, b, 2, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

int lstm_scan_masked_bf16(const bf16* x_proj, const bf16* w_hh,
                          const bf16* h0, const bf16* c0, const bf16* mask,
                          bf16* ys, bf16* h_t, bf16* c_t,
                          int T, int B, int H, int rows, void* stream) {
  const Dir<bf16> d{x_proj, w_hh, h0, c0, ys, h_t, c_t};
#define SCAN(RT, C)                                                \
  masked_rows<RT, C>(d, d, mask, 1, T, B, H, rows,                 \
                     static_cast<cudaStream_t>(stream))
  LSTM_SCAN_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_masked_bf16(const bf16* x_proj_f, const bf16* x_proj_b,
                            const bf16* w_hh_f, const bf16* w_hh_b,
                            const bf16* h0_f, const bf16* c0_f,
                            const bf16* h0_b, const bf16* c0_b,
                            const bf16* mask,
                            bf16* ys_f, bf16* ys_b,
                            bf16* h_f, bf16* c_f, bf16* h_b, bf16* c_b,
                            int T, int B, int H, int rows, void* stream) {
  const Dir<bf16> f{x_proj_f, w_hh_f, h0_f, c0_f, ys_f, h_f, c_f};
  const Dir<bf16> b{x_proj_b, w_hh_b, h0_b, c0_b, ys_b, h_b, c_b};
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

// Multicell LSTM scan for Hopper (sm_90a), float32 or bf16 I/O
// (multicell_scan_f32, multicell_scan_bf16).
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
// With bf16 I/O, x_proj, w_hh, h0, c0 and the outputs are bf16 and h is
// cast to bf16 before the product (multicell_pallas.py:62), as in the
// layer scans' bf16 entries: the same body (scan_body.cuh) in its bf16
// instantiation, so each cell gives their bits in bf16 too.
//
// Design. The TPU kernel advances the five cells one after another inside
// one grid step, because one TPU core runs one thing at a time. Here one
// launch of thread-block clusters runs the cells side by side, each cell
// on the float cluster body of the layer scans (scan_body.cuh, lstm_scan.cu
// says how a step runs): a group of n_i = H_i / 32 CTAs holds the cell's
// w_hh in shared memory, one [H_i, 128] slice a CTA, for all T steps, and
// exchanges h through distributed shared memory.
//   * A cluster has N = max_i H_i / 32 CTAs (8 for the trio) and belongs
//     to one cell. A cluster of a narrower cell runs G_i = N / n_i
//     independent groups (4 of 2 CTAs at H = 64), each with its own batch
//     tile of R rows, pushing h only inside its group. Where n_i does not
//     divide N (H = 96 or 160 beside 256) the N - G_i n_i spare CTAs run
//     no rows and pass the same cluster barriers (scan_idle): every CTA of
//     a cluster reaches every cluster barrier.
//   * The cells' clusters follow one another in the grid, widest cell
//     first; a cluster finds its cell from its index. Cell i takes
//     ceil(B / (R G_i)) clusters. R, the batch rows of a group, is one
//     for all cells (one template instantiation a launch) and comes from
//     the wrapper (multicell_cuda.multicell_geometry), with the h layout
//     below. Every CTA has the widest cell's shared memory.
//   * The products run in sixteen row groups of one warp, every warp of
//     the CTA (four columns a lane, RT = ceil(R / 16) <= 4 rows), not the
//     layer scans' four: with four the body spills from RT = 8 on under
//     the 128 registers a thread of 512 has, and a step at R = 39 took
//     ~21 us against the layer scans' ~14.6; with eight, RT = 8 at R = 64
//     still spills. With sixteen the k loop is unrolled twice and the next
//     step's x_proj fetched after the products (scan_body.cuh): ~0.97 ms
//     for the trio at B = 256 against ~1.05 rolled and ~1.11 with eight
//     row groups rolled (H100, scan_variants.py --multicell). At R <= 2
//     it keeps the layer scans' one column a lane in four groups.
//   * Order: each gate starts at x_proj and adds h[k] * w[k][col] with
//     fmaf for k ascending, and the cell update is the one written out in
//     scan_body.cuh: the body of lstm_scan_f32 and bilstm_scan_f32, so
//     each cell computes bit for bit what the per-module kernels compute
//     for it, at any R and any row groups (forward(backend='fused')
//     equals 'auto').
//   * Two h layouts, chosen per launch by the wrapper. Double-buffered h
//     (h_buffers = 2, the layer scans' layout): one cluster barrier a
//     step, but R <= 39 at H = 256, so the trio at B = 256 needs 3 x 7 +
//     2 x 2 = 25 clusters of 8 where an H100 holds 15: two waves.
//     Single-buffered (h_buffers = 1): R <= 64 fits, and the trio at
//     B = 256 one wave (3 x 4 + 2 x 1), at a second cluster barrier a step
//     (scan_body.cuh). The wrapper takes the double-buffered layout with
//     the fewest rows at which every cluster is resident at once, else
//     the single-buffered one likewise, else the single-buffered one at
//     the most rows that fit (waves). Double-buffered takes at most 48
//     rows (RT = 4 spills there; single-buffered it does not). Timed
//     against each other on an H100 (scan_variants.py --multicell,
//     PERF.md): at B = 256 the one wave is the faster (0.97 against 1.35
//     ms), at B = 8 (one wave either way) the one barrier (0.14 against
//     0.17).
//
// What bounds it on this card (worked out from the shapes, not measured):
// at T=45, B=256 and H=(256, 256, 64, 64, 256) the recurrent products are
// 2*B*T*sum_i 4H_i^2 = 18.9 GFLOP, 0.28 ms at 67 TFLOP/s float32 outside
// the tensor cores; the bytes (x_proj, w_hh, the carries, ys, each once)
// are ~215 MB, 0.064 ms at 3.35 TB/s. So operations bound it. A step is
// the layer scans' step (products from shared memory, the cell update,
// the cluster barrier), so the launch takes about as long as the most
// rows a CTA runs, times the waves.

#include "scan_body.cuh"

namespace {

constexpr int kMaxCells = 8;
constexpr int kGroups = 16;           // row groups (product warps) at C = 4
constexpr int kMaxRowsPerLane = 4;    // RT templates 1 .. 4
constexpr int kMaxRows = kGroups * kMaxRowsPerLane;
// double-buffered h takes RT <= 3 (48 rows): at RT = 4 it spills
constexpr int kMaxDoubleRowsPerLane = 3;
constexpr int kMaxDoubleRows = kGroups * kMaxDoubleRowsPerLane;

template <class IO>
struct Cell {
  Dir<IO> d;   // x_proj at the cell's feature offset
  int H;
  int first;   // the cell's first cluster in the grid
};

template <class IO>
struct Cells {
  Cell<IO> cell[kMaxCells];  // widest first
  int n;                 // cells
  int ctas;              // CTAs per cluster: the widest H / 32
  int width;             // x_proj's row: sum_i 4H_i floats
};

template <int RT, int C, int G, bool kSingleH, class IO>
__global__ void __launch_bounds__(kThreads, 1)
multicell_scan_kernel(const __grid_constant__ Cells<IO> cells, int T, int B,
                      int R) {
  const int k = blockIdx.x / cells.ctas;  // this cluster
  int i = 0;
  while (i + 1 < cells.n && k >= cells.cell[i + 1].first) ++i;
  const Cell<IO>& cell = cells.cell[i];
  const int n = cell.H / kUnits, groups = cells.ctas / n;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int g = rank / n;
  if (g >= groups) {  // a spare CTA: no rows, the same barriers
    scan_idle<kSingleH>(T);
    return;
  }
  scan_body<RT, C, G, false, kSingleH, IO>(
      cell.d, nullptr, T, B, cell.H, R,
      Group{rank % n, g * n, ((k - cell.first) * groups + g) * R},
      static_cast<size_t>(cells.width));
}

// shared memory per CTA: the widest cell's
size_t multicell_smem(const int* hidden, int n_cells, int R, int h_bufs) {
  size_t smem = 0;
  for (int i = 0; i < n_cells; ++i) {
    const size_t s = scan_smem_bytes(hidden[i], R, h_bufs);
    smem = s > smem ? s : smem;
  }
  return smem;
}

template <int RT, int C, int G, class IO>
cudaError_t multicell_rows(const Cells<IO>& cells, int clusters, size_t smem,
                           int T, int B, int R, int h_bufs,
                           cudaStream_t stream) {
  if (h_bufs == 1)
    return launch_cluster_grid(multicell_scan_kernel<RT, C, G, true, IO>,
                               smem, cells.ctas, clusters, 1, stream, cells,
                               T, B, R);
  if constexpr (RT > kMaxDoubleRowsPerLane) {
    return cudaErrorInvalidValue;
  } else {
    return launch_cluster_grid(multicell_scan_kernel<RT, C, G, false, IO>,
                               smem, cells.ctas, clusters, 1, stream, cells,
                               T, B, R);
  }
}

// residency of the float32 instantiations (the bf16 ones have the same
// threads and shared memory)
template <int RT, int C, int G>
cudaError_t multicell_max_clusters_rows(size_t smem, int max_h, int h_bufs,
                                        int* out) {
  if (h_bufs == 1)
    return max_clusters(multicell_scan_kernel<RT, C, G, true, float>, smem,
                        max_h, out);
  if constexpr (RT > kMaxDoubleRowsPerLane) {
    return cudaErrorInvalidValue;
  } else {
    return max_clusters(multicell_scan_kernel<RT, C, G, false, float>, smem,
                        max_h, out);
  }
}

// hidden sizes each a multiple of 32 in [32, 256]; the widest
int widest(const int* hidden, int n_cells) {
  int max_h = 0;
  for (int i = 0; i < n_cells; ++i) {
    const int H = hidden[i];
    if (H < 32 || H > 256 || H % 32) return -1;
    max_h = H > max_h ? H : max_h;
  }
  return max_h;
}

}  // namespace

// Dispatch on the rows per lane RT, the columns per lane C and the row
// groups G: at two rows or fewer the layer scans' one column a lane in
// four groups of four warps (a step is a chain of latencies); else four
// columns a lane in sixteen groups of one warp, RT = ceil(rows / 16) (see
// the design note). Rows outside [1, kMaxRows] are refused with
// cudaErrorInvalidValue.
#define MULTICELL_ROWS(rows, CALL)                                     \
  if (rows < 1 || rows > kMaxRows)                                     \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  if (rows <= 2) return static_cast<int>(CALL(1, 1, 4));               \
  switch ((rows + kGroups - 1) / kGroups) {                            \
    case 1: return static_cast<int>(CALL(1, 4, kGroups));              \
    case 2: return static_cast<int>(CALL(2, 4, kGroups));              \
    case 3: return static_cast<int>(CALL(3, 4, kGroups));              \
    default: return static_cast<int>(CALL(4, 4, kGroups));             \
  }
static_assert(kMaxRowsPerLane == 4, "MULTICELL_ROWS cases");

namespace {

// One launch of the multicell scan over IO tensors (the entries below).
template <class IO>
int multicell_scan(const IO* x_proj, const IO* const* w_hh,
                   const IO* const* h0, const IO* const* c0, IO* const* ys,
                   IO* const* h_t, IO* const* c_t, const int* hidden,
                   int n_cells, int T, int B, int rows, int h_buffers,
                   void* stream) {
  if (n_cells < 1 || n_cells > kMaxCells || T < 1 || B < 1 || rows < 1
      || rows > (h_buffers == 2 ? kMaxDoubleRows : kMaxRows)
      || (h_buffers != 1 && h_buffers != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_h = widest(hidden, n_cells);
  if (max_h < 0) return static_cast<int>(cudaErrorInvalidValue);
  int order[kMaxCells], offs[kMaxCells];
  int width = 0;
  for (int i = 0; i < n_cells; ++i) {
    order[i] = i;
    offs[i] = width;
    width += 4 * hidden[i];
  }
  // widest cells first (stable)
  for (int i = 1; i < n_cells; ++i)
    for (int k = i; k > 0 && hidden[order[k]] > hidden[order[k - 1]]; --k) {
      const int tmp = order[k];
      order[k] = order[k - 1];
      order[k - 1] = tmp;
    }
  Cells<IO> cells{};
  cells.n = n_cells;
  cells.ctas = max_h / kUnits;
  cells.width = width;
  int clusters = 0;
  for (int s = 0; s < n_cells; ++s) {
    const int i = order[s], H = hidden[i];
    const int per = rows * (cells.ctas / (H / kUnits));  // rows a cluster
    cells.cell[s] = Cell<IO>{Dir<IO>{x_proj + offs[i], w_hh[i], h0[i], c0[i],
                                     ys[i], h_t[i], c_t[i]},
                             H, clusters};
    clusters += (B + per - 1) / per;
  }
  const size_t smem = multicell_smem(hidden, n_cells, rows, h_buffers);
#define SCAN(RT, C, G)                                                 \
  multicell_rows<RT, C, G, IO>(cells, clusters, smem, T, B, rows,      \
                               h_buffers, static_cast<cudaStream_t>(stream))
  MULTICELL_ROWS(rows, SCAN)
#undef SCAN
}

}  // namespace

extern "C" {

// n_cells cells; the pointer arrays and `hidden` are host arrays of
// n_cells entries, in the caller's cell order (x_proj's feature order).
// The caller guarantees: float32 (multicell_scan_f32) or bf16
// (multicell_scan_bf16), contiguous, T >= 1, B >= 1,
// 1 <= n_cells <= 8, each H a multiple of 32 in [32, 256], all pointers on
// the current device. `rows` is the batch rows of a group and `h_buffers`
// the h layout, 2 (rows <= 48) or 1 (rows <= 64)
// (multicell_cuda.multicell_geometry). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments outside that range).
int multicell_scan_f32(const float* x_proj, const float* const* w_hh,
                       const float* const* h0, const float* const* c0,
                       float* const* ys, float* const* h_t,
                       float* const* c_t, const int* hidden, int n_cells,
                       int T, int B, int rows, int h_buffers, void* stream) {
  return multicell_scan(x_proj, w_hh, h0, c0, ys, h_t, c_t, hidden, n_cells,
                        T, B, rows, h_buffers, stream);
}

int multicell_scan_bf16(const __nv_bfloat16* x_proj,
                        const __nv_bfloat16* const* w_hh,
                        const __nv_bfloat16* const* h0,
                        const __nv_bfloat16* const* c0,
                        __nv_bfloat16* const* ys, __nv_bfloat16* const* h_t,
                        __nv_bfloat16* const* c_t, const int* hidden,
                        int n_cells, int T, int B, int rows, int h_buffers,
                        void* stream) {
  return multicell_scan(x_proj, w_hh, h0, c0, ys, h_t, c_t, hidden, n_cells,
                        T, B, rows, h_buffers, stream);
}

// The clusters of the multicell scan over cells of these hidden sizes at
// `rows` in the h layout `h_buffers` that the current device holds at
// once, into *out.
int multicell_scan_max_clusters(const int* hidden, int n_cells, int rows,
                                int h_buffers, int* out) {
  if (n_cells < 1 || n_cells > kMaxCells
      || (h_buffers != 1 && h_buffers != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_h = widest(hidden, n_cells);
  if (max_h < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = multicell_smem(hidden, n_cells, rows, h_buffers);
#define MAXC(RT, C, G) \
  multicell_max_clusters_rows<RT, C, G>(smem, max_h, h_buffers, out)
  MULTICELL_ROWS(rows, MAXC)
#undef MAXC
}

const char* multicell_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// LSTM layer scans for TRAINING on Hopper (sm_90a), float32 or bf16 I/O
// (float32 arithmetic), with the residuals in float32 or bf16.
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
// and their residual_dtype=bfloat16 variant (backend='auto_train_bf16res',
// lstm_train_pallas.py:79-82, :153-163, :184-186), the same kernels
// instantiated on a bf16 residual type Res:
//   lstm_train_fwd_bf16res, lstm_train_bwd_bf16res, lstm_train_dw_bf16res.
// The arithmetic is the float32 one: the forward stores acts, hseq and
// cseq rounded to bf16 (nearest even, as XLA's astype) and leaves ys, h_T,
// c_T and its float32 carry as they are; the backward scan reads acts,
// c_new and c_prev as bf16 and widens each where it is used (widening it
// right after the load, which the next step's prefetch issues early, would
// make the step wait for the load); the dW kernel takes h_prev in bf16
// through its copy ring and widens each stage once, in shared memory.
// Widening is exact, so a bf16res entry gives the f32 entry's bits on the
// widened residuals. The scans' shared memory, the w_hh slice included,
// stays float32: their geometry and residency are the f32 entries'.
//
// Training on bf16 params runs the same two scans on the I/O type IO
// (the forward reads w_hh in it too) and the backward on w_hh's type W,
// as the TPU kernels take them (lstm_train_pallas.py:50-87, :136-199;
// each residual type as above):
//   lstm_train_{fwd,bwd}_bf16[_bf16res]  IO = W = bf16: a bf16 input to
//       the layer (x_proj = x @ w_ih + b in bf16);
//   lstm_train_bwd_wbf16[_bf16res]       IO = float32, W = bf16: a
//       float32 input on bf16 params, which JAX promotes (x_proj, ys,
//       the carry and the gradients float32, w_hh bf16). Its forward
//       rounds nothing, so it is the f32 (bf16res) entry on w_hh
//       widened by the wrapper; only the backward depends on W, through
//       the dgates rounding.
// Every value read is widened (exact); the carry (h, c), the gates, the
// sums and (dh, dc) stay float32, as in the f32 entries. The forward
// rounds h to IO once, when it pushes it to the h buffers the products
// read (`dot(h.astype(x.dtype), w_hh)`, :63-64): with bf16 I/O each cell
// item keeps its float32 h in a register for the masked blend, for hseq
// and for h_T, and rounds ys, h_T and c_T to bf16 as it stores them. The
// backward rounds dgates to W before the dh product (`dgates.astype(
// w_hh.dtype)`, :188-190) and writes dx_proj, dh0 and dc0 in IO; dw_hh
// sums the UNROUNDED float32 dgates (:184-186), so the bf16-I/O entries
// also write them, float32, to `dgates`, which the dW entries read as
// they read the f32 entry's dx_proj (the wbf16 entry's dx_proj is that
// float32 buffer). A product of two bf16 values is exact in float32, so
// the products are the TPU kernels' and only the order of the float32
// sums is this kernel's, the f32 entries' order: on bf16-exact inputs
// with the roundings left out an entry gives the f32 entry's bits.
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
// Design. The TPU kernels keep w_hh (and the backward's w_hh^T) in VMEM
// for the whole time grid; here w_hh stays in the shared memory of a
// thread-block cluster for all T steps. A cluster of n = H / 32 CTAs owns
// R batch rows (R in {1, 2, 4, 8, 12, 16, 18, 20, 24, 32}, chosen by the
// wrapper so that ceil(B / R) clusters run in one wave: an H100 holds 15
// clusters of 8 such CTAs, so B = 256 at H = 256 takes R = 18); CTA c
// owns the hidden units [32c, 32c + 32) and their 128 gate columns
// g*H + 32c + u, and loads the slice w_hh[:, those columns] (H x 128
// floats, 128 KiB at H = 256) into its shared memory once per launch.
// Both kernels read that same slice, so the backward needs no transpose
// of w_hh.
//   * forward step: the CTA's 512 threads compute its 128 gate columns
//     for the R rows, x_proj + h_{t-1} @ w_slice, the k sum split four
//     ways (two ways above R = 16, where the rows split in two) and summed
//     in shared memory in a fixed order; then one thread per (row, unit)
//     does the cell update, writes ys, acts, hseq and cseq (128-byte runs
//     per warp) and pushes its h to the double-buffered h of EVERY CTA
//     of the cluster through distributed shared memory; one cluster
//     barrier per step. The blend is rounded as written (__fmul_rn /
//     __fadd_rn, no FMA) so ys is exactly zero at a masked step and the
//     carry rounds as the TPU kernel's does.
//   * backward step: one thread per (row, unit) computes its dgates (to
//     dx_proj and to shared memory), then the CTA computes the PARTIAL
//     dh = dgates_slice @ w_slice^T over its 128 columns for all H
//     inputs and reduce-scatters it: each piece goes to slot [c] of its
//     owner's double-buffered shared memory, and after the cluster
//     barrier the owner sums the n slots in the fixed order c = 0..n-1,
//     so dh0 (and dW) are the same from run to run. dgates are never
//     gathered whole (that would move 4x the bytes).
//   * Residual loads (x_proj and the mask forward; acts, c, dy and the
//     mask backward) for step t+1 are issued before step t's products, so
//     their latency hides behind them.
//   * w_slice is stored [k][128] with its float4 groups XOR-swizzled by
//     k % 8: the forward's warps read one k across 32 columns and the
//     backward's one float4 of columns across 32 consecutive k, and both
//     hit 32 distinct banks.
//   * dW: the [H, 4H] sum over T*B rows does not fit a CTA beside the
//     slice of w_hh (256 KiB at H = 256), and CTAs cannot share an
//     accumulator, so a second kernel computes it as a float32 product on
//     the CUDA cores (TF32 would not hold dW to 1e-5 of its largest
//     entry). Both operands, h_prev [N, H] and dgates [N, 4H], are
//     row-major with the summed index N = T*B outermost, so a stage of
//     kDwK rows of either is a contiguous block that goes to shared memory
//     as it is. A block of 256 threads owns a 128 x 128 tile of dw_hh (64
//     x 128 where H = 64 or 160 would leave half a 128-row tile idle) for
//     one contiguous slab of rows; each thread owns 8 x 8 outputs (4 x 8 in
//     the 64-row tile) as 4 x 4 sub-tiles 64 rows and 64 columns apart, so
//     that its shared-memory reads are float4s that no two lanes of a
//     quarter warp take from one bank. The stages come through a ring of
//     kDwStages buffers filled by cp.async (16-byte copies, the tail past
//     the slab zero-filled through the copy's source size), with one
//     __syncthreads per stage; at most 128 registers a thread, so two
//     blocks share an SM. Split-K for fill: at H = 256 dw_hh has only 16
//     tiles, so the wrapper splits N into slabs (a function of the shapes
//     only) until tiles x slabs fill the card's two blocks per SM, and
//     each block writes its partial tile to slab s of a [S, H, 4H] output.
//     No atomics: the wrapper sums the slabs in a fixed order, as the TPU
//     sums its per-batch-tile slabs, and each thread sums its rows in
//     ascending order, so the result is the same from run to run.
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
// A scan is a chain of T dependent steps: a step costs its CTA's share of
// the products (R x H x 128 FMAs, read from shared memory) plus one
// cluster barrier, and the FMAs run on the CUDA cores in float32; TF32 or
// bf16 tensor cores are later work.

#include "cluster_scan.cuh"
#include "cp_async.cuh"

namespace {

// The rows of R that one backward product item covers: R / c for the
// fewest chunks c that divide R into at most 10 rows (acc registers).
constexpr int rows_per_item(int R) {
  int c = 1;
  while (R / c > 10 || R % c != 0) ++c;
  return R / c;
}

// How a CTA of R rows splits its work. Products: thread (col, ks, rs)
// sums k in its quarter (half above R = 16) for the rows of rs. Cells:
// item tid + p*kThreads is (row, unit) = (item / 32, item % 32).
template <int R>
struct Shape {
  static constexpr int kSplitK = R > 16 ? 2 : 4;
  static constexpr int kSplitR = 4 / kSplitK;
  static constexpr int kRowsPerThread = R / kSplitR;
  static constexpr int kCellsPerThread = (R * kUnits + kThreads - 1) / kThreads;
  static constexpr int kRowsPerItem = rows_per_item(R);  // backward products
  static_assert(kCols * kSplitK * kSplitR == kThreads, "thread split");
  static_assert(R % kSplitR == 0, "rows split");
};

template <int R>
constexpr size_t fwd_smem_bytes(int H) {
  // w slice, h double-buffered [2][R][H], partial gates [kSplitK][R][kCols]
  return sizeof(float) * (static_cast<size_t>(H) * kCols + 2 * R * H
                          + Shape<R>::kSplitK * R * kCols);
}

template <int R>
constexpr size_t bwd_smem_bytes(int H) {
  // w slice, dgates [R][kCols], partial dh double-buffered [2][n][R][32]
  return sizeof(float) * (static_cast<size_t>(H) * kCols + R * kCols
                          + 2 * R * H);
}

// ---------------------------------------------------------------------------
// #7 forward
// ---------------------------------------------------------------------------

// One gate column's x_proj for a thread's RT rows of one step, kept in IO
// until the products start (widening a value right after its load would
// make the step wait for the load).
template <int RT, class IO>
struct XRows {
  IO v[RT];
  // rows b_first .. of the step at `x` (x_proj + step row * 4H + column);
  // zeros past B, and everywhere unless `on`
  __device__ __forceinline__ void load(const IO* __restrict__ x, bool on,
                                       int b_first, int B, size_t H4) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
      v[i] = (on && b_first + i < B) ? __ldg(x + (b_first + i) * H4)
                                     : from_f32<IO>(0.0f);
  }
  __device__ __forceinline__ float get(int i) const { return to_f32(v[i]); }
};

// The products of the bf16-I/O forward: the f32 body's loop (the same
// sums), as a function of its own; inlined in place, the same loop made the
// bf16 instantiation at 32 rows spill more than the f32 one (ptxas -v on
// an H100 build; see kFetch).
template <int RT>
__device__ __forceinline__ void fwd_products(float (&acc)[RT], const float* hb,
                                             const float* w_s,
                                             const int (&w_off)[8],
                                             int k_begin, int kspan, int H) {
  for (int k = k_begin; k < k_begin + kspan; k += 8) {
    float w[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) w[kk] = w_s[(k + kk) * kCols + w_off[kk]];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(hb + i * H + k);
      const float4 e = *reinterpret_cast<const float4*>(hb + i * H + k + 4);
      acc[i] = fmaf(a.x, w[0], acc[i]);
      acc[i] = fmaf(a.y, w[1], acc[i]);
      acc[i] = fmaf(a.z, w[2], acc[i]);
      acc[i] = fmaf(a.w, w[3], acc[i]);
      acc[i] = fmaf(e.x, w[4], acc[i]);
      acc[i] = fmaf(e.y, w[5], acc[i]);
      acc[i] = fmaf(e.z, w[6], acc[i]);
      acc[i] = fmaf(e.w, w[7], acc[i]);
    }
  }
}

template <int R, class Res, class IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_train_fwd_kernel(const IO* __restrict__ x_proj,
                      const IO* __restrict__ w_hh,
                      const IO* __restrict__ h0,
                      const IO* __restrict__ c0,
                      const IO* __restrict__ mask,
                      IO* __restrict__ ys, Res* __restrict__ acts,
                      Res* __restrict__ hseq, Res* __restrict__ cseq,
                      IO* __restrict__ h_t, IO* __restrict__ c_t,
                      int T, int B, int H) {
  using S = Shape<R>;
  constexpr int RT = S::kRowsPerThread;
  constexpr int CPT = S::kCellsPerThread;
  // bf16 I/O: the h buffers hold h rounded to bf16, each cell item its
  // float32 h (h_own)
  constexpr bool kRoundH = !std::is_same_v<IO, float>;
  // Where a step's x_proj is fetched: the f32 body fetches the next step's
  // before the products, in flight during them (0); the bf16 one, whose
  // h_own also stays live through the products, fetches it after them, in
  // flight during the cell update and the barrier while its registers are
  // free during the products (1), and at 12 rows each step's own at the
  // step's start (2): at these places and only there no instantiation
  // spills more than the f32 body's at its rows (H100, sm_90a, ptxas -v;
  // chip_smoke.py phase 3i gates it).
  constexpr int kFetch = !kRoundH ? 0 : R == 12 ? 2 : 1;
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
  float* red = h_s + 2 * R * H;                  // [kSplitK][R][kCols]

  // products: gate column col, k in [k_begin, k_begin + kspan), rows
  // [r_begin, r_begin + RT)
  const int col = tid % kCols;
  const int ks = (tid / kCols) % S::kSplitK;
  const int r_begin = (tid / kCols) / S::kSplitK * RT;
  const int kspan = H / S::kSplitK;
  const int k_begin = ks * kspan;
  const size_t gcol = (col / kUnits) * H + unit0 + col % kUnits;
  int w_off[8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    w_off[kk] = (((col >> 2) ^ kk) << 2) | (col & 3);

  load_w_slice(w_hh, w_s, H, cta);
  for (int idx = tid; idx < R * H; idx += kThreads) {
    const int b = b0 + idx / H;
    h_s[idx] = b < B ? to_f32(h0[static_cast<size_t>(b) * H + idx % H])
                     : 0.0f;
  }
  // the next step's mask stays in IO until it is used (as x_proj does,
  // XRows)
  float c[CPT], h_own[kRoundH ? CPT : 1];
  IO m_next[CPT];
#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int b = b0 + item / kUnits;
    const bool ok = item < R * kUnits && b < B;
    c[p] = ok ? to_f32(c0[static_cast<size_t>(b) * H + unit0
                          + item % kUnits])
              : 0.0f;
    m_next[p] = ok ? __ldg(mask + b) : from_f32<IO>(0.0f);
    if constexpr (kRoundH)
      h_own[p] = ok ? to_f32(h0[static_cast<size_t>(b) * H + unit0
                                + item % kUnits])
                    : 0.0f;
  }
  // x_proj of step 0, read by the ks == 0 threads (they start the sum)
  XRows<RT, IO> xp;
  if constexpr (kFetch != 2)
    xp.load(x_proj + gcol, ks == 0, b0 + r_begin, B, H4);
  cluster.sync();  // every CTA started, w_s and h_s[0] loaded

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float acc[RT], m[CPT];
    if constexpr (kFetch == 2)
      xp.load(x_proj + static_cast<size_t>(t) * B * H4 + gcol, ks == 0,
              b0 + r_begin, B, H4);
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = xp.get(i);
#pragma unroll
    for (int p = 0; p < CPT; ++p) m[p] = to_f32(m_next[p]);
    if (t + 1 < T) {  // step t+1's residuals, in flight during the products
      const size_t row0 = static_cast<size_t>(t + 1) * B;
      if constexpr (kFetch == 0)
        xp.load(x_proj + row0 * H4 + gcol, ks == 0, b0 + r_begin, B, H4);
#pragma unroll
      for (int p = 0; p < CPT; ++p) {
        const int item = tid + p * kThreads;
        const int b = b0 + item / kUnits;
        m_next[p] = (item < R * kUnits && b < B) ? __ldg(mask + row0 + b)
                                                 : from_f32<IO>(0.0f);
      }
    }

    // partial gates += h_{t-1}[rows] @ w_slice[k range, col], eight k at
    // a time (k_begin is a multiple of 8, so k % 8 == kk)
    const float* hb = h_s + cur * R * H + r_begin * H;
    if constexpr (kRoundH) {
      fwd_products(acc, hb, w_s, w_off, k_begin, kspan, H);
    } else {
      for (int k = k_begin; k < k_begin + kspan; k += 8) {
        float w[8];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          w[kk] = w_s[(k + kk) * kCols + w_off[kk]];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(hb + i * H + k);
          const float4 e =
              *reinterpret_cast<const float4*>(hb + i * H + k + 4);
          acc[i] = fmaf(a.x, w[0], acc[i]);
          acc[i] = fmaf(a.y, w[1], acc[i]);
          acc[i] = fmaf(a.z, w[2], acc[i]);
          acc[i] = fmaf(a.w, w[3], acc[i]);
          acc[i] = fmaf(e.x, w[4], acc[i]);
          acc[i] = fmaf(e.y, w[5], acc[i]);
          acc[i] = fmaf(e.z, w[6], acc[i]);
          acc[i] = fmaf(e.w, w[7], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      red[(ks * R + r_begin + i) * kCols + col] = acc[i];
    __syncthreads();  // every partial sum is in shared memory
    if constexpr (kFetch == 1) {
      if (t + 1 < T)
        xp.load(x_proj + static_cast<size_t>(t + 1) * B * H4 + gcol,
                ks == 0, b0 + r_begin, B, H4);
    }

    const float* h_cur = h_s + cur * R * H;
    float* h_next = h_s + (cur ^ 1) * R * H;
    const size_t row0 = static_cast<size_t>(t) * B;
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      if (item >= R * kUnits) continue;
      const int r = item / kUnits, u = item % kUnits, b = b0 + r;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = red[r * kCols + g * kUnits + u];
#pragma unroll
        for (int q = 1; q < S::kSplitK; ++q)
          s += red[(q * R + r) * kCols + g * kUnits + u];
        gate[g] = s;
      }
      const float i = sigmoid(gate[0]);
      const float f = sigmoid(gate[1]);
      const float g = tanhf(gate[2]);
      const float o = sigmoid(gate[3]);
      const float c_new = f * c[p] + i * g;
      const float h_new = o * tanhf(c_new);
      c[p] = blend(m[p], c_new, c[p]);
      const float h_keep = blend(m[p], h_new, kRoundH
                                                  ? h_own[p]
                                                  : h_cur[r * H + unit0 + u]);
      if constexpr (kRoundH) h_own[p] = h_keep;
      if (b < B) {
        const size_t row = row0 + b;
        Res* a = acts + row * H4 + unit0 + u;
        a[0] = from_f32<Res>(i);
        a[H] = from_f32<Res>(f);
        a[2 * H] = from_f32<Res>(g);
        a[3 * H] = from_f32<Res>(o);
        ys[row * H + unit0 + u] = from_f32<IO>(__fmul_rn(m[p], h_new));
        hseq[row * H + unit0 + u] = from_f32<Res>(h_keep);
        cseq[row * H + unit0 + u] = from_f32<Res>(c[p]);
      }
      // the new h of this unit (rounded to IO: the products' operand),
      // into the next h buffer of every CTA
      for (int q = 0; q < n_cta; ++q)
        cluster.map_shared_rank(h_next, q)[r * H + unit0 + u] =
            round_io<IO>(h_keep);
    }
    // h_t is complete everywhere, and nobody reads h_{t-1} or the partial
    // sums any more
    cluster.sync();
    cur ^= 1;
  }

#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int r = item / kUnits, u = item % kUnits, b = b0 + r;
    if (item < R * kUnits && b < B) {
      h_t[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(
          kRoundH ? h_own[p] : h_s[cur * R * H + r * H + unit0 + u]);
      c_t[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(c[p]);
    }
  }
}

// ---------------------------------------------------------------------------
// #8 backward scan
// ---------------------------------------------------------------------------

// One (row, unit)'s residuals of one step: i, f, g, o, c_new, c_prev as
// stored (Res), dy and m as given (IO); each widened where it is used.
template <class Res, class IO>
struct Residuals {
  Res a[4], c_new, c_prev;
  IO dy, m;
};

template <class Res, class IO>
__device__ __forceinline__ void load_residuals(
    Residuals<Res, IO>& v, const Res* __restrict__ acts,
    const Res* __restrict__ c_new_seq, const Res* __restrict__ c_prev_seq,
    const IO* __restrict__ dy, const IO* __restrict__ mask, size_t row,
    int H, int unit) {
  const Res* a = acts + row * 4 * H + unit;
#pragma unroll
  for (int g = 0; g < 4; ++g) v.a[g] = __ldg(a + g * H);
  v.c_new = __ldg(c_new_seq + row * H + unit);
  v.c_prev = __ldg(c_prev_seq + row * H + unit);
  v.dy = __ldg(dy + row * H + unit);
  v.m = __ldg(mask + row);
}

// `dgates` [T, B, 4H] float32 receives the unrounded gate gradients
// with bf16 I/O (for the dW reduction) and is not touched otherwise.
template <int R, class Res, class IO, class W>
__global__ void __launch_bounds__(kThreads, 1)
lstm_train_bwd_kernel(const IO* __restrict__ dy,
                      const IO* __restrict__ dh_T,
                      const IO* __restrict__ dc_T,
                      const Res* __restrict__ acts,
                      const Res* __restrict__ c_new_seq,
                      const Res* __restrict__ c_prev_seq,
                      const W* __restrict__ w_hh,
                      const IO* __restrict__ mask,
                      IO* __restrict__ dx_proj,
                      float* __restrict__ dgates,
                      IO* __restrict__ dh0, IO* __restrict__ dc0,
                      int T, int B, int H) {
  using S = Shape<R>;
  constexpr int CPT = S::kCellsPerThread;
  constexpr int RB = S::kRowsPerItem;
  constexpr bool kBF16IO = !std::is_same_v<IO, float>;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = H / kUnits;
  const int cta = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / n_cta) * R;
  const int unit0 = cta * kUnits;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int tid = threadIdx.x;

  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);   // [H][kCols], swizzled
  float* dg_s = w_s + H * kCols;                 // [R][kCols]
  float* red = dg_s + R * kCols;                 // [2][n_cta][R][kUnits]

  load_w_slice(w_hh, w_s, H, cta);
  float dh[CPT], dc[CPT];
  Residuals<Res, IO> v[CPT];
#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int b = b0 + item / kUnits, unit = unit0 + item % kUnits;
    const bool ok = item < R * kUnits && b < B;
    dh[p] = ok ? to_f32(dh_T[static_cast<size_t>(b) * H + unit]) : 0.0f;
    dc[p] = ok ? to_f32(dc_T[static_cast<size_t>(b) * H + unit]) : 0.0f;
    if (ok)
      load_residuals(v[p], acts, c_new_seq, c_prev_seq, dy, mask,
                     static_cast<size_t>(T - 1) * B + b, H, unit);
  }
  cluster.sync();  // every CTA started, w_s loaded

  int par = 0;
  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = static_cast<size_t>(t) * B;
    float keep[CPT], dcp[CPT];
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      keep[p] = 1.0f;
      dcp[p] = 0.0f;
      if (item >= R * kUnits) continue;
      const int r = item / kUnits, u = item % kUnits, b = b0 + r;
      float* dgr = dg_s + r * kCols + u;
      if (b >= B) {
        dgr[0] = dgr[kUnits] = dgr[2 * kUnits] = dgr[3 * kUnits] = 0.0f;
        continue;
      }
      const float m = to_f32(v[p].m);
      const float i = to_f32(v[p].a[0]), f = to_f32(v[p].a[1]);
      const float g = to_f32(v[p].a[2]), o = to_f32(v[p].a[3]);
      const float tc = tanhf(to_f32(v[p].c_new));
      const float dh_new = m * (dh[p] + to_f32(v[p].dy));
      const float dc_new = m * dc[p];
      const float d_o = dh_new * tc;
      const float dc_cur = dc_new + dh_new * o * (1.0f - tc * tc);
      const float di = dc_cur * g;
      const float dg = dc_cur * i;
      const float df = dc_cur * to_f32(v[p].c_prev);
      dcp[p] = dc_cur * f;
      keep[p] = 1.0f - m;
      const float gi = di * i * (1.0f - i);
      const float gf = df * f * (1.0f - f);
      const float gg = dg * (1.0f - g * g);
      const float go = d_o * o * (1.0f - o);
      const size_t at = (row0 + b) * H4 + unit0 + u;
      IO* dx = dx_proj + at;
      dx[0] = from_f32<IO>(gi);
      dx[H] = from_f32<IO>(gf);
      dx[2 * H] = from_f32<IO>(gg);
      dx[3 * H] = from_f32<IO>(go);
      if constexpr (kBF16IO) {
        float* dgt = dgates + at;
        dgt[0] = gi;
        dgt[H] = gf;
        dgt[2 * H] = gg;
        dgt[3 * H] = go;
      }
      // the dh product's operand: dgates rounded to w_hh's type
      dgr[0] = round_io<W>(gi);
      dgr[kUnits] = round_io<W>(gf);
      dgr[2 * kUnits] = round_io<W>(gg);
      dgr[3 * kUnits] = round_io<W>(go);
      if (t > 0)  // step t-1's residuals, in flight during the products
        load_residuals(v[p], acts, c_new_seq, c_prev_seq, dy, mask,
                       row0 - B + b, H, unit0 + u);
    }
    __syncthreads();  // every row's dgates are in shared memory

    // partial dh[r][k] = dgates[r] @ w_slice[k]^T over this CTA's columns,
    // for every input k; item (rows of rc, k), k fastest so that a warp
    // shares its rows and reads 32 consecutive k
    float* red_cur = red + par * R * H;
    const int n_items = H * (R / RB);
    for (int item = tid; item < n_items; item += kThreads) {
      const int k = item % H, rc = item / H;
      const float* wrow = w_s + k * kCols;
      const float* dgr = dg_s + rc * RB * kCols;
      const int k7 = k & 7;
      float acc[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) acc[rr] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < kCols / 4; ++j) {
        const float4 w =
            *reinterpret_cast<const float4*>(wrow + ((j ^ k7) << 2));
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          const float4 d =
              *reinterpret_cast<const float4*>(dgr + rr * kCols + 4 * j);
          acc[rr] = fmaf(d.x, w.x, acc[rr]);
          acc[rr] = fmaf(d.y, w.y, acc[rr]);
          acc[rr] = fmaf(d.z, w.z, acc[rr]);
          acc[rr] = fmaf(d.w, w.w, acc[rr]);
        }
      }
      // reduce-scatter: slot [cta] of the owner of input k
      float* dst = cluster.map_shared_rank(red_cur, k / kUnits);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        dst[(cta * R + rc * RB + rr) * kUnits + k % kUnits] = acc[rr];
    }
    cluster.sync();  // every CTA's partials have arrived

#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      if (item >= R * kUnits) continue;
      const int r = item / kUnits, u = item % kUnits;
      float rec = red_cur[r * kUnits + u];
      for (int q = 1; q < n_cta; ++q) rec += red_cur[(q * R + r) * kUnits + u];
      dh[p] = keep[p] * dh[p] + rec;
      dc[p] = keep[p] * dc[p] + dcp[p];
    }
    par ^= 1;
  }

#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int b = b0 + item / kUnits, unit = unit0 + item % kUnits;
    if (item < R * kUnits && b < B) {
      dh0[static_cast<size_t>(b) * H + unit] = from_f32<IO>(dh[p]);
      dc0[static_cast<size_t>(b) * H + unit] = from_f32<IO>(dc[p]);
    }
  }
}

// ---------------------------------------------------------------------------
// #8 dW reduction: slabs[s] = h_prev[rows of s]^T @ dgates[rows of s]
// ---------------------------------------------------------------------------

constexpr int kDwThreads = 256;
constexpr int kDwTileN = 128;  // gate columns of dw_hh per block
constexpr int kDwK = 16;       // rows of h_prev and dgates per stage
constexpr int kDwStages = 3;   // stages in the cp.async ring

// A block's tile is MI x 64 rows of dw_hh (hidden inputs) by kDwTileN
// gate columns; its ring of stages in shared memory, the h_prev stages
// [kDwK][64 * MI] in the residual type Res, the dgates ones [kDwK][128]
// float32; with bf16 residuals one more h_prev stage, widened.
template <int MI, class Res>
constexpr size_t dw_smem_bytes() {
  constexpr bool kWiden = !std::is_same_v<Res, float>;
  return kDwStages * kDwK
             * (sizeof(Res) * 64 * MI + sizeof(float) * kDwTileN)
         + (kWiden ? sizeof(float) * kDwK * 64 * MI : 0);
}

// Start the copies of one stage into ring buffer `buf`: rows k0 .. k0 +
// kDwK - 1 of the block's columns, zeros for rows from k_end on and for
// columns past H. A copy moves 16 bytes: 4 float32 or 8 bf16 values of
// h_prev, so that a bf16 stage [16][64] (MI = 1) is 128 copies, one for
// half the threads. H % 8 == 0, so a copy is all in or all past H, and
// every row starts on a 64-byte boundary (a bf16 row at H = 160 is 320
// bytes, at H = 32 64).
template <int MI, class Res>
__device__ __forceinline__ void dw_load_stage(
    const Res* __restrict__ h_prev, const float* __restrict__ dgates,
    Res* a_s, float* b_s, int k0, int k_end, int m0, int n0, int H,
    int buf) {
  constexpr int BM = 64 * MI;
  constexpr int kPer = 16 / sizeof(Res);             // values per copy
  constexpr int kCopies = kDwK * BM / kPer;          // copies per stage
  Res* a = a_s + buf * kDwK * BM;
  float* b = b_s + buf * kDwK * kDwTileN;
  static_assert(kCopies % kDwThreads == 0 || kCopies < kDwThreads,
                "whole rounds of copies, or one partial round");
  static_assert(kDwK * kDwTileN / 4 % kDwThreads == 0, "whole float4s");
#pragma unroll
  for (int j = 0; j < (kCopies + kDwThreads - 1) / kDwThreads; ++j) {
    const int i = threadIdx.x + j * kDwThreads;
    if (kCopies < kDwThreads && i >= kCopies) break;
    const int kk = i / (BM / kPer), c = kPer * (i % (BM / kPer));
    const int k = k0 + kk, m = m0 + c;
    const bool ok = k < k_end && m < H;
    cp_async16(a + kk * BM + c,
               ok ? h_prev + static_cast<size_t>(k) * H + m : h_prev, ok);
  }
#pragma unroll
  for (int j = 0; j < kDwK * kDwTileN / 4 / kDwThreads; ++j) {
    const int i = threadIdx.x + j * kDwThreads;
    const int kk = i / (kDwTileN / 4), c = 4 * (i % (kDwTileN / 4));
    const int k = k0 + kk;
    const bool ok = k < k_end;  // 4H is a multiple of kDwTileN
    cp_async16(b + kk * kDwTileN + c,
               ok ? dgates + static_cast<size_t>(k) * 4 * H + n0 + c : dgates,
               ok);
  }
}

// A bf16 h_prev stage [kDwK][64 * MI] widened (exactly) into float32
// [kDwK][64 * MI], once for the block. Every value of a stage is read by
// the 16 threads of its ty: widening it at each read costs one integer
// instruction for every eight products. Measured by phase 3h on the H100
// against the f32 entry, at the four shapes: widened at each read 1.10x
// to 1.24x; each warp widening the slice it reads (a __syncwarp, no
// second block barrier) 1.07x to 1.19x, with its rows swizzled over the
// banks 1.02x to 1.10x (1.10x at H = 256); this, one block-wide widening
// and a second __syncthreads a stage, 1.04x to 1.07x. Four values a
// thread a round: one 8-byte read, one 16-byte store, consecutive threads
// on consecutive addresses (no bank is shared).
struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

template <int MI>
__device__ __forceinline__ void widen_stage(const __nv_bfloat16* src,
                                            float* dst) {
  constexpr int kQuads = kDwK * 64 * MI / 4;
  static_assert(kQuads % kDwThreads == 0, "whole rounds");
#pragma unroll
  for (int j = 0; j < kQuads / kDwThreads; ++j) {
    const int i = threadIdx.x + j * kDwThreads;
    const Bf16x4 q = reinterpret_cast<const Bf16x4*>(src)[i];
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(__low2float(q.lo), __high2float(q.lo),
                    __low2float(q.hi), __high2float(q.hi));
  }
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns the outputs at rows
// mi*64 + 4*ty + p and columns ni*64 + 4*tx + q of the block's tile
// (mi < MI, ni < 2, p, q < 4).
template <int MI, class Res>
__global__ void __launch_bounds__(kDwThreads, 2)
lstm_train_dw_kernel(const Res* __restrict__ h_prev,     // [N, H]
                     const float* __restrict__ dgates,   // [N, 4H]
                     float* __restrict__ slabs,          // [S, H, 4H]
                     int N, int H, int rows_per_slab) {
  constexpr int BM = 64 * MI;
  constexpr bool kWiden = !std::is_same_v<Res, float>;
  extern __shared__ float4 smem[];
  Res* a_s = reinterpret_cast<Res*>(smem);           // [stages][kDwK][BM]
  float* b_s = reinterpret_cast<float*>(a_s + kDwStages * kDwK * BM);
                                                     // [stages][kDwK][128]
  float* a_w = b_s + kDwStages * kDwK * kDwTileN;    // [kDwK][BM], kWiden
  const int H4 = 4 * H;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kDwTileN;
  const int s = blockIdx.z;
  const int k_begin = s * rows_per_slab;
  const int k_end = min(N, k_begin + rows_per_slab);
  const int n_stages = (k_end - k_begin + kDwK - 1) / kDwK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4 * MI][8] = {};
  // fill the ring; every iteration commits one group (empty ones too), so
  // that waiting for all but the kDwStages - 2 newest finds stage st done
#pragma unroll
  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < n_stages)
      dw_load_stage<MI, Res>(h_prev, dgates, a_s, b_s, k_begin + st * kDwK,
                             k_end, m0, n0, H, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kDwStages - 2>();
    // stage st is in shared memory for every thread, and every thread is
    // done with stage st - 1, whose buffer the next copies overwrite
    __syncthreads();
    const int next = st + kDwStages - 1;
    if (next < n_stages)
      dw_load_stage<MI, Res>(h_prev, dgates, a_s, b_s, k_begin + next * kDwK,
                             k_end, m0, n0, H, next % kDwStages);
    cp_async_commit();

    const float* a;
    if constexpr (kWiden) {
      // every thread is done with the last stage's a_w (the barrier
      // above); the widened stage is complete after this one
      widen_stage<MI>(a_s + (st % kDwStages) * kDwK * BM, a_w);
      __syncthreads();
      a = a_w;
    } else {
      a = a_s + (st % kDwStages) * kDwK * BM;
    }
    const float* b = b_s + (st % kDwStages) * kDwK * kDwTileN;
#pragma unroll
    for (int kk = 0; kk < kDwK; ++kk) {
      float av[4 * MI], bv[8];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float4 q = *reinterpret_cast<const float4*>(
            a + kk * BM + mi * 64 + 4 * ty);
        av[4 * mi] = q.x;
        av[4 * mi + 1] = q.y;
        av[4 * mi + 2] = q.z;
        av[4 * mi + 3] = q.w;
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const float4 q = *reinterpret_cast<const float4*>(
            b + kk * kDwTileN + ni * 64 + 4 * tx);
        bv[4 * ni] = q.x;
        bv[4 * ni + 1] = q.y;
        bv[4 * ni + 2] = q.z;
        bv[4 * ni + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = slabs + static_cast<size_t>(s) * H * H4;
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i) {
    const int m = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (m >= H) continue;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * H4 + n0
                                 + ni * 64 + 4 * tx) =
          make_float4(acc[i][4 * ni], acc[i][4 * ni + 1], acc[i][4 * ni + 2],
                      acc[i][4 * ni + 3]);
  }
}

template <int MI, class Res>
cudaError_t dw_tiles(const Res* h_prev, const float* dgates, float* slabs,
                     int N, int H, int n_slabs, int rows_per_slab,
                     cudaStream_t stream) {
  const dim3 grid(4 * H / kDwTileN, (H + 64 * MI - 1) / (64 * MI), n_slabs);
  const size_t smem = dw_smem_bytes<MI, Res>();  // <= 48 KiB: no opt-in
  auto* kernel = lstm_train_dw_kernel<MI, Res>;
  kernel<<<grid, kDwThreads, smem, stream>>>(h_prev, dgates, slabs, N, H,
                                             rows_per_slab);
  return cudaGetLastError();
}

// Tiles of 64 rows of dw_hh where H % 128 is in (0, 64] (H = 64, 160:
// fewer rows idle), else of 128 (lstm_train_cuda._dw_tile_rows).
template <class Res>
cudaError_t dw_slabs(const Res* h_prev, const float* dgates, float* slabs,
                     int N, int H, int n_slabs, int rows_per_slab,
                     cudaStream_t stream) {
  const int rem = H % 128;
  if (rem != 0 && rem <= 64)
    return dw_tiles<1, Res>(h_prev, dgates, slabs, N, H, n_slabs,
                            rows_per_slab, stream);
  return dw_tiles<2, Res>(h_prev, dgates, slabs, N, H, n_slabs,
                          rows_per_slab, stream);
}

template <int R, class Res, class IO>
cudaError_t fwd_rows(const IO* x_proj, const IO* w_hh, const IO* h0,
                     const IO* c0, const IO* mask, IO* ys, Res* acts,
                     Res* hseq, Res* cseq, IO* h_t, IO* c_t, int T, int B,
                     int H, cudaStream_t stream) {
  return launch_clusters(lstm_train_fwd_kernel<R, Res, IO>,
                         fwd_smem_bytes<R>(H), B, H, R, 1, stream, x_proj,
                         w_hh, h0, c0, mask, ys, acts, hseq, cseq, h_t, c_t,
                         T, B, H);
}

template <int R, class Res, class IO, class W>
cudaError_t bwd_rows(const IO* dy, const IO* dh_T, const IO* dc_T,
                     const Res* acts, const Res* c_new_seq,
                     const Res* c_prev_seq, const W* w_hh, const IO* mask,
                     IO* dx_proj, float* dgates, IO* dh0, IO* dc0, int T,
                     int B, int H, cudaStream_t stream) {
  return launch_clusters(lstm_train_bwd_kernel<R, Res, IO, W>,
                         bwd_smem_bytes<R>(H), B, H, R, 1, stream, dy, dh_T,
                         dc_T, acts, c_new_seq, c_prev_seq, w_hh, mask,
                         dx_proj, dgates, dh0, dc0, T, B, H);
}

template <int R, class Res, class IO, class W>
cudaError_t max_clusters_rows(int H, int* out) {
  int fwd = 0, bwd = 0;
  cudaError_t err = max_clusters(lstm_train_fwd_kernel<R, Res, IO>,
                                 fwd_smem_bytes<R>(H), H, &fwd);
  if (err != cudaSuccess) return err;
  err = max_clusters(lstm_train_bwd_kernel<R, Res, IO, W>,
                     bwd_smem_bytes<R>(H), H, &bwd);
  *out = fwd < bwd ? fwd : bwd;
  return err;
}

using bf16 = __nv_bfloat16;

}  // namespace

// Dispatch on the rows per cluster (lstm_train_cuda._ROWS); anything
// else is refused with cudaErrorInvalidValue.
#define LSTM_TRAIN_ROWS(R, CALL)                                   \
  switch (R) {                                                     \
    case 1: return static_cast<int>(CALL(1));                      \
    case 2: return static_cast<int>(CALL(2));                      \
    case 4: return static_cast<int>(CALL(4));                      \
    case 8: return static_cast<int>(CALL(8));                      \
    case 12: return static_cast<int>(CALL(12));                    \
    case 16: return static_cast<int>(CALL(16));                    \
    case 18: return static_cast<int>(CALL(18));                    \
    case 20: return static_cast<int>(CALL(20));                    \
    case 24: return static_cast<int>(CALL(24));                    \
    case 32: return static_cast<int>(CALL(32));                    \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

extern "C" {

// The caller guarantees: the types of each entry's signature, contiguous,
// T >= 1, B >= 1, H a multiple of 32 in [32, 256], all pointers on the
// current device. `rows` is the batch rows per cluster (the wrapper's
// `_train_geometry`). Entries by suffix: f32 (everything float32),
// bf16res (the residuals acts, hseq, cseq, c_new_seq, c_prev_seq and
// h_prev bf16), bf16 (x_proj, w_hh, h0, c0, mask, ys, h_T, c_T, dy,
// dh_T, dc_T, dx_proj, dh0 and dc0 bf16), wbf16 (the backward's w_hh
// bf16), and the last two with _bf16res.

#define FWD(R)                                                             \
  fwd_rows<R>(x_proj, w_hh, h0, c0, mask, ys, acts, hseq, cseq, h_t, c_t, \
              T, B, H, static_cast<cudaStream_t>(stream))
#define FWD_ENTRY(NAME, IO, RES)                                             \
  int NAME(const IO* x_proj, const IO* w_hh, const IO* h0, const IO* c0,     \
           const IO* mask, IO* ys, RES* acts, RES* hseq, RES* cseq, IO* h_t, \
           IO* c_t, int T, int B, int H, int rows, void* stream) {           \
    LSTM_TRAIN_ROWS(rows, FWD)                                               \
  }

FWD_ENTRY(lstm_train_fwd_f32, float, float)
FWD_ENTRY(lstm_train_fwd_bf16res, float, bf16)
FWD_ENTRY(lstm_train_fwd_bf16, bf16, float)
FWD_ENTRY(lstm_train_fwd_bf16_bf16res, bf16, bf16)

// w_hh is [H, 4H], the forward's layout. The float32-I/O entries write
// dx_proj (float32, the dW entries' dgates); the bf16-I/O ones dx_proj
// in bf16 and the float32 dgates [T, B, 4H] besides.
#define BWD(R)                                                            \
  bwd_rows<R>(dy, dh_T, dc_T, acts, c_new_seq, c_prev_seq, w_hh, mask,    \
              dx_proj, dgates, dh0, dc0, T, B, H,                         \
              static_cast<cudaStream_t>(stream))
#define BWD_ENTRY(NAME, IO, W, RES)                                        \
  int NAME(const IO* dy, const IO* dh_T, const IO* dc_T, const RES* acts,  \
           const RES* c_new_seq, const RES* c_prev_seq, const W* w_hh,     \
           const IO* mask, IO* dx_proj, IO* dh0, IO* dc0, int T, int B,    \
           int H, int rows, void* stream) {                                \
    float* dgates = nullptr;                                               \
    LSTM_TRAIN_ROWS(rows, BWD)                                             \
  }
#define BWD_BF16_ENTRY(NAME, RES)                                          \
  int NAME(const bf16* dy, const bf16* dh_T, const bf16* dc_T,             \
           const RES* acts, const RES* c_new_seq, const RES* c_prev_seq,   \
           const bf16* w_hh, const bf16* mask, bf16* dx_proj,              \
           float* dgates, bf16* dh0, bf16* dc0, int T, int B, int H,       \
           int rows, void* stream) {                                       \
    LSTM_TRAIN_ROWS(rows, BWD)                                             \
  }

BWD_ENTRY(lstm_train_bwd_f32, float, float, float)
BWD_ENTRY(lstm_train_bwd_bf16res, float, float, bf16)
BWD_BF16_ENTRY(lstm_train_bwd_bf16, float)
BWD_BF16_ENTRY(lstm_train_bwd_bf16_bf16res, bf16)
BWD_ENTRY(lstm_train_bwd_wbf16, float, bf16, float)
BWD_ENTRY(lstm_train_bwd_wbf16_bf16res, float, bf16, bf16)

#undef FWD
#undef FWD_ENTRY
#undef BWD
#undef BWD_ENTRY
#undef BWD_BF16_ENTRY

// The clusters of #7 and of #8's scan at (H, rows) that the current device
// holds at once (the fewer of the two), into *out, of the instantiation
// on I/O type bf16 if `io_bf16` (else float32), the backward's w_hh bf16
// if `w_bf16` (the forward's is in the I/O type) and residuals bf16 if
// `res_bf16`; bf16 I/O takes bf16 w_hh.
int lstm_train_max_clusters(int H, int rows, int io_bf16, int w_bf16,
                            int res_bf16, int* out) {
#define MAXC(R) max_clusters_rows<R, Res, IO, W>(H, out)
#define MAXC_TYPES(RES_T, IO_T, W_T) \
  {                                  \
    using Res = RES_T;               \
    using IO = IO_T;                 \
    using W = W_T;                   \
    LSTM_TRAIN_ROWS(rows, MAXC)      \
  }
  if (io_bf16 && !w_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (io_bf16 && res_bf16) MAXC_TYPES(bf16, bf16, bf16)
  if (io_bf16) MAXC_TYPES(float, bf16, bf16)
  if (w_bf16 && res_bf16) MAXC_TYPES(bf16, float, bf16)
  if (w_bf16) MAXC_TYPES(float, float, bf16)
  if (res_bf16) MAXC_TYPES(bf16, float, float)
  MAXC_TYPES(float, float, float)
#undef MAXC_TYPES
#undef MAXC
}

// h_prev [N, H], dgates [N, 4H] with N = T*B; slabs [n_slabs, H, 4H],
// slab s summing rows [s*rows_per_slab, (s+1)*rows_per_slab).
int lstm_train_dw_f32(const float* h_prev, const float* dgates, float* slabs,
                      int N, int H, int n_slabs, int rows_per_slab,
                      void* stream) {
  return static_cast<int>(dw_slabs(h_prev, dgates, slabs, N, H, n_slabs,
                                   rows_per_slab,
                                   static_cast<cudaStream_t>(stream)));
}

int lstm_train_dw_bf16res(const bf16* h_prev, const float* dgates,
                          float* slabs, int N, int H, int n_slabs,
                          int rows_per_slab, void* stream) {
  return static_cast<int>(dw_slabs(h_prev, dgates, slabs, N, H, n_slabs,
                                   rows_per_slab,
                                   static_cast<cudaStream_t>(stream)));
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

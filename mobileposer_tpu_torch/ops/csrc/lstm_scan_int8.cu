// W8A8 int8 LSTM layer scans for Hopper (sm_90a): float32 or bf16
// activations (I/O), a float32 carry, int8 recurrent weights with a
// per-column scale, the hidden state re-quantized per row at every step.
//
// Replaces three TPU kernels of mobileposer_tpu/ops/lstm_pallas.py:
//   lstm_scan_int8           <- lstm_layer_pallas_int8 (_lstm_step_kernel_int8):
//                               one unidirectional full-length layer (the
//                               velocity module);
//   bilstm_scan_int8         <- bilstm_layer_pallas_int8
//                               (_bilstm_step_kernel_int8): both directions
//                               of a bidirectional layer in one launch,
//                               grid y selecting the direction;
//   lstm_scan_masked_int8    <- lstm_layer_masked_pallas_int8
//   bilstm_scan_masked_int8     (_masked_step_kernel_int8): one direction,
//                               or both directions sharing one [T, B] mask
//                               (the backward input is reversed per
//                               length), of a ragged batch.
// Contract (the float kernels' of lstm_scan.cu, with the recurrent term of
// mobileposer_tpu/ops/quant.py int8_recurrent_gates): x_proj [T, B, 4H]
// already holds the int8 input projection plus b; w_hh the int8 [H, 4H]
// as it is; w_scale [4H]; gate order (i, f, g, o); the carry stays
// float32. Per step and row, with h the previous hidden state:
//   scale = max(max_j |h_j| * f32(1/127), 1e-12)
//   q_j   = clamp(round_half_even(h_j / scale), -127, 127)
//   gate  = x_proj + f32(sum_k q_k * w[k, col]) * (scale * w_scale[col])
// which is what the plain version computes, in the same order and with
// the same roundings: the int32 sum is exact in any order, and every
// product and sum, the cell update's too, is written with
// __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA. The
// nonlinearities are expf and tanhf as in torch's CUDA sigmoid and tanh,
// so on the card the kernels can agree with the plain version to the bit,
// and no h/scale lands on the other side of a rounding boundary. XLA turns
// the JAX package's `amax / 127` into a multiply by the float32
// reciprocal; the kernels do the same. The masked entries blend as the
// masked float kernel does (exact zeros at masked steps).
//
// Design: the thread-block-cluster layout of lstm_scan.cu's float body
// (scan_body.cuh, cluster_scan.cuh), with the recurrent product on the
// int8 tensor cores. A cluster of n = H / 32 CTAs of 512 threads owns R batch rows of
// one direction (R from 1 to 64, chosen by the wrapper: the fewest with
// which all n_dir * ceil(B / R) clusters are resident at once); CTA c owns
// the hidden units [32c, 32c + 32) and their 128 gate columns, so the cell
// update needs no exchange. Each of its 16 warps owns 8 of those columns
// (one n8 tile of mma.m16n8k32, int8_mma.cuh) and holds their B fragments
// for every k in registers for all T steps (H / 16 registers a lane),
// loaded once from the int8 w_hh. The int32 sum is exact, so the kernel
// may take k in any order: the lane that holds logical k 4t .. 4t+3 and
// 16+4t .. 16+4t+3 of a k-step holds the eight consecutive k 32s + 8t ..
// 32s + 8t + 7, in A and B alike, so one 8-byte shared-memory read gives
// two A registers. A thread owns the (row, unit) items (w + 16p, u) of
// its warp w and lane u, and keeps their h and c in registers. Per step:
//   (a) quantize: the scale of each row from its partial maxima of |h|,
//       one per CTA (max is exact in any order, so every CTA computes the
//       same scale), and each thread quantizes its own h and writes the
//       int8 value into q of every CTA through distributed shared memory:
//       a CTA quantizes only its own R x 32 values. q has 16 ceil(R / 16)
//       rows (the padding rows zero) and a row stride that keeps the A
//       reads free of bank conflicts. One cluster barrier.
//   (b) products: ceil(R / 16) M-tiles x H / 32 k-steps of the mma per
//       warp, int32 accumulators in registers, stored into a [R][136]
//       buffer (8 words of padding a row: conflict-free 8-byte stores).
//       One CTA barrier.
//   (c) cell: each thread dequantizes its four sums with the x_proj
//       values it fetched at the start of the step (in flight during (a)
//       and (b)), updates the cell and writes ys; a warp is one row's 32
//       units of the CTA, so one warp max gives the row's partial maximum,
//       which lanes 0 .. n-1 push to the n CTAs. One cluster barrier.
// q, the sums and the maxima need no second buffer: each is written only
// after a cluster barrier that every reader of its last contents passed.
// Every CTA quantizing the whole R x H tile itself would save the first
// cluster barrier (~0.5 us) but cost ~2.4 us a step at R = 37 in
// divisions and conversions (scan_variants.py on an H100); at R = 1 and
// at H = 64 that body is the faster one (by ~0.02 ms a launch). Rows past
// B read zeros (scale 1e-12, q = 0) and write nothing. Shared memory per
// CTA: 16 ceil(R/16) S (q; S = H, or H + 32 where H / 32 is even) + 544R
// (sums) + 32R (maxima) bytes: 35,136 at R = 37, H = 256.
//
// Masked variant (lstm_scan_masked_int8_kernel, kernel #5): the same body
// (a kMasked template flag), the same geometry (rows from the wrapper,
// residency queried for the masked instantiation) and the same roundings,
// plus what the masked float body of lstm_scan.cu adds:
//   * at the start the cluster finds t_end, one past the last step at
//     which any of its R rows has m != 0 (cluster_scan.cuh tile_end; every
//     CTA reads the same mask columns, so all agree on the number of steps
//     and on the cluster barriers). Steps from t_end on only write zeros
//     to ys, so a tile whose rows all end early stops there;
//   * each cell item reads its row's m of step t beside that step's
//     x_proj, before the step's quantization and products;
//   * after the cell update it blends, rounded as written
//     (cluster_scan.cuh blend): c <- blend(m, c_new, c), h <- blend(m,
//     h_new, h), ys[t] = __fmul_rn(m, h_new). h lives in registers, so h
//     is blended there, and the row's partial maximum that the next step
//     quantizes from is taken over the blended h (over h_new the scale of
//     a masked step would change).
// With every m = 1, blend(1, a, b) = a and 1 * h = h, and the int32 sums
// are exact, so the masked entries give the full-length entries' outputs
// bit for bit.
//
// bf16 I/O (the *_int8_bf16 entries; the TPU kernels' bf16 variant): the
// same body over the I/O type IO = __nv_bfloat16. Only its loads and
// stores change: x_proj, h0, c0 and the mask are read as bf16 and widened
// (`to_f32`, exact), and ys, h_T, c_T and the masked tail's zeros are
// rounded to bf16 (`from_f32`, nearest even) as they are written. w_hh
// stays int8 and w_scale float32. Everything between is the float32
// instantiation's: h and c in registers, the maxima, the scale, the
// quantization, the int32 products, the dequantization, the cell update
// and the blend. In particular the quantized h is that of the float32
// carry, as in the TPU kernel (`_gates_int8` quantizes its float32
// scratch h; only the float body rounds h to bf16 for its product). So
// for any bf16 inputs a bf16 entry's outputs are the float32 entry's on
// the same inputs widened, rounded to bf16, bit for bit. Shared memory
// holds q, the sums and the maxima, none in the I/O type, so the geometry
// and the residency are the float32 instantiation's. A step's x_proj and
// mask are held as read and widened at the cell update: widened where
// they were loaded, each step waited for its loads before the
// quantization, ~0.35 us a step (the masked scans at T = 512 took 1.10x
// to 1.14x the float32 entry's time, 0.99x held as read; chip_smoke.py
// phase 3g and bench_turns on an NVIDIA H100 80GB HBM3 at 700 W).
//
// What bounds it on this card (worked out from the shapes, not measured):
// per step and direction 2*B*H*4H integer operations against 1,979 TOP/s
// of int8 tensor cores, and the bytes of x_proj/ys (f32), w_hh (int8),
// the state and the mask against 3.35 TB/s. Streaming (T = 45, B = 256,
// H = 256, both directions): ~12.1 G int8 ops (6 us) against ~118 MB of
// x_proj, ys and state (35 us), so bytes bound it. The scan is a chain of
// T dependent steps: the full-length body takes a step's products off the
// CUDA cores and w_hh out of L2, so a step is its latencies: the
// quantization, the products, the cell update and two cluster barriers
// (scan_variants.py times each part). At evaluation's B = 64 a cluster
// holds few rows (one M-tile), so a masked step is those latencies too.

#include <stdint.h>

#include "cluster_scan.cuh"
#include "int8_mma.cuh"

namespace {

constexpr float kInvQmax = 1.0f / 127.0f;  // the float32 reciprocal

// torch's CUDA sigmoid, 1 / (1 + exp(-x)) in float32, with each operation
// rounded on its own
__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// the row's quantization scale from its max |h|
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInvQmax), 1e-12f);
}

// h / scale rounded half to even, clamped to [-127, 127]
__device__ __forceinline__ int quantize(float h, float scale) {
  const int q = __float2int_rn(__fdiv_rn(h, scale));
  return min(max(q, -127), 127);
}

// x_proj + f32(acc) * (scale * w_scale), rounded as written; |acc| <=
// 127^2 * H < 2^24, so the conversion is exact
__device__ __forceinline__ float dequant_gate(float x, int acc, float scale,
                                              float w_scale) {
  return __fadd_rn(x, __fmul_rn(__int2float_rn(acc),
                                __fmul_rn(scale, w_scale)));
}

// the cell update as _gate_update computes it, one rounding per operation
__device__ __forceinline__ void cell_update(const float (&gate)[4], float c,
                                            float& c_new, float& h_new) {
  const float i = sigmoid_rn(gate[0]);
  const float f = sigmoid_rn(gate[1]);
  const float g = tanhf(gate[2]);
  const float o = sigmoid_rn(gate[3]);
  c_new = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  h_new = __fmul_rn(o, tanhf(c_new));
}

constexpr int kTileRows = 16;                   // rows of an mma M-tile
constexpr int kMaxTiles = 4;                    // M-tiles: MT templates 1..4
constexpr int kMaxRows = kTileRows * kMaxTiles;
constexpr int kMaxCtas = 8;                     // H / 32 at H = 256
constexpr int kMaxKSteps = 8;                   // H / 32 at H = 256
constexpr int kSumStride = kCols + 8;           // int32 words a row of sums

template <class IO>
struct ClusterDir {
  const IO* x_proj;      // [T, B, 4H]
  const int8_t* w_hh;    // [H, 4H]
  const float* w_scale;  // [4H], float32 whatever IO is
  const IO* h0;          // [B, H]
  const IO* c0;          // [B, H]
  IO* ys;                // [T, B, H]
  IO* h_t;               // [B, H]
  IO* c_t;               // [B, H]
};

// Row stride of the quantized h (bytes): a half-warp's 8-byte A reads of
// four rows then fall on 32 distinct banks.
__host__ __device__ __forceinline__ int q_stride(int H) {
  return (H / kUnits) % 2 == 0 ? H + 32 : H;
}

size_t cluster_smem_bytes(int H, int R) {
  const int MT = (R + kTileRows - 1) / kTileRows;
  return static_cast<size_t>(kTileRows) * MT * q_stride(H)
         + sizeof(int) * static_cast<size_t>(R) * kSumStride
         + sizeof(float) * static_cast<size_t>(R) * kMaxCtas;
}

// max |v| over the warp's 32 lanes: for v >= 0 the float order is the
// order of the bit patterns
__device__ __forceinline__ float warp_max_abs(float v) {
  return __uint_as_float(
      __reduce_max_sync(0xffffffffu, __float_as_uint(fabsf(v))));
}

// One direction (see the design note above); with kMasked, the masked
// variant over mask [T, B]. MT = ceil(R / 16) M-tiles; the cell items of a
// thread are (row, unit) = (warp + 16 p, lane), p < MT: a warp holds one
// row's 32 units of this CTA. `d` by value: a reference to the kernel's
// parameters would put both directions' in local memory. IO is the I/O
// type (float or __nv_bfloat16), the mask's too.
template <int MT, bool kMasked, class IO>
__device__ __forceinline__ void cluster_scan_int8(
    const ClusterDir<IO> d, const IO* __restrict__ mask, int T, int B, int H,
    int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = H / kUnits;
  const int n_ks = H / 32;
  const int cta = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / n_cta) * R;
  const int unit0 = cta * kUnits;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int S = q_stride(H);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, tig = lane % 4;  // the mma fragment coordinates

  extern __shared__ float4 smem[];
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);         // [16 MT][S]
  int* sum_s = reinterpret_cast<int*>(q_s + kTileRows * MT * S);
  float* amax_s = reinterpret_cast<float*>(sum_s + R * kSumStride);

  // the warp's B fragments: slice column 8 * warp + grp, i.e. gate
  // column (col / 32) * H + unit0 + col % 32; k-step s holds the k
  // 32s + 8 tig .. + 3 (b[0]) and 32s + 8 tig + 4 .. + 7 (b[1])
  unsigned wf[kMaxKSteps][2];
  {
    const int col = 8 * warp + grp;
    const int8_t* wc = d.w_hh + (col / kUnits) * H + unit0 + col % kUnits;
#pragma unroll
    for (int s = 0; s < kMaxKSteps; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned v = 0;
        if (s < n_ks) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t k = 32 * s + 8 * tig + 4 * half + j;
            v |= static_cast<unsigned>(static_cast<uint8_t>(
                     __ldg(wc + k * H4))) << (8 * j);
          }
        }
        wf[s][half] = v;
      }
  }

  // the M-tiles' padding rows of q stay zero
  for (int idx = R * S / 4 + tid; idx < kTileRows * MT * S / 4;
       idx += kThreads)
    reinterpret_cast<int*>(q_s)[idx] = 0;
  // the steps this cluster runs: all T, or (masked) up to the tile's last
  // valid step; the sums serve as the reduction's slot
  int t_end = T;
  if constexpr (kMasked) t_end = tile_end(mask, T, B, b0, R, sum_s);
  const int u = lane;  // the unit (within the CTA) of every cell item
  float ws[4], h[MT], c[MT];
#pragma unroll
  for (int g = 0; g < 4; ++g) ws[g] = __ldg(d.w_scale + g * H + unit0 + u);
#pragma unroll
  for (int p = 0; p < MT; ++p) {
    const int r = warp + kTileRows * p, b = b0 + r;
    const bool ok = r < R && b < B;
    h[p] = ok ? to_f32(d.h0[static_cast<size_t>(b) * H + unit0 + u]) : 0.0f;
    c[p] = ok ? to_f32(d.c0[static_cast<size_t>(b) * H + unit0 + u]) : 0.0f;
  }

  // the partial maxima of a row's |h| over this CTA's units, to every CTA
  auto push_maxima = [&]() {
#pragma unroll
    for (int p = 0; p < MT; ++p) {
      const int r = warp + kTileRows * p;
      if (r >= R) continue;  // the same for the whole warp
      const float m = warp_max_abs(h[p]);
      if (lane < n_cta)
        cluster.map_shared_rank(amax_s, lane)[r * kMaxCtas + cta] = m;
    }
  };
  cluster.sync();  // every CTA started: its shared memory may be written
  push_maxima();
  cluster.sync();  // the maxima of h0 in place

  const IO zero = from_f32<IO>(0.0f);
  for (int t = 0; t < t_end; ++t) {
    // this step's x_proj (and, masked, mask) for the cell items, in flight
    // during (a) and (b); held as read and widened in (c), so that no
    // widening of a bf16 value waits for its load before the barriers
    const IO* xt = d.x_proj + static_cast<size_t>(t) * B * H4;
    IO x[MT][4], m[MT];
#pragma unroll
    for (int p = 0; p < MT; ++p) {
      const int r = warp + kTileRows * p, b = b0 + r;
      const bool ok = r < R && b < B;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[p][g] = ok ? __ldg(xt + b * H4 + g * H + unit0 + u) : zero;
      if constexpr (kMasked)
        m[p] = ok ? __ldg(mask + static_cast<size_t>(t) * B + b) : zero;
    }

    // (a) each row's scale from its partial maxima (lane q < n_cta reads
    // CTA q's; one warp max); this CTA's units of h_{t-1} quantized, into
    // q of every CTA
    float scale[MT] = {};
#pragma unroll
    for (int p = 0; p < MT; ++p) {
      const int r = warp + kTileRows * p;
      if (r >= R) continue;  // the same for the whole warp
      scale[p] = row_scale(
          warp_max_abs(lane < n_cta ? amax_s[r * kMaxCtas + lane] : 0.0f));
      const int8_t q = static_cast<int8_t>(quantize(h[p], scale[p]));
      for (int cq = 0; cq < n_cta; ++cq)
        cluster.map_shared_rank(q_s, cq)[r * S + unit0 + u] = q;
    }
    cluster.sync();  // q complete everywhere; every maximum read

    // (b) sums = q @ w_slice[:, the warp's 8 columns], exact int32
    int acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] = 0;
#pragma unroll
    for (int s = 0; s < kMaxKSteps; ++s) {
      if (s < n_ks) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int8_t* qa = q_s + (kTileRows * m + grp) * S + 32 * s
                             + 8 * tig;
          const int2 lo = *reinterpret_cast<const int2*>(qa);
          const int2 hi = *reinterpret_cast<const int2*>(qa + 8 * S);
          const unsigned a[4] = {static_cast<unsigned>(lo.x),
                                 static_cast<unsigned>(hi.x),
                                 static_cast<unsigned>(lo.y),
                                 static_cast<unsigned>(hi.y)};
          mma_s8_m16n8k32(acc[m], a, wf[s]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = kTileRows * m + grp, col = 8 * warp + 2 * tig;
      if (r < R)
        *reinterpret_cast<int2*>(sum_s + r * kSumStride + col) =
            make_int2(acc[m][0], acc[m][1]);
      if (r + 8 < R)
        *reinterpret_cast<int2*>(sum_s + (r + 8) * kSumStride + col) =
            make_int2(acc[m][2], acc[m][3]);
    }
    __syncthreads();  // every sum of the tile is in shared memory

    // (c) cell update (masked: blend); the maxima of the new h to every
    // CTA
    IO* yt = d.ys + static_cast<size_t>(t) * B * H;
#pragma unroll
    for (int p = 0; p < MT; ++p) {
      const int r = warp + kTileRows * p, b = b0 + r;
      if (r >= R) continue;  // the same for the whole warp
      const int* sr = sum_s + r * kSumStride + u;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = dequant_gate(to_f32(x[p][g]), sr[g * kUnits], scale[p],
                               ws[g]);
      float c_new, h_new, y;
      cell_update(gate, c[p], c_new, h_new);
      if constexpr (kMasked) {
        const float mp = to_f32(m[p]);
        c[p] = blend(mp, c_new, c[p]);
        h[p] = blend(mp, h_new, h[p]);
        y = __fmul_rn(mp, h_new);  // exactly zero at a masked step
      } else {
        c[p] = c_new;
        h[p] = h_new;
        y = h_new;
      }
      if (b < B) yt[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(y);
    }
    push_maxima();
    // the maxima of h_t are in place everywhere, and nobody reads q or the
    // sums of this step any more
    cluster.sync();
  }

#pragma unroll
  for (int p = 0; p < MT; ++p) {
    const int r = warp + kTileRows * p, b = b0 + r;
    if (r < R && b < B) {
      d.h_t[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(h[p]);
      d.c_t[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(c[p]);
      if constexpr (kMasked)  // the steps past the tile's last valid one
        for (int t = t_end; t < T; ++t)
          d.ys[(static_cast<size_t>(t) * B + b) * H + unit0 + u] =
              from_f32<IO>(0.0f);
    }
  }
}

template <int MT, class IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_int8_kernel(ClusterDir<IO> d0, ClusterDir<IO> d1, int T, int B,
                      int H, int R) {
  cluster_scan_int8<MT, false, IO>(blockIdx.y == 0 ? d0 : d1, nullptr, T, B,
                                   H, R);
}

template <int MT, class IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_scan_masked_int8_kernel(ClusterDir<IO> d0, ClusterDir<IO> d1,
                             const IO* __restrict__ mask, int T, int B,
                             int H, int R) {
  cluster_scan_int8<MT, true, IO>(blockIdx.y == 0 ? d0 : d1, mask, T, B, H,
                                  R);
}

template <int MT, class IO>
cudaError_t cluster_rows(const ClusterDir<IO>& d0, const ClusterDir<IO>& d1,
                         int n_dir, int T, int B, int H, int R,
                         cudaStream_t stream) {
  return launch_clusters(lstm_scan_int8_kernel<MT, IO>,
                         cluster_smem_bytes(H, R), B, H, R, n_dir, stream,
                         d0, d1, T, B, H, R);
}

template <int MT, class IO>
cudaError_t masked_rows(const ClusterDir<IO>& d0, const ClusterDir<IO>& d1,
                        const IO* mask, int n_dir, int T, int B, int H,
                        int R, cudaStream_t stream) {
  return launch_clusters(lstm_scan_masked_int8_kernel<MT, IO>,
                         cluster_smem_bytes(H, R), B, H, R, n_dir, stream,
                         d0, d1, mask, T, B, H, R);
}

// residency of the float32 instantiations: the bf16 ones have the same
// threads, the same shared memory and one CTA an SM (the geometry is the
// same for both dtypes; chip_smoke.py phase 3g compares the two)
template <int MT, class IO = float>
cudaError_t cluster_max_clusters(int H, int R, int* out) {
  return max_clusters(lstm_scan_int8_kernel<MT, IO>,
                      cluster_smem_bytes(H, R), H, out);
}

template <int MT, class IO = float>
cudaError_t masked_max_clusters(int H, int R, int* out) {
  return max_clusters(lstm_scan_masked_int8_kernel<MT, IO>,
                      cluster_smem_bytes(H, R), H, out);
}

}  // namespace

// Dispatch a cluster scan of `rows` rows per cluster on its M-tiles
// MT = ceil(rows / 16); rows outside [1, kMaxRows] are refused with
// cudaErrorInvalidValue.
#define LSTM_SCAN_INT8_ROWS(rows, CALL)                                \
  if (rows < 1 || rows > kMaxRows)                                     \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  switch ((rows + kTileRows - 1) / kTileRows) {                        \
    case 1: return static_cast<int>(CALL(1));                          \
    case 2: return static_cast<int>(CALL(2));                          \
    case 3: return static_cast<int>(CALL(3));                          \
    default: return static_cast<int>(CALL(4));                         \
  }
static_assert(kMaxTiles == 4, "LSTM_SCAN_INT8_ROWS cases");

extern "C" {

// The caller guarantees: x_proj/h0/c0/w_scale float32, w_hh the int8
// [H, 4H] weights, all contiguous, T >= 1, B >= 1, H a multiple of 32 in
// [32, 256], all pointers on the current device. `rows` is the batch rows
// per cluster (the wrapper's `scan_geometry(..., int8=True)`).
int lstm_scan_int8(const float* x_proj, const int8_t* w_hh,
                   const float* w_scale, const float* h0, const float* c0,
                   float* ys, float* h_t, float* c_t,
                   int T, int B, int H, int rows, void* stream) {
  const ClusterDir<float> d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
#define SCAN(MT) \
  cluster_rows<MT>(d, d, 1, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_int8(const float* x_proj_f, const float* x_proj_b,
                     const int8_t* w_hh_f, const int8_t* w_hh_b,
                     const float* w_scale_f, const float* w_scale_b,
                     const float* h0_f, const float* c0_f,
                     const float* h0_b, const float* c0_b,
                     float* ys_f, float* ys_b,
                     float* h_f, float* c_f, float* h_b, float* c_b,
                     int T, int B, int H, int rows, void* stream) {
  const ClusterDir<float> f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f,
                            ys_f, h_f, c_f};
  const ClusterDir<float> b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b,
                            ys_b, h_b, c_b};
#define SCAN(MT) \
  cluster_rows<MT>(f, b, 2, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

// The clusters of the full-length int8 scan at (H, rows) that the current
// device holds at once, into *out.
int lstm_scan_int8_max_clusters(int H, int rows, int* out) {
#define MAXC(MT) cluster_max_clusters<MT>(H, rows, out)
  LSTM_SCAN_INT8_ROWS(rows, MAXC)
#undef MAXC
}

// The masked entries: as above, with mask [T, B] float32 (the masked
// instantiation's `rows`: `scan_geometry(..., masked=True, int8=True)`).
int lstm_scan_masked_int8(const float* x_proj, const int8_t* w_hh,
                          const float* w_scale, const float* h0,
                          const float* c0, const float* mask,
                          float* ys, float* h_t, float* c_t,
                          int T, int B, int H, int rows, void* stream) {
  const ClusterDir<float> d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
#define SCAN(MT)                                              \
  masked_rows<MT>(d, d, mask, 1, T, B, H, rows,               \
                  static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_masked_int8(const float* x_proj_f, const float* x_proj_b,
                            const int8_t* w_hh_f, const int8_t* w_hh_b,
                            const float* w_scale_f, const float* w_scale_b,
                            const float* h0_f, const float* c0_f,
                            const float* h0_b, const float* c0_b,
                            const float* mask,
                            float* ys_f, float* ys_b,
                            float* h_f, float* c_f, float* h_b, float* c_b,
                            int T, int B, int H, int rows, void* stream) {
  const ClusterDir<float> f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f,
                            ys_f, h_f, c_f};
  const ClusterDir<float> b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b,
                            ys_b, h_b, c_b};
#define SCAN(MT)                                              \
  masked_rows<MT>(f, b, mask, 2, T, B, H, rows,               \
                  static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

// The clusters of the masked int8 scan at (H, rows) that the current
// device holds at once, into *out.
int lstm_scan_masked_int8_max_clusters(int H, int rows, int* out) {
#define MAXC(MT) masked_max_clusters<MT>(H, rows, out)
  LSTM_SCAN_INT8_ROWS(rows, MAXC)
#undef MAXC
}

// The bf16-I/O entries: the float32 entries' contract with x_proj, h0,
// c0, the mask and the outputs in bf16 (__nv_bfloat16, raw bits); w_hh
// int8 and w_scale float32 as there, the carry float32. The same rows per
// cluster as the float32 entries (`scan_geometry(..., int8=True)`, with
// masked=True for the masked ones).
typedef __nv_bfloat16 bf16;

int lstm_scan_int8_bf16(const bf16* x_proj, const int8_t* w_hh,
                        const float* w_scale, const bf16* h0, const bf16* c0,
                        bf16* ys, bf16* h_t, bf16* c_t,
                        int T, int B, int H, int rows, void* stream) {
  const ClusterDir<bf16> d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
#define SCAN(MT) \
  cluster_rows<MT>(d, d, 1, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_int8_bf16(const bf16* x_proj_f, const bf16* x_proj_b,
                          const int8_t* w_hh_f, const int8_t* w_hh_b,
                          const float* w_scale_f, const float* w_scale_b,
                          const bf16* h0_f, const bf16* c0_f,
                          const bf16* h0_b, const bf16* c0_b,
                          bf16* ys_f, bf16* ys_b,
                          bf16* h_f, bf16* c_f, bf16* h_b, bf16* c_b,
                          int T, int B, int H, int rows, void* stream) {
  const ClusterDir<bf16> f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f,
                           ys_f, h_f, c_f};
  const ClusterDir<bf16> b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b,
                           ys_b, h_b, c_b};
#define SCAN(MT) \
  cluster_rows<MT>(f, b, 2, T, B, H, rows, static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

int lstm_scan_masked_int8_bf16(const bf16* x_proj, const int8_t* w_hh,
                               const float* w_scale, const bf16* h0,
                               const bf16* c0, const bf16* mask,
                               bf16* ys, bf16* h_t, bf16* c_t,
                               int T, int B, int H, int rows, void* stream) {
  const ClusterDir<bf16> d{x_proj, w_hh, w_scale, h0, c0, ys, h_t, c_t};
#define SCAN(MT)                                              \
  masked_rows<MT>(d, d, mask, 1, T, B, H, rows,               \
                  static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

int bilstm_scan_masked_int8_bf16(const bf16* x_proj_f, const bf16* x_proj_b,
                                 const int8_t* w_hh_f, const int8_t* w_hh_b,
                                 const float* w_scale_f,
                                 const float* w_scale_b,
                                 const bf16* h0_f, const bf16* c0_f,
                                 const bf16* h0_b, const bf16* c0_b,
                                 const bf16* mask,
                                 bf16* ys_f, bf16* ys_b,
                                 bf16* h_f, bf16* c_f, bf16* h_b, bf16* c_b,
                                 int T, int B, int H, int rows,
                                 void* stream) {
  const ClusterDir<bf16> f{x_proj_f, w_hh_f, w_scale_f, h0_f, c0_f,
                           ys_f, h_f, c_f};
  const ClusterDir<bf16> b{x_proj_b, w_hh_b, w_scale_b, h0_b, c0_b,
                           ys_b, h_b, c_b};
#define SCAN(MT)                                              \
  masked_rows<MT>(f, b, mask, 2, T, B, H, rows,               \
                  static_cast<cudaStream_t>(stream))
  LSTM_SCAN_INT8_ROWS(rows, SCAN)
#undef SCAN
}

// The clusters of the bf16 instantiations at (H, rows) that the current
// device holds at once, into *out: the full-length one, or with `masked`
// the masked one. The wrappers take the float32 instantiations' rows for
// both dtypes; chip_smoke.py compares the two counts.
int lstm_scan_int8_bf16_max_clusters(int H, int rows, int masked, int* out) {
#define MAXC(MT)                                                    \
  (masked ? masked_max_clusters<MT, bf16>(H, rows, out)             \
          : cluster_max_clusters<MT, bf16>(H, rows, out))
  LSTM_SCAN_INT8_ROWS(rows, MAXC)
#undef MAXC
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

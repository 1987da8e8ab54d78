// The LSTM scan body for Hopper (sm_90a) that lstm_scan.cu (the layer
// scans #1, #2 and #3) and multicell_scan.cu (#9) share: one group of
// n = H / 32 CTAs of a thread-block cluster (cluster_scan.cuh) advances R
// batch rows of one LSTM direction over T steps, each CTA holding its
// [H, 128] slice of w_hh in shared memory. lstm_scan.cu's design note says
// how a step runs; multicell_scan.cu's how a cluster holds several groups.
// One body keeps one summation order: each gate starts at x_proj and adds
// h[k] * w[k][col] with fmaf for k = 0 .. H-1, and the cell update is
// written out, so the multicell scan gives the layer scans' bits.
//
// The I/O type IO is float or __nv_bfloat16, as the TPU kernels take
// float32 or bf16 I/O. With bf16 I/O, x_proj, w_hh, h0 and c0 are widened
// to float32 as they are read (exact), the w_hh slice in shared memory,
// the gates, the sums and the carry (h, c) are float32 as in the float32
// instantiation, and ys, h_T and c_T are rounded to bf16 (nearest even)
// as they are stored. The recurrent product takes h as the TPU kernel
// does, `dot(h.astype(bf16), w_hh, preferred_element_type=f32)`: each
// lane rounds its h to bf16 once, when it pushes it to the h buffers the
// products read, and since a product of two bf16 values is exact in
// float32 the fmaf chain gives the TPU kernel's products exactly (only
// the order of the float32 sum is this body's). The masked variant's hold
// of h on a masked step blends the float32 h, not the rounded one
// (`h_keep = m*h_new + (1-m)*h`, lstm_pallas.py:150-153): each cell item
// keeps its float32 h in a register beside c.

#pragma once

#include <type_traits>

#include "cluster_scan.cuh"

namespace {

template <class IO>
struct Dir {
  const IO* x_proj;  // [T, B, xs]: the direction's 4H columns first
  const IO* w_hh;    // [H, 4H]
  const IO* h0;      // [B, H]
  const IO* c0;      // [B, H]
  IO* ys;            // [T, B, H]
  IO* h_t;           // [B, H]
  IO* c_t;           // [B, H]
};

// Where a CTA's group of n = H / 32 CTAs sits in its cluster.
struct Group {
  int cta;    // the CTA's rank in the group: units [32 cta, 32 cta + 32)
  int rank0;  // the cluster rank of the group's first CTA
  int b0;     // the group's first batch row
};

// w slice [H][kCols], h [h_bufs][R][H] (double- or single-buffered),
// gates [R][kCols]
size_t scan_smem_bytes(int H, int R, int h_bufs) {
  return sizeof(float) * (static_cast<size_t>(H) * kCols
                          + static_cast<size_t>(h_bufs) * R * H + R * kCols);
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

// The scan of one direction by the group `at` (lstm_scan.cu's design
// note): the products in G row groups of RT rows, 4 / C warps each (G = 4
// in the layer scans; 16, every warp, in the multicell scan, which then
// unrolls the k loop twice and fetches the next step's x_proj after the
// products, in flight during the barrier and the cell update, so that its
// registers are free while the accumulators live); with kMasked, the
// masked variant over mask [T, B]; with kSingleH, h single-buffered: a
// cluster barrier after the products (every CTA of the group has read
// h_{t-1}) before the pushes overwrite it, two a step. `d` by value: a
// reference to the kernel's parameters would put both directions' in
// local memory. `xs` is x_proj's row stride in elements: the layer scans
// pass 4 * H, which nvcc then sees as such (a stride read from the
// parameters made bilstm_scan_f32 at B = 200 ~3% slower on an H100,
// bench_turns.py), the multicell scan its cells' total width. IO is the
// I/O type (see above), the mask's too.
template <int RT, int C, int G, bool kMasked, bool kSingleH,
          class IO = float>
__device__ __forceinline__ void scan_body(const Dir<IO> d,
                                          const IO* __restrict__ mask,
                                          int T, int B, int H, int R,
                                          const Group at, size_t xs) {
  constexpr int CPT = (G * RT * kUnits + kThreads - 1) / kThreads;
  constexpr int kWarpsPerGroup = 4 / C;  // warps covering the 128 columns
  static_assert(G * kWarpsPerGroup * 32 <= kThreads, "product warps");
  constexpr int kHBufs = kSingleH ? 1 : 2;
  constexpr bool kLateFetch = G > 4;
  constexpr bool kBF16 = !std::is_same_v<IO, float>;
  // the masked bf16 body keeps each item's float32 h (the f32 body reads
  // it back from the h buffer, which holds it unrounded)
  constexpr bool kHoldH = kMasked && kBF16;
  // Registers the bf16 body gives back, so that none of its
  // instantiations spills (with the float32 body's layout they did from
  // eight rows a lane on; H100 build, sm_90a, `chip_smoke.py` phase 3f
  // gates it), each computing the same sums in the same order: the next
  // step's x_proj stays in bf16 until it goes to the gate slots, two
  // gates a register (kPackX); the masked body reads a step's mask value
  // at its cell update instead of carrying it from the step before
  // (kLateMask); from nine rows a lane on, the product lanes address h
  // from their group's first row, so rows past `rows` (never stored) read
  // up to three rows beyond the tile, inside the shared memory, instead
  // of each row holding a clamped index (kRowBase); and the masked body
  // at ten rows takes one k at a time, one w row and one h value a row,
  // instead of four (kOneK: 37 to 40 rows a cluster, which a masked bf16
  // launch of more than ~300 rows at H = 256 gets, such as a
  // forward(lengths=...) of that many windows or an offline evaluation
  // group that large; the default groups of 64 sequences do not).
  constexpr bool kPackX = kBF16;
  constexpr bool kLateMask = kHoldH;
  constexpr bool kRowBase = kBF16 && RT >= 9;
  constexpr bool kOneK = kRowBase && kMasked && RT == 10;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = H / kUnits;
  const int b0 = at.b0;
  const int unit0 = at.cta * kUnits;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);   // [H][kCols], swizzled
  float* h_s = w_s + H * kCols;                  // [kHBufs][R][H]
  float* gates = h_s + kHBufs * R * H;           // [R][kCols]

  // products: the lane sums the gate columns col0 .. col0 + C - 1 of the
  // slice for the tile rows [r_begin, r_begin + rows) of its row group;
  // past `rows` it repeats the last row and stores nothing, so that the k
  // loop has no branch
  const int lane = tid % 32, grp = tid / 32 / kWarpsPerGroup;
  const int col0 = C * (32 * (tid / 32 % kWarpsPerGroup) + lane);
  const int r_begin = grp * RT;
  const int rows = grp < G ? min(RT, R - r_begin) : 0;

  // the steps this cluster runs: all T, or (masked) up to the tile's last
  // valid step; the gate buffer serves as the reduction's slot
  int t_end = T;
  if constexpr (kMasked)
    t_end = tile_end(mask, T, B, b0, R, reinterpret_cast<int*>(gates));

  // cells: item tid + p*kThreads is (row, unit) = (item / 32, item % 32);
  // it also fetches that (row, unit)'s four x_proj columns (and, masked,
  // its mask value) of the next step
  load_w_slice(d.w_hh, w_s, H, at.cta);
  for (int idx = tid; idx < R * H; idx += kThreads) {
    const int b = b0 + idx / H;
    h_s[idx] =
        b < B ? to_f32(d.h0[static_cast<size_t>(b) * H + idx % H]) : 0.0f;
  }
  float c[CPT];
  float hf[CPT] = {};     // kHoldH: the item's float32 h
  float xn[CPT][4] = {};  // x_proj of the next step, per item and gate
  __nv_bfloat162 xb[CPT][2];  // kPackX: the same, gates (0, 1) and (2, 3)
  float m[CPT] = {}, mn[CPT] = {};  // mask of this step and of the next
#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int r = item / kUnits, u = item % kUnits, b = b0 + r;
    const bool ok = item < R * kUnits && b < B;
    xb[p][0] = xb[p][1] = __floats2bfloat162_rn(0.0f, 0.0f);
    c[p] = ok ? to_f32(d.c0[static_cast<size_t>(b) * H + unit0 + u]) : 0.0f;
    if constexpr (kHoldH)
      hf[p] = ok ? to_f32(d.h0[static_cast<size_t>(b) * H + unit0 + u])
                 : 0.0f;
    if (item < R * kUnits) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gates[r * kCols + g * kUnits + u] =
            ok ? to_f32(__ldg(d.x_proj + b * xs + g * H + unit0 + u))
               : 0.0f;
    }
    if constexpr (kMasked && !kLateMask)
      m[p] = ok && t_end > 0 ? to_f32(__ldg(mask + b)) : 0.0f;
  }
  cluster.sync();  // every CTA started; w_s, h_s[0], x_proj[0] loaded

  // step t+1's x_proj (and, masked, mask) for the cell items
  auto fetch_next = [&](int t) {
    if (t + 1 >= t_end) return;
    const size_t row0 = static_cast<size_t>(t + 1) * B;
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      const int b = b0 + item / kUnits, u = item % kUnits;
      const bool ok = item < R * kUnits && b < B;
      if constexpr (kPackX) {
        const IO* xp = d.x_proj + (row0 + b) * xs + unit0 + u;
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
        xb[p][0] = ok ? __halves2bfloat162(__ldg(xp), __ldg(xp + H)) : zero;
        xb[p][1] = ok ? __halves2bfloat162(__ldg(xp + 2 * H),
                                           __ldg(xp + 3 * H))
                      : zero;
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          xn[p][g] = ok ? to_f32(__ldg(d.x_proj + (row0 + b) * xs + g * H
                                      + unit0 + u))
                        : 0.0f;
      }
      if constexpr (kMasked && !kLateMask)
        mn[p] = ok ? to_f32(__ldg(mask + row0 + b)) : 0.0f;
    }
  };

  int cur = 0;
  for (int t = 0; t < t_end; ++t) {
    if constexpr (!kLateFetch) fetch_next(t);  // in flight during products
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
      const float* hrow = hb + r_begin * H;
      // h[k] of the lane's row i
      auto h_at = [&](int i, int k) {
        return kRowBase ? hrow + i * H + k : hb + ro[i] * H + k;
      };
      auto k_group = [&](int k) {
        float w[4][C];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          load_cols<C>(w_s + swizzle(k + kk, col0), w[kk]);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(h_at(i, k));
          const float hk[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < C; ++j)
              acc[i][j] = fmaf(hk[kk], w[kk][j], acc[i][j]);
        }
      };
      auto k_one_at_a_time = [&](int k) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[C];
          load_cols<C>(w_s + swizzle(k + kk, col0), w);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float hk = *h_at(i, k + kk);
#pragma unroll
            for (int j = 0; j < C; ++j) acc[i][j] = fmaf(hk, w[j], acc[i][j]);
          }
        }
      };
      if constexpr (G > 4) {
        // the multicell scan: unrolled twice, a step of the trio at
        // B = 256 (R = 64) takes ~8% less on an H100, with the same bits
#pragma unroll 2
        for (int k = 0; k < H; k += 4) k_group(k);
      } else if constexpr (RT == 3) {
        // nvcc leaves this loop rolled at three rows a lane; unrolled four
        // times, a step of the masked bi layer at B = 64 (R = 10) takes
        // ~23% less on an H100, with the same bits
#pragma unroll 4
        for (int k = 0; k < H; k += 4) k_group(k);
      } else if constexpr (kOneK) {
        for (int k = 0; k < H; k += 4) k_one_at_a_time(k);
      } else {
        for (int k = 0; k < H; k += 4) k_group(k);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (i < rows) store_cols<C>(gates + ro[i] * kCols + col0, acc[i]);
    }
    if constexpr (kLateFetch) fetch_next(t);
    if constexpr (kSingleH)
      cluster.sync();  // the gates in place; every CTA has read h_{t-1}
    else
      __syncthreads();  // every gate of the tile is in shared memory

    float* h_next = h_s + (kSingleH ? 0 : cur ^ 1) * R * H;
    IO* yt = d.ys + static_cast<size_t>(t) * B * H;
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      const int item = tid + p * kThreads;
      if (item >= R * kUnits) continue;
      const int r = item / kUnits, u = item % kUnits, b = b0 + r;
      float mt = 0.0f;  // masked: this step's mask value
      if constexpr (kLateMask)
        mt = b < B ? to_f32(__ldg(mask + static_cast<size_t>(t) * B + b))
                   : 0.0f;
      else if constexpr (kMasked)
        mt = m[p];
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
        c[p] = blend(mt, c_new, c[p]);
        if constexpr (kHoldH) {
          h = blend(mt, h_new, hf[p]);
          hf[p] = h;
        } else {
          h = blend(mt, h_new, h_s[cur * R * H + r * H + unit0 + u]);
        }
        y = __fmul_rn(mt, h_new);  // exactly zero at a masked step
        if constexpr (!kLateMask) m[p] = mn[p];
      } else {
        c[p] = c_new;
      }
      if (b < B) yt[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(y);
      // the new h of this unit as the products take it (bf16 I/O: rounded
      // to bf16), into the next h buffer of every CTA
      const float hx = round_io<IO>(h);
      for (int q = 0; q < n_cta; ++q)
        cluster.map_shared_rank(h_next, at.rank0 + q)[r * H + unit0 + u] = hx;
      // the next step's x_proj into this (row, unit)'s gate slots
      if constexpr (kPackX) {
        gr[0] = __low2float(xb[p][0]);
        gr[kUnits] = __high2float(xb[p][0]);
        gr[2 * kUnits] = __low2float(xb[p][1]);
        gr[3 * kUnits] = __high2float(xb[p][1]);
      } else {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) gr[gi * kUnits] = xn[p][gi];
      }
    }
    // h_t and x_proj[t+1] are in place everywhere, and nobody reads h_{t-1}
    // any more
    cluster.sync();
    if constexpr (!kSingleH) cur ^= 1;
  }

#pragma unroll
  for (int p = 0; p < CPT; ++p) {
    const int item = tid + p * kThreads;
    const int r = item / kUnits, u = item % kUnits, b = b0 + r;
    if (item < R * kUnits && b < B) {
      // the last h pushed, which bf16 I/O rounded already: h_T is the
      // float32 carry rounded once
      d.h_t[static_cast<size_t>(b) * H + unit0 + u] =
          from_f32<IO>(h_s[cur * R * H + r * H + unit0 + u]);
      d.c_t[static_cast<size_t>(b) * H + unit0 + u] = from_f32<IO>(c[p]);
      if constexpr (kMasked)  // the steps past the tile's last valid one
        for (int t = t_end; t < T; ++t)
          d.ys[(static_cast<size_t>(t) * B + b) * H + unit0 + u] =
              from_f32<IO>(0.0f);
    }
  }
}

// The cluster barriers that scan_body<RT, C, G, false, kSingleH> passes over
// T steps, for a CTA of the cluster that runs no rows: every CTA of a
// cluster reaches every cluster barrier.
template <bool kSingleH>
__device__ __forceinline__ void scan_idle(int T) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < 1 + T * (kSingleH ? 2 : 1); ++i) cluster.sync();
}

}  // namespace

// The float32 LSTM scan body for Hopper (sm_90a) that lstm_scan.cu (the
// layer scans #1, #2 and #3) and multicell_scan.cu (#9) share: one group of
// n = H / 32 CTAs of a thread-block cluster (cluster_scan.cuh) advances R
// batch rows of one LSTM direction over T steps, each CTA holding its
// [H, 128] slice of w_hh in shared memory. lstm_scan.cu's design note says
// how a step runs; multicell_scan.cu's how a cluster holds several groups.
// One body keeps one summation order: each gate starts at x_proj and adds
// h[k] * w[k][col] with fmaf for k = 0 .. H-1, and the cell update is
// written out, so the multicell scan gives the layer scans' bits.

#pragma once

#include "cluster_scan.cuh"

namespace {

struct Dir {
  const float* x_proj;  // [T, B, xs]: the direction's 4H columns first
  const float* w_hh;    // [H, 4H]
  const float* h0;      // [B, H]
  const float* c0;      // [B, H]
  float* ys;            // [T, B, H]
  float* h_t;           // [B, H]
  float* c_t;           // [B, H]
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
// local memory. `xs` is x_proj's row stride in floats: the layer scans
// pass 4 * H, which nvcc then sees as such (a stride read from the
// parameters made bilstm_scan_f32 at B = 200 ~3% slower on an H100,
// bench_turns.py), the multicell scan its cells' total width.
template <int RT, int C, int G, bool kMasked, bool kSingleH>
__device__ __forceinline__ void scan_body(const Dir d,
                                          const float* __restrict__ mask,
                                          int T, int B, int H, int R,
                                          const Group at, size_t xs) {
  constexpr int CPT = (G * RT * kUnits + kThreads - 1) / kThreads;
  constexpr int kWarpsPerGroup = 4 / C;  // warps covering the 128 columns
  static_assert(G * kWarpsPerGroup * 32 <= kThreads, "product warps");
  constexpr int kHBufs = kSingleH ? 1 : 2;
  constexpr bool kLateFetch = G > 4;
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
            ok ? __ldg(d.x_proj + b * xs + g * H + unit0 + u) : 0.0f;
    }
    if constexpr (kMasked) m[p] = ok && t_end > 0 ? __ldg(mask + b) : 0.0f;
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
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xn[p][g] = ok ? __ldg(d.x_proj + (row0 + b) * xs + g * H + unit0 + u)
                      : 0.0f;
      if constexpr (kMasked) mn[p] = ok ? __ldg(mask + row0 + b) : 0.0f;
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
        cluster.map_shared_rank(h_next, at.rank0 + q)[r * H + unit0 + u] = h;
      // the next step's x_proj into this (row, unit)'s gate slots
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) gr[gi * kUnits] = xn[p][gi];
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
      d.h_t[static_cast<size_t>(b) * H + unit0 + u] =
          h_s[cur * R * H + r * H + unit0 + u];
      d.c_t[static_cast<size_t>(b) * H + unit0 + u] = c[p];
      if constexpr (kMasked)  // the steps past the tile's last valid one
        for (int t = t_end; t < T; ++t)
          d.ys[(static_cast<size_t>(t) * B + b) * H + unit0 + u] = 0.0f;
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

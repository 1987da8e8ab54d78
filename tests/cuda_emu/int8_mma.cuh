// The CPU stand-in's int8_mma.cuh (found before ops/csrc/int8_mma.cuh on
// the stand-in's include path): the warp's lanes exchange their fragments
// (emu_warp_share) and each lane sums its four D entries from them, with
// the fragment layout that ops/csrc/int8_mma.cuh states.
#pragma once
#include <cstdint>

inline void mma_s8_m16n8k32(int (&d)[4], const unsigned (&a)[4],
                            const unsigned (&b)[2]) {
  const uint32_t mine[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  const uint32_t (*all)[8] = emu_warp_share(mine, 6);  // a[0..3], b[0..1]
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
    int sum = 0;
    for (int k = 0; k < 32; ++k) {
      // A[row][k] is byte k % 4 of a[(row >= 8) + 2 (k >= 16)] of lane
      // 4 (row % 8) + (k % 16) / 4; B[k][col] byte k % 4 of b[k >= 16] of
      // lane 4 col + (k % 16) / 4
      const int t_k = k % 16 / 4;  // the lane's index in its group
      const uint32_t aw = all[4 * (row % 8) + t_k][(row >= 8) + 2 * (k >= 16)];
      const uint32_t bw = all[4 * col + t_k][4 + (k >= 16)];
      sum += static_cast<int8_t>(aw >> (8 * (k % 4)))
             * static_cast<int8_t>(bw >> (8 * (k % 4)));
    }
    d[i] += sum;
  }
}

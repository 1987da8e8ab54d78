// The int8 tensor-core product of lstm_scan_int8.cu, the one inline PTX of
// the int8 scans, kept here so that the CPU stand-in of the tests can put
// its own in its place.
//
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (sm_80 and later): a
// warp multiplies a 16 x 32 int8 tile A by a 32 x 8 int8 tile B and adds
// the 16 x 8 int32 tile D, exactly. With lane = 4 * g + t (g = lane / 4,
// t = lane % 4), the fragments are (PTX ISA, "mma.m16n8k32", .s8; CUTLASS
// SM80_16x8x32_S32S8S8S32_TN):
//   a[0]: A[g][4t .. 4t+3]          a[1]: A[g+8][4t .. 4t+3]
//   a[2]: A[g][16+4t .. 16+4t+3]    a[3]: A[g+8][16+4t .. 16+4t+3]
//   b[0]: B[4t .. 4t+3][g]          b[1]: B[16+4t .. 16+4t+3][g]
//   d[0], d[1]: D[g][2t], D[g][2t+1]    d[2], d[3]: D[g+8][2t], D[g+8][2t+1]
// four int8 values to a 32-bit register, the lowest k in the lowest byte.

#pragma once

namespace {

__device__ __forceinline__ void mma_s8_m16n8k32(int (&d)[4],
                                                const unsigned (&a)[4],
                                                const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace

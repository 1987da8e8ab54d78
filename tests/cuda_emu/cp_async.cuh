// The CPU stand-in's cp_async.cuh (found before ops/csrc/cp_async.cuh on
// the stand-in's include path): a copy is a plain 16-byte copy (or 16 zero
// bytes), done at once, so commit and wait have nothing to do.
#pragma once
#include <cstring>

inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

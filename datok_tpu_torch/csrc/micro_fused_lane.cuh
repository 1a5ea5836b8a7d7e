// One lane of KP, the fused probe loop: the K-step walk that the TPU
// probe bench_micro/micro_fused.py (kernel :50-82, pallas_call :87)
// runs on a random 16-bit table.  Single C++ source of that walk for
// the CUDA kernel (micro_fused.cu) and its host build (micro_host.cpp,
// for tests).
//
// Step i: a = ring[c] (column b of the (R, B) ring), the two bytes of
// (a, h) from the transposed int8 planes (2H, 256) (table byte - 128,
// low plane in rows [0, H), high plane in rows [H, 2H)), entry =
// (lo + 128) | (hi + 128) << 8, ys[i] = entry ^ i, h' = entry & 2047
// folded into [0, H) as the kernel folds it (:72-74), c = (c + 1) % R.
// This follows the Pallas kernel, not the script's numpy_replay: where
// the one-hot row or the column mask has no match (a not in 1..255, or
// h not in [0, H)) the TPU sums 0, so the byte is 0x80 and the entry
// 0x8080; nothing is read there.
#pragma once

#include <stdint.h>

#ifndef DT_HD
#if defined(__CUDACC__)
#define DT_HD __host__ __device__ __forceinline__
#else
#define DT_HD inline
#endif
#endif

namespace dt {

constexpr int32_t kFusedSymbols = 256;  // columns of the planes (A_pad)
constexpr int32_t kFusedHotMask = (1 << 11) - 1;

// ``ring`` and ``ys`` point at this lane's column; rows are B apart.
DT_HD void micro_fused_lane(const int32_t* ring, int32_t R, int64_t B,
                            const int8_t* planes, int32_t H, int32_t K,
                            int32_t h, int32_t* ys, int32_t* h_out) {
  int32_t c = 0;
  for (int32_t i = 0; i < K; ++i) {
    int32_t a = ring[(int64_t)c * B];
    int32_t lo = 128, hi = 128;
    if (a > 0 && a < kFusedSymbols && h >= 0 && h < H) {
      lo += planes[(int64_t)h * kFusedSymbols + a];
      hi += planes[(int64_t)(H + h) * kFusedSymbols + a];
    }
    int32_t entry = lo | (hi << 8);
    int32_t h_new = entry & kFusedHotMask;
    if (h_new >= H) h_new -= H;
    if (h_new >= H) h_new = 0;
    ys[(int64_t)i * B] = entry ^ i;
    h = h_new;
    c = (c + 1) % R;
  }
  *h_out = h;
}

}  // namespace dt

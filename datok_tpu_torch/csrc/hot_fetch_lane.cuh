// One lane of KF, the hot-plane fetch: the function that the TPU
// probes bench_micro/micro_pallas.py (kernel :38-51, pallas_call :58)
// and bench_micro/micro_ablate.py (kernel :111-130, pallas_call :133)
// compute with a bf16 one-hot matmul and a masked column select.
// Single C++ source of that function for the CUDA kernel (hot_fetch.cu)
// and its host build (micro_host.cpp, for tests).
//
// ``planes`` is (256, n_planes * H) bytes, row a holding the n_planes
// planes of symbol a side by side.  With the select on, the entry of
// (a, h) is the OR over k < n_planes of planes[a, k*H + h] << 8k; with
// it off, the entry is planes[a, 0] whatever h is (the probe's
// ``rows[:, 0]``).  Where the TPU's one-hot row or column mask has no
// match (a not in 1..255, or h not in [0, H) with the select on) the
// entry is 0, and nothing is read.
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

constexpr int32_t kFetchSymbols = 256;  // rows of the planes (A_pad)

template <bool kSelect>
DT_HD int32_t hot_fetch_lane(const uint8_t* planes, int32_t H,
                             int32_t n_planes, int32_t a, int32_t h) {
  if (a <= 0 || a >= kFetchSymbols) return 0;
  const uint8_t* row = planes + (int64_t)a * n_planes * H;
  if (!kSelect) return row[0];
  if (h < 0 || h >= H) return 0;
  uint32_t entry = 0;
  for (int32_t k = 0; k < n_planes; ++k) {
    entry |= (uint32_t)row[(int64_t)k * H + h] << (8 * k);
  }
  return (int32_t)entry;
}

}  // namespace dt

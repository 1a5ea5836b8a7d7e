// One lane of KF, the hot-plane fetch: the function that the TPU
// probes bench_micro/micro_pallas.py (kernel :38-51, pallas_call :58)
// and bench_micro/micro_ablate.py (kernel :111-130, pallas_call :133)
// compute with a bf16 one-hot matmul and a masked column select.
// Single C++ source of that function for the CUDA kernel (hot_fetch.cu)
// and its host build (micro_host.cpp, for tests).
//
// The lane reads one aligned 4-byte word of a table that the wrapper
// prepares once from the probes' (256, n_planes * H) byte planes
// (kernels/hot_fetch.py): the planes interleaved, (256, W, 4) bytes,
// byte k of word (a, h) being planes[a, k*H + h] for k < n_planes, with
// W = H when the select is on; with it off W = 1, since the function
// reads column 0 only.  The lane does the TPU kernel's per-lane work
// around that load: the one-hot row's mask first, then with the select
// on the column mask and the join of the n_planes bytes of its column,
// plane k into bits 8k..8k+7; with it off plane 0's byte (the probe's
// ``rows[:, 0]``), whatever h is.  Where the one-hot row or the column
// mask has no match (a not in 1..255, or h outside [0, H) with the
// select on) the entry is 0, and nothing is read.
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
DT_HD int32_t hot_fetch_lane(const uint32_t* table, int32_t W,
                             int32_t n_planes, int32_t a, int32_t h) {
  if ((uint32_t)(a - 1) >= (uint32_t)(kFetchSymbols - 1)) return 0;
  if (!kSelect) return (int32_t)(table[a] & 0xFFu);
  if ((uint32_t)h >= (uint32_t)W) return 0;
  uint32_t word = table[a * W + h], entry = 0;
  for (int32_t k = 0; k < n_planes; ++k)
    entry |= ((word >> (8 * k)) & 0xFFu) << (8 * k);
  return (int32_t)entry;
}

}  // namespace dt

// KF: the hot-plane fetch for Hopper (sm_90a).
//
// Replaces the TPU kernels of bench_micro/micro_pallas.py
// (make_pallas_fetch, kernel :38, pl.pallas_call :58) and
// bench_micro/micro_ablate.py (make_pallas, kernel :111, pl.pallas_call
// :133): they compute the same function, so one kernel serves both,
// with the column select as a template parameter and the plane count
// as an argument.  The TPU cannot gather, so it builds a bf16 one-hot
// row per lane and multiplies it into all the planes (BL x 256 x 3H
// MACs per block) before a masked reduction keeps one column.  A Hopper
// thread can gather, so each lane reads its n_planes bytes directly.
//
// What bounds it on this card: per lane, 8 bytes of a/h in, n_planes
// scattered one-byte reads of the planes (295 KB at H=384, more than a
// block's shared memory; they stay in the 50 MB L2), 4 bytes out.  So
// at B=16384 a launch moves well under 1 MB and is bound by launch
// latency and one dependent L2 round trip, not by bandwidth.  The a/h
// loads and the store are coalesced (one thread per lane, 256-thread
// blocks); the planes are read through L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hot_fetch_lane.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSelect>
__global__ void __launch_bounds__(kThreads)
hot_fetch_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ h,
                 const uint8_t* __restrict__ planes, int32_t H,
                 int32_t n_planes, int32_t B, int32_t* __restrict__ out) {
  int32_t lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;  // pad lanes of the last block
  out[lane] = dt::hot_fetch_lane<kSelect>(planes, H, n_planes, a[lane],
                                          kSelect ? h[lane] : 0);
}

}  // namespace

// Launches KF on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int dt_hot_fetch_launch(const int32_t* a, const int32_t* h,
                                   const uint8_t* planes, int32_t H,
                                   int32_t n_planes, int32_t select,
                                   int32_t B, int32_t* out, void* stream) {
  if (B > 0) {
    int32_t grid = (B + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (select) {
      hot_fetch_kernel<true><<<grid, kThreads, 0, s>>>(a, h, planes, H,
                                                       n_planes, B, out);
    } else {
      hot_fetch_kernel<false><<<grid, kThreads, 0, s>>>(a, h, planes, H,
                                                        n_planes, B, out);
    }
  }
  return (int)cudaGetLastError();
}

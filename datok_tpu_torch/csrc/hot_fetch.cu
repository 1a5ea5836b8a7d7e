// KF: the hot-plane fetch for Hopper (sm_90a).
//
// Replaces the TPU kernels of bench_micro/micro_pallas.py
// (make_pallas_fetch, kernel :38, pl.pallas_call :58) and
// bench_micro/micro_ablate.py (make_pallas, kernel :111, pl.pallas_call
// :133): they compute the same function, so one kernel serves both,
// with the column select as a template parameter.  The TPU cannot
// gather, so it builds a bf16 one-hot row per lane and multiplies it
// into all the planes (BL x 256 x 3H MACs per block) before a masked
// reduction keeps one column and joins its n_planes bytes.  A Hopper
// thread can gather, so each lane reads its column directly.  As the TPU
// probes convert their planes to bf16 once (make_pallas_fetch,
// make_pallas), the wrapper interleaves them once (kernels/hot_fetch.py,
// hot_fetch_lane.cuh): the bytes of one column of every plane side by
// side in one 4-byte word, so a lane makes one aligned load instead of
// n_planes scattered byte loads H bytes apart, then joins the bytes.
//
// What bounds it on this card: a lane loads 8 bytes of a/h (coalesced),
// then one word of the table (393 KB at H=384, resident in the 50 MB
// L2) whose address depends on them, then stores 4 bytes (coalesced):
// two dependent memory round trips.  At B=16384 a launch moves well
// under 1 MB, so its byte bound (0.04-0.15 us) is far below what one
// launch can reach: the time is launch latency plus those two round
// trips.  256-thread blocks (B=16384 on 64 SMs) measured faster than
// 128-thread blocks on 128 SMs, in both modes (PERF.md).  The host
// side of a call is the larger cost, so a call passes six arguments
// (the table's as one pointer), and the launcher sets the device only
// when it is not the current one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hot_fetch_lane.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSelect>
__global__ void __launch_bounds__(kThreads)
hot_fetch_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ h,
                 const uint32_t* __restrict__ table, int32_t W,
                 int32_t n_planes, int32_t B, int32_t* __restrict__ out) {
  int32_t lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;  // pad lanes of the last block
  out[lane] = dt::hot_fetch_lane<kSelect>(table, W, n_planes, a[lane],
                                          kSelect ? h[lane] : 0);
}

}  // namespace

// The prepared table, set up once by the wrapper (kernels/hot_fetch.py)
// so that a call passes one pointer for it.
struct FetchTable {
  const uint32_t* table;  // (256, W) words of 4 interleaved plane bytes
  int32_t W, n_planes, select, device;
};

// Launches KF on ``stream`` of CUDA device ``t->device``; returns a CUDA
// error code (0 = launched).
extern "C" int dt_hot_fetch_launch(const int32_t* a, const int32_t* h,
                                   int32_t* out, int32_t B,
                                   const FetchTable* t, void* stream) {
  if (B <= 0) return 0;
  int cur = t->device;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != t->device) e = cudaSetDevice(t->device);
  if (e != cudaSuccess) return (int)e;
  int32_t grid = (B + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (t->select)
    hot_fetch_kernel<true><<<grid, kThreads, 0, s>>>(a, h, t->table, t->W,
                                                     t->n_planes, B, out);
  else
    hot_fetch_kernel<false><<<grid, kThreads, 0, s>>>(a, h, t->table, t->W,
                                                      t->n_planes, B, out);
  e = cudaGetLastError();
  if (cur != t->device) {
    cudaError_t r = cudaSetDevice(cur);
    if (e == cudaSuccess) e = r;
  }
  return (int)e;
}

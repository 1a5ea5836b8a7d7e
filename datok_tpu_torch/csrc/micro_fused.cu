// KP: the fused probe loop for Hopper (sm_90a).
//
// Replaces the TPU kernel of bench_micro/micro_fused.py (kernel :50,
// pl.pallas_call :87).  On the TPU a block of BL lanes fetches its ring
// symbol by a masked reduction over the 128 ring rows, builds an int8
// one-hot block and multiplies the (2H, 256) planes into it (2H x 256 x
// BL MACs a step) before a masked reduction keeps row h: the TPU has
// neither a per-lane gather nor a scatter.  A Hopper thread has both,
// so one thread runs one lane's K steps with h and the ring cursor in
// registers and reads two plane bytes a step.
//
// What bounds it on this card: per lane-step one coalesced 4-byte ring
// load, two dependent one-byte plane reads (the planes are 196 KB at
// H=384 and stay in L2) that wait on the previous step's h, and one
// coalesced 4-byte store into the (K, B) rows.  The chain of dependent
// L2 reads sets the time of a lane; all B=16384 lanes are resident at
// once.  Staging the planes in shared memory (they fit the 227 KB
// opt-in) would shorten that chain and is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "micro_fused_lane.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
micro_fused_kernel(const int32_t* __restrict__ ring, int32_t R, int32_t B,
                   const int8_t* __restrict__ planes, int32_t H, int32_t K,
                   const int32_t* __restrict__ h0, int32_t* __restrict__ ys,
                   int32_t* __restrict__ h_out) {
  int32_t lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;  // pad lanes of the last block
  dt::micro_fused_lane(ring + lane, R, B, planes, H, K, h0[lane], ys + lane,
                       h_out + lane);
}

}  // namespace

// Launches KP on ``stream``; returns cudaGetLastError() (0 = launched).
extern "C" int dt_micro_fused_launch(const int32_t* ring, int32_t R,
                                     int32_t B, const int8_t* planes,
                                     int32_t H, int32_t K, const int32_t* h0,
                                     int32_t* ys, int32_t* h_out,
                                     void* stream) {
  if (B > 0) {
    int32_t grid = (B + kThreads - 1) / kThreads;
    micro_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ring, R, B, planes, H, K, h0, ys, h_out);
  }
  return (int)cudaGetLastError();
}

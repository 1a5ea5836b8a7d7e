// Host builds of KF's and KP's per-lane bodies (hot_fetch_lane.cuh,
// micro_fused_lane.cuh), compiled with g++ so the tests can hold the
// kernels' C++ against the JAX probes on a machine without a GPU.  Same
// arguments as dt_hot_fetch_launch (hot_fetch.cu) and
// dt_micro_fused_launch (micro_fused.cu) minus the stream; lanes run one
// after another.  Tests only: the main path never calls it.

#include <stdint.h>

#include "hot_fetch_lane.cuh"
#include "micro_fused_lane.cuh"

extern "C" int dt_hot_fetch_host(const int32_t* a, const int32_t* h,
                                 const uint8_t* planes, int32_t H,
                                 int32_t n_planes, int32_t select, int32_t B,
                                 int32_t* out) {
  for (int32_t lane = 0; lane < B; ++lane) {
    out[lane] = select ? dt::hot_fetch_lane<true>(planes, H, n_planes,
                                                  a[lane], h[lane])
                       : dt::hot_fetch_lane<false>(planes, H, n_planes,
                                                   a[lane], 0);
  }
  return 0;
}

extern "C" int dt_micro_fused_host(const int32_t* ring, int32_t R, int32_t B,
                                   const int8_t* planes, int32_t H, int32_t K,
                                   const int32_t* h0, int32_t* ys,
                                   int32_t* h_out) {
  for (int32_t lane = 0; lane < B; ++lane) {
    dt::micro_fused_lane(ring + lane, R, B, planes, H, K, h0[lane],
                         ys + lane, h_out + lane);
  }
  return 0;
}

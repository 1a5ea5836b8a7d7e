// Host builds of KF's and KP's per-lane bodies (hot_fetch_lane.cuh,
// micro_fused_lane.cuh), compiled with g++ so the tests can hold the
// kernels' C++ against the JAX probes on a machine without a GPU.  Same
// arguments as dt_hot_fetch_launch (hot_fetch.cu) and
// dt_micro_fused_launch (micro_fused.cu) minus the launch's shape,
// device and stream; lanes run one after another.  Tests only: the
// main path never calls it.

#include <stdint.h>

#include <vector>

#include "hot_fetch_lane.cuh"
#include "micro_fused_lane.cuh"

extern "C" int dt_hot_fetch_host(const int32_t* a, const int32_t* h,
                                 const uint32_t* table, int32_t W,
                                 int32_t n_planes, int32_t select, int32_t B,
                                 int32_t* out) {
  for (int32_t lane = 0; lane < B; ++lane) {
    out[lane] = select ? dt::hot_fetch_lane<true>(table, W, n_planes, a[lane],
                                                  h[lane])
                       : dt::hot_fetch_lane<false>(table, W, n_planes,
                                                   a[lane], 0);
  }
  return 0;
}

// KP's L2 form: each lane reads the planes where they lie.
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

// KP's shared-memory form's ring window on the host: the words go into
// a window of W rows (one lane: T = 1) when asked, as the kernel's
// cp.async copies put them there.
struct HostStage {
  const int32_t* ring;  // this lane's column of the (R, B) ring
  int64_t B;
  int32_t R, K, W;
  int32_t* win;

  void issue(int32_t i0) {
    for (int32_t j = 0; j < W && i0 + j < K; ++j)
      win[j] = ring[(int64_t)((i0 + j) % R) * B];
  }
  void wait() {}
};

// KP's shared-memory form: the planes copied first, as the block's bulk
// copy stages them, and each lane's walk on a ring window of ``W`` rows
// (the plan's ring_rows), filled before the walk as the kernel fills it
// while the planes arrive.
extern "C" int dt_micro_fused_staged_host(const int32_t* ring, int32_t R,
                                          int32_t B, const int8_t* planes,
                                          int32_t H, int32_t K,
                                          const int32_t* h0, int32_t* ys,
                                          int32_t* h_out, int32_t W) {
  if (W < 1) return 1;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(planes);
  std::vector<uint8_t> staged(bytes, bytes + 2 * (int64_t)H * dt::kFusedSymbols);
  std::vector<int32_t> win(W);
  for (int32_t lane = 0; lane < B; ++lane) {
    HostStage stage{ring + lane, B, R, K, W, win.data()};
    stage.issue(0);
    dt::micro_fused_lane_staged(staged.data(), H, K, h0[lane], ys + lane, B,
                                h_out + lane, win.data(), 1, W, stage);
  }
  return 0;
}

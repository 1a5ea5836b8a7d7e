// KP: the fused probe loop for Hopper (sm_90a).
//
// Replaces the TPU kernel of bench_micro/micro_fused.py (kernel :50,
// pl.pallas_call :87).  On the TPU a block of BL lanes fetches its ring
// symbol by a masked reduction over the 128 ring rows, builds an int8
// one-hot block and multiplies the (2H, 256) planes into it (2H x 256 x
// BL MACs a step) before a masked reduction keeps row h: the TPU has
// neither a per-lane gather nor a scatter.  A Hopper thread has both,
// so one thread runs one lane's K steps with h in a register and reads
// two plane bytes a step (micro_fused_lane.cuh).
//
// What bounds it on this card: per lane-step one 4-byte ring word and
// one 4-byte store, both off the chain, and two plane reads that wait
// on the previous step's h.  All B=16384 lanes are resident at once
// (one warp a scheduler), so nothing hides that chain: a lane's time is
// K times one plane read plus the step's dependent integer work.  Two
// forms, picked by kernels/micro_fused.py:plan from H, B, K and the SM
// count:
// - shared memory, where the planes (2H x 256 bytes) and at least one
//   row of a ring window fit one block's 227 KB: persistent blocks, one
//   an SM, at most 256 threads.  One thread issues TMA bulk copies of
//   the planes into the block's shared memory against an mbarrier;
//   meanwhile each thread copies its lane's ring words into its column
//   of a window after the planes (cp.async, 4 bytes each, nothing
//   waits), so no global load sits among the steps: measured, a global
//   load between steps slowed the shared-memory reads of the chain.
//   Each plane read is then a shared-memory read instead of an L2
//   round trip.  The steps are a short loop unrolled by 4 (a longer
//   unrolled body cost more in instruction fetch at kernel start than
//   it saved).  The fill (the planes into every SM: 25 MB at H=384) is
//   the new cost, bound by what one SM takes in more than by L2: half
//   the blocks barely shortened it, and thread-block clusters that
//   multicast the copy (L2 read once a cluster) were slower on an H100
//   (PERF.md), so each block copies the planes for itself.
// - L2 (larger planes): the planes stay in L2, 256-thread blocks, one
//   lane a thread, each step's ring word loaded when it is needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "micro_fused_lane.cuh"

namespace {

constexpr int kL2Threads = 256;
constexpr int kSmemThreads = 256;  // at most, kernels/micro_fused.py:plan
// one block's shared memory on Hopper (sharedMemPerBlockOptin)
constexpr int kSmemLimit = 232448;
constexpr uint32_t kFillChunk = 16384;  // bytes of one bulk copy
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kL2Threads)
micro_fused_kernel(const int32_t* __restrict__ ring, int32_t R, int32_t B,
                   const int8_t* __restrict__ planes, int32_t H, int32_t K,
                   const int32_t* __restrict__ h0, int32_t* __restrict__ ys,
                   int32_t* __restrict__ h_out) {
  int32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;  // pad lanes of the last block
  dt::micro_fused_lane(ring + lane, R, B, planes, H, K, h0[lane], ys + lane,
                       h_out + lane);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The planes (n_bytes) into this block's shared memory at ``dst``, cut
// into kFillChunk bulk copies, each signalling ``bar`` as it lands.
__device__ __forceinline__ void fill(uint32_t dst, const uint8_t* src,
                                     uint32_t n_bytes, uint32_t bar) {
  for (uint32_t off = 0; off < n_bytes; off += kFillChunk) {
    uint32_t n = n_bytes - off < kFillChunk ? n_bytes - off : kFillChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(dst + off),
        "l"(src + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// A lane's ring window (micro_fused_lane_staged): the ring words of W
// steps into this thread's column of the window, 4 bytes each with
// cp.async (no register holds them, and nothing waits until wait()).
// Each thread reads only its own column, so no barrier is needed.
struct RingStage {
  const int32_t* ring;  // this lane's column of the (R, B) ring
  int64_t B;
  int32_t R, K, W, T;
  uint32_t win;  // shared address of this thread's column

  __device__ __forceinline__ void issue(int32_t i0) {
    int32_t c = i0 % R;
    int32_t n = K - i0 < W ? K - i0 : W;
    for (int32_t j = 0; j < n; ++j) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       win + 4u * (uint32_t)(j * T)),
                   "l"(ring + (int64_t)c * B)
                   : "memory");
      if (++c == R) c = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ void wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

__global__ void __launch_bounds__(kSmemThreads, 1)
micro_fused_smem_kernel(const int32_t* __restrict__ ring, int32_t R,
                        int32_t B, const uint8_t* __restrict__ planes,
                        int32_t H, int32_t K, int32_t W,
                        const int32_t* __restrict__ h0,
                        int32_t* __restrict__ ys,
                        int32_t* __restrict__ h_out) {
  // shared memory: the planes (2H x 256 bytes, a multiple of 512), the
  // ring window (W rows of blockDim.x words), the mbarrier
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t n_bytes = 2u * H * dt::kFusedSymbols;
  const int32_t T = blockDim.x;
  uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  const int32_t* win = reinterpret_cast<const int32_t*>(smem + n_bytes);
  uint32_t bar = dst + n_bytes + 4u * (uint32_t)(W * T);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(n_bytes)
                 : "memory");
  }
  __syncthreads();  // the barrier armed before any thread waits on it
  if (threadIdx.x == 0) fill(dst, planes, n_bytes, bar);

  // while the planes arrive: the first lane's start row and ring window
  int32_t lane = blockIdx.x * T + threadIdx.x;
  const int32_t stride = gridDim.x * T;
  RingStage stage{ring + lane, B, R, K, W, T,
                  dst + n_bytes + 4u * threadIdx.x};
  int32_t h = 0;
  if (lane < B) {
    h = h0[lane];
    stage.issue(0);
  }
  wait_parity(bar, 0);
  for (; lane < B; lane += stride) {
    dt::micro_fused_lane_staged(smem, H, K, h, ys + lane, B, h_out + lane,
                                win + threadIdx.x, T, W, stage);
    int32_t next = lane + stride;
    if (next < B) {
      h = h0[next];
      stage.ring = ring + next;
      stage.issue(0);
    }
  }
}

cudaError_t smem_launch(int device, int grid, int threads, int smem,
                        cudaStream_t s, const int32_t* ring, int32_t R,
                        int32_t B, const int8_t* planes, int32_t H, int32_t K,
                        int32_t W, const int32_t* h0, int32_t* ys,
                        int32_t* h_out) {
  // the opt-in to a block's whole shared memory, once a device
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t e = cudaFuncSetAttribute(
        micro_fused_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return e;
    ready[device] = true;
  }
  micro_fused_smem_kernel<<<grid, threads, smem, s>>>(
      ring, R, B, reinterpret_cast<const uint8_t*>(planes), H, K, W, h0, ys,
      h_out);
  return cudaGetLastError();
}

}  // namespace

// Launches KP on ``stream`` of CUDA device ``device`` in the form that
// kernels/micro_fused.py:plan chose: ``smem`` > 0 is the shared-memory
// form with ``smem`` bytes of dynamic shared memory (the planes, a ring
// window of ``ring_rows`` rows, the mbarrier), 0 the L2 form.  Returns
// a CUDA error code (0 = launched).
extern "C" int dt_micro_fused_launch(const int32_t* ring, int32_t R,
                                     int32_t B, const int8_t* planes,
                                     int32_t H, int32_t K, const int32_t* h0,
                                     int32_t* ys, int32_t* h_out,
                                     int32_t grid, int32_t threads,
                                     int32_t smem, int32_t ring_rows,
                                     int32_t device, void* stream) {
  if (B <= 0) return 0;
  int cur = device;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (smem == 0) {
    micro_fused_kernel<<<grid, threads, 0, s>>>(ring, R, B, planes, H, K, h0,
                                                ys, h_out);
    e = cudaGetLastError();
  } else {
    e = smem_launch(device, grid, threads, smem, s, ring, R, B, planes, H, K,
                    ring_rows, h0, ys, h_out);
  }
  if (cur != device) {
    cudaError_t r = cudaSetDevice(cur);
    if (e == cudaSuccess) e = r;
  }
  return (int)e;
}

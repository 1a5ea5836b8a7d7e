// K1: the batched transduce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel datok_tpu/runtime/pallas_engine.py:_make_kernel
// (:384, launched through pl.pallas_call at :674) together with the
// XLA round loop around it (_run_machine_pallas, :737) and the event
// compaction after it (jax_engine.py:_compact_ys, :1370).  It computes
// what they compute together: the events and exit state of the
// reference loop for every lane.  One thread runs one lane's step loop
// (transduce_step.cuh) to completion; the TPU's round loop, service
// steps and cold-entry injection have no counterpart, since a Hopper
// thread can read any cell of the table itself.
//
// K1 runs the full step (transduce_step.cuh): the TPU kernel's run
// skip and fused boundaries are part of it, so a step may take a run
// of letters or a whole token boundary.  The general form is compiled
// beside it, over the matrix and over a double array: an engine built
// with engine="general" launches it (a double-array model, which has
// no per-state words, only ever runs it), the default engine the full
// form.  The double-array instance is the counterpart of the JAX
// general machine over DoubleArrayRep (jax_engine.py:_run_machine,
// :702, an XLA while loop of gathers): a loop of torch ops would cost
// what the plain machine does, so the loop folds into the kernel.
// Read as base, then check and base again, its step would wait on two
// dependent L2 loads where a matrix step waits on one.  So the tables
// are interleaved (word, check) pairs (24.4 MB at DE size, in the 50
// MB L2) and each lane carries the base of every state it holds: the
// step loads its probe's check cell and its transition's pair at once
// from registers, and a separate-state hop reads a small hop table
// through L1 with __ldg, not L2 (transduce_step.cuh).  The hop table
// is not staged into shared memory: on an H100 that was at most 2.6%
// faster with a table of a few entries and slower from 16 KB on, what
// it took of the SM's 256 KB being what L1 lost (PERF.md).  A double
// array has no hot set and takes up to 256 threads a block, as many
// blocks as the lanes need.  Measured on an H100, the step with its
// one dependent L2 load runs about 0.84x the time of the
// base-then-check step it replaced and 1.2x the matrix general form's,
// with about an eighth more instructions a step; with hops spread over
// a hop table of one entry a state (147 KB) it takes 1.08x as long,
// a hop that misses L1 taking a second L2 load back (PERF.md).
//
// What bounds it on this card: each step is a chain of the state's
// cells, whose loads wait for the step before, and integer selects, so
// a lane is latency bound, and the wave's lanes are the only
// parallelism (B = 32768 gives 8 warps an SM); a warp takes as many
// steps as its slowest lane.  The full form cuts the steps a character
// by two fifths at a quarter more instructions a step; measured, K1
// runs at about four times its instruction bound, and where the cells
// come from matters less than the loads a step waits on (PERF.md).
// The design:
// - the full form's per-state words (runtime/rep.py:state_table,
//   73.6 KB at 18,405 states) are read from device memory through L1,
//   so the ε probe and the skip and fuse gates are one load on the
//   state, mostly an L1 hit.  Staged into shared memory at block start
//   they measured 2-4% slower on an H100 (PERF.md): they take
//   that much of the SM's L1, which holds the table's and the meta's
//   lines;
// - the consume cell from the ε target, which a fused boundary needs,
//   is loaded beside the transition cell, not after it, and the next
//   meta word after both (the skip gate decides its address);
// - with a hot set (runtime/hot.py; the engine keeps none by default,
//   since it made K1 slower on mixed text) the hot states' rows are
//   staged into shared memory at block start, 16 bytes a thread at a
//   time, so a step from a hot state is one shared-memory load; cold
//   states read the whole table, which stays in the 50 MB L2;
// - tagged cells tell the lane whether its next state is hot without a
//   lookup;
// - each lane reads its own row of the (B, L) meta, one word a step
//   ahead of its use (past a skipped run when it skips), whose lines
//   stay in L1 while the lane walks them, so no transpose runs before
//   the launch;
// - one block per SM (the hot rows take the SM's shared memory),
//   with ceil(B / SMs) lanes a block rounded up to a warp, so every SM
//   gets lanes; a thread loops over lanes when B exceeds 1024 a block.
//
// Events go per lane, in step order, to row ``lane`` of a (B, E)
// buffer with E = max_steps: a lane emits at most one event per step,
// so the row cannot overflow, and no compaction pass is needed.  Each
// block sums its lanes' cold steps and steps and adds them, with one
// atomic each, to ``cold`` (this launch, zeroed here first) and, when
// given, to ``cold_total`` (the engine's running sum).

#include <cuda_runtime.h>
#include <stdint.h>

#include "transduce_step.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallThreads = 256;

struct Outs {
  int32_t *events, *counts, *state, *steps;
  uint8_t* bad;
  unsigned long long *cold, *cold_total;
};

// ``kFull`` picks the step's form, ``kLayout`` the tables' layout.
template <int kThreads, bool kFull, dt::Layout kLayout>
__global__ void __launch_bounds__(kThreads, 1)
transduce_kernel(dt::Model m, const uint4* __restrict__ hot_rows,
                 int32_t n_hot_quads, const int32_t* __restrict__ meta,
                 int32_t L, int32_t B, const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ entries,
                 const uint8_t* __restrict__ stops, int32_t max_steps,
                 Outs o) {
  extern __shared__ uint4 smem_hot[];
  __shared__ unsigned long long block_sum[2];
  // stage the hot rows, 16 bytes a thread per load
#pragma unroll 4
  for (int32_t i = threadIdx.x; i < n_hot_quads; i += blockDim.x)
    smem_hot[i] = __ldg(hot_rows + i);
  if (threadIdx.x == 0) block_sum[0] = block_sum[1] = 0;
  __syncthreads();
  // (without a hot set no lane is hot and the pointer is never read)
  m.hot = reinterpret_cast<const uint32_t*>(smem_hot);
  if (kLayout == dt::Layout::DoubleArray) m.root_b = dt::da_base(m, dt::ROOT);

  unsigned long long cold = 0, steps = 0;
  for (int32_t lane = blockIdx.x * blockDim.x + threadIdx.x; lane < B;
       lane += gridDim.x * blockDim.x) {
    cold += dt::run_lane<kFull, kLayout>(
        m, meta + (int64_t)lane * L, L, lengths[lane], entries[lane],
        stops[lane] != 0, max_steps, o.events + (int64_t)lane * max_steps,
        o.counts + lane, o.bad + lane, o.state + (int64_t)lane * 6,
        o.steps + lane);
    steps += o.steps[lane];
  }
  for (int d = 16; d > 0; d >>= 1) {
    cold += __shfl_down_sync(0xffffffffu, cold, d);
    steps += __shfl_down_sync(0xffffffffu, steps, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_sum[0], cold);
    atomicAdd(&block_sum[1], steps);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(o.cold, block_sum[0]);
    atomicAdd(o.cold + 1, block_sum[1]);
    if (o.cold_total != nullptr) {
      atomicAdd(o.cold_total, block_sum[0]);
      atomicAdd(o.cold_total + 1, block_sum[1]);
    }
  }
}

template <int kThreads, bool kFull,
          dt::Layout kLayout = dt::Layout::Matrix>
cudaError_t launch(int grid, int threads, size_t smem, cudaStream_t stream,
                   const dt::Model& m, const uint4* hot_rows,
                   int32_t n_hot_quads, const int32_t* meta, int32_t L,
                   int32_t B, const int32_t* lengths, const int32_t* entries,
                   const uint8_t* stops, int32_t max_steps, const Outs& o) {
  auto kernel = transduce_kernel<kThreads, kFull, kLayout>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(m, hot_rows, n_hot_quads, meta, L,
                                          B, lengths, entries, stops,
                                          max_steps, o);
  return cudaGetLastError();
}

template <int kThreads>
cudaError_t launch_form(bool full, int grid, int threads, size_t smem,
                        cudaStream_t stream, const dt::Model& m,
                        const uint4* hot_rows, int32_t n_hot_quads,
                        const int32_t* meta, int32_t L, int32_t B,
                        const int32_t* lengths, const int32_t* entries,
                        const uint8_t* stops, int32_t max_steps,
                        const Outs& o) {
  if (full)
    return launch<kThreads, true>(grid, threads, smem, stream, m, hot_rows,
                                  n_hot_quads, meta, L, B, lengths, entries,
                                  stops, max_steps, o);
  return launch<kThreads, false>(grid, threads, smem, stream, m, hot_rows,
                                 n_hot_quads, meta, L, B, lengths, entries,
                                 stops, max_steps, o);
}

// The launch's SMs, the first step of every entry.
cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// Launches K1 on ``stream``; returns a CUDA error code (0 = launched).
// ``hot_rows`` holds ``n_hot`` cells (a multiple of 4, 0 without a hot
// set), ``st`` the ``n_st`` per-state words, ``full`` picks the full
// form (1) or the general one (0), ``meta`` is (B, L), ``cold`` two
// int64; ``n_cells`` < 2^31.
extern "C" int dt_transduce_launch(
    const uint32_t* table, int64_t n_cells, int32_t S, int32_t max_sym,
    int32_t eps, int32_t unknown, int32_t identity, const uint32_t* hot_rows,
    int32_t n_hot, const int32_t* hot_of, int32_t n_hot_of, int32_t root_h,
    uint32_t tag_mask, const int32_t* st, int32_t n_st, int32_t full,
    const int32_t* meta, int32_t L, int32_t B,
    const int32_t* lengths, const int32_t* entries, const uint8_t* stops,
    int32_t max_steps, int32_t* events, int32_t* counts, uint8_t* bad,
    int32_t* state, int32_t* steps, int64_t* cold, int64_t* cold_total,
    void* stream) {
  cudaStream_t strm = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(cold, 0, 2 * sizeof(int64_t), strm);
  if (e != cudaSuccess || B <= 0) return (int)e;
  int n_sm = 0;
  e = sm_count(&n_sm);
  if (e != cudaSuccess) return (int)e;
  int per_sm = (B + n_sm - 1) / n_sm;
  int threads = ((per_sm + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  int grid = (B + threads - 1) / threads;
  if (grid > n_sm) grid = n_sm;
  dt::Model m{table, hot_rows, hot_of, st, n_st, (int32_t)n_cells, S,
              max_sym, eps, unknown, identity, n_hot_of, root_h, tag_mask,
              nullptr, 0};
  Outs o{events, counts, state, steps, bad,
         reinterpret_cast<unsigned long long*>(cold),
         reinterpret_cast<unsigned long long*>(cold_total)};
  const uint4* rows = reinterpret_cast<const uint4*>(hot_rows);
  int32_t quads = n_hot / 4;
  size_t smem = (size_t)quads * sizeof(uint4);
  if (threads <= kSmallThreads)
    e = launch_form<kSmallThreads>(full != 0, grid, threads, smem, strm, m,
                                   rows, quads, meta, L, B, lengths, entries,
                                   stops, max_steps, o);
  else
    e = launch_form<kMaxThreads>(full != 0, grid, threads, smem, strm, m,
                                 rows, quads, meta, L, B, lengths, entries,
                                 stops, max_steps, o);
  return (int)e;
}

// Launches K1's general form over a double array on ``stream``:
// ``base`` (n_cells < 2^28 words, read where a lane enters), ``pairs``
// (n_cells interleaved (word, check) pairs), ``hop`` (the hop table,
// entries of two words), ``size`` the size field; the other arguments
// and the return are dt_transduce_launch's.  Blocks of ceil(B / SMs)
// lanes rounded up to a warp, at most 256, as many as the lanes need.
extern "C" int dt_transduce_da_launch(
    const uint32_t* base, const uint32_t* pairs, const uint32_t* hop,
    int64_t n_cells, int32_t size, int32_t eps, int32_t unknown,
    int32_t identity, const int32_t* meta, int32_t L, int32_t B,
    const int32_t* lengths, const int32_t* entries, const uint8_t* stops,
    int32_t max_steps, int32_t* events, int32_t* counts, uint8_t* bad,
    int32_t* state, int32_t* steps, int64_t* cold, int64_t* cold_total, void* stream) {
  cudaStream_t strm = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(cold, 0, 2 * sizeof(int64_t), strm);
  if (e != cudaSuccess || B <= 0) return (int)e;
  int n_sm = 0;
  e = sm_count(&n_sm);
  if (e != cudaSuccess) return (int)e;
  int per_sm = (B + n_sm - 1) / n_sm;
  int threads = ((per_sm + 31) / 32) * 32;
  if (threads > kSmallThreads) threads = kSmallThreads;
  int grid = (B + threads - 1) / threads;
  dt::Model m{base, nullptr, nullptr, nullptr, 0, (int32_t)n_cells, 0, 0,
              eps, unknown, identity, 0, 0, 0u,
              reinterpret_cast<const uint64_t*>(pairs), size,
              reinterpret_cast<const uint64_t*>(hop), 0u};
  Outs o{events, counts, state, steps, bad,
         reinterpret_cast<unsigned long long*>(cold),
         reinterpret_cast<unsigned long long*>(cold_total)};
  return (int)launch<kSmallThreads, false, dt::Layout::DoubleArray>(
      grid, threads, 0, strm, m, nullptr, 0, meta, L, B, lengths, entries,
      stops, max_steps, o);
}

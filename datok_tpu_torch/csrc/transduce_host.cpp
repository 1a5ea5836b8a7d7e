// Host build of K1's step (transduce_step.cuh), compiled with g++ so the
// tests can hold the kernel's C++ step logic against the JAX reference
// on a machine without a GPU.  Same arguments as dt_transduce_launch
// (transduce.cu) minus the stream; lanes run one after another and the
// hot rows are read where they lie.  Tests only: the main path never
// calls it.

#include <stdint.h>

#include "transduce_step.cuh"

namespace {

using RunLane = int32_t (*)(const dt::Model&, const int32_t*, int32_t,
                            int32_t, int32_t, bool, int32_t, int32_t*,
                            int32_t*, uint8_t*, int32_t*, int32_t*);

// Every lane, one after another, with ``run``; the step and cold counts
// as the kernel sums them.
int run_lanes(RunLane run, const dt::Model& m, const int32_t* meta,
              int32_t L, int32_t B, const int32_t* lengths,
              const int32_t* entries, const uint8_t* stops,
              int32_t max_steps, int32_t* events, int32_t* counts,
              uint8_t* bad, int32_t* state, int32_t* steps, int64_t* cold,
              int64_t* cold_total) {
  int64_t n_cold = 0, n_steps = 0;
  for (int32_t lane = 0; lane < B; ++lane) {
    n_cold += run(m, meta + (int64_t)lane * L, L, lengths[lane],
                  entries[lane], stops[lane] != 0, max_steps,
                  events + (int64_t)lane * max_steps, counts + lane,
                  bad + lane, state + (int64_t)lane * 6, steps + lane);
    n_steps += steps[lane];
  }
  cold[0] = n_cold;
  cold[1] = n_steps;
  if (cold_total != nullptr) {
    cold_total[0] += n_cold;
    cold_total[1] += n_steps;
  }
  return 0;
}

}  // namespace

extern "C" int dt_transduce_host(
    const uint32_t* table, int64_t n_cells, int32_t S, int32_t max_sym,
    int32_t eps, int32_t unknown, int32_t identity, const uint32_t* hot_rows,
    int32_t n_hot, const int32_t* hot_of, int32_t n_hot_of, int32_t root_h,
    uint32_t tag_mask, const int32_t* st, int32_t n_st, int32_t full,
    const int32_t* meta, int32_t L, int32_t B,
    const int32_t* lengths, const int32_t* entries, const uint8_t* stops,
    int32_t max_steps, int32_t* events, int32_t* counts, uint8_t* bad,
    int32_t* state, int32_t* steps, int64_t* cold, int64_t* cold_total) {
  (void)n_hot;
  dt::Model m{table, hot_rows, hot_of, st, n_st, (int32_t)n_cells, S,
              max_sym, eps, unknown, identity, n_hot_of, root_h, tag_mask,
              nullptr, 0};
  return run_lanes(full ? dt::run_lane<true, dt::Layout::Matrix>
                        : dt::run_lane<false, dt::Layout::Matrix>,
                   m, meta, L, B, lengths, entries, stops, max_steps, events,
                   counts, bad, state, steps, cold, cold_total);
}

// The general form over a double array; the arguments are
// dt_transduce_da_launch's (transduce.cu) minus the stream.
extern "C" int dt_transduce_da_host(
    const uint32_t* base, const uint32_t* pairs, const uint32_t* hop,
    int64_t n_cells, int32_t size, int32_t eps, int32_t unknown,
    int32_t identity, const int32_t* meta, int32_t L, int32_t B,
    const int32_t* lengths, const int32_t* entries, const uint8_t* stops,
    int32_t max_steps, int32_t* events, int32_t* counts, uint8_t* bad,
    int32_t* state, int32_t* steps, int64_t* cold, int64_t* cold_total) {
  dt::Model m{base, nullptr, nullptr, nullptr, 0, (int32_t)n_cells, 0, 0,
              eps, unknown, identity, 0, 0, 0u,
              reinterpret_cast<const uint64_t*>(pairs), size,
              reinterpret_cast<const uint64_t*>(hop), 0u};
  m.root_b = dt::da_base(m, dt::ROOT);
  return run_lanes(dt::run_lane<false, dt::Layout::DoubleArray>, m, meta, L,
                   B, lengths, entries, stops, max_steps, events, counts, bad,
                   state, steps, cold, cold_total);
}

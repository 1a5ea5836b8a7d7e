// One lane of KP, the fused probe loop: the K-step walk that the TPU
// probe bench_micro/micro_fused.py (kernel :50-82, pallas_call :87)
// runs on a random 16-bit table.  Single C++ source of that walk for
// the CUDA kernel's two forms (micro_fused.cu) and their host builds
// (micro_host.cpp, for tests).
//
// Step i: a = ring[c] (column b of the (R, B) ring), the two bytes of
// (a, h) from the transposed int8 planes (2H, 256) (table byte - 128,
// low plane in rows [0, H), high plane in rows [H, 2H)), entry =
// (lo + 128) | (hi + 128) << 8, ys[i] = entry ^ i, h' = entry & 2047
// folded into [0, H) as the kernel folds it (:72-74), c = (c + 1) % R.
// This follows the Pallas kernel, not the script's numpy_replay: where
// the one-hot row or the column mask has no match (a not in 1..255, or
// h not in [0, H)) the TPU sums 0, so the byte is 0x80 and the entry
// 0x8080; nothing is read there.
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

constexpr int32_t kFusedSymbols = 256;  // columns of the planes (A_pad)
constexpr int32_t kFusedHotMask = (1 << 11) - 1;
// One step's entry of symbol ``a`` in row ``h`` of the planes.
DT_HD int32_t fused_entry(const int8_t* planes, int32_t H, int32_t a,
                          int32_t h) {
  int32_t lo = 128, hi = 128;
  if (a > 0 && a < kFusedSymbols && h >= 0 && h < H) {
    int32_t at = h * kFusedSymbols + a;
    lo += planes[at];
    hi += planes[at + H * kFusedSymbols];
  }
  return lo | (hi << 8);
}

// The next row: the entry's low 11 bits folded into [0, H).
DT_HD int32_t fused_next_h(int32_t entry, int32_t H) {
  int32_t h = entry & kFusedHotMask;
  if (h >= H) h -= H;
  if (h >= H) h = 0;
  return h;
}

// The L2 form: ``ring`` and ``ys`` point at this lane's column; rows
// are B apart; each step loads its ring word when it needs it.
DT_HD void micro_fused_lane(const int32_t* ring, int32_t R, int64_t B,
                            const int8_t* planes, int32_t H, int32_t K,
                            int32_t h, int32_t* ys, int32_t* h_out) {
  int32_t c = 0;
  for (int32_t i = 0; i < K; ++i) {
    int32_t entry = fused_entry(planes, H, ring[(int64_t)c * B], h);
    ys[(int64_t)i * B] = entry ^ i;
    h = fused_next_h(entry, H);
    c = (c + 1) % R;
  }
  *h_out = h;
}

// The shared-memory form, on the block's staged planes: each lane
// finds the ring words of its next W steps in a window of shared memory
// (``win``: the word of window row r at win[r * T], T the lanes a
// block), which ``stage.issue(i)`` fills with the words of steps i, i+1,
// ... (at most W) and ``stage.wait()`` waits for; the caller has issued
// the first window (the kernel does so while the planes arrive).  No
// global load sits among the steps, and each step's symbol is read a
// step ahead, so a step's chain is the address, two shared-memory
// reads, the bytes joined and masked, and the fold: the step masks the
// two bytes with a mask from its symbol alone (0 where a is outside
// 1..255, and at step 0 where h0 is outside [0, H), which then reads
// row 0), so it has no branch.  The bytes are read unsigned:
// u = (v - 128) mod 256, so v = u ^ 0x80.
template <class Stage>
DT_HD void micro_fused_lane_staged(const uint8_t* planes, int32_t H,
                                   int32_t K, int32_t h, int32_t* ys,
                                   int64_t B, int32_t* h_out,
                                   const int32_t* win, int32_t T, int32_t W,
                                   Stage& stage) {
  stage.wait();
  int32_t a = win[0];
  if ((uint32_t)h >= (uint32_t)H) {
    h = 0;
    a = 0;
  }
  // the high plane's row of h, carried beside h so that both bytes'
  // addresses are one operation from the fold
  int32_t hH = h + H;
  for (int32_t i0 = 0; i0 < K; i0 += W) {
    if (i0 > 0) {  // the next window, when K exceeds W
      stage.issue(i0);
      stage.wait();
      a = win[0];
    }
    const int32_t n = K - i0 < W ? K - i0 : W;
#pragma unroll 4
    for (int32_t r = 0; r < n; ++r) {
      int32_t a_next = r + 1 < n ? win[(r + 1) * T] : 0;
      bool valid = (uint32_t)(a - 1) < (uint32_t)(kFusedSymbols - 1);
      uint32_t ok = valid ? 0xFFFFu : 0u;
      uint32_t ok_e = valid ? (uint32_t)kFusedHotMask : 0u;
      uint32_t a8 = (uint32_t)a & 0xFFu;
      uint32_t u = (uint32_t)planes[((uint32_t)h << 8) | a8] |
                   ((uint32_t)planes[((uint32_t)hH << 8) | a8] << 8);
      int32_t i = i0 + r;
      ys[(int64_t)i * B] = (int32_t)((u & ok) ^ 0x8080u) ^ i;
      int32_t e = (int32_t)((u & ok_e) ^ 0x80u);
      bool low = e < H, mid = e < 2 * H;
      h = low ? e : (mid ? e - H : 0);
      hH = low ? e + H : (mid ? e : H);
      a = a_next;
    }
  }
  *h_out = h;
}

}  // namespace dt

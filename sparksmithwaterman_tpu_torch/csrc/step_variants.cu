// K7: packed lane bests under the step variants A-E of the TPU probe.
//
// Replaces the TPU kernel
//   experiments/packed_step_variants.py:make_kernel
// which times five forms of the packed wavefront step against C references:
// packed rows (ROWS, M) int32 (code in the low byte, START_BIT on segment
// starts) and refs (C, N) uint8 give out (C, ROWS, M) int32.  Lane i on
// step d sees ref[d - i] (REF_PAD outside [0, N)); `steps` steps run (the
// m + n - 1 diagonals rounded up to whole bodies of the TPU loop) and all
// of them count:
//
//   c1[i] = max(0, r2[i] + sub(read[i], ref[d - i]), max(r1[i], d1[i]) + gap)
//   x[i]  = c1[(i - 1) mod M]                     (the TPU's circular roll)
//   rc[i] = A, E: start[i] ? 0 : x[i]     B: i == 0 ? 0 : x[i]
//           C:    x[i] * !start[i]        D: x[i]
//   d1, r2, r1 = c1, r1, rc
//
// A-D end with the segmented suffix max over the start lanes (each start
// lane then holds its read's best); E stores the raw lane bests.  B and D
// are not Smith-Waterman; the probe timed them, and this kernel reproduces
// them exactly, the wrap of D included.
//
// What bounds it on the H100: integer ALU throughput, as K1.  L = M / 32
// lanes per thread in registers, the circular shift as one __shfl_sync per
// step, each variant its own instantiation so its step is the instruction
// form the probe meant (select, lane-0 select, multiply, none).  The
// reference is read from global memory through the read-only cache, one
// byte per thread per step, fetched a step ahead.  Two forms, chosen by
// the wrapper from the shape and the scheme alone (ops/cuda_score.py
// step_form):
//
// - s16x2 (step_variant_s16x2_kernel; A, B, D and E), where no value can
//   leave int16: two (reference, row) rows per warp, one in each 16-bit
//   half of every register, both against the same reference column, the
//   substitution as in wavefront.cuh sweep_s16x2 (codes as f16 halves,
//   eq_unit16x2 and one IMAD), and each variant's mask in halves: A and E
//   AND the start lanes' keep2, B zeroes thread 0's first register only,
//   D has no mask.  The best is a 3-input max over pairs of steps.
// - int32 (step_variant_kernel, one warp per (reference, row)): variant C
//   always, and every call the rule does not admit.  C's point is the
//   multiply by "not a start", and the card has no 16x2 integer multiply,
//   so C has no 16-bit form: an AND would be variant A again.
#include "wavefront.cuh"

namespace {

using namespace swt;

enum Variant { kA = 0, kB = 1, kC = 2, kD = 3, kE = 4 };

__device__ __forceinline__ int ref_code(const uint8_t* ref, int j, int n) {
  return (j >= 0 && j < n) ? (int)__ldg(ref + j) : kRefPad;
}

template <int L, int V>
__global__ void __launch_bounds__(kThreads)
step_variant_kernel(const int32_t* __restrict__ packed, int rows,
                    int row_blocks, const uint8_t* __restrict__ refs, int n,
                    int steps, int match, int mismatch, int gap,
                    int32_t* __restrict__ out) {
  const int c = blockIdx.x / row_blocks;
  const int row = (blockIdx.x % row_blocks) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles stay within it
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  const int m = 32 * L;
  const int left = (lane + 31) & 31;
  const uint8_t* ref = refs + (long long)c * n;

  int rd[L], keep[L], rw[L], d1[L], r1[L], r2[L], best[L];
  uint32_t start = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int raw = packed[(long long)row * m + first + k];
    rd[k] = raw & 255;
    if (raw >= kStartBit) start |= 1u << k;
    keep[k] = raw >= kStartBit ? 0 : 1;
    rw[k] = kRefPad;
    d1[k] = r1[k] = r2[k] = best[k] = 0;
  }
  int next = ref_code(ref, -first, n);
  for (int d = 0; d < steps; ++d) {
#pragma unroll
    for (int k = L - 1; k > 0; --k) rw[k] = rw[k - 1];
    rw[0] = next;
    next = ref_code(ref, d + 1 - first, n);
    int c1[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int sub = rd[k] == rw[k] ? match : mismatch;
      c1[k] = max(max(r2[k] + sub, max(r1[k], d1[k]) + gap), 0);
    }
    const int wrap = __shfl_sync(0xffffffffu, c1[L - 1], left);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int x = k > 0 ? c1[k - 1] : wrap;
      int rc;
      if (V == kA || V == kE)
        rc = ((start >> k) & 1u) ? 0 : x;
      else if (V == kB)
        rc = (k == 0 && lane == 0) ? 0 : x;
      else if (V == kC)
        rc = x * keep[k];
      else
        rc = x;
      best[k] = max(best[k], c1[k]);
      r2[k] = r1[k];
      r1[k] = rc;
      d1[k] = c1[k];
    }
  }

  int32_t* o = out + ((long long)c * rows + row) * m + first;
  if (V == kE) {
#pragma unroll
    for (int k = 0; k < L; ++k) o[k] = best[k];
    return;
  }
  // Segmented suffix max, as in lane_best.cu: first within the thread,
  // right to left, restarting after each segment start; `open` marks
  // lanes whose segment runs past this thread's last lane.
  int run = 0;
  bool is_open = true;
  uint32_t open = 0;
#pragma unroll
  for (int k = L - 1; k >= 0; --k) {
    if (k < L - 1 && ((start >> (k + 1)) & 1u)) {
      run = 0;
      is_open = false;
    }
    run = max(run, best[k]);
    best[k] = run;
    if (is_open) open |= 1u << k;
  }
  // Then the carry from the threads to the right, while the segment runs
  // on: flag bit 0 = the thread's first lane starts a segment, bit 1 = a
  // segment starts inside the thread after its first lane.
  const int head = best[0];
  const int flags = (start & 1u) | ((open & 1u) ? 0 : 2);
  int carry = 0;
  bool stop = false;
  for (int u = 1; u < 32; ++u) {
    const int hv = __shfl_sync(0xffffffffu, head, u);
    const int fl = __shfl_sync(0xffffffffu, flags, u);
    if (u > lane && !stop) {
      if (fl & 1) {
        stop = true;
      } else {
        carry = max(carry, hv);
        if (fl & 2) stop = true;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k)
    o[k] = ((open >> k) & 1u) ? max(best[k], carry) : best[k];
}

// -- The s16x2 form ---------------------------------------------------------

// Steps per iteration of the s16x2 loop: even (the best takes pairs), and
// for L <= 8 a multiple of L, so that the window of reference columns
// rotates by register name and never moves; wider rows keep their window
// as bytes, four columns a register, as sweep_s16x2 does.
template <int L>
constexpr int kVariantUnroll = L > 8 ? 2 : (L < 2 ? 2 : L);

// One warp's two rows against one reference, all in registers: H = c1 of
// the step before, U = the shifted term of the step before, w = the
// window of reference columns its lanes see, next = the code of the
// column that enters it on the next step (fetched a step ahead).
template <int L, int V>
struct VariantS16x2 {
  static constexpr bool kBytes = L > 8;
  static constexpr int NW = kBytes ? L / 4 : L;
  uint32_t rd2[L], keep2[L], H[L], U[L], best[L], w[NW];
  uint32_t keep0;  // B: zeroes the wrap into lane 0 (thread 0's first register)
  int next, first, left, n;
  const uint8_t* ref;
  uint32_t k_sub, mismatch2, gap2;

  // Step d = (a multiple of kVariantUnroll) + u.  kBest: 0 the step's
  // value is left for the next one, 2 it is the second of a pair (one
  // 3-input max with the first's value, which H still holds), 1 it is
  // counted alone.
  template <int u, int kBest>
  __device__ __forceinline__ void step(int d) {
    if (!kBytes) {
      w[u % L] = code_half(next) * 0x00010001u;
    } else {
#pragma unroll
      for (int q = NW - 1; q > 0; --q) w[q] = __funnelshift_l(w[q - 1], w[q], 8);
      w[0] = __byte_perm(w[0], (uint32_t)next, 0x2104);
    }
    next = ref_code(ref, d + 1 - first, n);
    const uint32_t wrap = __shfl_sync(0xffffffffu, H[L - 1], left);
#pragma unroll
    for (int k = L - 1; k >= 0; --k) {
      // Lane first + k reads column d - first - k: window slot (u - k) mod L.
      const uint32_t rw = kBytes ? __byte_perm(w[k / 4], 0x3C3C3C3Cu, 0x4040 + 0x0101 * (k % 4))
                                 : w[((u - k) % L + L) % L];
      uint32_t up = k > 0 ? H[k - 1] : wrap;
      if (V == kA || V == kE) up &= keep2[k];
      if (V == kB && k == 0) up &= keep0;
      const uint32_t v = eq_unit16x2(rd2[k], rw) * k_sub + U[k];
      const uint32_t h = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(__vmaxs2(up, H[k]), gap2));
      if (kBest == 1) best[k] = __vmaxs2(best[k], h);
      if (kBest == 2) best[k] = __vimax3_s16x2(best[k], H[k], h);
      U[k] = up;
      H[k] = h;
    }
  }

  // Steps d .. d + R - 1, the best over each pair.
  template <int R, int u = 0>
  __device__ __forceinline__ void steps(int d) {
    if constexpr (u < R) {
      step<u, (u & 1) ? 2 : 0>(d + u);
      steps<R, u + 1>(d);
    }
  }

  // Steps d .. d + r - 1 for r < R, each counted alone, under forward
  // branches (no loop).
  template <int R, int u = 0>
  __device__ __forceinline__ void tail(int d, int r) {
    if constexpr (u < R - 1) {
      if (u < r) step<u, 1>(d + u);
      tail<R, u + 1>(d, r);
    }
  }
};

// Block b of reference c takes rows 8 (b % row_blocks) .. + 7, warp w
// the pair 2w, 2w + 1; an odd number of rows leaves the last pair's high
// half empty (READ_PAD, which matches no reference code, so it stays 0,
// and it is not stored).  k_sub = match - mismatch, mismatch2 and gap2
// pair16 of the scheme.
template <int L, int V>
__global__ void __launch_bounds__(kThreads)
step_variant_s16x2_kernel(const int32_t* __restrict__ packed, int rows,
                          int row_blocks, const uint8_t* __restrict__ refs, int n,
                          int steps, uint32_t k_sub, uint32_t mismatch2,
                          uint32_t gap2, int32_t* __restrict__ out) {
  constexpr int R = kVariantUnroll<L>;
  using State = VariantS16x2<L, V>;
  const int c = blockIdx.x / row_blocks;
  const int row = (blockIdx.x % row_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles stay within it
  const int lane = threadIdx.x & 31;
  const int m = 32 * L;
  const bool has_hi = row + 1 < rows;

  State st;
  st.first = lane * L;
  st.left = (lane + 31) & 31;
  st.n = n;
  st.ref = refs + (long long)c * n;
  st.k_sub = k_sub;
  st.mismatch2 = mismatch2;
  st.gap2 = gap2;
  st.keep0 = lane == 0 ? 0u : 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = st.first + k;
    const int lo = packed[(long long)row * m + i];
    const int hi = has_hi ? packed[(long long)(row + 1) * m + i] : kReadPad;
    st.rd2[k] = code_half(lo) | code_half(hi) << 16;
    st.keep2[k] = (lo >= kStartBit ? 0u : 0x0000FFFFu) | (hi >= kStartBit ? 0u : 0xFFFF0000u);
    st.H[k] = st.U[k] = st.best[k] = 0;
  }
#pragma unroll
  for (int q = 0; q < State::NW; ++q)
    st.w[q] = State::kBytes ? (uint32_t)kRefPad * 0x01010101u : code_half(kRefPad) * 0x00010001u;
  st.next = ref_code(st.ref, -st.first, n);

  int d = 0;
  for (; d + R <= steps; d += R) st.template steps<R>(d);
  st.template tail<R>(d, steps - d);

  // The reference, the rows and the start lanes again, from the block
  // index and the rows, so that none of them holds a register across the
  // loop (ptxas spilled them otherwise, as in lane_best.cu).
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const int row2 = (block % row_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  const bool has_hi2 = row2 + 1 < rows;
  const int first = (threadIdx.x & 31) * L;
  int32_t* o = out + ((long long)(block / row_blocks) * rows + row2) * m;
  int lo_best[L], hi_best[L];
  uint32_t start_lo = 0, start_hi = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    lo_best[k] = (int)(st.best[k] & 0xFFFFu);
    hi_best[k] = (int)(st.best[k] >> 16);
    if (V != kE) {
      start_lo |= (uint32_t)(packed[(long long)row2 * m + first + k] >= kStartBit) << k;
      start_hi |= (uint32_t)(has_hi2 && packed[(long long)(row2 + 1) * m + first + k] >= kStartBit) << k;
    }
  }
  if (V == kE) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      o[first + k] = lo_best[k];
      if (has_hi2) o[m + first + k] = hi_best[k];
    }
    return;
  }
  store_suffix_max<L>(lo_best, start_lo, m, true, o);
  store_suffix_max<L>(hi_best, start_hi, m, has_hi2, o + m);
}

}  // namespace

extern "C" int swt_step_variant_best(const void* packed, int rows, int m,
                                     const void* refs, int c, int n,
                                     int variant, int steps, int match,
                                     int mismatch, int gap, void* out,
                                     int device, void* stream) {
  const int L = m / 32;
  if (m % 32 || (L & (L - 1)) || L < 1 || L > 32 || rows <= 0 || c <= 0 ||
      n < 0 || steps < 0 || variant < 0 || variant > 4)
    return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = row_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L * 8 + variant) {
#define SWT_LAUNCH_V(l, v)                                                   \
  case l * 8 + v:                                                            \
    step_variant_kernel<l, v><<<(unsigned)blocks, swt::kThreads, 0, s>>>(    \
        (const int32_t*)packed, rows, (int)row_blocks, (const uint8_t*)refs, \
        n, steps, match, mismatch, gap, (int32_t*)out);                      \
    break;
#define SWT_LAUNCH(l) \
  SWT_LAUNCH_V(l, 0) SWT_LAUNCH_V(l, 1) SWT_LAUNCH_V(l, 2) SWT_LAUNCH_V(l, 3) SWT_LAUNCH_V(l, 4)
    SWT_LAUNCH(1) SWT_LAUNCH(2) SWT_LAUNCH(4) SWT_LAUNCH(8) SWT_LAUNCH(16) SWT_LAUNCH(32)
#undef SWT_LAUNCH
#undef SWT_LAUNCH_V
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The s16x2 form (variants A, B, D, E); the wrapper takes it only where
// ops/cuda_score.py step_form says so.  This entry refuses variant C and
// what no form of the rule admits: a scheme of the wrong signs, or match x
// ceil(steps / 2) > 32767 (B: match x min(ceil(steps / 2), m)).
extern "C" int swt_step_variant_best_s16x2(const void* packed, int rows, int m,
                                           const void* refs, int c, int n,
                                           int variant, int steps, int match,
                                           int mismatch, int gap, void* out,
                                           int device, void* stream) {
  const int L = m / 32;
  const long long half = ((long long)steps + 1) / 2;
  const long long reach = variant == kB && m < half ? m : half;
  const bool fits = match >= 0 && (long long)match * reach <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0;
  if (m % 32 || (L & (L - 1)) || L < 1 || L > 32 || rows <= 0 || c <= 0 ||
      n < 0 || steps < 0 || variant < 0 || variant > 4 || variant == kC || !fits)
    return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = row_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L * 8 + variant) {
#define SWT_LAUNCH_V(l, v)                                                       \
  case l * 8 + v:                                                                \
    step_variant_s16x2_kernel<l, v><<<(unsigned)blocks, swt::kThreads, 0, s>>>(  \
        (const int32_t*)packed, rows, (int)row_blocks, (const uint8_t*)refs, n,  \
        steps, (uint32_t)(match - mismatch), swt::pair16(mismatch),              \
        swt::pair16(gap), (int32_t*)out);                                        \
    break;
#define SWT_LAUNCH(l) SWT_LAUNCH_V(l, 0) SWT_LAUNCH_V(l, 1) SWT_LAUNCH_V(l, 3) SWT_LAUNCH_V(l, 4)
    SWT_LAUNCH(1) SWT_LAUNCH(2) SWT_LAUNCH(4) SWT_LAUNCH(8) SWT_LAUNCH(16) SWT_LAUNCH(32)
#undef SWT_LAUNCH
#undef SWT_LAUNCH_V
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6: best of each lane over a chain of wavefront steps, no memory traffic.
//
// Replaces the TPU kernels
//   sparksmithwaterman_tpu/ops/microbench.py:_roofline_kernel
//   experiments/triangle_timepack.py:_chain_kernel   (masked = 1)
// which run the step of pallas_score.py:_make_step `steps` times on an
// (RB, M) int32 state held in registers:
//
//   c1[i] = max(0, r2[i] + sub[i], max(r1[i], d1[i]) + gap)
//   rc[i] = start[i] ? 0 : c1[(i - 1) mod M]      (the TPU's circular roll)
//   d1, r2, r1 = c1, r1, rc
//
// where sub[i] compares lane i's code (the low byte of reads[row][i]) with
// row 0's code at lane i, constant over the steps, and start[i] is
// reads[row][i] >= START_BIT.  out[row][i] is the max of c1[i] over the
// steps the TPU kernel counts: `steps / unroll` bodies of `unroll` steps;
// with masked = 0 and an odd unroll each body's last step is run but not
// counted (the TPU body keeps a max over pairs of steps).  masked = 1 adds
// the time-packing probe's moving boundary: on step s, lanes i >= (s & 1023)
// are zeroed in c1 and in rc (rc still reads the unmasked c1 of lane i-1).
//
// What bounds it on the H100: integer ALU throughput, nothing else; there is no
// memory traffic between the first load and the last store.  So the design
// keeps everything in registers: L = M / 32 lanes per thread, the circular
// i-1 shift as one __shfl_sync per step whose source is the thread to the
// left (thread 0 reads thread 31).  Two forms, chosen by the wrapper from
// the data alone (ops/cuda_score.py step_form):
//
// - s16x2 (step_chain_s16x2_kernel), where no value can leave int16: warp
//   w of a block takes rows 2w and 2w + 1, one in each 16-bit half of every
//   register, as K1's s16x2 form does.  The substitution is constant, so
//   each register's pair of sub values is made once before the loop, and
//   the step is sweep_s16x2's without the reference: per register of two
//   cells, the start-lane AND, __vmaxs2 and __vadd2 for the gap term,
//   __viaddmax_s16x2_relu for the rest, and half of a 3-input max for the
//   best (one __vimax3_s16x2 per pair of steps).  The one shuffle moves
//   both rows' wrap, each in its own half.  The masked probe's boundary is
//   a per-register select shared by both halves (both hold the same lane).
// - int32 (step_chain_kernel, one warp per row): every other call.
#include "wavefront.cuh"

namespace {

using namespace swt;

template <int L, bool kMasked, bool kCount>
__device__ __forceinline__ void chain_step(int (&d1)[L], int (&r1)[L],
                                           int (&r2)[L], int (&best)[L],
                                           const int (&sub)[L], uint32_t start,
                                           int left, int first, int s,
                                           int gap) {
  int c[L];
#pragma unroll
  for (int k = 0; k < L; ++k)
    c[k] = max(max(r2[k] + sub[k], max(r1[k], d1[k]) + gap), 0);
  const int wrap = __shfl_sync(0xffffffffu, c[L - 1], left);
  const int b = s & 1023;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    int rc = ((start >> k) & 1u) ? 0 : (k > 0 ? c[k - 1] : wrap);
    int ck = c[k];
    if (kMasked && first + k >= b) {
      rc = 0;
      ck = 0;
    }
    if (kCount) best[k] = max(best[k], ck);
    r2[k] = r1[k];
    r1[k] = rc;
    d1[k] = ck;
  }
}

template <int L, bool kMasked>
__global__ void __launch_bounds__(kThreads)
step_chain_kernel(const int32_t* __restrict__ reads, int rb, int bodies,
                  int counted, int unroll, int match, int mismatch, int gap,
                  int32_t* __restrict__ out) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rb) return;  // a whole warp: the shuffles stay within it
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  const int m = 32 * L;
  const int left = (lane + 31) & 31;

  int sub[L], d1[L], r1[L], r2[L], best[L];
  uint32_t start = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int raw = reads[(long long)row * m + first + k];
    sub[k] = (raw & 255) == (reads[first + k] & 255) ? match : mismatch;
    if (raw >= kStartBit) start |= 1u << k;
    d1[k] = r1[k] = r2[k] = best[k] = 0;
  }
  int s = 0;
  for (int t = 0; t < bodies; ++t) {
#pragma unroll 4
    for (int k = 0; k < counted; ++k, ++s)
      chain_step<L, kMasked, true>(d1, r1, r2, best, sub, start, left, first,
                                   s, gap);
    for (int k = counted; k < unroll; ++k, ++s)
      chain_step<L, kMasked, false>(d1, r1, r2, best, sub, start, left, first,
                                    s, gap);
  }
  int32_t* o = out + (long long)row * m + first;
#pragma unroll
  for (int k = 0; k < L; ++k) o[k] = best[k];
}

// -- The s16x2 form ---------------------------------------------------------
//
// The state of a register between steps: H = c1 of the step before (d1;
// masked where the lane was dead), U = the shifted term of the step before
// (r2), hu = the unmasked c1 of the thread's last register (the next
// step's wrap, masked form only).  The shifted term of lane i is computed
// from H[i-1] on the step that uses it: with the boundary, lane i live
// implies lane i-1 live, so H[i-1] masked equals the unmasked c1 there;
// only the wrap (lane 0 from lane M-1) needs hu.

// All ones where lane `lane` is live on a step whose boundary is b.
__device__ __forceinline__ uint32_t live_mask(int lane, int b) {
  return (uint32_t)((lane - b) >> 31);
}

// One step s.  kBest: 0 the step is not counted, 1 it is counted alone,
// 2 it is the second of a counted pair (one 3-input max with the first's
// value, which H still holds).
template <int L, bool kMasked, int kBest>
__device__ __forceinline__ void chain_step_s16x2(uint32_t (&H)[L], uint32_t (&U)[L],
                                                 uint32_t (&best)[L], uint32_t& hu,
                                                 const uint32_t (&sub2)[L],
                                                 const uint32_t (&keep2)[L], int left,
                                                 int first, int s, uint32_t gap2) {
  const int b = s & 1023, b_prev = (s - 1) & 1023;
  const uint32_t wrap = __shfl_sync(0xffffffffu, kMasked ? hu : H[L - 1], left);
#pragma unroll
  for (int k = L - 1; k >= 0; --k) {
    uint32_t up = (k > 0 ? H[k - 1] : wrap) & keep2[k];
    if (kMasked) up &= live_mask(first + k, b_prev);
    uint32_t h = __viaddmax_s16x2_relu(U[k], sub2[k], __vadd2(__vmaxs2(up, H[k]), gap2));
    if (kMasked) {
      if (k == L - 1) hu = h;
      h &= live_mask(first + k, b);
    }
    if (kBest == 1) best[k] = __vmaxs2(best[k], h);
    if (kBest == 2) best[k] = __vimax3_s16x2(best[k], H[k], h);
    U[k] = up;
    H[k] = h;
  }
}

// Pairs of counted steps per iteration of the pair loop: enough that the
// loop's counter is a small share of its instructions, few enough that
// the loop stays small.
template <int L>
constexpr int kChainPairs = L >= 8 ? 1 : 8 / L;

template <int L, bool kMasked>
__device__ __forceinline__ void chain_pairs_s16x2(int n, uint32_t (&H)[L], uint32_t (&U)[L],
                                                  uint32_t (&best)[L], uint32_t& hu,
                                                  const uint32_t (&sub2)[L],
                                                  const uint32_t (&keep2)[L], int left,
                                                  int first, int& s, uint32_t gap2) {
  constexpr int P = kChainPairs<L>;
  int q = 0;
  for (; q + P <= n; q += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      chain_step_s16x2<L, kMasked, 0>(H, U, best, hu, sub2, keep2, left, first, s, gap2);
      chain_step_s16x2<L, kMasked, 2>(H, U, best, hu, sub2, keep2, left, first, s + 1, gap2);
      s += 2;
    }
  }
  // The last n % P pairs, unrolled under forward branches, so that the
  // pair loop above is the only loop.
#pragma unroll
  for (int p = 0; p < P - 1; ++p) {
    if (q + p < n) {
      chain_step_s16x2<L, kMasked, 0>(H, U, best, hu, sub2, keep2, left, first, s, gap2);
      chain_step_s16x2<L, kMasked, 2>(H, U, best, hu, sub2, keep2, left, first, s + 1, gap2);
      s += 2;
    }
  }
}

// Block b takes rows 8b .. 8b + 7, warp w the pair 2w, 2w + 1; an odd rb
// leaves the last pair's high half empty (sub 0 and every lane a start,
// so it stays 0, and it is not stored).
template <int L, bool kMasked>
__global__ void __launch_bounds__(kThreads)
step_chain_s16x2_kernel(const int32_t* __restrict__ reads, int rb, int bodies,
                        int unroll, int match, int mismatch, uint32_t gap2,
                        int32_t* __restrict__ out) {
  const int row = blockIdx.x * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if (row >= rb) return;  // a whole warp: the shuffles stay within it
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  const int m = 32 * L;
  const int left = (lane + 31) & 31;
  const bool has_hi = row + 1 < rb;

  uint32_t sub2[L], keep2[L], H[L], U[L], best[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    const int ref = reads[i] & 255;
    const int lo = reads[(long long)row * m + i];
    const int hi = has_hi ? reads[(long long)(row + 1) * m + i] : kStartBit;
    const int sub_lo = (lo & 255) == ref ? match : mismatch;
    const int sub_hi = has_hi ? ((hi & 255) == ref ? match : mismatch) : 0;
    sub2[k] = ((uint32_t)sub_lo & 0xFFFFu) | (uint32_t)sub_hi << 16;
    keep2[k] = (lo >= kStartBit ? 0u : 0x0000FFFFu) | (hi >= kStartBit ? 0u : 0xFFFF0000u);
    H[k] = U[k] = best[k] = 0;
  }
  uint32_t hu = 0;
  int s = 0;
  // Bodies of an even unroll run as one chain of pairs; with an odd unroll
  // each body ends in one more step, counted only when masked.
  const bool single = unroll & 1;
  const int pairs = single ? unroll / 2 : bodies * (unroll / 2);
  for (int t = 0; t < (single ? bodies : 1); ++t) {
    chain_pairs_s16x2<L, kMasked>(pairs, H, U, best, hu, sub2, keep2, left, first, s, gap2);
    if (single) {
      chain_step_s16x2<L, kMasked, kMasked ? 1 : 0>(H, U, best, hu, sub2, keep2, left, first, s, gap2);
      ++s;
    }
  }
  int32_t* o = out + (long long)row * m + first;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    o[k] = (int)(best[k] & 0xFFFFu);
    if (has_hi) o[m + k] = (int)(best[k] >> 16);
  }
}

}  // namespace

extern "C" int swt_step_chain_best(const void* reads, int rb, int m, int steps,
                                   int unroll, int match, int mismatch,
                                   int gap, int masked, void* out, int device,
                                   void* stream) {
  const int L = m / 32;
  if (m % 32 || swt::pick_lanes(m) != L || rb <= 0 || steps < 0 ||
      unroll < (masked ? 1 : 2))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rb + swt::kWarps - 1) / swt::kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bodies = steps / unroll;
  const int counted = (masked || unroll % 2 == 0) ? unroll : unroll - 1;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L * 2 + (masked ? 1 : 0)) {
#define SWT_LAUNCH_MASK(l, mk)                                            \
  case l * 2 + mk:                                                        \
    step_chain_kernel<l, mk><<<(unsigned)blocks, swt::kThreads, 0, s>>>(  \
        (const int32_t*)reads, rb, bodies, counted, unroll, match,        \
        mismatch, gap, (int32_t*)out);                                    \
    break;
#define SWT_LAUNCH(l) SWT_LAUNCH_MASK(l, 0) SWT_LAUNCH_MASK(l, 1)
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
#undef SWT_LAUNCH_MASK
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The s16x2 form; the wrapper takes it only where ops/cuda_score.py
// step_form says so.  This entry checks only the rule's loosest bound, as
// it cannot see whether lane 0 of every row starts (which the wrapper reads
// from the data) or whether the masked bound applies: it refuses a scheme
// of the wrong signs, or match x min(ceil(S / 2), m) > 32767 for the S
// steps that run.  Rows whose lane 0 is not a start are the wrapper's to
// refuse.
extern "C" int swt_step_chain_best_s16x2(const void* reads, int rb, int m, int steps,
                                         int unroll, int match, int mismatch, int gap,
                                         int masked, void* out, int device, void* stream) {
  const int L = m / 32;
  if (m % 32 || swt::pick_lanes(m) != L || rb <= 0 || steps < 0 || unroll < (masked ? 1 : 2))
    return (int)cudaErrorInvalidValue;
  const int bodies = steps / unroll;
  const long long run = (long long)bodies * unroll;
  const long long reach = (run + 1) / 2 < m ? (run + 1) / 2 : m;
  const bool fits = match >= 0 && (long long)match * reach <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0;
  if (!fits) return (int)cudaErrorInvalidValue;
  const long long blocks = (rb + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L * 2 + (masked ? 1 : 0)) {
#define SWT_LAUNCH_MASK(l, mk)                                                  \
  case l * 2 + mk:                                                              \
    step_chain_s16x2_kernel<l, mk><<<(unsigned)blocks, swt::kThreads, 0, s>>>(  \
        (const int32_t*)reads, rb, bodies, unroll, match, mismatch,             \
        swt::pair16(gap), (int32_t*)out);                                       \
    break;
#define SWT_LAUNCH(l) SWT_LAUNCH_MASK(l, 0) SWT_LAUNCH_MASK(l, 1)
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
#undef SWT_LAUNCH_MASK
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

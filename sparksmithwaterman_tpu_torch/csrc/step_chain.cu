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
// keeps everything in registers: one warp per row, L = M / 32 lanes per
// thread, the circular i-1 shift as one __shfl_sync per step whose source is
// the thread to the left (thread 0 reads thread 31).
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

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
// What bounds it on the H100: integer ALU throughput, as K1.  One warp per
// (reference, row), L = M / 32 lanes per thread in registers, the circular
// shift as one __shfl_sync per step, each variant its own instantiation so
// its step is the instruction form the probe meant (select, lane-0 select,
// multiply, none).  The reference is read from global memory through the
// read-only cache, one byte per thread per step, fetched a step ahead.
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

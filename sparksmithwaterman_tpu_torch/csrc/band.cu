// K3: packed lane best over one reference SEGMENT, with the DP's left
// boundary column in and its right boundary column out.
//
// Replaces the TPU kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_diag_kernel_packed_band
// (reached through _band_call and pallas_band_lane_best), the in-segment
// fill of the shard_seq strategy: one DP matrix cut along the reference
// into segments that run in order, the right column of one segment
// becoming the left column of the next.
//
// Contract.  packed (ROWS, M) int32 as K1 (read code in the low byte,
// START_BIT = 256 on each segment's first lane).  Segment c is the
// seg_lens[c] bytes at segs + offs[c] (int64 offsets); it has ns[c] >= 1
// columns, and columns past seg_lens[c] read as REF_PAD.  bnd
// (C, ROWS, M) int32 is the column H[i, -1] left of the segment.  Out:
//   out     (C, ROWS, M): per-lane best over the segment, suffix-maxed per
//           packed read; each read's START lane is the contract;
//   bnd_out (C, ROWS, M): H[i, ns[c] - 1] at every lane i < M.
// Chaining segments left to right (zero bnd into the first, each bnd_out
// into the next) and taking the max of the start lanes equals K1 on the
// whole reference.
//
// Left column in: before diagonal i, lane i's state (its W term for
// column 0) is set to bnd[i].  Lane i+1 reads it on diagonal i as its N
// term and so holds it as its NW term for diagonal i+1 (zero at a
// segment start, through zmask).  It is state, not a cell of this
// segment, so it does not enter best.  A lane on a diagonal before its
// column 0 computes a cell left of the segment from these values; such a
// cell is at most bnd[i'] + gap for a lane i' above it in the same read,
// which cell (i', 0) already reaches, so start lanes do not see them.
// Right column out: lane i's value on diagonal i + ns - 1.  Every
// segment runs exactly m + ns - 1 diagonals, whatever seg_lens says, so
// an all-pad tail segment still passes its (decaying) column on.  Lanes
// past M and rows past ROWS are isolated all-pad segments, as in K1, and
// take no boundary value.
//
// What bounds it on the H100: the same register-resident integer sweep as
// K1 (wavefront.cuh), plus a compare and a select per cell for the right
// column; bnd is read once and the two outputs are written once, so it
// is bound by integer operations, not bytes.  The design keeps K1's
// shape: one warp per packed row, L lanes per thread, one shuffle per
// diagonal, the segment streamed through the 4 KB shared ring; the
// boundary injection runs only on the first M diagonals.
#include "wavefront.cuh"

namespace {

using namespace swt;

// A copy of K1's segmented suffix max (lane_best.cu) as a function; K1
// keeps its own, since it spills when it calls this one.  best[] over the
// warp's 32 * L lanes, segments beginning at the set bits of `start`
// (lane-local), then the row's lanes < m stored to o when `live`.  Every
// lane of the warp must call it.
template <int L>
__device__ __forceinline__ void store_suffix_max(int (&best)[L],
                                                 uint32_t start, int m,
                                                 bool live, int32_t* o) {
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  // First within the thread, right to left, restarting at segment
  // starts; `open` marks lanes whose segment runs past this thread's
  // last lane.
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
  // Then the carry from the threads to the right: walk right while the
  // segment continues.  head = max over this thread's first local segment;
  // flag bit 0 = lane `first` starts a segment, bit 1 = a segment starts
  // inside this thread after lane `first`.
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
  if (!live) return;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (first + k < m) o[first + k] = ((open >> k) & 1u) ? max(best[k], carry) : best[k];
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
band_kernel(const int32_t* __restrict__ packed, int rows, int m,
            int row_blocks, const uint8_t* __restrict__ segs,
            const long long* __restrict__ offs,
            const int32_t* __restrict__ seg_lens,
            const int32_t* __restrict__ ns,
            const int32_t* __restrict__ bnd, int match, int mismatch, int gap,
            int32_t* __restrict__ out, int32_t* __restrict__ bnd_out) {
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / row_blocks;
  const int row = (blockIdx.x % row_blocks) * kWarps + (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const bool live = row < rows;
  const int width = max(ns[c], 1);
  const int nd = m + width - 1;
  const long long base = ((long long)c * rows + row) * m;

  int rd[L], bv[L], bo[L], best[L];
  uint32_t start = 0;  // bit k: lane first+k starts a segment
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    const bool real = live && i < m;
    const int raw = real ? packed[(long long)row * m + i] : kStartBit;
    rd[k] = raw & 255;
    if (raw >= kStartBit || i == 0) start |= 1u << k;
    bv[k] = real ? bnd[base + i] : 0;
    bo[k] = 0;
    best[k] = 0;
  }
  const int last = first + width - 1;  // diagonal of lane `first` in column ns-1
  sweep<L>(
      rd, start, nd, segs + offs[c], seg_lens[c], match, mismatch, gap, ring,
      [&](int k, int d, int h) {
        best[k] = max(best[k], h);
        if (d == last + k) bo[k] = h;
      },
      [&](int d, int(&H)[L]) {
        if (d < m) {
#pragma unroll
          for (int k = 0; k < L; ++k)
            if (first + k == d) H[k] = bv[k];
        }
      });
  store_suffix_max<L>(best, start, m, live, out + base);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (first + k < m) bnd_out[base + first + k] = bo[k];
  }
}

}  // namespace

extern "C" int swt_band_lane_best(const void* packed, int rows, int m,
                                  const void* segs, const void* offs,
                                  const void* seg_lens, const void* ns, int c,
                                  const void* bnd, int match, int mismatch,
                                  int gap, void* out, void* bnd_out,
                                  int device, void* stream) {
  const int L = swt::pick_lanes(m);
  if (L == 0 || rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = row_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
#define SWT_LAUNCH(l)                                                       \
  case l:                                                                   \
    band_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(              \
        (const int32_t*)packed, rows, m, (int)row_blocks,                   \
        (const uint8_t*)segs, (const long long*)offs,                       \
        (const int32_t*)seg_lens, (const int32_t*)ns,                       \
        (const int32_t*)bnd, match, mismatch, gap, (int32_t*)out,           \
        (int32_t*)bnd_out);                                                 \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

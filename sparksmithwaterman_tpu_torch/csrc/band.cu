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
// boundary injection runs only on the first M diagonals.  A row of more
// than 1,024 lanes runs in stripes of 512 (band_wide_kernel): in stripe
// s, lane sW + k takes its left column before local diagonal k and gives
// its right column on local diagonal k + ns - 1, and lane sW's NW term on
// its first diagonal is bnd[sW - 1].
#include "wavefront.cuh"

namespace {

using namespace swt;

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

// K3 on a row wider than kMaxLanes, in stripes of 32 * L lanes (see the
// top of this file and wavefront.cuh), over rows row0 .. row0 +
// row_blocks * kWarps - 1; carry + carry_offs[c] holds two carry rows of
// max(ns[c], 1) int32 for each of them.
template <int L>
__global__ void __launch_bounds__(kThreads)
band_wide_kernel(const int32_t* __restrict__ packed, int rows, int m,
                 int row0, int row_blocks, const uint8_t* __restrict__ segs,
                 const long long* __restrict__ offs,
                 const int32_t* __restrict__ seg_lens,
                 const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ bnd, int match, int mismatch,
                 int gap, int32_t* __restrict__ out,
                 int32_t* __restrict__ bnd_out, int32_t* __restrict__ carry,
                 const long long* __restrict__ carry_offs) {
  constexpr int W = 32 * L;
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / row_blocks;
  const int part_row = (blockIdx.x % row_blocks) * kWarps + (threadIdx.x >> 5);
  const int row = row0 + part_row;
  const int first = (threadIdx.x & 31) * L;
  const bool live = row < rows;
  const int width = max(ns[c], 1);
  const long long base = ((long long)c * rows + row) * m;
  const int32_t* prow = packed + (long long)row * m;
  int32_t* buf = carry + carry_offs[c] + 2LL * part_row * width;
  const int last = first + width - 1;  // local diagonal of lane `first` in column ns-1

  for (int s = 0; s * W < m; ++s) {
    const int i0 = s * W;
    const int lanes = min(W, m - i0);
    int rd[L], bv[L], bo[L], best[L];
    uint32_t start = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      const bool real = live && i < m;
      const int raw = real ? prow[i] : kStartBit;
      rd[k] = raw & 255;
      if (raw >= kStartBit || i == 0) start |= 1u << k;
      bv[k] = real ? bnd[base + i] : 0;
      bo[k] = 0;
      best[k] = 0;
    }
    __syncwarp();  // the stripe above's carry row is visible
    StripeEdge<L> edge(buf + ((s + 1) & 1) * width, s > 0 ? width : 0, buf + (s & 1) * width,
                       (s > 0 && live) ? bnd[base + i0 - 1] : 0);
    sweep<L>(
        rd, start, lanes + width - 1, segs + offs[c], seg_lens[c], match, mismatch, gap, ring,
        [&](int k, int d, int h) {
          best[k] = max(best[k], h);
          if (d == last + k) bo[k] = h;
        },
        [&](int d, int(&H)[L]) {
          if (d < lanes) {
#pragma unroll
            for (int k = 0; k < L; ++k)
              if (first + k == d) H[k] = bv[k];
          }
        },
        edge);
    store_suffix_max<L>(best, start, lanes, live, out + base + i0);
    if (live) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (first + k < lanes) bnd_out[base + i0 + first + k] = bo[k];
      }
    }
  }
  if (live) stripe_suffix_max<L>(prow, m, out + base);
}

}  // namespace

extern "C" int swt_band_lane_best(const void* packed, int rows, int m,
                                  const void* segs, const void* offs,
                                  const void* seg_lens, const void* ns, int c,
                                  const void* bnd, int match, int mismatch,
                                  int gap, void* out, void* bnd_out,
                                  void* carry, const void* carry_offs,
                                  int part_rows, int device, void* stream) {
  const int L = swt::pick_lanes(m);
  if (rows <= 0 || c <= 0 || (L == 0 && carry == nullptr)) return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = row_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    return swt::launch_parts(rows, part_rows, [&](int row0, int part_blocks) {
      band_wide_kernel<swt::kStripeL><<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const int32_t*)packed, rows, m, row0, part_blocks, (const uint8_t*)segs,
          (const long long*)offs, (const int32_t*)seg_lens, (const int32_t*)ns,
          (const int32_t*)bnd, match, mismatch, gap, (int32_t*)out,
          (int32_t*)bnd_out, (int32_t*)carry, (const long long*)carry_offs);
    });
  }
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

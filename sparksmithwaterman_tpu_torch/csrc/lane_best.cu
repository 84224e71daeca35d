// K1: packed lane best against mixed-length references.
//
// Replaces the TPU kernels
//   sparksmithwaterman_tpu/ops/pallas_score.py:_diag_kernel_packed_varlen
//   sparksmithwaterman_tpu/ops/pallas_score.py:_chunked_kernel_packed_multi
// with their shared contract: packed read rows (ROWS, M) int32 (read code
// in the low byte, START_BIT = 256 on each segment's first lane) against C
// references with true lengths lens (C,) int32 give out (C, ROWS, M) int32
// where each segment's start lane holds that read's best local-alignment
// score against the reference.  Reference c is the lens[c] bytes at
// refs + offs[c] (int64 offsets), so a batch is one flat buffer with no
// padding; a (C, N) padded batch is the case offs[c] = c * N.
//
// What bounds it on the H100: the sweep is integer ALU work with no
// memory traffic in the inner loop; the output (C*ROWS*M int32) is
// written once.  So it is bound by operations: the repo's bound counts
// 1.5 instructions per DP cell (three DPX/SIMD instructions per register
// of two 16-bit cells) at 33.45 T instructions/s (132 SMs x 4 x 32
// threads x 1,980 MHz).  Every cell stays in registers: L lanes per
// thread, neighbour lanes through one warp shuffle per diagonal (no
// block barrier per diagonal), the reference streamed through a
// shared-memory ring shared by the block's rows.  Each reference runs m +
// len - 1 diagonals (0 for len == 0), so a mixed-length batch pays no
// length padding, and a 131 kb or 1 Mb reference needs no other form:
// different references are different blocks, which is what made the
// TPU's multi-ref fold unnecessary here.
//
// Two forms, chosen by the wrapper from the data alone (ops/cuda_score.py
// k1k4_form):
//
// - s16x2 (lane_best_s16x2_kernel), rows of at most 1,024 lanes whose
//   scores fit int16 (k1_form): warp w of a block takes packed rows 2w and 2w + 1,
//   one in each 16-bit half of every register, two cells per
//   instruction (wavefront.cuh sweep_s16x2).  What it does about the
//   bound: the int32 form spends about ten instructions a cell, all on
//   the integer pipe, which takes a warp instruction every other clock;
//   this form spends four and a half integer instructions per register
//   of two cells (the segment mask, the max of the N and W terms, the
//   gap, the DPX add-max-relu, half a 3-input max for the running best),
//   and puts the substitution on the FP16 pipe (a compare of codes held
//   as f16) and the FMA pipe (one IMAD adds it to the NW term).  No
//   value leaves int16: a cell is the best score of a path ending there,
//   and with mismatch <= 0 and gap <= 0 a path gains at most `match` per
//   lane of its segment, so 0 <= H[i][j] <= match x (lanes of the
//   segment up to i) <= match x m <= 32767; every negative intermediate
//   (U + mismatch, max(N, W) + gap with U, N, W >= 0) is at least
//   min(mismatch, gap) >= -32768.  So the wrapping adds are exact and no
//   saturating form is needed.  An odd last row pairs with an all-pad row: every lane starts
//   a segment of READ_PAD, stays 0 and is not stored.  The segmented
//   suffix max runs once per row after the sweep, on each half unpacked
//   to int32.  A row of more than 1,024 lanes takes this form where
//   match x (its longest segment) <= 32,767 and mismatch and gap < 0
//   (lane_best_wide_s16x2_kernel): the pair is swept in stripes of 256
//   lanes (wavefront.cuh kStripe16L), top to bottom, its carry rows
//   (StripeEdge16x2) one uint32_t a column holding both rows' halves.
//   What bounds it is what bounds the one-pass form, plus a shuffle and a
//   select a diagonal for lane 0's carried N term.  The bound above
//   holds a segment at a time, so the row's width does not enter it: a
//   read of 6,553 bp in an 8,192-lane row fits at match 5.
// - int32 (lane_best_kernel, one warp per row, one cell per
//   instruction): every other row of at most 1,024 lanes; every other row
//   of more than 1,024 lanes runs in stripes of 512
//   (lane_best_wide_kernel, wavefront.cuh StripeEdge).  Both striped
//   forms keep their carry rows in a scratch buffer the wrapper
//   allocates.
//
// Lanes a caller may read: the start lane of every segment.  Other lanes
// hold the suffix max of their segment from that lane on (in the s16x2
// form also over the extra diagonals sweep_s16x2 may run), which the TPU
// kernel (which also sweeps padding diagonals) need not match.
#include "wavefront.cuh"

namespace {

using namespace swt;

template <int L>
__global__ void __launch_bounds__(kThreads)
lane_best_kernel(const int32_t* __restrict__ packed, int rows, int m,
                 int row_blocks, const uint8_t* __restrict__ refs,
                 const long long* __restrict__ offs,
                 const int32_t* __restrict__ lens,
                 int match, int mismatch, int gap,
                 int32_t* __restrict__ out) {
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / row_blocks;
  const int row = (blockIdx.x % row_blocks) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  const bool live = row < rows;
  const int len = lens[c];
  const int nd = len > 0 ? m + len - 1 : 0;

  int rd[L];
  uint32_t start = 0;  // bit k: lane first+k starts a segment
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    // Lanes past m (and rows past ROWS) form isolated all-pad segments.
    const int raw =
        (live && i < m) ? packed[(long long)row * m + i] : kStartBit;
    rd[k] = raw & 255;
    if (raw >= kStartBit || i == 0) start |= 1u << k;
  }

  int best[L];
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = 0;
  sweep<L>(rd, start, nd, refs + offs[c], len, match,
           mismatch, gap, ring,
           [&](int k, int, int h) { best[k] = max(best[k], h); });

  // Segmented suffix max, written out here and not through
  // wavefront.cuh's store_suffix_max: through that function ptxas spills registers
  // in this kernel at L = 8 and it runs slower (an A/B on one H100).
  // First within the thread, right to left, restarting at segment
  // starts; `open` marks lanes whose segment runs past this thread's last
  // lane.
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
  int32_t* o = out + ((long long)c * rows + row) * m;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (first + k < m) o[first + k] = ((open >> k) & 1u) ? max(best[k], carry) : best[k];
  }
}

// The s16x2 form (see the top of this file): block b of reference c
// takes packed rows 8 (b % row_blocks) .. + 7, warp w the pair 2w, 2w + 1.
// k_sub = match - mismatch, mismatch2 and gap2 pair16 of the scheme, all
// from the host, so that they sit in the constant bank, not registers.
template <int L>
__global__ void __launch_bounds__(kThreads)
lane_best_s16x2_kernel(const int32_t* __restrict__ packed, int rows, int m,
                       int row_blocks, const uint8_t* __restrict__ refs,
                       const long long* __restrict__ offs,
                       const int32_t* __restrict__ lens, uint32_t k_sub,
                       uint32_t mismatch2, uint32_t gap2,
                       int32_t* __restrict__ out) {
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  const int c = blockIdx.x / row_blocks;
  const int row = (blockIdx.x % row_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const int len = lens[c];
  const int nd = len > 0 ? m + len - 1 : 0;

  uint32_t rd2[L], keep2[L], best2[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    // Lanes past m (and rows past ROWS) form isolated all-pad segments.
    const int lo = (row < rows && i < m) ? packed[(long long)row * m + i] : kStartBit;
    const int hi = (row + 1 < rows && i < m) ? packed[(long long)(row + 1) * m + i] : kStartBit;
    rd2[k] = code_half(lo) | code_half(hi) << 16;
    keep2[k] = (lo >= kStartBit || i == 0 ? 0u : 0x0000FFFFu) | (hi >= kStartBit || i == 0 ? 0u : 0xFFFF0000u);
    best2[k] = 0;
  }
  // The best of a register over pairs of diagonals (the unroll is even):
  // on the second of each pair, one 3-input max of best, the first's
  // value and the second's.
  sweep_s16x2<L>(rd2, keep2, nd, refs + offs[c], len, k_sub, mismatch2, gap2, ring,
                 [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
                   if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
                 });

  // The row and the segment starts again, from the block index and keep2,
  // so that none of them holds a register across the sweep (ptxas
  // spilled them otherwise).
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const int c2 = block / row_blocks;
  const int row2 = (block % row_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  uint32_t start_lo = 0, start_hi = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    asm volatile("" : "+r"(keep2[k]));  // not derived again from the loads
    start_lo |= (uint32_t)((keep2[k] & 0xFFFFu) == 0) << k;
    start_hi |= (uint32_t)((keep2[k] >> 16) == 0) << k;
  }
  int32_t* o = out + ((long long)c2 * rows + row2) * m;
  int best[L];
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] & 0xFFFFu);
  store_suffix_max<L>(best, start_lo, m, row2 < rows, o);
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] >> 16);
  store_suffix_max<L>(best, start_hi, m, row2 + 1 < rows, o + m);
}

// A row wider than kMaxLanes, in stripes of 32 * L lanes (wavefront.cuh):
// each stripe sweeps and stores its own segmented suffix max, then
// stripe_suffix_max carries each read's max back over the stripe
// boundaries it crosses.  Blocks hold 1 to kWarps warps, a row each
// (launch_wide): the launch covers rows row0 .. row0 + row_blocks x the
// block's warps - 1, and carry + carry_offs[c] holds two carry rows of
// len int32 for each of them.
template <int L>
__global__ void __launch_bounds__(kThreads)
lane_best_wide_kernel(const int32_t* __restrict__ packed, int rows, int m,
                      int row0, int row_blocks,
                      const uint8_t* __restrict__ refs,
                      const long long* __restrict__ offs,
                      const int32_t* __restrict__ lens, int match,
                      int mismatch, int gap, int32_t* __restrict__ out,
                      int32_t* __restrict__ carry,
                      const long long* __restrict__ carry_offs) {
  constexpr int W = 32 * L;
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / row_blocks;
  const int part_row = (blockIdx.x % row_blocks) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int row = row0 + part_row;
  const int first = (threadIdx.x & 31) * L;
  const bool live = row < rows;
  const int len = lens[c];
  const int32_t* prow = packed + (long long)row * m;
  int32_t* o = out + ((long long)c * rows + row) * m;
  int32_t* buf = carry + carry_offs[c] + 2LL * part_row * len;

  for (int s = 0; s * W < m; ++s) {
    const int base = s * W;
    const int lanes = min(W, m - base);
    int rd[L], best[L];
    uint32_t start = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = base + first + k;
      const int raw = (live && i < m) ? prow[i] : kStartBit;
      rd[k] = raw & 255;
      if (raw >= kStartBit || i == 0) start |= 1u << k;
      best[k] = 0;
    }
    __syncwarp();  // the stripe above's carry row is visible
    StripeEdge<L> edge(buf + ((s + 1) & 1) * len, s > 0 ? len : 0, buf + (s & 1) * len, 0);
    sweep<L>(rd, start, len > 0 ? lanes + len - 1 : 0, refs + offs[c], len,
             match, mismatch, gap, ring,
             [&](int k, int, int h) { best[k] = max(best[k], h); },
             [](int, int(&)[L]) {}, edge);
    store_suffix_max<L>(best, start, lanes, live, o + base);
  }
  if (live) stripe_suffix_max<L>(prow, m, o);
}

// The pair of rows and the reference of this warp in a launch of the
// striped s16x2 form, from the block index read anew (asm volatile), so
// that none of them holds a register across a sweep (ptxas spilled the
// kernel below at L = 8 with them live).
struct WidePair {
  int c, part_pair, row;
};

__device__ __forceinline__ WidePair wide_pair(int row0, int row_blocks) {
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const int part_pair = (block % row_blocks) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  return {block / row_blocks, part_pair, row0 + 2 * part_pair};
}

// The s16x2 form of a row wider than kMaxLanes: warp w of a block of W
// warps (1 to kWarps, launch_wide) takes the pair of packed rows row0 +
// 2W (b % row_blocks) + 2w, + 1, one in each 16-bit half, and sweeps it
// in stripes of 32 * L lanes through sweep_s16x2 with a StripeEdge16x2,
// whose carry rows hold both rows' halves.  A stripe's lane starts a
// segment only where its packed lane has START_BIT (or is the row's lane
// 0): lane 0 of a later stripe continues the read above it.  Each stripe
// stores each row's own segmented suffix max, unpacked to int32, then
// stripe_suffix_max carries each read's max back over the stripe
// boundaries it crosses, as in lane_best_wide_kernel.  carry +
// carry_offs[c] holds two carry rows of len uint32_t for each pair of the
// launch.
template <int L>
__global__ void __launch_bounds__(kThreads)
lane_best_wide_s16x2_kernel(const int32_t* __restrict__ packed, int rows, int m,
                            int row0, int row_blocks,
                            const uint8_t* __restrict__ refs,
                            const long long* __restrict__ offs,
                            const int32_t* __restrict__ lens, uint32_t k_sub,
                            uint32_t mismatch2, uint32_t gap2,
                            int32_t* __restrict__ out,
                            uint32_t* __restrict__ carry,
                            const long long* __restrict__ carry_offs) {
  constexpr int W = 32 * L;
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  const int first = (threadIdx.x & 31) * L;

  for (int s = 0; s * W < m; ++s) {
    const int base = s * W;
    const int lanes = min(W, m - base);
    const WidePair p = wide_pair(row0, row_blocks);
    const int len = lens[p.c];
    const int32_t* prow = packed + (long long)p.row * m;
    uint32_t rd2[L], keep2[L], best2[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = base + first + k;
      // Lanes past m (and rows past ROWS) form isolated all-pad segments.
      const int lo = (p.row < rows && i < m) ? prow[i] : kStartBit;
      const int hi = (p.row + 1 < rows && i < m) ? prow[m + i] : kStartBit;
      rd2[k] = code_half(lo) | code_half(hi) << 16;
      keep2[k] = (lo >= kStartBit || i == 0 ? 0u : 0x0000FFFFu) | (hi >= kStartBit || i == 0 ? 0u : 0xFFFF0000u);
      best2[k] = 0;
    }
    // Every warp is done with the ring of the stripe above (sweep_s16x2
    // writes its top before its first barrier), and this pair's carry row
    // from that stripe is visible.
    __syncthreads();
    uint32_t* buf = carry + carry_offs[p.c] + 2LL * p.part_pair * len;
    StripeEdge16x2<L> edge(buf + ((s + 1) & 1) * len, s > 0 ? len : 0, buf + (s & 1) * len, len);
    sweep_s16x2<L>(rd2, keep2, len > 0 ? lanes + len - 1 : 0, refs + offs[p.c], len, k_sub, mismatch2, gap2, ring,
                   [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
                     if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
                   },
                   [](int) {}, edge);
    const WidePair q = wide_pair(row0, row_blocks);
    int32_t* o = out + ((long long)q.c * rows + q.row) * m + base;
    uint32_t start_lo = 0, start_hi = 0;
    int best[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      asm volatile("" : "+r"(keep2[k]));  // not derived again from the loads
      start_lo |= (uint32_t)((keep2[k] & 0xFFFFu) == 0) << k;
      start_hi |= (uint32_t)((keep2[k] >> 16) == 0) << k;
      best[k] = (int)(best2[k] & 0xFFFFu);
    }
    store_suffix_max<L>(best, start_lo, lanes, q.row < rows, o);
#pragma unroll
    for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] >> 16);
    store_suffix_max<L>(best, start_hi, lanes, q.row + 1 < rows, o + m);
  }
  const WidePair q = wide_pair(row0, row_blocks);
  const int32_t* prow = packed + (long long)q.row * m;
  int32_t* o = out + ((long long)q.c * rows + q.row) * m;
  if (q.row < rows) stripe_suffix_max<L>(prow, m, o);
  if (q.row + 1 < rows) stripe_suffix_max<L>(prow + m, m, o + m);
}

// Launches a striped kernel over rows [0, rows), per_warp rows a warp (1 in
// the int32 form, a pair in s16x2), in parts of part_rows rows as
// launch_parts does, so that the parts reuse one carry scratch.  Each part
// runs as blocks of kWarps warps and, for the warps left over, one more
// launch of blocks of as many warps as remain, so that no warp of either
// sweeps past the last row: a lone int32 row is a block of one warp.
// launch(row0, row_blocks, warps) launches row_blocks x c blocks of
// `warps` warps over the rows from row0.  Returns the first launch error,
// or cudaSuccess.
template <class Launch>
int launch_wide(int rows, int part_rows, int per_warp, Launch&& launch) {
  return launch_parts(rows, part_rows, [&](int row0, int) {
    const int part = rows - row0 < part_rows ? rows - row0 : part_rows;
    const int warps = (part + per_warp - 1) / per_warp;
    const int full = warps / kWarps, rest = warps % kWarps;
    if (full > 0) launch(row0, full, kWarps);
    if (rest > 0 && cudaPeekAtLastError() == cudaSuccess) launch(row0 + full * kWarps * per_warp, 1, rest);
  }, per_warp * kWarps);
}

}  // namespace

extern "C" int swt_lane_best_varlen(const void* packed, int rows, int m,
                                    const void* refs, const void* offs,
                                    const void* lens, int c, int match,
                                    int mismatch, int gap, void* out,
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
    return launch_wide(rows, part_rows, 1, [&](int row0, int part_blocks, int warps) {
      lane_best_wide_kernel<swt::kStripeL><<<(unsigned)(part_blocks * c), 32 * warps, 0, s>>>(
          (const int32_t*)packed, rows, m, row0, part_blocks,
          (const uint8_t*)refs, (const long long*)offs, (const int32_t*)lens,
          match, mismatch, gap, (int32_t*)out, (int32_t*)carry,
          (const long long*)carry_offs);
    });
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                       \
  case l:                                                                   \
    lane_best_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(              \
        (const int32_t*)packed, rows, m, (int)row_blocks,                   \
        (const uint8_t*)refs, (const long long*)offs,                       \
        (const int32_t*)lens, match,                                        \
        mismatch, gap, (int32_t*)out);                                      \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The s16x2 form; the wrapper takes it only where ops/cuda_score.py
// k1k4_form says so, and this entry refuses a scheme under which a value
// could leave int16: rows of at most kMaxLanes where match x m <= 32767,
// wider rows (in stripes, lane_best_wide_s16x2_kernel, carry rows in
// `carry` as for the int32 entry but per pair: part_rows a multiple of
// 2 * kWarps) where match x seg <= 32767, seg (1 <= seg <= m) the caller's
// bound on the lanes of a segment (its longest read), and mismatch < 0
// and gap < 0 (the stripes' rule).
extern "C" int swt_lane_best_varlen_s16x2(const void* packed, int rows, int m,
                                          const void* refs, const void* offs,
                                          const void* lens, int c, int match,
                                          int mismatch, int gap, void* out,
                                          void* carry, const void* carry_offs,
                                          int part_rows, int seg, int device,
                                          void* stream) {
  const int L = swt::pick_lanes(m);
  const bool wide = L == 0;
  const int lanes = wide ? seg : m;
  const bool fits = match >= 0 && (long long)match * lanes <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0 &&
                    (!wide || (seg >= 1 && seg <= m && mismatch < 0 && gap < 0 && carry != nullptr));
  if (rows <= 0 || c <= 0 || !fits) return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = row_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t k_sub = (uint32_t)(match - mismatch);
  if (wide) {
    return launch_wide(rows, part_rows, 2, [&](int row0, int part_blocks, int warps) {
      lane_best_wide_s16x2_kernel<swt::kStripe16L><<<(unsigned)(part_blocks * c), 32 * warps, 0, s>>>(
          (const int32_t*)packed, rows, m, row0, part_blocks, (const uint8_t*)refs,
          (const long long*)offs, (const int32_t*)lens, k_sub, pair16(mismatch), pair16(gap),
          (int32_t*)out, (uint32_t*)carry, (const long long*)carry_offs);
    });
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                           \
  case l:                                                                       \
    lane_best_s16x2_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(      \
        (const int32_t*)packed, rows, m, (int)row_blocks, (const uint8_t*)refs, \
        (const long long*)offs, (const int32_t*)lens, k_sub,                    \
        pair16(mismatch), pair16(gap), (int32_t*)out);                          \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* swt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2: per-lane argmax of the DP rows, for the windowed traceback.
//
// Replaces the TPU kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_chunked_argmax_kernel
// with its contract: unpacked reads (R, M) uint8 against refs (C, N) uint8
// give three (R, C, M) int32 arrays.  Lane i of pair (r, c) covers DP row
// i+1 (read position i): best = the row's max, bestd = the first global
// anti-diagonal d = i + j reaching it (strict >), count = how many of the
// row's cells equal it, counted only while best > 0.  The host rebuilds
// max cells as (i, bestd - i).  Only lane 0 takes the row-0 boundary.
// Every pair runs exactly m + n - 1 diagonals, padding columns right of
// the reference included (as the plain version does).
//
// What bounds it on the H100: like K1 it is register-resident integer
// work and writes its three outputs once.  The reference is streamed
// through a shared-memory ring shared by the block's warps, so a 131 kb
// reference costs no more shared memory than a 2 kb one.  Two forms,
// picked by the wrapper from the data alone (ops/cuda_score.py k1_form,
// the rule of K1, K4, K5 and K8, m the width of the reads tensor):
//
// - s16x2 (argmax_s16x2_kernel), reads of at most 1,024 positions whose
//   scores fit int16: wavefront.cuh's sweep_s16x2, warp w of a block on
//   reads 2w and 2w + 1, one in each 16-bit half of every register, the
//   recurrence in __viaddmax_s16x2_relu.  The argmax state is 16-bit too:
//   per register the pair's bests, the local diagonal of each half's
//   first best and its tie count, updated by DPX and integer instructions
//   alone (0/1 flags from __vimin_s16x2_relu and __viaddmin_s16x2_relu,
//   selects as __viaddmax_s16x2 of a value made small or large by one
//   IMAD): nine instructions a register of two cells over the sweep's
//   (the SIMD compares __vcmpgts2 and __vcmpeq2 have no sm_90 instruction
//   and cost a sequence each).  The diagonal and the
//   count fit 16 bits for kEpoch diagonals; at the tile that would pass
//   them (and at the end) a thread merges its lanes' state into device
//   memory and starts again from zero, so a segment of any length runs.
//   Column segments fill the card where a launch has few blocks (one
//   reference, few reads: the traceback's call): see below.
// - int32 (argmax_kernel, one warp per read, L lanes per thread, the
//   generic sweep with a per-cell callback): every other read of at most
//   1,024 positions, one segment.
// - int32 wide (argmax_wide_kernel): a read of more than 1,024 positions
//   outside the striped rule runs in stripes of 512 (wavefront.cuh); a
//   stripe's local diagonal d is the global d + 512 s.
// - s16x2 wide (argmax_wide_s16x2_kernel), reads of more than 1,024
//   positions under k1k4_form's striped rule (match x m <= 32,767,
//   mismatch < 0, gap < 0): a pair in stripes of 256 lanes through
//   sweep_s16x2 with a StripeEdge16x2, the argmax state and its epochs as
//   argmax_s16x2_kernel's.  Its outputs equal the plain version's on
//   every lane, pad rows and the columns right of the reference included;
//   below, how it does that and how it fills the card.
//
// Column segments (ops/cuda_score.py argmax_segments).  Segment s covers
// the reference's columns [s stride, s stride + length), starts from H = 0
// at its left edge, and counts the cells of the global diagonals it owns:
// segment 0 from d = 0, segment s >= 1 from d = s stride + offset, each up
// to where the next one starts, the last one to m + n - 1.  So every cell
// (i, j) is counted by one segment, the one owning d = i + j.  With match
// > 0, mismatch <= 0 and gap < 0 an alignment of positive score spans at
// most W = m + match m / |gap| columns, so a segment's cells at its local
// columns >= W - 1 are exact; offset >= W + m - 2 puts every owned cell of
// every lane i < m there (local j = d - i >= offset - (m - 1)).  The mask
// on the owned diagonals is one test a diagonal (the same for every
// lane), and it also drops the diagonals sweep_s16x2 adds to round nd up
// to its unroll, whose padding cells can equal a row's best under
// mismatch = 0 or gap = 0.  Each segment writes (best, bestd, count) of
// its owned cells to partials (S, R, C, M); argmax_merge_kernel takes,
// per lane, the max best, the bestd of the lowest segment reaching it
// (d rises with j along a row) and the sum of those segments' counts.
// The entry points refuse a plan that is not exact.
//
// Lanes a caller may read: lanes whose best equals the read's max.  There
// the three values depend only on real cells; other lanes may differ from
// the TPU kernel, which also sweeps padding diagonals.  (The s16x2 forms
// equal the plain version on every lane.)
//
// The s16x2 wide form.  With mismatch < 0 and gap < 0, let p =
// min(|mismatch|, |gap|) and u the pair's longer read:
// - Pad rows.  A row of READ_PAD matches nothing, so its max is at least p
//   below the max of the row above it, and row u - 1's is at most match x
//   min(u, len) (a match takes a row and one of the segment's len
//   columns): every lane i >= u - 1 + ceil(match min(u, len) / p) is 0 in
//   all three outputs.  A pair sweeps only the stripes below that lane and
//   writes zeros past them, so a 150 bp read padded to the file's longest
//   sweeps one or two stripes, not all of them.
// - Columns right of the reference.  The plain version runs m + n - 1
//   diagonals, so lane i sees m - 1 - i REF_PAD columns past the
//   reference, where a cell can exceed every real cell of its row.  A cell
//   there t + 1 columns in is at most match x min(i + 1, len) - p (t + 1)
//   (a match takes a row and a column of the len the segment has), so
//   each stripe runs its diagonals (and its carry row) only that far,
//   min(its lanes + len + ceil(match min(i0 + lanes, u, len) / p) - 1,
//   the plain version's last diagonal): past that every cell is 0 and
//   changes no state.
// - Filling the card.  The main path's call is one reference against the
//   file's reads, so a block takes one pair and its four warps sweep four
//   consecutive stripes at once, warp w kPipeLag x w diagonals behind the
//   sweep (StripeEdge16x2's kPipe): a stripe reads column j of the carry
//   on its diagonal j, which the stripe above wrote on its diagonal j + 255,
//   and a __syncthreads() every 32 diagonals orders the two.  The stripes
//   go in rounds of four, each stripe's carry row in one of five rows of a
//   scratch a block, so the stripe above's row is never the one written.
//   Where the reference allows, the column segments above cut it too.
#include "wavefront.cuh"

namespace {

using namespace swt;

template <int L>
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const uint8_t* __restrict__ reads, int r, int m,
              int read_blocks, const uint8_t* __restrict__ refs,
              long long ref_stride, int c_total, int n, int match,
              int mismatch, int gap, int32_t* __restrict__ best_out,
              int32_t* __restrict__ bestd_out,
              int32_t* __restrict__ count_out) {
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / read_blocks;
  const int read = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const bool live = read < r;
  const int nd = n > 0 ? m + n - 1 : 0;

  int rd[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    rd[k] = (live && i < m) ? reads[(long long)read * m + i] : kReadPad;
  }
  const uint32_t zmask = first == 0 ? 1u : 0u;

  int best[L], bestd[L], count[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    best[k] = 0;
    bestd[k] = 0;
    count[k] = 0;
  }
  sweep<L>(rd, zmask, nd, refs + (long long)c * ref_stride, n, match,
           mismatch, gap, ring, [&](int k, int d, int h) {
             if (h > best[k]) {
               best[k] = h;
               bestd[k] = d;
               count[k] = 1;
             } else if (h == best[k] && h > 0) {
               ++count[k];
             }
           });

  if (!live) return;
  const long long o = ((long long)read * c_total + c) * m;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    if (i < m) {
      best_out[o + i] = best[k];
      bestd_out[o + i] = bestd[k];
      count_out[o + i] = count[k];
    }
  }
}

// K2 on a read wider than kMaxLanes, in stripes of 32 * L lanes, over
// reads read0 .. read0 + read_blocks * kWarps - 1; carry + 2 * n *
// ((read - read0) * c_total + c) holds the pair's two carry rows.
template <int L>
__global__ void __launch_bounds__(kThreads)
argmax_wide_kernel(const uint8_t* __restrict__ reads, int r, int m,
                   int read0, int read_blocks, const uint8_t* __restrict__ refs,
                   long long ref_stride, int c_total, int n, int match,
                   int mismatch, int gap, int32_t* __restrict__ best_out,
                   int32_t* __restrict__ bestd_out,
                   int32_t* __restrict__ count_out,
                   int32_t* __restrict__ carry) {
  constexpr int W = 32 * L;
  __shared__ uint8_t ring[kRing];
  const int c = blockIdx.x / read_blocks;
  const int part_read = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int read = read0 + part_read;
  const int first = (threadIdx.x & 31) * L;
  const bool live = read < r;
  const long long o = ((long long)read * c_total + c) * m;
  int32_t* buf = carry + 2LL * n * ((long long)part_read * c_total + c);

  for (int s = 0; s * W < m; ++s) {
    const int i0 = s * W;
    const int lanes = min(W, m - i0);
    int rd[L], best[L], bestd[L], count[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      rd[k] = (live && i < m) ? reads[(long long)read * m + i] : kReadPad;
      best[k] = 0;
      bestd[k] = 0;
      count[k] = 0;
    }
    __syncwarp();  // the stripe above's carry row is visible
    StripeEdge<L> edge(buf + ((s + 1) & 1) * n, s > 0 ? n : 0, buf + (s & 1) * n, 0);
    sweep<L>(rd, (s == 0 && first == 0) ? 1u : 0u, n > 0 ? lanes + n - 1 : 0,
             refs + (long long)c * ref_stride, n, match, mismatch, gap, ring,
             [&](int k, int d, int h) {
               if (h > best[k]) {
                 best[k] = h;
                 bestd[k] = d + i0;
                 count[k] = 1;
               } else if (h == best[k] && h > 0) {
                 ++count[k];
               }
             },
             [](int, int(&)[L]) {}, edge);
    if (live) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = i0 + first + k;
        if (i < m) {
          best_out[o + i] = best[k];
          bestd_out[o + i] = bestd[k];
          count_out[o + i] = count[k];
        }
      }
    }
  }
}

// Diagonals between two flushes of the s16x2 form's 16-bit argmax state
// at most (a count up to kEpoch, and a local diagonal less 32767, fit a
// signed 16-bit half).
constexpr int kEpoch = 16384;

// The s16x2 form's column segments (see the top of this file).
struct ArgSegments {
  int stride, length, offset, count;
};

// One register of the s16x2 form's argmax state, two cells, on a
// diagonal: hm the cells' values (0 where not owned), dlow the epoch's
// diagonal less 32767 in both halves (see argmax_s16x2_kernel).
__device__ __forceinline__ void argmax_update16(uint32_t hm, uint32_t dlow, uint32_t& best2, uint32_t& bestd2,
                                                uint32_t& count2) {
  const uint32_t t = __vsub2(hm, best2);
  const uint32_t gt = __vimin_s16x2_relu(t, 0x00010001u);
  const uint32_t ge = __viaddmin_s16x2_relu(t, 0x00010001u, 0x00010001u);
  best2 = __vmaxs2(best2, hm);
  count2 = __viaddmax_s16x2(count2, gt * 0x8001u + ge, gt);
  bestd2 = __viaddmax_s16x2(dlow, gt * 0x7FFFu, bestd2);
}

// One 16-bit half of a register, as an int (the state is non-negative).
__device__ __forceinline__ int half16(uint32_t v, int hi) { return (int)((v >> (16 * hi)) & 0xFFFFu); }

// Where a block of the s16x2 form works: reads 8 (b % read_blocks) .. + 7
// of reference c and segment s (b / read_blocks = c count + s), warp w on
// the pair read, read + 1 = 2w, 2w + 1 of them.
struct ArgPlace {
  int c, s, read;
};

__device__ __forceinline__ ArgPlace arg_place(int block, int read_blocks, int count) {
  const int cs = block / read_blocks;
  return {cs / count, cs % count, (block % read_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5)};
}

// The s16x2 form's outputs: the partials (S, R, C, M) of the segments, or
// with one segment the (R, C, M) result.
struct ArgOut {
  int32_t* best;
  int32_t* bestd;
  int32_t* count;
};

// Merges this thread's 16-bit state (diagonals from the epoch's first,
// dbase in global terms) into its lanes' (best, bestd, count) in `out`,
// writing them where `merge` is false (the segment's first flush), and
// zeroes the state.  The pair and segment come again from the block
// index, so that none of them holds a register across the sweep.
template <int L>
__device__ __forceinline__ void flush_state(uint32_t (&best2)[L], uint32_t (&bestd2)[L],
                                            uint32_t (&count2)[L], int r, int m, int c_total,
                                            int read_blocks, int count, int dbase, bool merge,
                                            ArgOut out) {
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const ArgPlace q = arg_place(block, read_blocks, count);
  const int first = (threadIdx.x & 31) * L;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q.read + h < r && i < m) {
        const long long o = (((long long)q.s * r + q.read + h) * c_total + q.c) * m + i;
        const int b = half16(best2[k], h);
        const int cnt = b > 0 ? half16(count2[k], h) : 0;
        const int bd = b > 0 ? half16(bestd2[k], h) + dbase : 0;
        const int was = merge ? out.best[o] : -1;
        if (b > was) {
          out.best[o] = b;
          out.bestd[o] = bd;
          out.count[o] = cnt;
        } else if (b == was && b > 0) {
          out.count[o] += cnt;
        }
      }
    }
    best2[k] = bestd2[k] = count2[k] = 0;
  }
}

// The s16x2 form (see the top of this file), on the block's place
// (arg_place).
template <int L>
__global__ void __launch_bounds__(kThreads)
argmax_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m, int read_blocks,
                    const uint8_t* __restrict__ refs, long long ref_stride, int c_total, int n,
                    ArgSegments sg, uint32_t k_sub, uint32_t mismatch2, uint32_t gap2, ArgOut out) {
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  const ArgPlace p = arg_place(blockIdx.x, read_blocks, sg.count);
  const int first = (threadIdx.x & 31) * L;
  const int j0 = p.s * sg.stride;
  // The local diagonals this segment owns: [lo, lo + owned).
  const int lo = p.s == 0 ? 0 : sg.offset;
  const int hi = p.s == sg.count - 1 ? m + n - 1 - j0 : sg.stride + sg.offset;
  const unsigned owned = hi - lo;

  uint32_t rd2[L], keep2[L], best2[L], bestd2[L], count2[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    const int a = (p.read < r && i < m) ? reads[(long long)p.read * m + i] : kReadPad;
    const int b = (p.read + 1 < r && i < m) ? reads[(long long)(p.read + 1) * m + i] : kReadPad;
    rd2[k] = code_half(a) | code_half(b) << 16;
    keep2[k] = i == 0 ? 0u : 0xFFFFFFFFu;
    best2[k] = bestd2[k] = count2[k] = 0;
  }
  int ebase = 0;       // the epoch's first local diagonal
  bool merge = false;  // a flush before this one wrote this segment's lanes
  // A tile that could end past kEpoch diagonals from the epoch's start
  // starts a new epoch.
  const auto on_tile = [&](int base) {
    if (base - ebase > kEpoch - kS16x2Tile<L>) {
      flush_state<L>(best2, bestd2, count2, r, m, c_total, read_blocks, sg.count, ebase + j0, merge, out);
      ebase = base;
      merge = true;
    }
  };
  sweep_s16x2<L>(
      rd2, keep2, hi, refs + (long long)p.c * ref_stride + j0, min(sg.length, n - j0), k_sub, mismatch2,
      gap2, ring,
      [&](int k, bool, uint32_t h, uint32_t, int d) {
        // Per diagonal: all ones where this segment owns it (else h counts
        // as 0), and the epoch's diagonal less 32767 in both halves (d -
        // ebase + 32769 lies in [0, 65536)).
        const uint32_t own = (unsigned)(d - lo) < owned ? 0xFFFFFFFFu : 0u;
        const uint32_t dlow = (uint32_t)(d - ebase + 32769) * 0x00010001u;
        // Per half, with t = h - best: gt = 1 where h > best, ge = 1 where
        // h >= best (its wrap at t = 32767 only where gt is 1).  The count
        // restarts at 1 where gt (count - 32766 < 1), else adds ge; a
        // count of zeros restarts at the first best > 0, and a best of 0
        // counts 0 (flush_state).  bestd takes d where gt (d - 32767 +
        // 32767), else keeps its value (d - 32767 < 0 <= bestd).
        argmax_update16(h & own, dlow, best2[k], bestd2[k], count2[k]);
      },
      on_tile);
  flush_state<L>(best2, bestd2, count2, r, m, c_total, read_blocks, sg.count, ebase + j0, merge, out);
}

// The diagonals between two warps of argmax_wide_s16x2_kernel's pipeline:
// column j of a carry row is stored at the end of the step of the stripe
// above's diagonal j + 32 L - 1 and read up to 63 columns ahead of the
// reading stripe's diagonal, after a barrier every 32 diagonals, so the
// lag must pass 32 L - 1 + 63 (and be a multiple of 32).
template <int L>
constexpr int kPipeLag = 32 * L + 64;

// Merges a thread's 16-bit state of one stripe into the lanes [0, lanes)
// from o (and o_hi, the pair's other read, where has_hi), as flush_state
// does, and zeroes the state.
template <int L>
__device__ __forceinline__ void flush_stripe(uint32_t (&best2)[L], uint32_t (&bestd2)[L], uint32_t (&count2)[L],
                                             long long o, long long o_hi, bool has_hi, int lanes, int dbase,
                                             bool merge, ArgOut out) {
  const int first = (threadIdx.x & 31) * L;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((h == 0 || has_hi) && i < lanes) {
        const long long at = (h ? o_hi : o) + i;
        const int b = half16(best2[k], h);
        const int cnt = b > 0 ? half16(count2[k], h) : 0;
        const int bd = b > 0 ? half16(bestd2[k], h) + dbase : 0;
        const int was = merge ? out.best[at] : -1;
        if (b > was) {
          out.best[at] = b;
          out.bestd[at] = bd;
          out.count[at] = cnt;
        } else if (b == was && b > 0) {
          out.count[at] += cnt;
        }
      }
    }
    best2[k] = bestd2[k] = count2[k] = 0;
  }
}

// The s16x2 form on reads wider than kMaxLanes (see the top of this
// file): block b takes the pair read0 + 2 (b % part_pairs), + 1 against
// reference c and segment s (b / part_pairs = c count + s), its kWarps
// warps on as many stripes a round; cols the length of each of the
// block's kWarps + 1 carry rows, from carry + (kWarps + 1) cols b.  p =
// min(|mismatch|, |gap|).
template <int L>
__global__ void __launch_bounds__(kThreads)
argmax_wide_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m, int read0, int part_pairs,
                         const uint8_t* __restrict__ refs, long long ref_stride, int c_total, int n,
                         ArgSegments sg, int match, int p, uint32_t k_sub, uint32_t mismatch2, uint32_t gap2,
                         int cols, ArgOut out, uint32_t* __restrict__ carry) {
  constexpr int W = 32 * L;
  static_assert((kWarps - 1) * kPipeLag<L> + W <= kS16x2Tile<L>, "the ring's look-back holds the last warp's columns");
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  const int warp = threadIdx.x >> 5;
  const int first = (threadIdx.x & 31) * L;
  const int cs = blockIdx.x / part_pairs;
  const int c = cs / sg.count, seg = cs % sg.count;
  const int read = read0 + 2 * (blockIdx.x % part_pairs);
  if (read >= r) return;  // the whole block
  const bool has_hi = read + 1 < r;
  const uint8_t* rd = reads + (long long)read * m;
  int used = 0;  // 1 + the last position of the pair that is not pad (every warp alike)
  for (int i = threadIdx.x & 31; i < m; i += 32)
    if (rd[i] != kReadPad || (has_hi && rd[m + i] != kReadPad)) used = i + 1;
  used = __reduce_max_sync(0xffffffffu, used);
  const int j0 = seg * sg.stride;
  const int len = min(sg.length, n - j0);
  // The local diagonals this segment owns: [lo, hi).
  const int lo = seg == 0 ? 0 : sg.offset;
  const int hi = seg == sg.count - 1 ? m + n - 1 - j0 : sg.stride + sg.offset;
  const unsigned owned = hi - lo;
  // Lanes past stop are 0; the stripes below it.
  const int stop = used == 0 ? 0 : min(m, used - 1 + (match * min(used, len) + p - 1) / p);
  const int stripes = (stop + W - 1) / W;
  const long long o = (((long long)seg * r + read) * c_total + c) * m;
  const long long o_hi = o + (long long)c_total * m;
  for (int i = stripes * W + threadIdx.x; i < m; i += blockDim.x) {
    out.best[o + i] = out.bestd[o + i] = out.count[o + i] = 0;
    if (has_hi) out.best[o_hi + i] = out.bestd[o_hi + i] = out.count[o_hi + i] = 0;
  }
  // Stripe t's diagonals (its columns up to where every cell is 0, and no
  // further than the plain version's last diagonal), and the columns of
  // its carry row that the stripe below reads.
  const auto diagonals = [&](int t) {
    const int i0 = t * W, lanes = min(W, m - i0);
    return min(hi - i0, lanes + len + (match * min(min(i0 + lanes, used), len) + p - 1) / p - 1);
  };
  const auto carried = [&](int t) { return max(0, min(cols, diagonals(t) - W + 1)); };
  uint32_t* rows = carry + (kWarps + 1LL) * cols * blockIdx.x;

  uint32_t rd2[L], keep2[L], best2[L], bestd2[L], count2[L];
  for (int s0 = 0; s0 < stripes; s0 += kWarps) {
    const int s = s0 + warp;
    const bool live = s < stripes;
    const int i0 = s * W;
    const int lag = warp * kPipeLag<L>;
    int nd = 0;  // the round's: its last stripe's, behind its lag
    for (int w = 0; w < kWarps && s0 + w < stripes; ++w) nd = max(nd, w * kPipeLag<L> + diagonals(s0 + w));
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      const int a = (live && i < m) ? rd[i] : kReadPad;
      const int b = (live && has_hi && i < m) ? rd[m + i] : kReadPad;
      rd2[k] = code_half(a) | code_half(b) << 16;
      keep2[k] = i == 0 ? 0u : 0xFFFFFFFFu;
      best2[k] = bestd2[k] = count2[k] = 0;
    }
    // The round before is done: its carry rows are written and the ring
    // is free.
    __syncthreads();
    StripeEdge16x2<L, true> edge(rows + (long long)((s + kWarps) % (kWarps + 1)) * cols,
                                 live && s > 0 ? carried(s - 1) : 0, rows + (long long)(s % (kWarps + 1)) * cols,
                                 live && s + 1 < stripes ? carried(s) : 0, lag);
    // The epoch's first diagonal of the sweep: the sweep's, not the
    // stripe's, which starts lag diagonals before 0, so that d - ebase >= 0
    // (d - ebase - 32767 < 0 <= bestd; see argmax_s16x2_kernel).
    int ebase = 0;
    bool merge = false;  // a flush before this one wrote this stripe's lanes
    const int dbase = i0 + j0 - lag;  // a lane's global diagonal less the sweep's
    const auto on_tile = [&](int base) {
      if (base - ebase > kEpoch - kS16x2Tile<L>) {
        if (live) flush_stripe<L>(best2, bestd2, count2, o + i0, o_hi + i0, has_hi, m - i0, ebase + dbase, merge, out);
        ebase = base;
        merge = true;
      }
    };
    sweep_s16x2<L>(
        rd2, keep2, nd, refs + (long long)c * ref_stride + j0, len, k_sub, mismatch2, gap2, ring,
        [&](int k, bool, uint32_t h, uint32_t, int d) {
          // d is the stripe's own diagonal: owned where d + i0 lies in
          // [lo, hi), the epoch's diagonal d + lag - ebase.
          const uint32_t own = (unsigned)(d + i0 - lo) < owned ? 0xFFFFFFFFu : 0u;
          const uint32_t dlow = (uint32_t)(d + lag - ebase + 32769) * 0x00010001u;
          argmax_update16(h & own, dlow, best2[k], bestd2[k], count2[k]);
        },
        on_tile, edge);
    if (live) flush_stripe<L>(best2, bestd2, count2, o + i0, o_hi + i0, has_hi, m - i0, ebase + dbase, merge, out);
  }
}

// The merge of the s16x2 form's segments: per lane of the (R, C, M)
// result, over the partials of segments 0 .. segments-1 in order.
__global__ void argmax_merge_kernel(const int32_t* __restrict__ part_best,
                                    const int32_t* __restrict__ part_bestd,
                                    const int32_t* __restrict__ part_count, int segments,
                                    long long lanes, int32_t* __restrict__ best,
                                    int32_t* __restrict__ bestd, int32_t* __restrict__ count) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < lanes;
       t += (long long)gridDim.x * blockDim.x) {
    int b = 0, bd = 0, cnt = 0;
    for (int s = 0; s < segments; ++s) {
      const int v = part_best[s * lanes + t];
      if (v > b) {
        b = v;
        bd = part_bestd[s * lanes + t];
        cnt = part_count[s * lanes + t];
      } else if (v == b && v > 0) {
        cnt += part_count[s * lanes + t];
      }
    }
    best[t] = b;
    bestd[t] = bd;
    count[t] = cnt;
  }
}

// The s16x2 form's plan (stride, length, offset, count), checked: one
// segment when stride and length cover n; else, under match > 0,
// mismatch <= 0 and gap < 0, segments with offset >= W + m - 2 and
// length >= stride + offset, count of them (see the top of this file).
// count 0: refused.
ArgSegments plan(int m, int n, int match, int mismatch, int gap, int stride, int length, int offset,
                 int count) {
  if (stride >= n && length >= n) return {n, n, 0, count == 1 ? 1 : 0};
  const ArgSegments no{stride, length, offset, 0};
  if (stride <= 0 || match <= 0 || mismatch > 0 || gap >= 0) return no;
  const long long w = m + (long long)match * m / -(long long)gap;
  if (offset < w + m - 2 || length < (long long)stride + offset) return no;
  const long long want = ((long long)m + n - 1 - offset + stride - 1) / stride;
  if (count != (want > 1 ? want : 1)) return no;
  return {stride, length, offset, count};
}

}  // namespace

extern "C" int swt_argmax_lane(const void* reads, int r, int m,
                               const void* refs, long long ref_stride, int c,
                               int n, int match, int mismatch, int gap,
                               void* best, void* bestd, void* count,
                               void* carry, int part_reads, int device,
                               void* stream) {
  const int L = swt::pick_lanes(m);
  if (r <= 0 || c <= 0 || (L == 0 && carry == nullptr)) return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = read_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      argmax_wide_kernel<swt::kStripeL><<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)refs,
          ref_stride, c, n, match, mismatch, gap, (int32_t*)best,
          (int32_t*)bestd, (int32_t*)count, (int32_t*)carry);
    });
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                       \
  case l:                                                                   \
    argmax_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(                 \
        (const uint8_t*)reads, r, m, (int)read_blocks,                      \
        (const uint8_t*)refs, ref_stride, c, n, match, mismatch, gap,       \
        (int32_t*)best, (int32_t*)bestd, (int32_t*)count);                  \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2 in the s16x2 form; the wrapper takes it only where ops/cuda_score.py
// k1k4_form says so, and this entry refuses a scheme under which a value
// could leave int16, reads wider than kMaxLanes (argmax_wide_s16x2_kernel)
// unless mismatch < 0 and gap < 0 and `carry`, of carry_elems words,
// holds kWarps + 1 rows of carry_cols >= min(length, n) + m words for
// each block of part_reads reads (an even count) at a time, and a plan
// that is not exact.  Its
// arguments are swt_argmax_lane's, with the plan of ops/cuda_score.py
// argmax_segments before the carry; with seg_count > 1, best, bestd and
// count are the (seg_count, r, c, m) partials, which swt_argmax_merge
// reduces.
extern "C" int swt_argmax_lane_s16x2(const void* reads, int r, int m, const void* refs,
                                     long long ref_stride, int c, int n, int match, int mismatch,
                                     int gap, void* best, void* bestd, void* count, int seg_stride,
                                     int seg_length, int seg_offset, int seg_count, void* carry,
                                     long long carry_elems, int carry_cols, int part_reads, int device,
                                     void* stream) {
  const int L = swt::pick_lanes(m);
  const ArgSegments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length, seg_offset, seg_count);
  const bool fits = match >= 0 && (long long)match * m <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0 &&
                    (L > 0 || (mismatch < 0 && gap < 0 && carry != nullptr && part_reads > 0 &&
                               carry_cols >= (sg.length < n ? sg.length : n) + m &&
                               carry_elems >= (swt::kWarps + 1LL) * carry_cols * (part_reads / 2) * c * sg.count));
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || !fits || sg.count == 0)
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = L > 0 ? read_blocks * c * sg.count : (r + 1) / 2 * (long long)c * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    const int p = mismatch > gap ? -mismatch : -gap;
    return swt::launch_parts(r, part_reads, [&](int read0, int part_pairs) {
      argmax_wide_s16x2_kernel<swt::kStripe16L><<<(unsigned)(part_pairs * c * sg.count), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_pairs, (const uint8_t*)refs, ref_stride, c, n, sg, match, p,
          (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap), carry_cols,
          ArgOut{(int32_t*)best, (int32_t*)bestd, (int32_t*)count}, (uint32_t*)carry);
    }, 2);
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                                          \
  case l:                                                                                      \
    argmax_s16x2_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(                         \
        (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)refs, ref_stride, c, n, \
        sg, (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap),             \
        ArgOut{(int32_t*)best, (int32_t*)bestd, (int32_t*)count});                             \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The merge of swt_argmax_lane_s16x2's segments: partials (segments,
// lanes) int32 each into best, bestd and count (lanes,).
extern "C" int swt_argmax_merge(const void* part_best, const void* part_bestd, const void* part_count,
                                int segments, long long lanes, void* best, void* bestd, void* count,
                                int device, void* stream) {
  if (segments <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const long long blocks = (lanes + 255) / 256;
  argmax_merge_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)part_best, (const int32_t*)part_bestd, (const int32_t*)part_count, segments, lanes,
      (int32_t*)best, (int32_t*)bestd, (int32_t*)count);
  return (int)cudaGetLastError();
}

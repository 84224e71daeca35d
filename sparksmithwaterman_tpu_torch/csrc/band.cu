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
// The left column's contract: bnd is a column of the same DP, so 0 <=
// bnd[c, r, i] <= match x m, and <= match x seg where the caller bounds
// its reads' lanes by seg (every bnd_out of K3 and the zeros of a
// reference's first segment meet it: a cell is at most match x the lanes
// of its read).
//
// What bounds it on the H100: the register-resident integer sweep of K1
// (wavefront.cuh); bnd is read once and the two outputs are written
// once, so it is bound by integer operations, not bytes.  Two forms,
// chosen by the wrapper from the data alone (ops/cuda_score.py k3_form):
//
// - s16x2 (band_s16x2_kernel), rows of at most 1,024 lanes where no value
//   leaves int16: K1's s16x2 design, two packed rows a warp, one in each
//   16-bit half of every register, sweep_s16x2's recurrence in
//   __viaddmax_s16x2_relu.  A cell is at most bnd's bound plus match x
//   (m - 1), so the rule is match x (2m - 1) <= 32,767 (k1_form's with
//   the left column's match x m added): then U <= match x (2m - 2) <=
//   32,767 - match and the IMAD carries nothing across halves.  The
//   boundary columns cost only the first and the last diagonals: the
//   sweep runs its unrolled steps below m (the left column enters) and
//   from ns - 1 on (the right column leaves) as edge steps, and every
//   other step as K1's loop, with no compare a cell.  Both rows' left
//   columns are staged once in shared memory as one word a lane (low
//   row | high row << 16); before diagonal i the thread owning lane i
//   takes bnd[i] into that register (for L <= 8 the register is known at
//   compile time, as the unroll is a multiple of L), the lane to its
//   right reads it as its N term and keeps it, through keep2, as its NW
//   term (zero where that lane starts a read; both halves inject on the
//   same diagonal, lane i being lane i of both rows).  An edge step
//   folds every diagonal into best alone, so an injected value never
//   counts as a cell.  On diagonal i + ns - 1 the thread owning lane i
//   stores both rows' H there to bnd_out.
// - int32 (band_kernel, one warp per row): every other row of at most
//   1,024 lanes; the injection is a compare a lane on the first m
//   diagonals and the capture a compare a cell.
//
// Column pieces, in every form, where the scheme has match > 0, mismatch
// <= 0 and gap < 0 (ops/cuda_score.py band_segments plans them, these
// entries refuse a plan that is not exact): one segment of a long
// reference on one card is a long chain of diagonals for few blocks, so
// a launch may cut each segment at multiples of a stride S into pieces,
// one block (of rows) each.  Piece k >= 1 starts W - 1 columns before k
// S from zero state, W = L + match L // |gap|, L the lanes of the longest
// read (m, or the caller's bound seg): a positive cell is reached by an
// alignment spanning at most W columns, so the piece computes every cell
// of its own columns [k S, (k + 1) S) exactly, and no path from the left
// column reaches them (from bnd <= match x L a path stays positive for
// fewer than 2W - 1 columns, and S >= 2W).  Neither bound looks at how
// the row is swept: a wide row's piece runs its stripes over the piece's
// columns, with carry rows as wide as the piece, so its stripes compute
// the piece's DP as one pass would, and the argument holds unchanged.  Piece 0 takes
// bnd; the last piece, which computes column ns - 1 exactly, writes
// bnd_out; every piece of a segment cut in several takes the max of its
// suffix-maxed lane bests into out (zeroed by the wrapper) with
// atomicMax, which gives each start lane its read's best, as the suffix
// max distributes over max (a segment left whole stores its own).  cum
// (on the card) is the inclusive prefix sum of each reference's piece
// count, so a block finds its reference by a binary search and the
// launch needs no table from the host.  Read blocks vary fastest, so the blocks of one
// piece run together and share its bytes in L2.
//
// A row of more than 1,024 lanes runs in stripes, in pieces as above:
// in stripe s of piece 0, lane sW + k takes its left column before local
// diagonal k, and lane sW's NW term on its first diagonal is bnd[sW - 1];
// in the last piece lane sW + k gives its right column on local diagonal
// k + width - 1.  Each piece's carry rows are as wide as the piece
// (piece_carry), and the stripes' suffix max across their boundaries
// meets the other pieces' by atomicMax.  Two forms, by k3_form:
//
// - s16x2 (band_wide_s16x2_kernel) where match x (2L - 1) <= 32,767, L =
//   min(m, the caller's longest read), and mismatch < 0 and gap < 0: two
//   packed rows a warp in 16-bit halves, swept in stripes of 256 lanes by
//   sweep_s16x2 with a BandStripe16x2, the stripe carry one uint32 a
//   column holding both rows; the left column enters and the right column
//   leaves in edge steps only (the first and last 256 diagonals of a
//   stripe), as in band_s16x2_kernel, so the other steps are K1's striped
//   stripe step.  The bound is the one-pass form's with L for m.
// - int32 (band_wide_kernel): stripes of 512, one warp a row, every other
//   scheme and width.
#include "wavefront.cuh"

namespace {

using namespace swt;

// A launch's column pieces (see the top of this file): reference c's
// columns cut at multiples of stride, piece k >= 1 beginning back columns
// before k * stride; cum the inclusive prefix sum of the pieces of each
// reference, or null for one piece a reference.
struct Pieces {
  int stride, back;
  const int32_t* cum;
};

// A block's row block, reference, first column and columns, and whether
// it is its reference's first piece (takes bnd) and last (gives bnd_out);
// c < 0 for a block past the launch's pieces (the grid is sized by an
// upper bound of their count).
struct Piece {
  int rb, c, j0, width;
  bool first, last;
};

__device__ __forceinline__ Piece place(int block, int row_blocks, int refs, const int32_t* ns, Pieces pc) {
  Piece p;
  p.rb = block % row_blocks;
  const int g = block / row_blocks;
  int k = 0, count = 1;
  if (pc.cum == nullptr) {
    p.c = g;
  } else {
    if (g >= pc.cum[refs - 1]) {
      p.c = -1;
      return p;
    }
    int lo = 0, hi = refs - 1;  // the first reference whose cum passes g
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pc.cum[mid] > g)
        hi = mid;
      else
        lo = mid + 1;
    }
    const int before = lo ? pc.cum[lo - 1] : 0;
    p.c = lo;
    k = g - before;
    count = pc.cum[lo] - before;
  }
  p.j0 = k ? k * pc.stride - pc.back : 0;
  p.width = (k + 1 < count ? (k + 1) * pc.stride : max(ns[p.c], 1)) - p.j0;
  p.first = k == 0;
  p.last = k + 1 == count;
  return p;
}

// The bytes of piece p's columns that lie in its segment.
__device__ __forceinline__ int piece_len(const int32_t* seg_lens, const Piece& p) {
  return min(max(seg_lens[p.c] - p.j0, 0), p.width);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
band_kernel(const int32_t* __restrict__ packed, int rows, int m,
            int row_blocks, int refs, const uint8_t* __restrict__ segs,
            const long long* __restrict__ offs,
            const int32_t* __restrict__ seg_lens,
            const int32_t* __restrict__ ns,
            const int32_t* __restrict__ bnd, Pieces pc, int match, int mismatch, int gap,
            int32_t* __restrict__ out, int32_t* __restrict__ bnd_out) {
  __shared__ uint8_t ring[kRing];
  const Piece p = place(blockIdx.x, row_blocks, refs, ns, pc);
  if (p.c < 0) return;
  const int row = p.rb * kWarps + (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const bool live = row < rows;
  const int nd = m + p.width - 1;
  const int head = p.first ? m : 0;
  const long long base = ((long long)p.c * rows + row) * m;

  int rd[L], bv[L], bo[L], best[L];
  uint32_t start = 0;  // bit k: lane first+k starts a segment
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    const bool real = live && i < m;
    const int raw = real ? packed[(long long)row * m + i] : kStartBit;
    rd[k] = raw & 255;
    if (raw >= kStartBit || i == 0) start |= 1u << k;
    bv[k] = real && p.first ? bnd[base + i] : 0;
    bo[k] = 0;
    best[k] = 0;
  }
  // Diagonal of lane `first` in column ns - 1 (none but in the last piece).
  const int last = p.last ? first + p.width - 1 : -(1 << 30);
  sweep<L>(
      rd, start, nd, segs + offs[p.c] + p.j0, piece_len(seg_lens, p), match, mismatch, gap, ring,
      [&](int k, int d, int h) {
        best[k] = max(best[k], h);
        if (d == last + k) bo[k] = h;
      },
      [&](int d, int(&H)[L]) {
        if (d < head) {
#pragma unroll
          for (int k = 0; k < L; ++k)
            if (first + k == d) H[k] = bv[k];
        }
      });
  if (!(p.first && p.last))  // pieces of one segment meet in out
    store_suffix_max<L, true>(best, start, m, live, out + base);
  else
    store_suffix_max<L>(best, start, m, live, out + base);
  if (!live || !p.last) return;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (first + k < m) bnd_out[base + first + k] = bo[k];
  }
}

// The s16x2 form (see the top of this file): piece p's row block b takes
// packed rows 8b .. 8b + 7, warp w the pair 2w, 2w + 1.  k_sub = match -
// mismatch, mismatch2 and gap2 pair16 of the scheme.
template <int L>
__global__ void __launch_bounds__(kThreads)
band_s16x2_kernel(const int32_t* __restrict__ packed, int rows, int m,
                  int row_blocks, int refs, const uint8_t* __restrict__ segs,
                  const long long* __restrict__ offs,
                  const int32_t* __restrict__ seg_lens,
                  const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ bnd, Pieces pc, uint32_t k_sub,
                  uint32_t mismatch2, uint32_t gap2,
                  int32_t* __restrict__ out, int32_t* __restrict__ bnd_out) {
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  __shared__ uint32_t left[kWarps][32 * L];  // both rows' bnd, low | high << 16
  const Piece p = place(blockIdx.x, row_blocks, refs, ns, pc);
  if (p.c < 0) return;
  const int warp = threadIdx.x >> 5;
  const int row = p.rb * (2 * kWarps) + 2 * warp;
  const int first = (threadIdx.x & 31) * L;
  const int nd = m + p.width - 1;
  const long long base = ((long long)p.c * rows + row) * m;

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
  if (p.first) {  // the sweep's first barrier orders these stores before the reads
    for (int i = threadIdx.x & 31; i < m; i += 32) {
      const uint32_t lo = row < rows ? (uint32_t)bnd[base + i] : 0u;
      const uint32_t hi = row + 1 < rows ? (uint32_t)bnd[base + m + i] : 0u;
      left[warp][i] = (lo & 0xFFFFu) | hi << 16;
    }
  }
  const int tail = p.last ? p.width - 1 : 0x7fffffff;  // lane i's H leaves on diagonal i + tail
  int32_t* right = bnd_out + base;
  sweep_s16x2<L>(
      rd2, keep2, nd, segs + offs[p.c] + p.j0, piece_len(seg_lens, p), k_sub, mismatch2, gap2, ring,
      [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
        if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
      },
      [](int) {},
      make_edges(
          p.first ? m : 0, tail,
          [&](int d, int u, uint32_t(&H)[L]) {
            const uint32_t v = left[warp][d];
            if constexpr (L <= 8) {
              // The unroll is a multiple of L: lane d is register u % L of
              // the thread whose first lane is d - u % L.
              if (first == d - u % L) H[u % L] = v;
            } else {
#pragma unroll
              for (int k = 0; k < L; ++k)
                if (first + k == d) H[k] = v;
            }
          },
          [&](int d, uint32_t(&H)[L]) {
            const int k = d - tail - first;  // lane d - tail is register k of this thread
            if (k >= 0 && k < L && first + k < m) {
              uint32_t v = 0;
#pragma unroll
              for (int q = 0; q < L; ++q)
                if (q == k) v = H[q];
              if (row < rows) right[first + k] = (int)(v & 0xFFFFu);
              if (row + 1 < rows) right[m + first + k] = (int)(v >> 16);
            }
          }));

  // The piece, the row and the segment starts again, from the block index
  // and keep2, so that the output's address and the starts hold no
  // register across the sweep (as in K1's s16x2 kernel).
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const Piece q = place(block, row_blocks, refs, ns, pc);
  const int row2 = q.rb * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  uint32_t start_lo = 0, start_hi = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    asm volatile("" : "+r"(keep2[k]));  // not derived again from the loads
    start_lo |= (uint32_t)((keep2[k] & 0xFFFFu) == 0) << k;
    start_hi |= (uint32_t)((keep2[k] >> 16) == 0) << k;
  }
  int32_t* o = out + ((long long)q.c * rows + row2) * m;
  int best[L];
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] & 0xFFFFu);
  const bool shared = !(q.first && q.last);  // pieces of one segment meet in out
  if (shared)
    store_suffix_max<L, true>(best, start_lo, m, row2 < rows, o);
  else
    store_suffix_max<L>(best, start_lo, m, row2 < rows, o);
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] >> 16);
  if (shared)
    store_suffix_max<L, true>(best, start_hi, m, row2 + 1 < rows, o + m);
  else
    store_suffix_max<L>(best, start_hi, m, row2 + 1 < rows, o + m);
}

// The carry rows of piece p for row (int32) or pair (s16x2) `part_row` of
// a launch's part: reference c's scratch, from carry_offs[c] on, holds for
// each row (pair) of the part its pieces' two carry rows of each piece's
// width one after another, ns + (pieces - 1) x back columns a row (its
// pieces' widths: stride, stride + back, ..., and the rest), so a piece
// costs its own columns, not its segment's.
__device__ __forceinline__ long long piece_carry(const Piece& p, int part_row, const int32_t* ns, Pieces pc,
                                                 const long long* carry_offs) {
  const int n = max(ns[p.c], 1);
  if (p.first && p.last) return carry_offs[p.c] + 2LL * part_row * n;
  const int k = p.first ? 0 : (p.j0 + pc.back) / pc.stride;
  const int count = (n + pc.stride - 1) / pc.stride;
  const long long row_cols = n + (long long)(count - 1) * pc.back;
  return carry_offs[p.c] + 2 * (part_row * row_cols + (k ? (long long)k * (pc.stride + pc.back) - pc.back : 0));
}

// K3 on a row wider than kMaxLanes, in stripes of 32 * L lanes (see the
// top of this file and wavefront.cuh), over rows row0 .. row0 +
// row_blocks * kWarps - 1, one block a row block and column piece;
// piece_carry places each row's carry rows.
template <int L>
__global__ void __launch_bounds__(kThreads)
band_wide_kernel(const int32_t* __restrict__ packed, int rows, int m,
                 int row0, int row_blocks, int refs, const uint8_t* __restrict__ segs,
                 const long long* __restrict__ offs,
                 const int32_t* __restrict__ seg_lens,
                 const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ bnd, Pieces pc, int match, int mismatch,
                 int gap, int32_t* __restrict__ out,
                 int32_t* __restrict__ bnd_out, int32_t* __restrict__ carry,
                 const long long* __restrict__ carry_offs) {
  constexpr int W = 32 * L;
  __shared__ uint8_t ring[kRing];
  const Piece p = place(blockIdx.x, row_blocks, refs, ns, pc);
  if (p.c < 0) return;
  const int part_row = p.rb * kWarps + (threadIdx.x >> 5);
  const int row = row0 + part_row;
  const int first = (threadIdx.x & 31) * L;
  const bool live = row < rows;
  const int width = p.width;
  const long long base = ((long long)p.c * rows + row) * m;
  const int32_t* prow = packed + (long long)row * m;
  int32_t* buf = carry + piece_carry(p, part_row, ns, pc, carry_offs);
  const int last = p.last ? first + width - 1 : -(1 << 30);  // local diagonal of lane `first` in column ns-1
  const bool shared = !(p.first && p.last);  // pieces of one segment meet in out

  for (int s = 0; s * W < m; ++s) {
    const int i0 = s * W;
    const int lanes = min(W, m - i0);
    const int head = p.first ? lanes : 0;
    int rd[L], bv[L], bo[L], best[L];
    uint32_t start = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      const bool real = live && i < m;
      const int raw = real ? prow[i] : kStartBit;
      rd[k] = raw & 255;
      if (raw >= kStartBit || i == 0) start |= 1u << k;
      bv[k] = real && p.first ? bnd[base + i] : 0;
      bo[k] = 0;
      best[k] = 0;
    }
    __syncwarp();  // the stripe above's carry row is visible
    StripeEdge<L> edge(buf + ((s + 1) & 1) * width, s > 0 ? width : 0, buf + (s & 1) * width,
                       (s > 0 && live && p.first) ? bnd[base + i0 - 1] : 0);
    sweep<L>(
        rd, start, lanes + width - 1, segs + offs[p.c] + p.j0, piece_len(seg_lens, p), match, mismatch, gap, ring,
        [&](int k, int d, int h) {
          best[k] = max(best[k], h);
          if (d == last + k) bo[k] = h;
        },
        [&](int d, int(&H)[L]) {
          if (d < head) {
#pragma unroll
            for (int k = 0; k < L; ++k)
              if (first + k == d) H[k] = bv[k];
          }
        },
        edge);
    if (shared)
      store_suffix_max<L, true>(best, start, lanes, live, out + base + i0);
    else
      store_suffix_max<L>(best, start, lanes, live, out + base + i0);
    if (live && p.last) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (first + k < lanes) bnd_out[base + i0 + first + k] = bo[k];
      }
    }
  }
  if (!live) return;
  if (shared)
    stripe_suffix_max<L, true>(prow, m, out + base);
  else
    stripe_suffix_max<L>(prow, m, out + base);
}

// The piece and the pair of rows of this warp in a launch of the wide
// s16x2 form, from the block index read anew (asm volatile), so that none
// of them holds a register across a stripe's sweep (as
// lane_best_wide_s16x2_kernel's wide_pair).
struct WideBand {
  Piece p;
  int part_pair, row;
};

__device__ __forceinline__ WideBand wide_band(int row0, int row_blocks, int refs, const int32_t* ns, Pieces pc) {
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const Piece p = place(block, row_blocks, refs, ns, pc);
  const int part_pair = p.rb * kWarps + (threadIdx.x >> 5);
  return {p, part_pair, row0 + 2 * part_pair};
}

// The s16x2 form of a row wider than kMaxLanes (see the top of this file):
// warp w of a block takes the pair of packed rows row0 + 8 rb + 2w, + 1 of
// its piece, one in each 16-bit half, and sweeps it in stripes of 32 * L
// lanes through sweep_s16x2 with a BandStripe16x2: the stripe carry
// (StripeEdge16x2) on every step, and in piece 0 the left column entering
// each stripe's lane k before its local diagonal k (staged per stripe in
// shared memory, both rows a word, as band_s16x2_kernel stages the row's),
// lane 0's NW term on its first diagonal the left column of the lane above
// it; in the last piece lane k's H leaving on local diagonal k + width - 1.
// Each stripe stores each row's segmented suffix max, then the stripes'
// suffix max runs across their boundaries, by atomicMax where pieces meet.
template <int L>
__global__ void __launch_bounds__(kThreads)
band_wide_s16x2_kernel(const int32_t* __restrict__ packed, int rows, int m, int row0, int row_blocks, int refs,
                       const uint8_t* __restrict__ segs, const long long* __restrict__ offs,
                       const int32_t* __restrict__ seg_lens, const int32_t* __restrict__ ns,
                       const int32_t* __restrict__ bnd, Pieces pc, uint32_t k_sub, uint32_t mismatch2,
                       uint32_t gap2, int32_t* __restrict__ out, int32_t* __restrict__ bnd_out,
                       uint32_t* __restrict__ carry, const long long* __restrict__ carry_offs) {
  constexpr int W = 32 * L;
  static_assert(L <= 8 && kS16x2Unroll<L> % L == 0, "enter finds lane d's register by the step's slot");
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  __shared__ uint32_t left[kWarps][W];  // the stripe's left column, both rows: low | high << 16
  const int warp = threadIdx.x >> 5;
  const int first = (threadIdx.x & 31) * L;
  if (wide_band(row0, row_blocks, refs, ns, pc).p.c < 0) return;  // the whole block

  for (int s = 0; s * W < m; ++s) {
    const int i0 = s * W;
    const int lanes = min(W, m - i0);
    const WideBand b = wide_band(row0, row_blocks, refs, ns, pc);
    const int32_t* prow = packed + (long long)b.row * m;
    uint32_t rd2[L], keep2[L], best2[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      // Lanes past m (and rows past ROWS) form isolated all-pad segments.
      const int lo = (b.row < rows && i < m) ? prow[i] : kStartBit;
      const int hi = (b.row + 1 < rows && i < m) ? prow[m + i] : kStartBit;
      rd2[k] = code_half(lo) | code_half(hi) << 16;
      keep2[k] = (lo >= kStartBit || i == 0 ? 0u : 0x0000FFFFu) | (hi >= kStartBit || i == 0 ? 0u : 0xFFFF0000u);
      best2[k] = 0;
    }
    const long long base = ((long long)b.p.c * rows + b.row) * m + i0;  // the stripe's lane 0 of the low row
    // Every warp is done with the stripe above's ring and left column, and
    // this pair's carry row from it is visible; the sweep's first barrier
    // orders the left column's stores below before its reads.
    __syncthreads();
    uint32_t corner = 0;
    if (b.p.first) {
      for (int t = threadIdx.x & 31; t < lanes; t += 32) {
        const uint32_t lo = b.row < rows ? (uint32_t)bnd[base + t] : 0u;
        const uint32_t hi = b.row + 1 < rows ? (uint32_t)bnd[base + m + t] : 0u;
        left[warp][t] = (lo & 0xFFFFu) | hi << 16;
      }
      if (s > 0)
        corner = ((b.row < rows ? (uint32_t)bnd[base - 1] : 0u) & 0xFFFFu) |
                 (b.row + 1 < rows ? (uint32_t)bnd[base + m - 1] : 0u) << 16;
    }
    const int width = b.p.width;
    const int tail = b.p.last ? width - 1 : 0x7fffffff;  // lane k's H leaves on local diagonal k + tail
    uint32_t* buf = carry + piece_carry(b.p, b.part_pair, ns, pc, carry_offs);
    int32_t* right = bnd_out + base;
    const int row = b.row;
    sweep_s16x2<L>(
        rd2, keep2, lanes + width - 1, segs + offs[b.p.c] + b.p.j0, piece_len(seg_lens, b.p), k_sub, mismatch2,
        gap2, ring,
        [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
          if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
        },
        [](int) {},
        make_band_stripe(
            StripeEdge16x2<L>(buf + ((s + 1) & 1) * width, s > 0 ? width : 0, buf + (s & 1) * width, width),
            b.p.first ? lanes : 0, tail, corner,
            [&](int d, int u, uint32_t(&H)[L]) {
              // The unroll is a multiple of L: lane d is register u % L of
              // the thread whose first lane is d - u % L.
              const uint32_t v = left[warp][d];
              if (first == d - u % L) H[u % L] = v;
            },
            [&](int d, uint32_t(&H)[L]) {
              const int k = d - tail - first;  // lane d - tail is register k of this thread
              if (k >= 0 && k < L && first + k < lanes) {
                uint32_t v = 0;
#pragma unroll
                for (int q = 0; q < L; ++q)
                  if (q == k) v = H[q];
                if (row < rows) right[first + k] = (int)(v & 0xFFFFu);
                if (row + 1 < rows) right[m + first + k] = (int)(v >> 16);
              }
            }));

    const WideBand q = wide_band(row0, row_blocks, refs, ns, pc);
    const bool shared = !(q.p.first && q.p.last);  // pieces of one segment meet in out
    int32_t* o = out + ((long long)q.p.c * rows + q.row) * m + i0;
    uint32_t start_lo = 0, start_hi = 0;
    int best[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      asm volatile("" : "+r"(keep2[k]));  // not derived again from the loads
      start_lo |= (uint32_t)((keep2[k] & 0xFFFFu) == 0) << k;
      start_hi |= (uint32_t)((keep2[k] >> 16) == 0) << k;
      best[k] = (int)(best2[k] & 0xFFFFu);
    }
    if (shared)
      store_suffix_max<L, true>(best, start_lo, lanes, q.row < rows, o);
    else
      store_suffix_max<L>(best, start_lo, lanes, q.row < rows, o);
#pragma unroll
    for (int k = 0; k < L; ++k) best[k] = (int)(best2[k] >> 16);
    if (shared)
      store_suffix_max<L, true>(best, start_hi, lanes, q.row + 1 < rows, o + m);
    else
      store_suffix_max<L>(best, start_hi, lanes, q.row + 1 < rows, o + m);
  }
  const WideBand q = wide_band(row0, row_blocks, refs, ns, pc);
  const int32_t* prow = packed + (long long)q.row * m;
  int32_t* o = out + ((long long)q.p.c * rows + q.row) * m;
  for (int h = 0; h < 2; ++h) {
    if (q.row + h >= rows) break;
    if (!(q.p.first && q.p.last))
      stripe_suffix_max<L, true>(prow + h * m, m, o + h * m);
    else
      stripe_suffix_max<L>(prow + h * m, m, o + h * m);
  }
}

// A plan of column pieces is exact (see the top of this file) under
// match > 0, mismatch <= 0 and gap < 0, with a look-back of at least W - 1
// columns and a stride of at least 2W, W = seg + match seg // |gap|, seg
// (1 <= seg <= m) the caller's bound on a read's lanes (the left column's
// contract is 0 <= bnd <= match x seg).
bool exact_plan(int m, int seg, int match, int mismatch, int gap, Pieces pc) {
  if (pc.cum == nullptr) return true;
  if (seg < 1 || seg > m || match <= 0 || mismatch > 0 || gap >= 0) return false;
  const long long w = seg + (long long)match * seg / -(long long)gap;
  return pc.back >= w - 1 && pc.stride >= 2 * w;
}

}  // namespace

// pieces: the launch's count of column pieces, or an upper bound of it
// (the count of references when cum is null); seg: the caller's bound on
// a read's lanes (1 <= seg <= m, m for rows of one pass), which sizes W in
// exact_plan.  Rows wider than kMaxLanes (band_wide_kernel) need carry:
// two carry rows a row of part_rows rows a launch, reference c's from
// carry_offs[c] on, each piece's of its own width (piece_carry).
extern "C" int swt_band_lane_best(const void* packed, int rows, int m,
                                  const void* segs, const void* offs,
                                  const void* seg_lens, const void* ns, int c,
                                  const void* bnd, int match, int mismatch,
                                  int gap, void* out, void* bnd_out,
                                  void* carry, const void* carry_offs,
                                  int part_rows, int stride, int back,
                                  const void* cum, int pieces, int seg, int device,
                                  void* stream) {
  const int L = swt::pick_lanes(m);
  const Pieces pc{stride, back, (const int32_t*)cum};
  if (rows <= 0 || c <= 0 || pieces < c || (L == 0 && carry == nullptr) ||
      !exact_plan(m, seg, match, mismatch, gap, pc))
    return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = row_blocks * pieces;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    return swt::launch_parts(rows, part_rows, [&](int row0, int part_blocks) {
      band_wide_kernel<swt::kStripeL><<<(unsigned)(part_blocks * pieces), swt::kThreads, 0, s>>>(
          (const int32_t*)packed, rows, m, row0, part_blocks, c, (const uint8_t*)segs,
          (const long long*)offs, (const int32_t*)seg_lens, (const int32_t*)ns,
          (const int32_t*)bnd, pc, match, mismatch, gap, (int32_t*)out,
          (int32_t*)bnd_out, (int32_t*)carry, (const long long*)carry_offs);
    });
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                       \
  case l:                                                                   \
    band_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(              \
        (const int32_t*)packed, rows, m, (int)row_blocks, c,                \
        (const uint8_t*)segs, (const long long*)offs,                       \
        (const int32_t*)seg_lens, (const int32_t*)ns,                       \
        (const int32_t*)bnd, pc, match, mismatch, gap, (int32_t*)out,       \
        (int32_t*)bnd_out);                                                 \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The s16x2 form; the wrapper takes it only where ops/cuda_score.py
// k3_form says so, and this entry refuses a scheme under which a value
// could leave int16: match x (2 seg - 1) > 32,767, seg (1 <= seg <= m)
// the caller's bound on a read's lanes (m for rows of one pass; the left
// column's contract is 0 <= bnd <= match x seg); and rows wider than
// kMaxLanes (band_wide_s16x2_kernel, in stripes) unless mismatch < 0 and
// gap < 0 (the stripes' rule) and with carry, as for the int32 entry but
// per pair (part_rows a multiple of 2 * kWarps).
extern "C" int swt_band_lane_best_s16x2(const void* packed, int rows, int m,
                                        const void* segs, const void* offs,
                                        const void* seg_lens, const void* ns, int c,
                                        const void* bnd, int match, int mismatch,
                                        int gap, void* out, void* bnd_out,
                                        void* carry, const void* carry_offs,
                                        int part_rows, int stride,
                                        int back, const void* cum, int pieces, int seg,
                                        int device, void* stream) {
  const int L = swt::pick_lanes(m);
  const bool wide = L == 0;
  const Pieces pc{stride, back, (const int32_t*)cum};
  const bool fits = match >= 0 && seg >= 1 && seg <= m && (long long)match * (2LL * seg - 1) <= 32767 &&
                    mismatch >= -32768 && mismatch <= 0 && gap >= -32768 && gap <= 0 &&
                    (!wide || (mismatch < 0 && gap < 0 && carry != nullptr));
  if (rows <= 0 || c <= 0 || pieces < c || !fits || !exact_plan(m, seg, match, mismatch, gap, pc))
    return (int)cudaErrorInvalidValue;
  const long long row_blocks = (rows + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = row_blocks * pieces;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    return swt::launch_parts(rows, part_rows, [&](int row0, int part_blocks) {
      band_wide_s16x2_kernel<swt::kStripe16L><<<(unsigned)(part_blocks * pieces), swt::kThreads, 0, s>>>(
          (const int32_t*)packed, rows, m, row0, part_blocks, c, (const uint8_t*)segs, (const long long*)offs,
          (const int32_t*)seg_lens, (const int32_t*)ns, (const int32_t*)bnd, pc, (uint32_t)(match - mismatch),
          pair16(mismatch), pair16(gap), (int32_t*)out, (int32_t*)bnd_out, (uint32_t*)carry,
          (const long long*)carry_offs);
    }, 2 * swt::kWarps);
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                                  \
  case l:                                                                              \
    band_s16x2_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(                   \
        (const int32_t*)packed, rows, m, (int)row_blocks, c, (const uint8_t*)segs,     \
        (const long long*)offs, (const int32_t*)seg_lens, (const int32_t*)ns,          \
        (const int32_t*)bnd, pc, (uint32_t)(match - mismatch), pair16(mismatch),       \
        pair16(gap), (int32_t*)out, (int32_t*)bnd_out);                                \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8: every DP cell equal to a read's best score, listed on the card.
//
// Replaces the lax code of the in-lane-tie fallback,
//   sparksmithwaterman_tpu/ops/longseq.py:_max_cells_device_batch
// (a lax.scan of row updates stacking H as (m, R, n), then a vmapped
// argwhere).  Reads (R, M) uint8, READ_PAD-padded, against ONE reference
// (N,) uint8, with each read's best score best[r] known before the launch
// (the max of K2's lane bests), give count[r] (int64), the number of cells
// (i, j) with H[i][j] == best[r], and their (i, j) as int32 pairs in the
// slots cells[r][0, capacity) in the order found; the wrapper sorts them
// row-major and fills the rest with -1.  A slot is written only below
// capacity, and the count always counts.  A read with best[r] <= 0 lists
// nothing here.  A second kernel finishes the listing on the card
// (max_cells_finish_kernel, one block per read): it sorts each read's
// filled slots row-major, fills the rest with -1, and gives a read of best
// 0 every cell of its plane by arithmetic (count M x N), so that no torch
// operation runs after the launch.
//
// The recurrence is K5's (csrc/score_row.cu), its row step shared through
// csrc/row_scan.cuh: tiles of kRowTile columns, all M rows of a tile
// before the next, one carried column between tiles, each row's gap chain
// resolved by a scan within the lane and across the warp.  After each row every lane takes the max of its kRowCols columns
// and one vote asks whether any lane reached its read's best.  Only then
// does the warp walk its registers (`list_*`): one __ballot_sync per
// register (and per half in the s16x2 form), one atomicAdd on the read's
// 64-bit counter from the ballot's first lane for all its hits, and a
// store of (i, j) from each hitting lane whose slot is below capacity.
// A read's best is its max, so such rows are rare, and the listing costs
// one max per register, a compare and a vote per row over K5's work; its
// memory is O(R x capacity), not the (M, R, N) stack of the lax version.
//
// What bounds it on the H100: integer operations, as K5 (the inputs are
// read once per tile, and the output is a counter and a few slots a read).
// Four forms, picked by the wrapper from the data alone (ops/cuda_score.py
// k5_form, K5's rule, m the width of the reads tensor):
//
// - s16x2 (max_cells_s16x2_kernel), reads of at most 1,024 positions whose
//   scores fit int16: K5's s16x2 form, warp w of a block on reads 2w and
//   2w + 1, one in each 16-bit half of every register, the recurrence
//   __viaddmax_s16x2_relu with the decaying scan.  A row's max is
//   __vimax3_s16x2 over the lane's registers, compared with the pair's
//   packed bests by __vcmpges2; a listed register is compared half by half.
// - int32 (max_cells_kernel, one warp per read, the prefix max of
//   A[k] - gap*k): every other read of at most 1,024 positions.
// - s16x2 wide (max_cells_wide_s16x2_kernel): reads of more than 1,024
//   positions whose scores fit int16 (ops/cuda_score.py k5_form: K8's
//   recurrence is K5's row scan, which has no stripes, so K5's bound
//   match x m holds at any width).  A block a pair and segment, its four
//   warps on four tiles at once, a tile's last column passed to the next
//   tile's warp through a scratch of one uint32 a row (see the kernel).
// - int32 wide (max_cells_wide_kernel): other reads of more than 1,024
//   positions.  Codes are read from global memory and the carried column
//   lives in a scratch row of m int32 per read and segment, which the
//   wrapper allocates, as in score_row_wide_kernel.
//
// Rows: trailing pad rows are skipped only when mismatch < 0 and gap < 0
// (`trim`): a pad row (READ_PAD matches nothing) then stays strictly below
// a positive best.  Under other signs every one of the M rows is swept, as
// the plain version counts them.  Columns: all N of the reference, REF_PAD
// codes included, as the plain version; a tile's columns past the end read
// as REF_PAD and are never listed.
//
// Column segments.  A launch with few blocks (a few tied reads) cuts the
// reference into segments, one block each (ops/cuda_score.py
// max_cells_segments: a warp is one chain of M dependent row steps a tile,
// so each segment is a whole number of tiles, as few as the launch's
// target of blocks allows, and the redundant columns cost nothing the card
// lacks): segment k covers the columns [k S,
// k S + len), len >= S + W - 1, W = m + floor(match m / |gap|), and starts
// from H = 0 at its left edge.  Its first W - 1 columns can underestimate
// H, and they also lie in segment k - 1, so each column is listed by one
// segment only (ops/cuda_score.py owned_columns): segment 0 lists [0, S +
// skip), segment k >= 1 lists [k S + skip, (k + 1) S + skip), skip >= W - 1
// (clipped to N).  There a cell is exact: an alignment of positive score
// spans at most W columns, so the best one ending at column j >= k S + W -
// 1 starts inside the segment.  The entry points refuse a plan that is
// not exact.
#include "bitonic.cuh"
#include "row_scan.cuh"

namespace {

using namespace swt;

// A launch's column segments: the reference's columns [k * stride,
// min(k * stride + length, n)) for k < count, segment k >= 1 listing from
// its column `skip` on (see the top of this file).
struct Segments {
  int stride, length, count, skip;
};

// Where the cells go: count[r] and the slots cells[r][0, capacity).
struct Listing {
  unsigned long long* count;
  int2* cells;
  long long capacity;
};

// (read block, first column, columns) of a block.  Read blocks vary
// fastest, so the blocks of one segment run together and share its bytes
// in L2.
struct Place {
  int rb, j0, span;
};

__device__ __forceinline__ Place place(int block, int read_blocks, int n, Segments sg) {
  const int j0 = (block / read_blocks) * sg.stride;
  return {block % read_blocks, j0, min(sg.length, n - j0)};
}

// The columns [lo, hi) of a segment that it lists, relative to its first.
struct Own {
  int lo, hi;
};

__device__ __forceinline__ Own owned(const Place& p, Segments sg) {
  return {p.j0 == 0 ? 0 : sg.skip, min(sg.stride + sg.skip, p.span)};
}

// Appends (i, j) to read `read`'s slots on the lanes where `hit`: one
// ballot, one atomicAdd from its first lane for all the warp's hits.  The
// whole warp calls it.
__device__ __forceinline__ void append(bool hit, int read, int i, int j, Listing out) {
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const int first = __ffs(mask) - 1;
  unsigned long long base = 0;
  if (lane == first) base = atomicAdd(out.count + read, (unsigned long long)__popc(mask));
  base = __shfl_sync(0xffffffffu, base, first);
  if (hit) {
    const unsigned long long slot = base + __popc(mask & ((1u << lane) - 1u));
    if (slot < (unsigned long long)out.capacity) out.cells[read * out.capacity + (long long)slot] = make_int2(i, j);
  }
}

// One warp's read in the int32 form: the read's codes in `code`, its
// carried column in `carry` (zeroed), `used` = 1 + this lane's last
// non-pad position, the reference's segment ref[0, span) whose columns
// [own.lo, own.hi) it lists as j0 + column.
__device__ __forceinline__ void list_read(const uint8_t* code, int* carry, int used, int m,
                                          const uint8_t* ref, int span, int match,
                                          int mismatch, int gap, int trim, int best,
                                          int read, int j0, Own own, Listing out) {
  const int lane = threadIdx.x & 31;
  used = trim ? __reduce_max_sync(0xffffffffu, used) : m;
  __syncwarp();

  const int ramp0 = gap * lane * kRowCols;  // gap * (first column of this lane in the tile)
  for (int base = 0; used > 0 && base < span; base += kRowTile) {
    const int jl = base + lane * kRowCols;
    int rf[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf[k] = jl + k < span ? ref[jl + k] : kRefPad;
      h[k] = 0;  // H[-1][j]
    }
    int above = 0;  // H[i-1][base-1]
    for (int i = 0; i < used; ++i) {
      // The code before the carried column: in the other order ptxas
      // gives max_cells_kernel 72 registers and a 4-byte spill, not 64.
      const int ch = code[i];
      const int west = carry[i];  // H[i][base-1]
      int top = -0x7fffffff - 1;  // the row's max over this lane's columns
      row_step(h, rf, ch, west, above, ramp0, match, mismatch, gap,
               [&](int, int v) { top = max(top, v); });
      if (__any_sync(0xffffffffu, top >= best)) {
#pragma unroll
        for (int k = 0; k < kRowCols; ++k)
          append(h[k] == best && jl + k >= own.lo && jl + k < own.hi, read, i, j0 + jl + k, out);
      }
      above = west;
      __syncwarp();  // every lane has read carry[i]
      if (lane == 31) carry[i] = h[kRowCols - 1];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
max_cells_kernel(const uint8_t* __restrict__ reads, int r, int m, int read_blocks,
                 const uint8_t* __restrict__ ref, int n, Segments sg,
                 const int32_t* __restrict__ best, int match, int mismatch, int gap,
                 int trim, Listing out) {
  __shared__ uint8_t read_s[kWarps][kMaxLanes];
  __shared__ int carry_s[kWarps][kMaxLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Place p = place(blockIdx.x, read_blocks, n, sg);
  const int read = p.rb * kWarps + warp;
  if (read >= r || best[read] <= 0) return;  // the whole warp
  const uint8_t* rd = reads + (long long)read * m;
  uint8_t* code = read_s[warp];
  int* carry = carry_s[warp];

  int used = 0;  // 1 + the last read position that is not pad
  for (int i = lane; i < m; i += 32) {
    const int v = rd[i];
    code[i] = (uint8_t)v;
    carry[i] = 0;  // H[i][-1]
    if (v != kReadPad) used = i + 1;
  }
  list_read(code, carry, used, m, ref + p.j0, p.span, match, mismatch, gap, trim, best[read],
            read, p.j0, owned(p, sg), out);
}

// The wide form, over reads read0 .. read0 + read_blocks * kWarps - 1 in
// each column segment: the codes stay in global memory and the carried
// column is carry + m x (its read of the part x segments + its segment).
__global__ void __launch_bounds__(kThreads)
max_cells_wide_kernel(const uint8_t* __restrict__ reads, int r, int m, int read0, int read_blocks,
                      const uint8_t* __restrict__ ref, int n, Segments sg,
                      const int32_t* __restrict__ best, int match, int mismatch, int gap,
                      int trim, Listing out, int32_t* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const Place p = place(blockIdx.x, read_blocks, n, sg);
  const int part_read = p.rb * kWarps + (threadIdx.x >> 5);
  const int read = read0 + part_read;
  if (read >= r || best[read] <= 0) return;
  const uint8_t* rd = reads + (long long)read * m;
  int* col = carry + (long long)m * ((long long)part_read * sg.count + blockIdx.x / read_blocks);
  int used = 0;
  for (int i = lane; i < m; i += 32) {
    col[i] = 0;
    if (rd[i] != kReadPad) used = i + 1;
  }
  list_read(rd, col, used, m, ref + p.j0, p.span, match, mismatch, gap, trim, best[read], read, p.j0,
            owned(p, sg), out);
}

// A best in one 16-bit half of the row max's compare: 0x7FFF where the
// read has none to list (no read, or best <= 0), which a row reaches only
// at 32,767, and then list_pair lists nothing for it.
__device__ __forceinline__ uint32_t best_half(int b) {
  return b > 0 && b <= 32767 ? (uint32_t)b : 0x7FFFu;
}

// Lists a row of a tile of a pair in the s16x2 forms, the pair's reads,
// bests and owned columns given.  The whole warp calls it.
__device__ __forceinline__ void list_tile(const uint32_t (&h)[kRowCols], int i, int jl, int read, int b_lo,
                                          int b_hi, Own own, int j0, Listing out) {
#pragma unroll
  for (int k = 0; k < kRowCols; ++k) {
    const bool own_k = jl + k >= own.lo && jl + k < own.hi;
    append(own_k && b_lo > 0 && (int)(h[k] & 0xFFFFu) == b_lo, read, i, j0 + jl + k, out);
    append(own_k && b_hi > 0 && (int)(h[k] >> 16) == b_hi, read + 1, i, j0 + jl + k, out);
  }
}

// Lists a row of a pair in the s16x2 form: the pair, its bests and the
// columns it owns again from the block index, so that none of them holds
// a register across the rows.  The whole warp calls it.
__device__ __forceinline__ void list_pair(const uint32_t (&h)[kRowCols], int i, int jl,
                                          const int32_t* best, int r, int read_blocks,
                                          int n, Segments sg, Listing out) {
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const Place q = place(block, read_blocks, n, sg);
  const Own own = owned(q, sg);
  const int read = q.rb * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  const int b_lo = best[read];
  const int b_hi = read + 1 < r ? best[read + 1] : 0;
  list_tile(h, i, jl, read, b_lo, b_hi, own, q.j0, out);
}

// The s16x2 form (see the top of this file): block b takes reads 8 rb ..
// 8 rb + 7 of its place, warp w the pair 2w, 2w + 1; shared memory holds
// each warp's m code pairs and m carried pairs.  k_sub = match - mismatch,
// mismatch2 and gap2 pair16 of the scheme.
__global__ void __launch_bounds__(kThreads)
max_cells_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m, int read_blocks,
                       const uint8_t* __restrict__ ref, int n, Segments sg,
                       const int32_t* __restrict__ best, int trim, uint32_t k_sub,
                       uint32_t mismatch2, uint32_t gap2, ScanGaps scan, Listing out) {
  extern __shared__ uint32_t row_s[];
  const int lane = threadIdx.x & 31;
  const Place p = place(blockIdx.x, read_blocks, n, sg);
  const int read = p.rb * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if (read >= r) return;  // the whole warp
  const bool has_hi = read + 1 < r;
  const int b_lo = best[read];
  const int b_hi = has_hi ? best[read + 1] : 0;
  if (b_lo <= 0 && b_hi <= 0) return;
  const uint32_t best2 = best_half(b_lo) | best_half(b_hi) << 16;
  uint32_t* code2 = row_s + 2 * m * (threadIdx.x >> 5);
  uint32_t* carry2 = code2 + m;
  const uint8_t* rd = reads + (long long)read * m;
  int used = 0;  // 1 + the last position of the pair that is not pad
  for (int i = lane; i < m; i += 32) {
    const int lo = rd[i];
    const int hi = has_hi ? rd[m + i] : kReadPad;
    code2[i] = code_half(lo) | code_half(hi) << 16;
    carry2[i] = 0;  // H[i][-1]
    if (lo != kReadPad || hi != kReadPad) used = i + 1;
  }
  used = trim ? __reduce_max_sync(0xffffffffu, used) : m;
  const uint8_t* seg = ref + p.j0;
  const int span = p.span;
  __syncwarp();

  for (int base = 0; used > 0 && base < span; base += kRowTile) {
    const int jl = base + lane * kRowCols;
    uint32_t rf2[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf2[k] = code_half(jl + k < span ? seg[jl + k] : kRefPad) * 0x00010001u;
      h[k] = 0;  // H[-1][j]
    }
    uint32_t above = 0;  // H[i-1][base-1]
    for (int i = 0; i < used; ++i) {
      const uint32_t west = carry2[i];  // H[i][base-1]
      row_step_s16x2(h, rf2, code2[i], west, above, k_sub, mismatch2, gap2, scan);
      // The row's max in each half, against the pair's bests.
      uint32_t top = __vimax3_s16x2(h[0], h[1], h[2]);
#pragma unroll
      for (int k = 3; k < kRowCols; k += 2) top = __vimax3_s16x2(top, h[k], h[k + 1 < kRowCols ? k + 1 : k]);
      if (__any_sync(0xffffffffu, __vcmpges2(top, best2) != 0u))
        list_pair(h, i, jl, best, r, read_blocks, n, sg, out);
      above = west;
      __syncwarp();  // every lane has read carry2[i]
      if (lane == 31) carry2[i] = h[kRowCols - 1];
    }
    __syncwarp();
  }
}

// The wide s16x2 form's pipeline of tiles: warp w runs kTileLag rows
// behind warp w - 1, and the block meets at a barrier every kTileSync
// rows, so a row's carried word, stored by warp w - 1 on that row, is
// loaded by warp w (a row ahead, on the row before) only after a barrier
// (kTileLag > kTileSync).
constexpr int kTileSync = 32;
constexpr int kTileLag = kTileSync + 1;

// The s16x2 form of reads wider than kMaxLanes (see the top of this
// file): a block takes one pair of reads (read0 + 2 rb, + 1, one in each
// 16-bit half of every register) and one column segment, and its warps
// take consecutive tiles of it at once: in round q warp w runs tile 4q +
// w, kTileLag rows behind warp w - 1.  Each tile's last column, H of
// both reads as one uint32 a row, goes through a global scratch (column w
// of the pair's 4 m words a segment, carry + 4 m x (pair of the part x
// segments + segment), stored by lane 0 of warp w) to the warp on the
// next tile (warp w + 1, or warp 0 in the next round), which loads it a
// row ahead with lane 0 alone, off the row step's chain (as K5's wide s16x2
// form).  A launch of one or two tied reads, as the windowed traceback
// makes, is a chain of dependent row steps, a row of each tile after the
// other: four tiles in flight cut it to a row of each round.  The row
// step, the row's max, the vote and the listing are
// max_cells_s16x2_kernel's.
__global__ void __launch_bounds__(kThreads)
max_cells_wide_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m, int read0, int pairs,
                            const uint8_t* __restrict__ ref, int n, Segments sg,
                            const int32_t* __restrict__ best, int trim, uint32_t k_sub,
                            uint32_t mismatch2, uint32_t gap2, ScanGaps scan, Listing out,
                            uint32_t* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Place p = place(blockIdx.x, pairs, n, sg);
  const int read = read0 + 2 * p.rb;
  if (read >= r) return;  // the whole block
  const bool has_hi = read + 1 < r;
  const int b_lo = best[read];
  const int b_hi = has_hi ? best[read + 1] : 0;
  if (b_lo <= 0 && b_hi <= 0) return;
  const uint32_t best2 = best_half(b_lo) | best_half(b_hi) << 16;
  const uint8_t* rd = reads + (long long)read * m;
  const uint8_t* rd_hi = has_hi ? rd + m : nullptr;
  const auto code2 = [&](int i) {
    return code_half(rd[i]) | code_half(rd_hi != nullptr ? rd_hi[i] : kReadPad) << 16;
  };
  uint32_t* cols = carry + (long long)m * kWarps * ((long long)p.rb * sg.count + blockIdx.x / pairs);
  uint32_t* mine = cols + (long long)m * warp;                                // this warp's tiles' last column
  const uint32_t* theirs = cols + (long long)m * ((warp + kWarps - 1) % kWarps);  // the tile to the left's
  int used = 0;  // 1 + the last position of the pair that is not pad (the same in every warp)
  for (int i = lane; i < m; i += 32)
    if (rd[i] != kReadPad || (has_hi && rd[m + i] != kReadPad)) used = i + 1;
  used = trim ? __reduce_max_sync(0xffffffffu, used) : m;
  const uint8_t* seg = ref + p.j0;
  const int span = p.span;
  const Own own = owned(p, sg);
  const int tiles = used > 0 ? (span + kRowTile - 1) / kRowTile : 0;
  const int lag = warp * kTileLag;
  const int steps = used + (kWarps - 1) * kTileLag;

  for (int t0 = 0; t0 < tiles; t0 += kWarps) {
    const int t = t0 + warp;
    const bool busy = t < tiles;
    const int jl = t * kRowTile + lane * kRowCols;
    uint32_t rf2[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf2[k] = code_half(busy && jl + k < span ? seg[jl + k] : kRefPad) * 0x00010001u;
      h[k] = 0;  // H[-1][j]
    }
    const bool carried = t > 0 && lane == 0;  // lane 0 reads the column (row_step_s16x2 uses its west only)
    uint32_t above = 0, ch = 0, west = 0;  // H[i-1][base-1]; row i's codes and H[i][base-1]
    for (int s = 0; s < steps; ++s) {
      const int i = s - lag;
      if (busy && i >= 0 && i < used) {  // the whole warp
        if (i == 0) {
          ch = code2(0);
          west = carried ? __ldcg(theirs) : 0u;
        }
        const int next = i + 1 < used ? i + 1 : i;
        const uint32_t ch_next = code2(next), west_next = carried ? __ldcg(theirs + next) : 0u;
        row_step_s16x2(h, rf2, ch, west, above, k_sub, mismatch2, gap2, scan);
        // The row's max in each half, against the pair's bests.
        uint32_t top = __vimax3_s16x2(h[0], h[1], h[2]);
#pragma unroll
        for (int k = 3; k < kRowCols; k += 2) top = __vimax3_s16x2(top, h[k], h[k + 1 < kRowCols ? k + 1 : k]);
        if (__any_sync(0xffffffffu, __vcmpges2(top, best2) != 0u))
          list_tile(h, i, jl, read, b_lo, b_hi, own, p.j0, out);
        above = west;
        const uint32_t last = __shfl_sync(0xffffffffu, h[kRowCols - 1], 31);
        if (lane == 0) __stcg(mine + i, last);  // through L2, where the next tile's warp loads it
        ch = ch_next;
        west = west_next;
      }
      if (s % kTileSync == kTileSync - 1) __syncthreads();
    }
    __syncthreads();  // the round's last columns before the next round's loads
  }
}

// The finish: keys of at most kFinishKeys slots are sorted in shared
// memory; more, in the wrapper's scratch (a power of two of keys a read).
constexpr int kFinishThreads = 256;
constexpr int kFinishKeys = 4096;

// One block per read: slots [0, min(count, capacity)) sorted by the
// row-major key (i << 32) | j and the rest -1; a read of best 0 gets
// count m n and the first cells of its plane, row-major, then -1.
__global__ void __launch_bounds__(kFinishThreads)
max_cells_finish_kernel(const int32_t* __restrict__ best, int m, int n,
                        unsigned long long* __restrict__ count, int2* __restrict__ cells,
                        long long capacity, unsigned long long* __restrict__ scratch, int scratch_keys) {
  __shared__ unsigned long long keys_s[kFinishKeys];
  const int read = blockIdx.x;
  int2* slots = cells + read * capacity;
  if (best[read] == 0) {
    const long long plane = (long long)m * n;
    for (long long p = threadIdx.x; p < capacity; p += blockDim.x)
      slots[p] = p < plane ? make_int2((int)(p / n), (int)(p % n)) : make_int2(-1, -1);
    if (threadIdx.x == 0) count[read] = (unsigned long long)plane;
    return;
  }
  const unsigned long long got = count[read];
  const int k = (int)(got < (unsigned long long)capacity ? got : capacity);
  int p = 1;
  while (p < k) p <<= 1;
  unsigned long long* keys = p <= kFinishKeys ? keys_s : scratch + (long long)read * scratch_keys;
  const unsigned long long* raw = reinterpret_cast<const unsigned long long*>(slots);
  for (int t = threadIdx.x; t < p; t += blockDim.x) {
    // An int2 (i, j) read as 64 bits holds j above i: swap the halves.
    const unsigned long long v = t < k ? raw[t] : ~0ull;
    keys[t] = t < k ? (v << 32 | v >> 32) : v;
  }
  __syncthreads();
  bitonic_sort(keys, p);
  for (long long t = threadIdx.x; t < capacity; t += blockDim.x)
    slots[t] = t < k ? make_int2((int)(keys[t] >> 32), (int)(keys[t] & 0xFFFFFFFFu)) : make_int2(-1, -1);
}

// The wrapper's split of the reference (stride, length, skip), checked:
// one segment when stride and length cover n; else segments under match
// > 0, mismatch <= 0 and gap < 0 that overlap by at least skip >= W - 1
// columns (see the top of this file; reads of any width).  count 0:
// refused.
Segments plan(int m, int n, int match, int mismatch, int gap, int stride, int length, int skip) {
  if (stride >= n && length >= n) return {n, n, 1, 0};
  if (stride <= 0 || match <= 0 || mismatch > 0 || gap >= 0) return {stride, length, 0, skip};
  const long long w = m + (long long)match * m / -(long long)gap;
  if (skip < w - 1 || length < (long long)stride + skip) return {stride, length, 0, skip};
  return {stride, length, (int)(((long long)n + stride - 1) / stride), skip};
}

}  // namespace

// K8 in the int32 forms: reads (r, m) uint8, ref (n,) uint8, best (r,)
// int32 on the card; count (r,) int64, zeroed, and cells (r, capacity, 2)
// int32 filled in by the launch.  carry: for reads wider than kMaxLanes
// (unused otherwise), carry_n int32, at least m per read of a part of
// part_reads reads per column segment.
extern "C" int swt_max_cells_row(const void* reads, int r, int m, const void* ref, int n,
                                 const void* best, int match, int mismatch, int gap,
                                 void* count, void* cells, long long capacity, void* carry,
                                 long long carry_n, int part_reads, int seg_stride, int seg_length,
                                 int seg_skip, int device, void* stream) {
  const bool wide = m > swt::kMaxLanes;
  const Segments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length, seg_skip);
  if (r <= 0 || m <= 0 || n <= 0 || capacity <= 0 || sg.count == 0 ||
      (wide && (carry == nullptr || part_reads <= 0 || carry_n < (long long)m * sg.count * part_reads)))
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = (wide ? (part_reads + swt::kWarps - 1) / swt::kWarps : read_blocks) * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int trim = mismatch < 0 && gap < 0;
  const Listing out{(unsigned long long*)count, (int2*)cells, capacity};
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      max_cells_wide_kernel<<<(unsigned)(part_blocks * sg.count), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)ref, n, sg, (const int32_t*)best,
          match, mismatch, gap, trim, out, (int32_t*)carry);
    });
  max_cells_kernel<<<(unsigned)blocks, swt::kThreads, 0, s>>>(
      (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)ref, n, sg,
      (const int32_t*)best, match, mismatch, gap, trim, out);
  return (int)cudaGetLastError();
}

// K8 in the s16x2 form; the wrapper takes it only where ops/cuda_score.py
// k5_form says so, and this entry refuses a scheme under which a value
// could leave int16 (match x m > 32,767: K5's bound, at any width), and
// reads wider than kMaxLanes (max_cells_wide_s16x2_kernel, a block a
// pair) without a carry of carry_n >= kWarps x m uint32 per pair of a
// part of part_reads reads (even) per column segment.  Its arguments are
// swt_max_cells_row's.
extern "C" int swt_max_cells_row_s16x2(const void* reads, int r, int m, const void* ref, int n,
                                       const void* best, int match, int mismatch, int gap,
                                       void* count, void* cells, long long capacity, void* carry,
                                       long long carry_n, int part_reads, int seg_stride, int seg_length,
                                       int seg_skip, int device, void* stream) {
  const bool wide = m > swt::kMaxLanes;
  const bool fits = match >= 0 && (long long)match * m <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0;
  const Segments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length, seg_skip);
  if (r <= 0 || m <= 0 || n <= 0 || capacity <= 0 || !fits || sg.count == 0 ||
      (wide && (carry == nullptr || part_reads <= 0 || part_reads % 2 ||
                carry_n < (long long)swt::kWarps * m * sg.count * (part_reads / 2))))
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = (wide ? part_reads / 2 : read_blocks) * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ScanGaps scan = swt::scan_gaps(gap);
  const int trim = mismatch < 0 && gap < 0;
  const Listing out{(unsigned long long*)count, (int2*)cells, capacity};
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t k_sub = (uint32_t)(match - mismatch);
  if (wide)
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      max_cells_wide_s16x2_kernel<<<(unsigned)(part_blocks * sg.count), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)ref, n, sg, (const int32_t*)best, trim,
          k_sub, swt::pair16(mismatch), swt::pair16(gap), scan, out, (uint32_t*)carry);
    }, 2);
  const size_t smem = sizeof(uint32_t) * 2 * m * swt::kWarps;
  max_cells_s16x2_kernel<<<(unsigned)blocks, swt::kThreads, smem, s>>>(
      (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)ref, n, sg,
      (const int32_t*)best, trim, k_sub, swt::pair16(mismatch),
      swt::pair16(gap), scan, out);
  return (int)cudaGetLastError();
}

// The finish of K8's listing (see the top of this file), after
// swt_max_cells_row or swt_max_cells_row_s16x2 on the same stream: best
// (r,) int32, count (r,) int64 and cells (r, capacity, 2) int32 as the
// listing left them; scratch: scratch_keys >= the power of two at or above
// capacity 64-bit keys per read where that is above kFinishKeys (else
// unused).
extern "C" int swt_max_cells_finish(const void* best, int r, int m, int n, void* count, void* cells,
                                    long long capacity, void* scratch, int scratch_keys, int device,
                                    void* stream) {
  long long p = 1;
  while (p < capacity) p <<= 1;
  if (r <= 0 || m < 0 || n < 0 || capacity <= 0 || capacity > (1LL << 30) ||
      (p > kFinishKeys && (scratch == nullptr || scratch_keys < p)))
    return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  max_cells_finish_kernel<<<(unsigned)r, kFinishThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)best, m, n, (unsigned long long*)count, (int2*)cells, capacity,
      (unsigned long long*)scratch, scratch_keys);
  return (int)cudaGetLastError();
}

// K5: best local score of every (read, reference) pair, by DP rows.
//
// Replaces the TPU kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_score_kernel
// (reached through pallas_score_grid, the kernel='row' form) with its
// contract, which is K4's: reads (R, M) uint8, READ_PAD-padded, against
// references (C, N) uint8, REF_PAD-padded, give out (R, C) int32.
//
// The row form: for each read position i a whole DP row, the gap chain
// along the row resolved by a scan.  With a linear gap,
//   A[j]    = max(0, H[i-1][j-1] + sub(i, j), H[i-1][j] + gap)
//   H[i][j] = max(A[j], H[i][j-1] + gap) = max_{k <= j}(A[k] - gap*k) + gap*j.
// The TPU kernel kept a whole row in VMEM and cut the prefix max to the
// window a score can reach (_propagation_window); a 131 kb row does not fit
// the 227 KB of shared memory a block has, so here the columns are cut into
// tiles of kRowTile, and all M rows of one tile run before the next tile.
// Between tiles each row carries one value, H[i][last column of the tile]:
// it is the W term of row i in the next tile and the NW term of its first
// column on row i + 1.  The scan is exact, so no window is needed.
//
// What bounds it on the H100: integer operations, as K4 (the inputs are
// read once per tile and the output is one int32 per pair); per cell it
// does K4's work plus a step of the scan.  Lane t of a warp holds kRowCols
// consecutive columns of the tile in registers; the row's scan runs within
// the lane, then in five shuffle steps across the warp, and the NW term of
// a lane's first column is one shuffle.  A row step needs no barrier: each
// warp's carried column and read codes live in its own shared memory.  The
// row step of both forms is in csrc/row_scan.cuh, which K8 shares.
// Two forms, chosen by the wrapper from the data alone (ops/cuda_score.py
// k5_form: k1_form's rule of K1 and K4 without its limit of 1,024
// positions, m the width of the reads tensor):
//
// - s16x2 (score_row_s16x2_kernel), reads of at most 1,024 positions whose
//   scores fit int16: warp w of a block takes reads 2w and 2w + 1, one in
//   each 16-bit half of every register, both against the block's
//   reference, so a block of four warps takes eight reads.  A column's
//   reference code sits in both halves (code_half, wavefront.cuh) and a
//   row's two read codes are one word in shared memory; the substitution
//   is eq_unit16x2 and one IMAD, the recurrence __viaddmax_s16x2_relu, as
//   in sweep_s16x2.  The gap chain does not use the int32 form's ramp:
//   A[k] - gap*k reaches 32,767 + |gap| x 511 within one tile and leaves
//   int16 under schemes the rule admits.  It is the decaying scan
//   H[j] = max(A[j], H[j-1] + gap): one __viaddmax_s16x2_relu a register
//   within the lane (lane 0 starting from the carried column), five
//   shuffle steps across the warp, step s adding gap x kRowCols x s
//   clamped at -32,768 (a value that low loses to the lane's own, which
//   is >= 0, whether clamped or not), then a second pass within the lane
//   from the value the lane to the left hands over.  Every add is of a
//   value >= 0 and a constant >= -32,768, so nothing wraps; the relu
//   keeps H >= 0 and H never exceeds match x m.  Each warp stops at the
//   longer read of its pair: a pad row (READ_PAD matches nothing) scores
//   no more than the rows above it under the rule's signs.
// - int32 (score_row_kernel, one warp per read, the prefix max of
//   A[k] - gap*k): every other read of at most 1,024 positions, and any
//   scheme with a positive mismatch or gap.  A read of more than 1,024
//   positions outside the rule (score_row_wide_kernel) reads its codes from global memory
//   and carries its column in a scratch row of m int32 per (read,
//   reference) pair, which the wrapper allocates: the loop is the same,
//   so reads of any length run.
// - s16x2 wide (score_row_wide_s16x2_kernel), reads of more than 1,024
//   positions whose scores fit int16 (ops/cuda_score.py k5_form: the
//   row form has no stripes, so the one-pass rule holds at any width):
//   the s16x2 form's pairs and row step, the pair's code word of a row
//   built from the reads and its carried column in a scratch of one
//   uint32 a row holding both halves (half the int32 form's), each row's
//   code and carried word loaded during the row before it, so that the
//   loads are off the row step's dependency chain.
//
// Trailing pad rows and columns are skipped when mismatch <= 0 and gap <=
// 0 (`trim`, as K4; always so in the s16x2 form), and in the int32 form
// columns of the last tile past the reference's end do not count.
//
// A launch with few blocks (a long reference against few reads) leaves
// most of the card's 132 SMs idle, so the one-pass forms can cut every
// reference into column segments, each segment a block of its own: the
// grid is (read block, reference, segment).  Segment k covers the columns
// [k S, k S + len), len >= S + W - 1, W = m + floor(match m / |gap|):
// with match > 0, mismatch <= 0 and gap < 0 an alignment of score > 0
// uses at most m read positions and fewer than match m / |gap| reference
// gap columns, so it spans at most W columns, and every run of W columns
// lies in one segment.  A segment's best lies between the best alignment
// inside it and the pair's best, so the max over segments is the pair's
// best: each block takes it with atomicMax into an output the wrapper
// zeroes (max is order-free, so the result is deterministic).  The
// wrapper plans the split (ops/cuda_score.py row_segments); the entry
// points refuse a plan that is not exact.
#include "row_scan.cuh"

namespace {

using namespace swt;

// A launch's column segments: reference c's columns [k * stride,
// min(k * stride + length, n)) for k < count.
struct Segments {
  int stride, length, count;
};

// (read block, reference, first column, columns) of a block.  Read blocks
// vary fastest, so the blocks of one segment run together and share its
// bytes in L2.
struct Place {
  int rb, c, j0, span;
};

__device__ __forceinline__ Place place(int block, int read_blocks, int n, Segments sg) {
  const int rest = block / read_blocks;
  const int j0 = (rest % sg.count) * sg.stride;
  return {block % read_blocks, rest / sg.count, j0, min(sg.length, n - j0)};
}

// Stores a pair's best, or, with more than one segment, the max of it and
// what the pair's other segments stored.
__device__ __forceinline__ void put(int32_t* o, int v, bool split) {
  if (split)
    atomicMax(o, v);
  else
    *o = v;
}

// ref[0, span)'s columns before its REF_PAD tail; the whole warp calls it.
__device__ __forceinline__ int ref_len(const uint8_t* ref, int span) {
  int len = 0;
  for (int j = span - 1 - (int)(threadIdx.x & 31); j >= 0; j -= 32) {
    if (ref[j] != kRefPad) {
      len = j + 1;
      break;
    }
  }
  return __reduce_max_sync(0xffffffffu, len);
}

// One warp's pair in the int32 form: the read's codes in `code`, its
// carried column in `carry` (zeroed), `used` = 1 + this lane's last non-pad
// position.
__device__ __forceinline__ void score_row_pair(const uint8_t* code, int* carry,
                                               int used, int m,
                                               const uint8_t* ref, int n,
                                               int match, int mismatch,
                                               int gap, int trim, bool split,
                                               int32_t* o) {
  const int lane = threadIdx.x & 31;
  used = __reduce_max_sync(0xffffffffu, used);
  int len = ref_len(ref, n);
  if (!trim) {
    used = m;
    len = n;
  }
  __syncwarp();

  int best = 0;
  const int ramp0 = gap * lane * kRowCols;  // gap * (first column of this lane in the tile)
  for (int base = 0; used > 0 && base < len; base += kRowTile) {
    const int j0 = base + lane * kRowCols;
    int rf[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf[k] = j0 + k < n ? ref[j0 + k] : kRefPad;
      h[k] = 0;  // H[-1][j]
    }
    const bool full = base + kRowTile <= len;
    int above = 0;  // H[i-1][base-1]
    for (int i = 0; i < used; ++i) {
      const int west = carry[i];  // H[i][base-1]
      row_step(h, rf, code[i], west, above, ramp0, match, mismatch, gap, [&](int k, int v) {
        if (full || j0 + k < len) best = max(best, v);
      });
      above = west;
      __syncwarp();  // every lane has read carry[i]
      if (lane == 31) carry[i] = h[kRowCols - 1];
    }
    __syncwarp();
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) put(o, best, split);
}

__global__ void __launch_bounds__(kThreads)
score_row_kernel(const uint8_t* __restrict__ reads, int r, int m,
                 int read_blocks, const uint8_t* __restrict__ refs,
                 int c_total, int n, Segments sg, int match, int mismatch,
                 int gap, int trim, int32_t* __restrict__ out) {
  __shared__ uint8_t read_s[kWarps][kMaxLanes];
  __shared__ int carry_s[kWarps][kMaxLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Place p = place(blockIdx.x, read_blocks, n, sg);
  const int read = p.rb * kWarps + warp;
  if (read >= r) return;  // the whole warp: warps never wait for each other
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
  score_row_pair(code, carry, used, m, refs + (long long)p.c * n + p.j0, p.span, match,
                 mismatch, gap, trim, sg.count > 1, out + (long long)read * c_total + p.c);
}

// The s16x2 form (see the top of this file).  Block b takes reads 8 rb ..
// 8 rb + 7 of its place, warp w the pair 2w, 2w + 1; shared memory holds
// each warp's m code pairs and m carried pairs.  k_sub = match - mismatch,
// mismatch2 and gap2 pair16 of the scheme, from the host, so that they sit
// in the constant bank, not registers.
__global__ void __launch_bounds__(kThreads)
score_row_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m,
                       int read_blocks, const uint8_t* __restrict__ refs,
                       int c_total, int n, Segments sg, uint32_t k_sub,
                       uint32_t mismatch2, uint32_t gap2, ScanGaps scan,
                       int32_t* __restrict__ out) {
  extern __shared__ uint32_t row_s[];
  const int lane = threadIdx.x & 31;
  const Place p = place(blockIdx.x, read_blocks, n, sg);
  const int read = p.rb * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if (read >= r) return;  // the whole warp
  uint32_t* code2 = row_s + 2 * m * (threadIdx.x >> 5);
  uint32_t* carry2 = code2 + m;
  const uint8_t* rd = reads + (long long)read * m;
  const bool has_hi = read + 1 < r;
  int used = 0;  // 1 + the last position of the pair that is not pad
  for (int i = lane; i < m; i += 32) {
    const int lo = rd[i];
    const int hi = has_hi ? rd[m + i] : kReadPad;
    code2[i] = code_half(lo) | code_half(hi) << 16;
    carry2[i] = 0;  // H[i][-1]
    if (lo != kReadPad || hi != kReadPad) used = i + 1;
  }
  used = __reduce_max_sync(0xffffffffu, used);
  const uint8_t* ref = refs + (long long)p.c * n + p.j0;
  const int len = ref_len(ref, p.span);
  __syncwarp();

  // The best of both halves over the rows; columns past len are pad and
  // score no more than a real cell to their left, so every cell counts.
  uint32_t best2 = 0;
  for (int base = 0; used > 0 && base < len; base += kRowTile) {
    const int j0 = base + lane * kRowCols;
    uint32_t rf2[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf2[k] = code_half(j0 + k < len ? ref[j0 + k] : kRefPad) * 0x00010001u;
      h[k] = 0;  // H[-1][j]
    }
    uint32_t above = 0;  // H[i-1][base-1]
    for (int i = 0; i < used; ++i) {
      const uint32_t west = carry2[i];  // H[i][base-1]
      row_step_s16x2(h, rf2, code2[i], west, above, k_sub, mismatch2, gap2, scan);
#pragma unroll
      for (int k = 0; k < kRowCols; k += 2) best2 = __vimax3_s16x2(best2, h[k], h[k + 1]);
      above = west;
      __syncwarp();  // every lane has read carry2[i]
      if (lane == 31) carry2[i] = h[kRowCols - 1];
    }
    __syncwarp();
  }
  const int b_lo = __reduce_max_sync(0xffffffffu, best2 & 0xFFFFu);
  const int b_hi = __reduce_max_sync(0xffffffffu, best2 >> 16);
  // The pair and the reference again, from the block index, so that none
  // of them holds a register across the rows.
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const Place q = place(block, read_blocks, n, sg);
  const int read2 = q.rb * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if (lane == 0) {
    put(out + (long long)read2 * c_total + q.c, b_lo, sg.count > 1);
    if (read2 + 1 < r) put(out + (long long)(read2 + 1) * c_total + q.c, b_hi, sg.count > 1);
  }
}

// K5 on reads wider than kMaxLanes, over reads read0 .. read0 +
// read_blocks * kWarps - 1: the codes stay in global memory and the
// carried column is carry + m * ((read - read0) * c_total + c).
__global__ void __launch_bounds__(kThreads)
score_row_wide_kernel(const uint8_t* __restrict__ reads, int r, int m,
                      int read0, int read_blocks,
                      const uint8_t* __restrict__ refs,
                      int c_total, int n, int match, int mismatch, int gap,
                      int trim, int32_t* __restrict__ out,
                      int32_t* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x / read_blocks;
  const int part_read = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int read = read0 + part_read;
  if (read >= r) return;
  const uint8_t* rd = reads + (long long)read * m;
  int* col = carry + (long long)m * ((long long)part_read * c_total + c);
  int used = 0;
  for (int i = lane; i < m; i += 32) {
    col[i] = 0;
    if (rd[i] != kReadPad) used = i + 1;
  }
  score_row_pair(rd, col, used, m, refs + (long long)c * n, n, match,
                 mismatch, gap, trim, false, out + (long long)read * c_total + c);
}

// The s16x2 form on reads wider than kMaxLanes, over the pairs of reads
// read0 .. read0 + 8 read_blocks - 1: warp w of block b takes the pair
// read0 + 8 (b % read_blocks) + 2w, + 1 against reference b / read_blocks,
// row_step_s16x2 as score_row_s16x2_kernel runs it, to the longer read of
// the pair.  Its carried column is carry + m ((read - read0) / 2 c_total +
// c), one uint32 a row; a tile's first row reads none (H[i][-1] = 0).  Each
// row's code word and carried word are loaded during the row before.  Lane
// 0 alone reads and writes the carried column (the row's last column,
// lane 31's, reaches it by a shuffle off the row step's chain), so one
// thread's program order puts each load of a row's word before its store
// of the same row, and no barrier is needed.
__global__ void __launch_bounds__(kThreads)
score_row_wide_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m, int read0,
                            int read_blocks, const uint8_t* __restrict__ refs, int c_total, int n,
                            uint32_t k_sub, uint32_t mismatch2, uint32_t gap2, ScanGaps scan,
                            int32_t* __restrict__ out, uint32_t* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x / read_blocks;
  const int part_pair = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int read = read0 + 2 * part_pair;
  if (read >= r) return;  // the whole warp
  const uint8_t* rd = reads + (long long)read * m;
  const bool has_hi = read + 1 < r;
  const uint8_t* rd_hi = has_hi ? rd + m : nullptr;  // (rd[m + i] left ptxas spilling rd + m)
  const auto code2 = [&](int i) {
    return code_half(rd[i]) | code_half(rd_hi != nullptr ? rd_hi[i] : kReadPad) << 16;
  };
  uint32_t* col = carry + (long long)m * ((long long)part_pair * c_total + c);
  int used = 0;  // 1 + the last position of the pair that is not pad
  for (int i = lane; i < m; i += 32)
    if (rd[i] != kReadPad || (has_hi && rd[m + i] != kReadPad)) used = i + 1;
  used = __reduce_max_sync(0xffffffffu, used);
  const uint8_t* ref = refs + (long long)c * n;
  const int len = ref_len(ref, n);

  uint32_t best2 = 0;
  for (int base = 0; used > 0 && base < len; base += kRowTile) {
    const int j0 = base + lane * kRowCols;
    uint32_t rf2[kRowCols], h[kRowCols];
#pragma unroll
    for (int k = 0; k < kRowCols; ++k) {
      rf2[k] = code_half(j0 + k < len ? ref[j0 + k] : kRefPad) * 0x00010001u;
      h[k] = 0;  // H[-1][j]
    }
    const bool carried = base > 0 && lane == 0;  // lane 0 reads the column (row_step_s16x2 uses its west only)
    uint32_t above = 0;  // H[i-1][base-1]
    uint32_t ch = code2(0), west = carried ? col[0] : 0u;  // row 0's
    for (int i = 0; i < used; ++i) {
      const int next = i + 1 < used ? i + 1 : i;
      const uint32_t ch_next = code2(next), west_next = carried ? col[next] : 0u;
      row_step_s16x2(h, rf2, ch, west, above, k_sub, mismatch2, gap2, scan);
#pragma unroll
      for (int k = 0; k < kRowCols; k += 2) best2 = __vimax3_s16x2(best2, h[k], h[k + 1]);
      above = west;
      const uint32_t last = __shfl_sync(0xffffffffu, h[kRowCols - 1], 31);
      if (lane == 0) col[i] = last;
      ch = ch_next;
      west = west_next;
    }
  }
  const int b_lo = __reduce_max_sync(0xffffffffu, best2 & 0xFFFFu);
  const int b_hi = __reduce_max_sync(0xffffffffu, best2 >> 16);
  if (lane == 0) {
    out[(long long)read * c_total + c] = b_lo;
    if (has_hi) out[(long long)(read + 1) * c_total + c] = b_hi;
  }
}

// The wrapper's split of a launch's references (stride, length), checked:
// one segment when both cover n; else segments of reads of at most
// kMaxLanes under match > 0, mismatch <= 0 and gap < 0 that overlap by at
// least W - 1 columns (see the top of this file).  count 0: refused.
Segments plan(int m, int n, int match, int mismatch, int gap, int stride, int length) {
  if (stride >= n && length >= n) return {n, n, 1};
  if (stride <= 0 || m > kMaxLanes || match <= 0 || mismatch > 0 || gap >= 0) return {stride, length, 0};
  const long long w = m + (long long)match * m / -(long long)gap;
  if (length < stride + w - 1) return {stride, length, 0};
  return {stride, length, (int)(((long long)n + stride - 1) / stride)};
}

}  // namespace

extern "C" int swt_score_grid_row(const void* reads, int r, int m,
                                  const void* refs, int c, int n, int match,
                                  int mismatch, int gap, void* out, void* carry,
                                  int part_reads, int seg_stride, int seg_length,
                                  int device, void* stream) {
  const bool wide = m > swt::kMaxLanes;
  const Segments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length);
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || (wide && carry == nullptr) || sg.count == 0)
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = read_blocks * c * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int trim = mismatch <= 0 && gap <= 0;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      score_row_wide_kernel<<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)refs, c,
          n, match, mismatch, gap, trim, (int32_t*)out, (int32_t*)carry);
    });
  score_row_kernel<<<(unsigned)blocks, swt::kThreads, 0, s>>>(
      (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)refs, c,
      n, sg, match, mismatch, gap, trim, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The s16x2 form; the wrapper takes it only where ops/cuda_score.py
// k5_form says so, and this entry refuses a scheme under which a value
// could leave int16, and reads wider than kMaxLanes (score_row_wide_s16x2_kernel)
// without `carry`, the pairs' carried columns for part_reads reads (a
// multiple of 2 * kWarps) at a time.  Its arguments are
// swt_score_grid_row's.
extern "C" int swt_score_grid_row_s16x2(const void* reads, int r, int m,
                                        const void* refs, int c, int n,
                                        int match, int mismatch, int gap,
                                        void* out, void* carry, int part_reads, int seg_stride,
                                        int seg_length, int device, void* stream) {
  const bool wide = m > swt::kMaxLanes;
  const bool fits = match >= 0 && (long long)match * m <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0;
  const Segments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length);
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || (wide && carry == nullptr) || !fits || sg.count == 0)
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = read_blocks * c * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ScanGaps scan = swt::scan_gaps(gap);
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      score_row_wide_s16x2_kernel<<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)refs, c, n,
          (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap), scan, (int32_t*)out,
          (uint32_t*)carry);
    }, 2 * swt::kWarps);
  const size_t smem = sizeof(uint32_t) * 2 * m * swt::kWarps;
  score_row_s16x2_kernel<<<(unsigned)blocks, swt::kThreads, smem, s>>>(
      (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)refs, c, n, sg,
      (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap), scan,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

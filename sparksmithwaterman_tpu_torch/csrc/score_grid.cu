// K4: best local score of every (read, reference) pair, unpacked reads.
//
// Replaces the TPU kernels
//   sparksmithwaterman_tpu/ops/pallas_score.py:_diag_kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_chunked_kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_diag_kernel_carry
// with their shared contract: reads (R, M) uint8, READ_PAD-padded, against
// references (C, N) uint8, REF_PAD-padded, give out (R, C) int32, each entry
// the best local-alignment score of that pair.  The TPU split the work into
// a whole-window form, a streamed form for references past 8 kb and a form
// that carried the substitution column in registers, all for VMEM; here the
// reference always streams through the 4 KB shared ring of wavefront.cuh, so
// one kernel takes every length and every window mode.
//
// What bounds it on the H100: like K1, register-resident integer work
// with no memory traffic in the inner loop, and an output of one int32 per
// pair, so it is bound by operations.  L lanes per thread (lane i = read
// position i), neighbour lanes through one warp shuffle per diagonal; the
// block's reads share one reference.
//
// Two forms, chosen by the wrapper from the data alone (ops/cuda_score.py
// k1k4_form, the rule K1 uses, with m the width of the reads tensor):
//
// - s16x2 (score_grid_s16x2_kernel), reads of at most 1,024 positions
//   whose scores fit int16: warp w of a block takes reads 2w and 2w + 1,
//   one in each 16-bit half of every register, two cells per instruction
//   (wavefront.cuh sweep_s16x2), so a block of four warps takes eight
//   reads against one reference.  What it does about the bound: the int32
//   form spends about ten integer instructions a cell on a pipe that
//   takes a warp instruction every other clock; this form spends four and
//   a half integer instructions per register of two cells and puts the
//   substitution on the FP16 and FMA pipes (see wavefront.cuh).  An
//   unpacked read is one segment, so only lane 0 drops its shifted terms.
//   An odd last read pairs with an all-pad read, which scores 0 and is
//   not stored.  Reads wider than 1,024 positions take this form where
//   match x m <= 32,767 and mismatch and gap < 0
//   (score_grid_wide_s16x2_kernel, below): the pair in stripes of 256
//   lanes (wavefront.cuh kStripe16L), its carry rows one uint32_t a
//   column holding both reads' halves.
// - int32 (score_grid_kernel, one warp per read, one cell per
//   instruction): every other read of at most 1,024 positions, and any
//   scheme with a positive mismatch or gap; every other wider read runs
//   in stripes (score_grid_wide_kernel, below).
//
// Trailing pad is not swept when mismatch <= 0 and gap <= 0 (`trim`,
// always so in the s16x2 form): the block then runs m' + n' - 1
// diagonals, n' the reference's length before its REF_PAD tail and m'
// the longest of its reads before their READ_PAD tails (sweep_s16x2
// rounds that up to its unroll).  A pad code matches nothing, so a cell
// in a trailing pad row or column is at most the largest of its
// neighbours; it never exceeds the pair's best over real cells, and no
// real cell depends on it.  With a positive mismatch or gap that no
// longer holds, and the block runs all m + n - 1 diagonals, as the TPU
// kernels do.  Pad lanes of a short read in a wide group still cost a
// lane each (the batch backend encodes each read group at its longest
// read).  The output is written as (R, C): the per-reference sum over
// reads reduces over its rows.  A read group wider than 1,024 positions
// runs in stripes of 512 (score_grid_wide_kernel, wavefront.cuh), only
// as far as the block's longest read: a stripe of trailing READ_PAD lanes
// is not swept.  It needs `trim` (the wrapper takes such reads only when
// mismatch < 0 and gap < 0).
#include "wavefront.cuh"

namespace {

using namespace swt;

// Max of v over the block; every thread must call it.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = max(out, scratch[w]);
  __syncthreads();  // scratch is free again for the next call
  return out;
}

// (len, used) of K4's block: the reference's length before its REF_PAD
// tail and 1 + the last non-pad position of the block's reads, or (n, m)
// when !trim.  `used` comes in as this thread's own.  Every thread must
// call it.
__device__ __forceinline__ int2 trimmed(const uint8_t* ref, int n, int m,
                                        int used, int trim, int* scratch) {
  // Each thread walks its residue class down from the end and stops at
  // its first real byte.
  int len = 0;
  for (int j = n - 1 - (int)threadIdx.x; j >= 0; j -= kThreads) {
    if (ref[j] != kRefPad) {
      len = j + 1;
      break;
    }
  }
  len = block_max(len, scratch);
  used = block_max(used, scratch);
  return trim ? make_int2(len, used) : make_int2(n, m);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
score_grid_kernel(const uint8_t* __restrict__ reads, int r, int m,
                  int read_blocks, const uint8_t* __restrict__ refs,
                  int c_total, int n, int match, int mismatch, int gap,
                  int trim, int32_t* __restrict__ out) {
  __shared__ uint8_t ring[kRing];
  __shared__ int scratch[kWarps];
  const int c = blockIdx.x / read_blocks;
  const int read = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const bool live = read < r;
  const uint8_t* ref = refs + (long long)c * n;

  int rd[L];
  int used = 0;  // 1 + the last read position of this thread that is not pad
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    rd[k] = (live && i < m) ? reads[(long long)read * m + i] : kReadPad;
    if (rd[k] != kReadPad) used = i + 1;
  }
  const int2 lu = trimmed(ref, n, m, used, trim, scratch);
  const int len = lu.x;
  used = lu.y;
  const int nd = (len > 0 && used > 0) ? used + len - 1 : 0;

  int best[L];
#pragma unroll
  for (int k = 0; k < L; ++k) best[k] = 0;
  sweep<L>(rd, first == 0 ? 1u : 0u, nd, ref, len, match, mismatch, gap, ring,
           [&](int k, int, int h) { best[k] = max(best[k], h); });
  int b = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) b = max(b, best[k]);
  b = __reduce_max_sync(0xffffffffu, b);
  if (live && first == 0) out[(long long)read * c_total + c] = b;
}

// The s16x2 form (see the top of this file): block b of reference c takes
// reads 8 (b % read_blocks) .. + 7, warp w the pair 2w, 2w + 1.  k_sub =
// match - mismatch, mismatch2 and gap2 pair16 of the scheme, all from the
// host, so that they sit in the constant bank, not registers.
template <int L>
__global__ void __launch_bounds__(kThreads)
score_grid_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m,
                        int read_blocks, const uint8_t* __restrict__ refs,
                        int c_total, int n, uint32_t k_sub, uint32_t mismatch2,
                        uint32_t gap2, int32_t* __restrict__ out) {
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  __shared__ int scratch[kWarps];
  const int c = blockIdx.x / read_blocks;
  const int read = (blockIdx.x % read_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  const int first = (threadIdx.x & 31) * L;
  const uint8_t* ref = refs + (long long)c * n;

  uint32_t rd2[L], keep2[L], best2[L];
  int used = 0;  // 1 + the last position of this thread's two reads that is not pad
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = first + k;
    const int lo = (read < r && i < m) ? reads[(long long)read * m + i] : kReadPad;
    const int hi = (read + 1 < r && i < m) ? reads[(long long)(read + 1) * m + i] : kReadPad;
    if (lo != kReadPad || hi != kReadPad) used = i + 1;
    rd2[k] = code_half(lo) | code_half(hi) << 16;
    keep2[k] = i == 0 ? 0u : 0xFFFFFFFFu;
    best2[k] = 0;
  }
  const int2 lu = trimmed(ref, n, m, used, 1, scratch);
  const int nd = (lu.x > 0 && lu.y > 0) ? lu.y + lu.x - 1 : 0;
  // The best of a register over pairs of diagonals (the unroll is even),
  // as in K1: on the second of each pair, one 3-input max of best, the
  // first's value and the second's.
  sweep_s16x2<L>(rd2, keep2, nd, ref, lu.x, k_sub, mismatch2, gap2, ring,
                 [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
                   if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
                 });

  uint32_t b2 = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) b2 = __vmaxs2(b2, best2[k]);
  const int b_lo = __reduce_max_sync(0xffffffffu, b2 & 0xFFFFu);
  const int b_hi = __reduce_max_sync(0xffffffffu, b2 >> 16);
  // The pair and the reference again, from the block index, so that none
  // of them holds a register across the sweep.
  int block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  const int c2 = block / read_blocks;
  const int read2 = (block % read_blocks) * (2 * kWarps) + 2 * (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0) {
    if (read2 < r) out[(long long)read2 * c_total + c2] = b_lo;
    if (read2 + 1 < r) out[(long long)(read2 + 1) * c_total + c2] = b_hi;
  }
}

// K4 on reads wider than kMaxLanes, in stripes of 32 * L lanes, over
// reads read0 .. read0 + read_blocks * kWarps - 1; carry + 2 * n *
// ((read - read0) * c_total + c) holds the pair's two carry rows.  The
// max over stripes is the pair's best.
template <int L>
__global__ void __launch_bounds__(kThreads)
score_grid_wide_kernel(const uint8_t* __restrict__ reads, int r, int m,
                       int read0, int read_blocks,
                       const uint8_t* __restrict__ refs,
                       int c_total, int n, int match, int mismatch, int gap,
                       int trim, int32_t* __restrict__ out,
                       int32_t* __restrict__ carry) {
  constexpr int W = 32 * L;
  __shared__ uint8_t ring[kRing];
  __shared__ int scratch[kWarps];
  const int c = blockIdx.x / read_blocks;
  const int part_read = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int read = read0 + part_read;
  const int first = (threadIdx.x & 31) * L;
  const bool live = read < r;
  const uint8_t* ref = refs + (long long)c * n;
  const uint8_t* rp = reads + (long long)read * m;
  int32_t* buf = carry + 2LL * n * ((long long)part_read * c_total + c);

  int used = 0;  // 1 + this warp's last read position that is not pad
  for (int i = threadIdx.x & 31; live && i < m; i += 32)
    if (rp[i] != kReadPad) used = i + 1;
  const int2 lu = trimmed(ref, n, m, used, trim, scratch);
  const int len = lu.x;
  used = lu.y;

  int b = 0;
  for (int s = 0; len > 0 && s * W < used; ++s) {
    const int i0 = s * W;
    int rd[L], best[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      rd[k] = (live && i < m) ? rp[i] : kReadPad;
      best[k] = 0;
    }
    __syncwarp();  // the stripe above's carry row is visible
    StripeEdge<L> edge(buf + ((s + 1) & 1) * n, s > 0 ? len : 0, buf + (s & 1) * n, 0);
    sweep<L>(rd, (s == 0 && first == 0) ? 1u : 0u, min(W, used - i0) + len - 1, ref, len,
             match, mismatch, gap, ring,
             [&](int k, int, int h) { best[k] = max(best[k], h); },
             [](int, int(&)[L]) {}, edge);
#pragma unroll
    for (int k = 0; k < L; ++k) b = max(b, best[k]);
  }
  b = __reduce_max_sync(0xffffffffu, b);
  if (live && first == 0) out[(long long)read * c_total + c] = b;
}

// The s16x2 form on reads wider than kMaxLanes: warp w of a block takes
// the pair of reads read0 + 8 (b % read_blocks) + 2w, + 1, one in each
// 16-bit half, in stripes of 32 * L lanes through sweep_s16x2 with a
// StripeEdge16x2, only as far as the block's longest read (trimmed).
// An unpacked read is one segment, so only the first stripe's lane 0
// starts one.  carry + 2 * n * (((read - read0) / 2) * c_total + c) holds
// the pair's two carry rows of uint32_t.  The max over stripes of each
// half is its read's best.
template <int L>
__global__ void __launch_bounds__(kThreads)
score_grid_wide_s16x2_kernel(const uint8_t* __restrict__ reads, int r, int m,
                             int read0, int read_blocks,
                             const uint8_t* __restrict__ refs, int c_total,
                             int n, uint32_t k_sub, uint32_t mismatch2,
                             uint32_t gap2, int32_t* __restrict__ out,
                             uint32_t* __restrict__ carry) {
  constexpr int W = 32 * L;
  __shared__ uint32_t ring[kRing + kS16x2RingPad];
  __shared__ int scratch[kWarps];
  const int c = blockIdx.x / read_blocks;
  const int part_pair = (blockIdx.x % read_blocks) * kWarps + (threadIdx.x >> 5);
  const int read = read0 + 2 * part_pair;
  const int first = (threadIdx.x & 31) * L;
  const uint8_t* ref = refs + (long long)c * n;
  const uint8_t* rp = reads + (long long)read * m;
  uint32_t* buf = carry + 2LL * n * ((long long)part_pair * c_total + c);

  int used = 0;  // 1 + this warp's last position of its two reads that is not pad
  for (int i = threadIdx.x & 31; i < m; i += 32) {
    const int lo = read < r ? rp[i] : kReadPad;
    const int hi = read + 1 < r ? rp[m + i] : kReadPad;
    if (lo != kReadPad || hi != kReadPad) used = i + 1;
  }
  const int2 lu = trimmed(ref, n, m, used, 1, scratch);
  const int len = lu.x;
  used = lu.y;

  uint32_t b2 = 0;
  for (int s = 0; len > 0 && s * W < used; ++s) {
    const int i0 = s * W;
    uint32_t rd2[L], keep2[L], best2[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = i0 + first + k;
      const int lo = (read < r && i < m) ? rp[i] : kReadPad;
      const int hi = (read + 1 < r && i < m) ? rp[m + i] : kReadPad;
      rd2[k] = code_half(lo) | code_half(hi) << 16;
      keep2[k] = i == 0 ? 0u : 0xFFFFFFFFu;
      best2[k] = 0;
    }
    // Every warp is done with the ring of the stripe above (sweep_s16x2
    // writes its top before its first barrier), and this pair's carry row
    // from that stripe is visible.
    __syncthreads();
    StripeEdge16x2<L> edge(buf + ((s + 1) & 1) * n, s > 0 ? len : 0, buf + (s & 1) * n, len);
    sweep_s16x2<L>(rd2, keep2, min(W, used - i0) + len - 1, ref, len, k_sub, mismatch2, gap2, ring,
                   [&](int k, bool odd, uint32_t h, uint32_t h_prev, int) {
                     if (odd) best2[k] = __vimax3_s16x2(best2[k], h_prev, h);
                   },
                   [](int) {}, edge);
#pragma unroll
    for (int k = 0; k < L; ++k) b2 = __vmaxs2(b2, best2[k]);
  }
  const int b_lo = __reduce_max_sync(0xffffffffu, b2 & 0xFFFFu);
  const int b_hi = __reduce_max_sync(0xffffffffu, b2 >> 16);
  if ((threadIdx.x & 31) == 0) {
    if (read < r) out[(long long)read * c_total + c] = b_lo;
    if (read + 1 < r) out[(long long)(read + 1) * c_total + c] = b_hi;
  }
}

}  // namespace

extern "C" int swt_score_grid_diag(const void* reads, int r, int m,
                                   const void* refs, int c, int n, int match,
                                   int mismatch, int gap, void* out,
                                   void* carry, int part_reads, int device,
                                   void* stream) {
  const int L = swt::pick_lanes(m);
  const int trim = mismatch <= 0 && gap <= 0;
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || (L == 0 && (carry == nullptr || !trim)))
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = read_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      score_grid_wide_kernel<swt::kStripeL><<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)refs, c,
          n, match, mismatch, gap, trim, (int32_t*)out, (int32_t*)carry);
    });
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                       \
  case l:                                                                   \
    score_grid_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(        \
        (const uint8_t*)reads, r, m, (int)read_blocks,                      \
        (const uint8_t*)refs, c, n, match, mismatch, gap, trim,             \
        (int32_t*)out);                                                     \
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
// could leave int16 (match x m <= 32767, m the reads' width), and reads
// wider than kMaxLanes (in stripes, score_grid_wide_s16x2_kernel) unless
// mismatch < 0 and gap < 0 (the stripes' rule) and `carry` holds the
// pairs' carry rows, part_reads a multiple of 2 * kWarps.  Its arguments
// are swt_score_grid_diag's.
extern "C" int swt_score_grid_diag_s16x2(const void* reads, int r, int m,
                                         const void* refs, int c, int n,
                                         int match, int mismatch, int gap,
                                         void* out, void* carry, int part_reads,
                                         int device, void* stream) {
  const int L = swt::pick_lanes(m);
  const bool fits = match >= 0 && (long long)match * m <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0 &&
                    (L > 0 || (mismatch < 0 && gap < 0 && carry != nullptr));
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || !fits) return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = read_blocks * c;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 0) {
    return swt::launch_parts(r, part_reads, [&](int read0, int part_blocks) {
      score_grid_wide_s16x2_kernel<swt::kStripe16L><<<(unsigned)(part_blocks * c), swt::kThreads, 0, s>>>(
          (const uint8_t*)reads, r, m, read0, part_blocks, (const uint8_t*)refs, c, n,
          (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap), (int32_t*)out,
          (uint32_t*)carry);
    }, 2 * swt::kWarps);
  }
  switch (L) {
#define SWT_LAUNCH(l)                                                            \
  case l:                                                                        \
    score_grid_s16x2_kernel<l><<<(unsigned)blocks, swt::kThreads, 0, s>>>(       \
        (const uint8_t*)reads, r, m, (int)read_blocks, (const uint8_t*)refs, c, \
        n, (uint32_t)(match - mismatch), swt::pair16(mismatch), swt::pair16(gap), \
        (int32_t*)out);                                                          \
    break;
    SWT_FOR_EACH_L(SWT_LAUNCH)
#undef SWT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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
//   runs in stripes of 512 (wavefront.cuh); a stripe's local diagonal d is
//   the global d + 512 s.
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
// the TPU kernel, which also sweeps padding diagonals.
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
        const uint32_t hm = h & own;
        const uint32_t t = __vsub2(hm, best2[k]);
        const uint32_t gt = __vimin_s16x2_relu(t, 0x00010001u);
        const uint32_t ge = __viaddmin_s16x2_relu(t, 0x00010001u, 0x00010001u);
        best2[k] = __vmaxs2(best2[k], hm);
        count2[k] = __viaddmax_s16x2(count2[k], gt * 0x8001u + ge, gt);
        bestd2[k] = __viaddmax_s16x2(dlow, gt * 0x7FFFu, bestd2[k]);
      },
      on_tile);
  flush_state<L>(best2, bestd2, count2, r, m, c_total, read_blocks, sg.count, ebase + j0, merge, out);
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
// segment when stride and length cover n; else, for reads of at most
// kMaxLanes under match > 0, mismatch <= 0 and gap < 0, segments with
// offset >= W + m - 2 and length >= stride + offset, count of them (see
// the top of this file).  count 0: refused.
ArgSegments plan(int m, int n, int match, int mismatch, int gap, int stride, int length, int offset,
                 int count) {
  if (stride >= n && length >= n) return {n, n, 0, count == 1 ? 1 : 0};
  const ArgSegments no{stride, length, offset, 0};
  if (stride <= 0 || m > kMaxLanes || match <= 0 || mismatch > 0 || gap >= 0) return no;
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
// k1_form says so, and this entry refuses a scheme under which a value
// could leave int16, reads wider than kMaxLanes and a plan that is not
// exact.  Its arguments are swt_argmax_lane's, with the plan of
// ops/cuda_score.py argmax_segments in place of the carry; with
// seg_count > 1, best, bestd and count are the (seg_count, r, c, m)
// partials, which swt_argmax_merge reduces.
extern "C" int swt_argmax_lane_s16x2(const void* reads, int r, int m, const void* refs,
                                     long long ref_stride, int c, int n, int match, int mismatch,
                                     int gap, void* best, void* bestd, void* count, int seg_stride,
                                     int seg_length, int seg_offset, int seg_count, int device,
                                     void* stream) {
  const int L = swt::pick_lanes(m);
  const bool fits = match >= 0 && (long long)match * m <= 32767 && mismatch >= -32768 &&
                    mismatch <= 0 && gap >= -32768 && gap <= 0;
  const ArgSegments sg = plan(m, n, match, mismatch, gap, seg_stride, seg_length, seg_offset, seg_count);
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || L == 0 || !fits || sg.count == 0)
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + 2 * swt::kWarps - 1) / (2 * swt::kWarps);
  const long long blocks = read_blocks * c * sg.count;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
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

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
//
// What bounds it on the H100: like K1 it is register-resident integer
// work (about fourteen instructions per cell with the argmax update) and
// writes its three outputs once.  One warp per read, L lanes per thread,
// neighbour lanes through one warp shuffle per diagonal; the reference is
// streamed through the 4 KB shared-memory ring shared by the block's four
// reads, so a 131 kb reference costs no more shared memory than a 2 kb one.
// Each pair runs exactly m + n - 1 diagonals.  A read of more than 1,024
// positions runs in stripes of 512 (argmax_wide_kernel, wavefront.cuh);
// a stripe's local diagonal d is the global d + 512 s.
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

// K5: best local score of every (read, reference) pair, by DP rows.
//
// Replaces the TPU kernel
//   sparksmithwaterman_tpu/ops/pallas_score.py:_score_kernel
// (reached through pallas_score_grid, the kernel='row' form) with its
// contract, which is K4's: reads (R, M) uint8, READ_PAD-padded, against
// references (C, N) uint8, REF_PAD-padded, give out (R, C) int32.
//
// The row form: for each read position i a whole DP row, the gap chain
// along the row resolved by a prefix max.  With a linear gap,
//   A[j]    = max(0, H[i-1][j-1] + sub(i, j), H[i-1][j] + gap)
//   H[i][j] = max(A[j], H[i][j-1] + gap) = max_{k <= j}(A[k] - gap*k) + gap*j.
// The TPU kernel kept a whole row in VMEM and cut the prefix max to the
// window a score can reach (_propagation_window); a 131 kb row does not fit
// the 227 KB of shared memory a block has, so here the columns are cut into
// tiles of kRowTile, and all M rows of one tile run before the next tile.
// Between tiles each row carries one value, H[i][last column of the tile]:
// it is the W term of row i in the next tile and the NW term of its first
// column on row i + 1.  The prefix max is exact, so no window is needed.
//
// What bounds it on the H100: integer operations, as K4 (the inputs are
// read once per tile and the output is one int32 per pair); per cell it
// does K4's work plus a step of the prefix max.  One warp per read, the
// block's four reads sharing one reference: lane t holds kRowCols
// consecutive columns of the tile in registers, the row's prefix max is a
// scan within the lane and then a five-step shuffle scan across the warp,
// and the NW term of a lane's first column is one shuffle.  A row step
// needs no barrier: each warp's carried column and read live in its own
// shared memory.  Trailing pad rows and columns are skipped under the same
// rule as K4's (`trim`: mismatch <= 0 and gap <= 0), and columns of the
// last tile past the reference's end do not count.  A read of more than
// 1,024 positions (score_row_wide_kernel) reads its codes from global
// memory and carries its column in a scratch row of m int32 per (read,
// reference) pair, which the wrapper allocates: the loop is the same, so
// reads of any length run.
#include "wavefront.cuh"

namespace {

using namespace swt;

constexpr int kRowCols = 16;             // columns per lane
constexpr int kRowTile = 32 * kRowCols;  // columns per warp per tile

// One warp's pair: the read's codes in `code`, its carried column in
// `carry` (zeroed), `used` = 1 + this lane's last non-pad position.
__device__ __forceinline__ void score_row_pair(const uint8_t* code, int* carry,
                                               int used, int m,
                                               const uint8_t* ref, int n,
                                               int match, int mismatch,
                                               int gap, int trim, int32_t* o) {
  const int lane = threadIdx.x & 31;
  int len = 0;  // the reference's length before its REF_PAD tail
  for (int j = n - 1 - lane; j >= 0; j -= 32) {
    if (ref[j] != kRefPad) {
      len = j + 1;
      break;
    }
  }
  used = __reduce_max_sync(0xffffffffu, used);
  len = __reduce_max_sync(0xffffffffu, len);
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
      const int ch = code[i];
      const int west = carry[i];  // H[i][base-1]
      int left = __shfl_up_sync(0xffffffffu, h[kRowCols - 1], 1);
      if (lane == 0) left = above;
      // A[j] of this lane's columns, right to left so h[k-1] is still row i-1.
#pragma unroll
      for (int k = kRowCols - 1; k >= 0; --k) {
        const int nw = k > 0 ? h[k - 1] : left;
        const int sub = ch == rf[k] ? match : mismatch;
        h[k] = max(max(nw + sub, h[k] + gap), 0);
      }
      // Prefix max of A[k] - gap*k within the lane, then across the warp.
      int run = h[0] - ramp0;
      h[0] = run;
#pragma unroll
      for (int k = 1; k < kRowCols; ++k) {
        run = max(run, h[k] - ramp0 - gap * k);
        h[k] = run;
      }
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, run, s);
        if (lane >= s) run = max(run, v);
      }
      int before = __shfl_up_sync(0xffffffffu, run, 1);
      // Column base-1 enters the scan as H[i][base-1] - gap*(-1).
      before = lane > 0 ? max(before, west + gap) : west + gap;
#pragma unroll
      for (int k = 0; k < kRowCols; ++k) {
        h[k] = max(h[k], before) + ramp0 + gap * k;
        if (full || j0 + k < len) best = max(best, h[k]);
      }
      above = west;
      __syncwarp();  // every lane has read carry[i]
      if (lane == 31) carry[i] = h[kRowCols - 1];
    }
    __syncwarp();
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) *o = best;
}

__global__ void __launch_bounds__(kThreads)
score_row_kernel(const uint8_t* __restrict__ reads, int r, int m,
                 int read_blocks, const uint8_t* __restrict__ refs,
                 int c_total, int n, int match, int mismatch, int gap,
                 int trim, int32_t* __restrict__ out) {
  __shared__ uint8_t read_s[kWarps][kMaxLanes];
  __shared__ int carry_s[kWarps][kMaxLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x / read_blocks;
  const int read = (blockIdx.x % read_blocks) * kWarps + warp;
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
  score_row_pair(code, carry, used, m, refs + (long long)c * n, n, match,
                 mismatch, gap, trim, out + (long long)read * c_total + c);
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
                 mismatch, gap, trim, out + (long long)read * c_total + c);
}

}  // namespace

extern "C" int swt_score_grid_row(const void* reads, int r, int m,
                                  const void* refs, int c, int n, int match,
                                  int mismatch, int gap, void* out, void* carry,
                                  int part_reads, int device, void* stream) {
  const bool wide = m > swt::kMaxLanes;
  if (r <= 0 || c <= 0 || m <= 0 || n <= 0 || (wide && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long read_blocks = (r + swt::kWarps - 1) / swt::kWarps;
  const long long blocks = read_blocks * c;
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
      n, match, mismatch, gap, trim, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The row step of the row form, shared by K5 (csrc/score_row.cu) and K8
// (csrc/max_cells.cu): one DP row of the kRowCols columns a lane holds,
// the gap chain along the row resolved by a scan within the lane and
// across the warp.  With a linear gap,
//   A[j]    = max(0, H[i-1][j-1] + sub(i, j), H[i-1][j] + gap)
//   H[i][j] = max(A[j], H[i][j-1] + gap) = max_{k <= j}(A[k] - gap*k) + gap*j.
// A warp holds a tile of kRowTile columns, lane t the columns [t kRowCols,
// (t + 1) kRowCols) of it; between tiles each row carries one value,
// H[i][base - 1] (`west`), and the row before it H[i-1][base - 1]
// (`above`).  The whole warp calls each step.  csrc/score_row.cu explains
// the two forms.
#pragma once

#include "wavefront.cuh"

namespace swt {

constexpr int kRowCols = 16;             // columns per lane
constexpr int kRowTile = 32 * kRowCols;  // columns per warp per tile

// The s16x2 scan's constants across the warp: g[q] = pair16(max(gap *
// kRowCols * 2^q, -32768)), the decay over 2^q lanes.
struct ScanGaps {
  uint32_t g[5];
};

// The int32 form: h holds row i-1 of the lane's columns and on return row
// i; rf the columns' codes, ch the read's code at row i, ramp0 = gap *
// lane * kRowCols.  `cell(k, v)` sees each new H[i][column k] as it is
// made (the caller's best or row max).
template <class Cell>
__device__ __forceinline__ void row_step(int (&h)[kRowCols], const int (&rf)[kRowCols], int ch,
                                         int west, int above, int ramp0, int match, int mismatch,
                                         int gap, Cell cell) {
  const int lane = threadIdx.x & 31;
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
    cell(k, h[k]);
  }
}

// The s16x2 form: two reads, one in each 16-bit half; rf2 the columns'
// codes in both halves (code_half), ch the pair's codes at row i, k_sub =
// match - mismatch, mismatch2 and gap2 pair16 of the scheme.
__device__ __forceinline__ void row_step_s16x2(uint32_t (&h)[kRowCols], const uint32_t (&rf2)[kRowCols],
                                               uint32_t ch, uint32_t west, uint32_t above,
                                               uint32_t k_sub, uint32_t mismatch2, uint32_t gap2,
                                               const ScanGaps& scan) {
  const int lane = threadIdx.x & 31;
  uint32_t left = __shfl_up_sync(0xffffffffu, h[kRowCols - 1], 1);
  if (lane == 0) left = above;
  // A[j] of this lane's columns, right to left so h[k-1] is still row i-1.
#pragma unroll
  for (int k = kRowCols - 1; k >= 0; --k) {
    const uint32_t nw = k > 0 ? h[k - 1] : left;
    const uint32_t v = eq_unit16x2(ch, rf2[k]) * k_sub + nw;
    h[k] = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(h[k], gap2));
  }
  // The decaying scan: H at this lane's last column from its own
  // columns (lane 0's from column base-1 on), then across the warp.
  uint32_t run = __viaddmax_s16x2_relu(lane == 0 ? west : 0u, gap2, h[0]);
#pragma unroll
  for (int k = 1; k < kRowCols; ++k) run = __viaddmax_s16x2_relu(run, gap2, h[k]);
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, run, 1 << q);
    if (lane >= (1 << q)) run = __viaddmax_s16x2_relu(v, scan.g[q], run);
  }
  // H at the column left of this lane's first, then the lane's columns.
  uint32_t in = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) in = west;
  h[0] = __viaddmax_s16x2_relu(in, gap2, h[0]);
#pragma unroll
  for (int k = 1; k < kRowCols; ++k) h[k] = __viaddmax_s16x2_relu(h[k - 1], gap2, h[k]);
}

// The s16x2 scan's constants for a gap (see ScanGaps).
inline ScanGaps scan_gaps(int gap) {
  ScanGaps scan;
  for (int q = 0; q < 5; ++q) {
    const long long g = (long long)gap * kRowCols * (1 << q);
    scan.g[q] = pair16(g < -32768 ? -32768 : (int)g);
  }
  return scan;
}

}  // namespace swt

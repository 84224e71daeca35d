// K9: the traceback's fill, H and the direction codes of every DP cell.
//
// Replaces the lax code of the traceback's fill,
//   sparksmithwaterman_tpu/ops/recurrence.py:fill_pairs
// (a lax.scan of row updates stacking H and the codes as (M, B, N)), whose
// torch counterpart ops/recurrence.py fill_pairs is its plain version.
// Reads (B, M) uint8, READ_PAD-padded, each against its reference (B, N)
// uint8 or one reference (1, N) for all (ref_stride 0), give dirs (B, M, N)
// int8, 0 none, 1 align, 2 insertion, 3 deletion, 0 wherever H = 0, and,
// where the caller asks, H (B, M, N) int32 for DP rows 1..M.  Ties: `serial`
// a > ins > d; `distributed` d > ins > a.  Every cell is computed as the
// plain version computes it, pad rows and REF_PAD columns included.
//
// What bounds it on the H100: bytes.  The function writes one byte of code
// per cell (five with H) and does about 1.5 instructions of recurrence per
// cell, so at 3.35 TB/s against 33.45 T instructions/s the stores decide.
// The plain version's cost is none of these: about 12 torch launches per DP
// row, each a pass over a (B, N) row in device memory.  Here each pair's
// fill is one warp's loop over its rows, in registers; a row's codes leave
// as one 16-byte store per lane (64 more bytes per lane for H), the warp's
// 32 lanes writing 512 contiguous bytes.
//
// The row step is K5's int32 row form (csrc/row_scan.cuh), copied here
// with the codes added so that K5's and K8's instructions stay as they
// are: lane t of the warp holds the columns [base + 16t, base + 16t + 16)
// of a tile of kTileCols columns, all M rows of a tile run before the
// next, and between tiles each row carries H[i][base - 1] (`west`) through
// a scratch column of M int32 per pair, which the wrapper allocates when
// N > kTileCols; the row before carries H[i-1][base - 1] (`above`).  With
// a linear gap,
//   A[j]    = max(0, a, ins),  a = H[i-1][j-1] + sub(i, j),  ins = H[i-1][j] + gap
//   H[i][j] = max(A[j], H[i][j-1] + gap) = max_{k <= j}(A[k] - gap*k) + gap*j,
// the prefix max within the lane, then five shuffle steps across the warp,
// `west` entering as column base - 1.  The codes need a and ins of the row
// before and d = H[i][j-1] + gap of this one: a lane keeps row i-1 of its
// columns (`hp`) through the step, and d of its first column is one
// shuffle (lane 0: `west`; at column 0 of the matrix west = 0, the edge).
// Rows are the loop, so reads of any length need no stripes; offsets into
// the planes are 64-bit.
#include "wavefront.cuh"

namespace {

using namespace swt;

constexpr int kCols = 16;              // columns per lane
constexpr int kTileCols = 32 * kCols;  // columns per warp per tile

// The code of one cell from its three candidates and H (the tie order of
// the plain version: the first candidate equal to H wins).
template <bool kSerial>
__device__ __forceinline__ uint32_t code_of(int a, int ins, int d, int h) {
  uint32_t c;
  if (kSerial)
    c = a == h ? 1u : ins == h ? 2u : d == h ? 3u : 0u;
  else
    c = d == h ? 3u : ins == h ? 2u : a == h ? 1u : 0u;
  return h > 0 ? c : 0u;
}

// One DP row of the lane's kCols columns: h holds row i-1 of them and on
// return row i; code the row's codes, four bytes a word.  rf the columns'
// codes, ch the read's code at row i, ramp0 = gap * 16 * lane.  The whole
// warp calls it.
template <bool kSerial>
__device__ __forceinline__ void fill_row(int (&h)[kCols], const int (&rf)[kCols], int ch, int west,
                                         int above, int ramp0, int match, int mismatch, int gap,
                                         uint32_t (&code)[kCols / 4]) {
  const int lane = threadIdx.x & 31;
  int hp[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) hp[k] = h[k];
  int left = __shfl_up_sync(0xffffffffu, hp[kCols - 1], 1);  // H[i-1] left of this lane
  if (lane == 0) left = above;
  // Prefix max of A[k] - gap*k within the lane, then across the warp.
  int run = -0x7fffffff - 1;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int nw = k > 0 ? hp[k - 1] : left;
    const int sub = ch == rf[k] ? match : mismatch;
    run = max(run, max(max(nw + sub, hp[k] + gap), 0) - ramp0 - gap * k);
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
  for (int k = 0; k < kCols; ++k) h[k] = max(h[k], before) + ramp0 + gap * k;
  int d_left = __shfl_up_sync(0xffffffffu, h[kCols - 1], 1);  // H[i] left of this lane
  if (lane == 0) d_left = west;
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) code[q] = 0u;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int nw = k > 0 ? hp[k - 1] : left;
    const int sub = ch == rf[k] ? match : mismatch;
    const int d = (k > 0 ? h[k - 1] : d_left) + gap;
    code[k / 4] |= code_of<kSerial>(nw + sub, hp[k] + gap, d, h[k]) << (8 * (k % 4));
  }
}

// The lane's columns [jl, jl + kCols) of one row, those below n: one
// 16-byte store where the row allows it.
__device__ __forceinline__ void store_codes(int8_t* row, int jl, int n, const uint32_t (&code)[kCols / 4]) {
  int8_t* p = row + jl;
  if (jl + kCols <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(code[0], code[1], code[2], code[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (jl + k < n) p[k] = (int8_t)(code[k / 4] >> (8 * (k % 4)));
}

__device__ __forceinline__ void store_h(int32_t* row, int jl, int n, const int (&h)[kCols]) {
  int32_t* p = row + jl;
  if (jl + kCols <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q)
      reinterpret_cast<int4*>(p)[q] = make_int4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (jl + k < n) p[k] = h[k];
}

// One warp per pair: pair = 4 x block + warp.  carry: m int32 per pair,
// the column base - 1 of the tile before (unused when n <= kTileCols);
// h_out nullptr when the caller does not want H.
template <bool kSerial>
__global__ void __launch_bounds__(kThreads)
fill_dirs_kernel(const uint8_t* __restrict__ reads, int b, int m, const uint8_t* __restrict__ refs,
                 long long ref_stride, int n, int match, int mismatch, int gap,
                 int8_t* __restrict__ dirs, int32_t* __restrict__ h_out, int32_t* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= b) return;  // the whole warp
  const uint8_t* rd = reads + (long long)pair * m;
  const uint8_t* ref = refs + (long long)pair * ref_stride;
  int32_t* col = carry + (long long)pair * m;
  const long long plane = (long long)pair * m * n;
  const int ramp0 = gap * lane * kCols;  // gap * (first column of this lane in the tile)

  for (int base = 0; base < n; base += kTileCols) {
    const int jl = base + lane * kCols;
    const bool carried = base + kTileCols < n;  // the next tile reads this one's last column
    int rf[kCols], h[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      rf[k] = jl + k < n ? ref[jl + k] : kRefPad;
      h[k] = 0;  // H[-1][j]
    }
    int above = 0;  // H[i-1][base-1]
    int ch = rd[0];
    int west = base > 0 ? col[0] : 0;  // H[i][base-1]
    for (int i = 0; i < m; ++i) {
      // The next row's code and carried value, loaded a row ahead.
      const int ch_next = i + 1 < m ? rd[i + 1] : 0;
      const int west_next = base > 0 && i + 1 < m ? col[i + 1] : 0;
      uint32_t code[kCols / 4];
      fill_row<kSerial>(h, rf, ch, west, above, ramp0, match, mismatch, gap, code);
      const long long row = plane + (long long)i * n;
      store_codes(dirs + row, jl, n, code);
      if (h_out != nullptr) store_h(h_out + row, jl, n, h);
      above = west;
      if (carried) {
        __syncwarp();  // every lane has read col[i]
        if (lane == 31) col[i] = h[kCols - 1];
      }
      ch = ch_next;
      west = west_next;
    }
    __syncwarp();  // the carried column is written before the next tile reads it
  }
}

}  // namespace

// K9: reads (b, m) uint8, refs uint8 with row r of pair r at refs + r *
// ref_stride (0: one reference for all), n columns; dirs (b, m, n) int8 and,
// unless h is null, H (b, m, n) int32, written by the launch; serial != 0
// takes the serial tie order, else the distributed one.  carry: b * m int32
// of scratch, needed when n > 512.
extern "C" int swt_fill_dirs(const void* reads, int b, int m, const void* refs, long long ref_stride, int n,
                             int match, int mismatch, int gap, int serial, void* dirs, void* h, void* carry,
                             int device, void* stream) {
  if (b <= 0 || m <= 0 || n <= 0 || ref_stride < 0 || dirs == nullptr || (n > kTileCols && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((b + swt::kWarps - 1) / swt::kWarps);
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (serial)
    fill_dirs_kernel<true><<<blocks, swt::kThreads, 0, s>>>(
        (const uint8_t*)reads, b, m, (const uint8_t*)refs, ref_stride, n, match, mismatch, gap, (int8_t*)dirs,
        (int32_t*)h, (int32_t*)carry);
  else
    fill_dirs_kernel<false><<<blocks, swt::kThreads, 0, s>>>(
        (const uint8_t*)reads, b, m, (const uint8_t*)refs, ref_stride, n, match, mismatch, gap, (int8_t*)dirs,
        (int32_t*)h, (int32_t*)carry);
  return (int)cudaGetLastError();
}

// Shared anti-diagonal Smith-Waterman sweep for the Hopper kernels.
//
// One warp owns one DP "row block": 32 threads x L lanes = up to 32*L read
// positions (lanes), thread t holding lanes t*L .. t*L+L-1 in registers.
// Diagonal d visits cell (i, j = d - i) of every lane i at once:
//
//   D_d[i] = max(0, D_{d-2}[i-1] + sub(read[i], ref[d-i]),
//                   max(D_{d-1}[i-1], D_{d-1}[i]) + gap)
//
// (the recurrence of sparksmithwaterman_tpu/ops/pallas_score.py:_make_step).
// The two shifted terms come from lane i-1: within a thread they are the
// neighbour register, across threads one __shfl_up_sync per diagonal, so
// the sweep needs no block-wide barrier per diagonal.  Lanes whose bit is
// set in `zmask` take zero for both shifted terms (row 0 boundary at a
// segment start).
//
// Reference characters are staged through shared memory in tiles of kTile
// bytes, double-buffered in a ring of two tiles: lane i at diagonal d reads
// ref[d - i], at most 32*L - 1 <= kTile characters behind the newest, so
// the ring always holds the lookback.  Each thread keeps a register window
// of the L characters its lanes see and shifts it by one per diagonal.
// A ref of any length streams through the same 4 KB, which is why one
// kernel serves both the short-ref varlen path and the long-ref path of
// the TPU package.
//
// Rows wider than kMaxLanes (32 x 32) are swept in stripes of kStripe
// lanes (L = kStripeL), top to bottom, one after another by the same
// warp: the striped Smith-Waterman row carry.  Between stripes one carry
// row in global memory holds, for every reference column j, H of the
// stripe's last lane; the next stripe's lane 0 reads it as its N term
// (StripeEdge), and its NW term is the previous column's, which the sweep
// already keeps.  Each stripe runs its lanes + len - 1 diagonals, so the
// cells swept equal one wide sweep's, and no length limit remains.  The
// carry covers the columns [0, len) only: a cell right of the reference
// (REF_PAD) reads 0 from the stripe above, where one wide sweep would
// carry a decayed value.  With mismatch < 0 and gap < 0 such a cell is
// below a real cell of the same read, so no lane a caller reads changes;
// the wrappers take wide rows only under that rule.  The carry rows live
// in a scratch buffer the wrapper sizes for part_rows rows; a launch of
// more rows runs as several launches of part_rows rows (launch_parts),
// each kernel indexing the scratch by its row less the part's first.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace swt {

constexpr int kWarps = 4;              // row blocks (warps) per thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 2048;            // ref bytes staged per tile
constexpr int kRing = 2 * kTile;       // current tile + lookback tile
constexpr int kRefPad = 1;             // io.fasta.REF_PAD
constexpr int kReadPad = 0;            // io.fasta.READ_PAD
constexpr int kStartBit = 256;         // ops/packing.START_BIT
constexpr int kMaxLanes = 32 * 32;     // widest row swept in one pass (L = 32)
constexpr int kStripeL = 16;           // lanes per thread of a stripe
constexpr int kStripe = 32 * kStripeL; // lanes per stripe of a wider row

// Lanes per thread: the smallest instantiated L with 32 * L >= m, 0 if
// none (the row is then swept in stripes).
inline int pick_lanes(int m) {
  const int ls[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32};
  for (int l : ls)
    if (32 * l >= m) return l;
  return 0;
}

// Makes `device` current for one launch and gives the caller's device
// back at scope exit, so a launch on another card of a mesh leaves
// PyTorch's current device as it was.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Launches a striped kernel over rows [0, rows) in parts of part_rows rows
// (a multiple of kWarps) one after another on one stream, so that the
// parts reuse one carry scratch sized for part_rows rows:
// launch(row0, part_blocks) for each part, part_blocks = its blocks of
// kWarps rows.  Returns the first launch error, or cudaSuccess.
template <class Launch>
inline int launch_parts(int rows, int part_rows, Launch&& launch) {
  if (part_rows <= 0 || part_rows % kWarps) return (int)cudaErrorInvalidValue;
  for (int row0 = 0; row0 < rows; row0 += part_rows) {
    const int part = rows - row0 < part_rows ? rows - row0 : part_rows;
    launch(row0, (part + kWarps - 1) / kWarps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

#define SWT_FOR_EACH_L(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(12) X(16) X(24) X(32)

__device__ __forceinline__ void stage_tile(uint8_t* ring, const uint8_t* ref,
                                           int base, int len) {
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
    const int j = base + t;
    ring[j & (kRing - 1)] = j < len ? ref[j] : (uint8_t)kRefPad;
  }
}

__device__ __forceinline__ int ref_at(const uint8_t* ring, int j, int len) {
  return (j >= 0 && j < len) ? ring[j & (kRing - 1)] : kRefPad;
}

// The rows above a row's lane 0, for a row swept in one pass: none.  The
// sweep keeps thread 0's own shuffle value as its N term (zmask zeroes it:
// lane 0 always starts a segment) and starts its NW term at 0.
struct NoEdge {
  __device__ __forceinline__ int corner() const { return 0; }
  __device__ __forceinline__ int up(int, int up0) { return up0; }
  __device__ __forceinline__ void put(int, int) {}
};

// The carry between two stripes of a wide row (see the top of this file).
// `in` holds H of the stripe above's last lane at columns [0, cols_in)
// (cols_in = 0 for the first stripe); `out` receives this stripe's last
// lane, column j on diagonal j + W - 1, from thread 31.  Thread 0 takes
// in[d] as lane 0's N term on diagonal d; each thread prefetches one
// column of the next 32, which a shuffle hands to thread 0, so the load
// is 32 diagonals ahead of its use.  `corner` is H(row above lane 0,
// column -1): the left boundary column (0 but in K3).  The caller puts a
// __syncwarp() between stripes and alternates two carry rows, so a
// stripe never reads the row it writes.
template <int L>
struct StripeEdge {
  static constexpr int kW = 32 * L;
  const int* in;
  int cols_in;
  int* out;
  int corner_h;
  int pf = 0, next;
  __device__ __forceinline__ StripeEdge(const int* in_, int cols_in_, int* out_, int corner_)
      : in(in_), cols_in(cols_in_), out(out_), corner_h(corner_) {
    const int lane = threadIdx.x & 31;
    next = lane < cols_in ? in[lane] : 0;
  }
  __device__ __forceinline__ int corner() const { return corner_h; }
  __device__ __forceinline__ int up(int d, int up0) {
    const int lane = threadIdx.x & 31;
    if ((d & 31) == 0) {
      pf = next;
      const int j = d + 32 + lane;
      next = j < cols_in ? in[j] : 0;
    }
    const int v = __shfl_sync(0xffffffffu, pf, d & 31);
    return lane == 0 ? v : up0;
  }
  __device__ __forceinline__ void put(int d, int h) {
    if ((threadIdx.x & 31) == 31 && d >= kW - 1) out[d - (kW - 1)] = h;
  }
};

// Run diagonals 0 .. nd-1 for this warp's lanes and call on_cell(k, d, h)
// for every lane k of this thread on every diagonal.  Before diagonal d,
// enter(d, H) may overwrite this thread's D_{d-1} values H[0..L-1]; the
// lane to the right reads them as its N term on diagonal d (the band
// kernel injects its left boundary column there).  `edge` supplies lane
// 0's N and NW terms and takes the last lane's values (NoEdge, or
// StripeEdge for a stripe of a wide row).  Every thread of the block must
// call it with the same nd (it synchronises at tile edges).
template <int L, class OnCell, class Enter, class Edge>
__device__ __forceinline__ void sweep(const int (&rd)[L], uint32_t zmask,
                                      int nd, const uint8_t* ref, int len,
                                      int match, int mismatch, int gap,
                                      uint8_t* ring, OnCell&& on_cell,
                                      Enter&& enter, Edge& edge) {
  const int first = (threadIdx.x & 31) * L;
  int H[L], U[L], rw[L];  // D_{d-1}[i], D_{d-2}[i-1] (zeroed), ref[d-i]
#pragma unroll
  for (int k = 0; k < L; ++k) {
    H[k] = 0;
    U[k] = 0;
    rw[k] = kRefPad;
  }
  if (first == 0 && !(zmask & 1u)) U[0] = edge.corner();
  for (int base = 0; base < nd; base += kTile) {
    __syncthreads();  // everyone is done reading the slot being replaced
    stage_tile(ring, ref, base, len);
    __syncthreads();
    const int dend = min(nd, base + kTile);
    for (int d = base; d < dend; ++d) {
      enter(d, H);
#pragma unroll
      for (int k = L - 1; k > 0; --k) rw[k] = rw[k - 1];
      rw[0] = ref_at(ring, d - first, len);
      const int up0 = edge.up(d, __shfl_up_sync(0xffffffffu, H[L - 1], 1));
#pragma unroll
      for (int k = L - 1; k >= 0; --k) {
        int up = k > 0 ? H[k - 1] : up0;
        if ((zmask >> k) & 1u) up = 0;
        const int sub = rd[k] == rw[k] ? match : mismatch;
        const int h = max(max(U[k] + sub, max(up, H[k]) + gap), 0);
        U[k] = up;
        H[k] = h;
        on_cell(k, d, h);
      }
      edge.put(d, H[L - 1]);
    }
  }
}

template <int L, class OnCell, class Enter>
__device__ __forceinline__ void sweep(const int (&rd)[L], uint32_t zmask,
                                      int nd, const uint8_t* ref, int len,
                                      int match, int mismatch, int gap,
                                      uint8_t* ring, OnCell&& on_cell,
                                      Enter&& enter) {
  NoEdge edge;
  sweep<L>(rd, zmask, nd, ref, len, match, mismatch, gap, ring, on_cell,
           enter, edge);
}

template <int L, class OnCell>
__device__ __forceinline__ void sweep(const int (&rd)[L], uint32_t zmask,
                                      int nd, const uint8_t* ref, int len,
                                      int match, int mismatch, int gap,
                                      uint8_t* ring, OnCell&& on_cell) {
  sweep<L>(rd, zmask, nd, ref, len, match, mismatch, gap, ring, on_cell,
           [](int, int(&)[L]) {});
}

// Segmented suffix max of one row's lanes, then the store: best[] over
// the warp's 32 * L lanes, segments beginning at the set bits of `start`
// (lane-local), the lanes < m stored to o when `live`.  Every lane of the
// warp must call it.  (K1's one-pass kernel keeps its own copy: through
// this function ptxas spills registers there at L = 8.)
template <int L>
__device__ __forceinline__ void store_suffix_max(int (&best)[L],
                                                 uint32_t start, int m,
                                                 bool live, int32_t* o) {
  const int lane = threadIdx.x & 31;
  const int first = lane * L;
  // First within the thread, right to left, restarting at segment
  // starts; `open` marks lanes whose segment runs past this thread's
  // last lane.
  int run = 0;
  bool is_open = true;
  uint32_t open = 0;
#pragma unroll
  for (int k = L - 1; k >= 0; --k) {
    if (k < L - 1 && ((start >> (k + 1)) & 1u)) {
      run = 0;
      is_open = false;
    }
    run = max(run, best[k]);
    best[k] = run;
    if (is_open) open |= 1u << k;
  }
  // Then the carry from the threads to the right: walk right while the
  // segment continues.  head = max over this thread's first local segment;
  // flag bit 0 = lane `first` starts a segment, bit 1 = a segment starts
  // inside this thread after lane `first`.
  const int head = best[0];
  const int flags = (start & 1u) | ((open & 1u) ? 0 : 2);
  int carry = 0;
  bool stop = false;
  for (int u = 1; u < 32; ++u) {
    const int hv = __shfl_sync(0xffffffffu, head, u);
    const int fl = __shfl_sync(0xffffffffu, flags, u);
    if (u > lane && !stop) {
      if (fl & 1) {
        stop = true;
      } else {
        carry = max(carry, hv);
        if (fl & 2) stop = true;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (first + k < m) o[first + k] = ((open >> k) & 1u) ? max(best[k], carry) : best[k];
  }
}

// The packed kernels' suffix max across the stripes of a wide row, after
// every stripe stored its own (store_suffix_max): right to left, the
// final value at stripe s+1's first lane flows into stripe s's last
// segment when that lane does not start a read.  `row` is the packed row
// (m lanes), o its output; the whole warp calls it.
template <int L>
__device__ __forceinline__ void stripe_suffix_max(const int32_t* row, int m,
                                                  int32_t* o) {
  constexpr int W = 32 * L;
  const int first = (threadIdx.x & 31) * L;
  __syncwarp();  // every lane's stores are visible to the warp
  for (int s = (m + W - 1) / W - 2; s >= 0; --s) {
    const int next = (s + 1) * W;
    const int tail = row[next] < kStartBit ? o[next] : 0;
    if (tail > 0) {
      int last = 0;  // the last segment start in stripe s
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = s * W + first + k;
        if (row[i] >= kStartBit) last = i;
      }
      last = __reduce_max_sync(0xffffffffu, last);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int i = s * W + first + k;
        if (i >= last) o[i] = max(o[i], tail);
      }
    }
    __syncwarp();
  }
}

}  // namespace swt

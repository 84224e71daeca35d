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
constexpr int kMaxLanes = 32 * 32;     // widest supported row (L = 32)

// Lanes per thread: the smallest instantiated L with 32 * L >= m, 0 if none.
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

// Run diagonals 0 .. nd-1 for this warp's lanes and call on_cell(k, d, h)
// for every lane k of this thread on every diagonal.  Before diagonal d,
// enter(d, H) may overwrite this thread's D_{d-1} values H[0..L-1]; the
// lane to the right reads them as its N term on diagonal d (the band
// kernel injects its left boundary column there).  Every thread of the
// block must call it with the same nd (it synchronises at tile edges).
template <int L, class OnCell, class Enter>
__device__ __forceinline__ void sweep(const int (&rd)[L], uint32_t zmask,
                                      int nd, const uint8_t* ref, int len,
                                      int match, int mismatch, int gap,
                                      uint8_t* ring, OnCell&& on_cell,
                                      Enter&& enter) {
  const int first = (threadIdx.x & 31) * L;
  int H[L], U[L], rw[L];  // D_{d-1}[i], D_{d-2}[i-1] (zeroed), ref[d-i]
#pragma unroll
  for (int k = 0; k < L; ++k) {
    H[k] = 0;
    U[k] = 0;
    rw[k] = kRefPad;
  }
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
      const int up0 = __shfl_up_sync(0xffffffffu, H[L - 1], 1);
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
    }
  }
}

template <int L, class OnCell>
__device__ __forceinline__ void sweep(const int (&rd)[L], uint32_t zmask,
                                      int nd, const uint8_t* ref, int len,
                                      int match, int mismatch, int gap,
                                      uint8_t* ring, OnCell&& on_cell) {
  sweep<L>(rd, zmask, nd, ref, len, match, mismatch, gap, ring, on_cell,
           [](int, int(&)[L]) {});
}

}  // namespace swt

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
// The 16-bit form (sweep_s16x2 with a StripeEdge16x2) sweeps a pair of
// rows in stripes of 32 * kStripe16L lanes the same way, its carry rows
// one uint32_t a column holding both rows' halves, so a pair's scratch is
// one int32 row's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// Lanes per thread of a stripe in the s16x2 form (stripes of 256 lanes):
// at L <= 8 sweep_s16x2 rotates its window by name, at L = 16 it shifts
// bytes, and K1's and K4's striped kernels ran about 1.3x slower at 16
// (one H100, utils/kernel_times.py; PERF.md, the striped kernels).
constexpr int kStripe16L = 8;

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
// (a multiple of block_rows, the rows of one block: kWarps in the int32
// form, 2 * kWarps in the s16x2 form's pairs) one after another on one
// stream, so that the parts reuse one carry scratch sized for part_rows
// rows: launch(row0, part_blocks) for each part, part_blocks = its blocks
// of block_rows rows.  Returns the first launch error, or cudaSuccess.
template <class Launch>
inline int launch_parts(int rows, int part_rows, Launch&& launch, int block_rows = kWarps) {
  if (part_rows <= 0 || part_rows % block_rows) return (int)cudaErrorInvalidValue;
  for (int row0 = 0; row0 < rows; row0 += part_rows) {
    const int part = rows - row0 < part_rows ? rows - row0 : part_rows;
    launch(row0, (part + block_rows - 1) / block_rows);
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

// The 16-bit sweep: two rows per warp, one in each 16-bit half of every
// register, two cells per instruction.  Register k of a thread holds lane
// first + k of one row in its low half and of the other row in its high
// half, so the one __shfl_up_sync of the last register moves both rows,
// and both rows see the same reference column, which enters the window
// once.  The int32 sweep is bound by the SM's integer pipe (16 lanes per
// clock per scheduler: a warp instruction every other clock), so this one
// keeps integer instructions to four and a half per register and moves
// the substitution to the FP16 and FMA pipes.  Per register and diagonal (sweep_s16x2):
//
//   e   = set.eq(rd2, rw) * 2^-24      FP16: 0x0001 in a half whose codes
//                                      match, else 0 (an f16 subnormal)
//   V   = e * (match - mismatch) + U   IMAD: U + sub - mismatch per half
//   up  = N & keep2                    0 in a half that starts a segment
//   h   = __viaddmax_s16x2_relu(V, mismatch2, __vmaxs2(up, H) + gap2)
//   best = max(best, h)                every other diagonal as a 3-input
//                                      max of best, H and h
//
// Codes compare as halves: code_half(c) puts the code byte in the
// mantissa of a normal f16 (1.0 <= x < 1.25), so two halves are equal
// exactly when their code bytes are.  The arithmetic wraps at 16 bits and
// does not saturate; the caller takes this sweep only where no value
// leaves int16 (ops/cuda_score.py k1_form, and k1k4_form for a striped
// row: 0 <= match, match x the lanes of a row's longest segment <= 32767,
// -32768 <= mismatch, gap <= 0).  Then the 32-bit IMAD carries nothing
// from the low half into the high one: U <= match x (lanes - 1) <= 32767
// - match, so U + e (match - mismatch) <= 32767 - mismatch <= 65535, and
// V + mismatch wraps back to U + sub.
//
// The reference streams through a ring of kRing 32-bit words, each a
// code_half in both halves: one shared load per diagonal and no bounds
// test (the ring holds REF_PAD left of column 0 and right of len).  Its
// first kS16x2RingPad words are mirrored past its end, so an unrolled
// step reads its diagonals at one index and constant offsets.  For
// L <= 8 the diagonal loop is unrolled by a multiple of L, so the
// window's registers rotate by name and never move; wider rows keep
// their window as bytes, four columns a register, shifted by one
// funnel shift a register per diagonal and spread into halves by one
// byte permute per register (a window of L words spills at L = 32).
// The sweep runs nd rounded up to the unroll: the extra diagonals see
// only columns right of the reference, whose cells, with mismatch <= 0
// and gap <= 0, are no larger than a cell to their left or above in the
// same segment, so no segment's best changes.
constexpr uint32_t kHalfCode = 0x3C00u;  // f16 1.0: sign 0, exponent 15

__device__ __forceinline__ uint32_t code_half(int code) {
  return kHalfCode | (uint32_t)(code & 255);
}

// v in both 16-bit halves.
__host__ __device__ __forceinline__ uint32_t pair16(int v) {
  return ((uint32_t)v & 0xFFFFu) * 0x00010001u;
}

// 0x0001 in each half where a and b are equal halves, else 0.
__device__ __forceinline__ uint32_t eq_unit16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .b32 t;\n\tset.eq.f16x2.f16x2 t, %1, %2;\n\tmul.rn.f16x2 %0, t, %3;\n\t}"
      : "=r"(r) : "r"(a), "r"(b), "r"(0x00010001u));
  return r;
}

// Diagonals per unrolled step of sweep_s16x2 (even, so the best takes
// pairs of diagonals; a multiple of L up to L = 8) and the ref tile (a
// multiple of it, at most kTile, so the ring keeps the lookback).
template <int L>
constexpr int kS16x2Unroll = L > 8 ? 2 : (L % 2 ? 2 * L : L);
template <int L>
constexpr int kS16x2Tile = kTile - kTile % kS16x2Unroll<L>;
constexpr int kS16x2RingPad = 16;  // >= every kS16x2Unroll<L>

// Run the diagonals 0 .. nd-1 (nd rounded up to kS16x2Unroll<L>) for this
// warp's two rows and call on_cell(k, odd, h2, h2_prev, d) for every
// register k of this thread on every diagonal d, odd = (d & 1) known at
// compile time, h2_prev the register's value on diagonal d - 1 (so a
// caller can fold a pair of diagonals at once: see lane_best.cu).
// rd2[k] holds both rows' codes (code_half), keep2[k] 0 in a half whose
// lane starts a segment (lane 0 always does) and 0xFFFF elsewhere; k_sub
// = match - mismatch, mismatch2 and gap2 pair16 of the scheme.  `ring` is
// kRing + kS16x2RingPad words of shared memory.  Every thread of the
// block must call it with the same nd (it synchronises at tile edges).
// on_tile(base) runs before the diagonals base .. of each tile of
// kS16x2Tile<L> diagonals.
//
// `edges` (K3's boundary columns; NoEdges elsewhere, which compiles to
// the plain loop): an unrolled step whose diagonals reach below
// edges.head or up to edges.tail runs as an edge step, every other step
// as the plain one.  An edge step calls edges.enter(d, u, H) before each
// diagonal d < head (u = d's slot in the step, known at compile time), so
// that it may overwrite this thread's D_{d-1} values H[0..L-1] before the
// lane to the right reads them, and edges.leave(d, H) after each diagonal
// d >= tail with this thread's D_d values; and, since enter may have
// replaced a register's previous value, it calls on_cell(k, true, h, h,
// d) on every diagonal (each diagonal folded alone) instead of passing
// h_prev.  `edges` may also be a StripeEdge16x2 (a stripe of a wide pair
// of rows, below): every step is then a stripe step, the plain one with
// lane 0's N term from the stripe above and the last lane's value stored
// for the stripe below; or a BandStripe16x2 (K3's wide kernel): stripe
// steps, those that reach below head or up to tail with the hooks.
struct NoEdges {};

template <class Enter, class Leave>
struct Edges {
  int head, tail;
  Enter enter;
  Leave leave;
};

template <class Enter, class Leave>
__device__ __forceinline__ Edges<Enter, Leave> make_edges(int head, int tail, Enter enter, Leave leave) {
  return {head, tail, enter, leave};
}

// The carry between two stripes of a wide pair of rows (StripeEdge's
// 16-bit form), given to sweep_s16x2 as its `edges`: every step of the
// sweep is then a stripe step.  One uint32_t a column holds both rows'
// halves, so a pair's carry rows cost what one row's int32 rows cost.
// `in` holds H of the stripe above's last lane at columns [0, cols_in)
// (cols_in = 0 for the first stripe), and thread 0 takes in[d] as lane
// 0's N term on diagonal d in place of its own shuffle value, before the
// lane's keep2 mask (a lane 0 that starts a segment drops it); its NW term
// is the previous diagonal's N term, which the sweep keeps in U, and
// starts at 0, the left boundary.  Each thread prefetches one column of
// the next 32, which a shuffle hands to thread 0.  Thread 31 keeps the
// last lane's values of a step (R diagonals) in registers and writes them
// after it, column j on diagonal j + W - 1 to out[j], for j < cols_out
// only: the sweep rounds its diagonals up to its unroll, and the carry
// row holds cols_out columns.  The hooks run a step at a time (begin, up
// and put on each diagonal, end), so that the per-diagonal cost is a
// shuffle and a select: with the prefetch test and the bounded store on
// every diagonal, K1's striped kernel ran about 1.1x slower (one H100,
// utils/kernel_times.py).  The caller synchronises between stripes and alternates two
// carry rows, so a stripe never reads the row it writes.
//
// kPipe (K2's striped kernel, csrc/argmax.cu): the warps of a block sweep
// consecutive stripes of one pair at once, warp w `lag` diagonals behind
// the sweep (w x kPipeLag there), so that the stripe above has written a
// column before this one reads it.  The stripe step then runs on the
// local diagonal d - lag (columns left of 0 read REF_PAD from the ring's
// top and 0 from the carry), and begin() puts a __syncthreads() before
// each prefetch of 32 columns: every warp of the block calls it on the
// same diagonals, and it orders the stripe above's stores before them.
template <int L, bool kPipe = false>
struct StripeEdge16x2 {
  static constexpr int kW = 32 * L;
  static constexpr int R = kS16x2Unroll<L>;
  static_assert(32 % R == 0, "a step's diagonals share one prefetch of 32");
  const uint32_t* in;
  int cols_in;
  uint32_t* out;
  int cols_out;
  int lag;
  uint32_t pf = 0, next;
  uint32_t q[R];  // thread 31: this step's last-lane values
  __device__ __forceinline__ StripeEdge16x2(const uint32_t* in_, int cols_in_, uint32_t* out_, int cols_out_,
                                            int lag_ = 0)
      : in(in_), cols_in(cols_in_), out(out_), cols_out(cols_out_), lag(lag_) {
    const int lane = threadIdx.x & 31;
    next = (!kPipe || lag == 0) && lane < cols_in ? in[lane] : 0u;
  }
  // The diagonals this warp's stripe runs behind the sweep's.
  __device__ __forceinline__ int shift() const { return kPipe ? lag : 0; }
  // Before the step of diagonals d .. d + R - 1 (d a multiple of R).
  __device__ __forceinline__ void begin(int d) {
    if ((d & 31) == 0) {
      if (kPipe) __syncthreads();
      pf = next;
      const int j = d + 32 + (threadIdx.x & 31);
      next = (kPipe ? (unsigned)j < (unsigned)cols_in : j < cols_in) ? in[j] : 0u;
    }
  }
  __device__ __forceinline__ uint32_t up(int d, int u, uint32_t up0) {
    const uint32_t v = __shfl_sync(0xffffffffu, pf, (d & 31) + u);
    return (threadIdx.x & 31) == 0 ? v : up0;
  }
  __device__ __forceinline__ void put(int u, uint32_t h) { q[u] = h; }
  // After the step: thread 31 stores its columns below cols_out.
  __device__ __forceinline__ void end(int d) {
    const int j = d - (kW - 1);
    if ((threadIdx.x & 31) == 31) {
      if (j >= 0 && j + R <= cols_out) {
#pragma unroll
        for (int u = 0; u < R; ++u) out[j + u] = q[u];
      } else {
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (j + u >= 0 && j + u < cols_out) out[j + u] = q[u];
      }
    }
  }
};

template <class Ed>
struct IsStripeEdge16x2 : std::false_type {};
template <int L, bool kPipe>
struct IsStripeEdge16x2<StripeEdge16x2<L, kPipe>> : std::true_type {};

// K3's boundary columns on a stripe of a wide pair of rows: the stripe
// carry (`stripe`) on every step, and Edges' hooks on the steps whose
// diagonals reach below head or up to tail, on the stripe's own
// diagonals and lanes; `corner` (both rows' left column at the lane above
// the stripe's lane 0, the NW term of its first cell) starts lane 0's U.
template <int L, class Enter, class Leave>
struct BandStripe16x2 {
  StripeEdge16x2<L> stripe;
  int head, tail;
  uint32_t corner;
  Enter enter;
  Leave leave;
};

template <int L, class Enter, class Leave>
__device__ __forceinline__ BandStripe16x2<L, Enter, Leave> make_band_stripe(StripeEdge16x2<L> stripe, int head,
                                                                            int tail, uint32_t corner, Enter enter,
                                                                            Leave leave) {
  return {stripe, head, tail, corner, enter, leave};
}

template <class Ed>
struct IsBandStripe16x2 : std::false_type {};
template <int L, class Enter, class Leave>
struct IsBandStripe16x2<BandStripe16x2<L, Enter, Leave>> : std::true_type {};

// The stripe carry of sweep_s16x2's `edges`: itself, or a BandStripe16x2's.
template <int L, bool kPipe>
__device__ __forceinline__ StripeEdge16x2<L, kPipe>& stripe_edge(StripeEdge16x2<L, kPipe>& edges) {
  return edges;
}

template <int L, class Enter, class Leave>
__device__ __forceinline__ StripeEdge16x2<L>& stripe_edge(BandStripe16x2<L, Enter, Leave>& edges) {
  return edges.stripe;
}

template <int L, class OnCell, class OnTile, class Ed = NoEdges>
__device__ __forceinline__ void sweep_s16x2(const uint32_t (&rd2)[L],
                                            const uint32_t (&keep2)[L], int nd,
                                            const uint8_t* ref, int len,
                                            uint32_t k_sub, uint32_t mismatch2,
                                            uint32_t gap2, uint32_t* ring,
                                            OnCell&& on_cell, OnTile&& on_tile,
                                            Ed edges = Ed{}) {
  constexpr bool kStripeEdge = IsStripeEdge16x2<Ed>::value;
  constexpr bool kBandStripe = IsBandStripe16x2<Ed>::value;
  constexpr bool kEdges = !std::is_same<Ed, NoEdges>::value && !kStripeEdge && !kBandStripe;
  constexpr int R = kS16x2Unroll<L>;
  constexpr int T = kS16x2Tile<L>;
  constexpr bool kBytes = L > 8;      // window as bytes, four a register
  constexpr int NW = kBytes ? (L + 3) / 4 : L;
  const uint32_t pad = code_half(kRefPad) * 0x00010001u;
  const int first = (threadIdx.x & 31) * L;
  uint32_t H[L], U[L], w[NW];  // D_{d-1}[i], D_{d-2}[i-1] (masked), window
#pragma unroll
  for (int k = 0; k < L; ++k) {
    H[k] = 0;
    U[k] = 0;
  }
#pragma unroll
  for (int q = 0; q < NW; ++q) w[q] = kBytes ? (uint32_t)kRefPad * 0x01010101u : pad;
  if constexpr (kBandStripe) {
    if (first == 0) U[0] = edges.corner & keep2[0];
  }
  // Columns left of 0 alias the ring's top, which no first tile writes.
  for (int t = T + threadIdx.x; t < kRing; t += blockDim.x) ring[t] = pad;
  nd = (nd + R - 1) / R * R;
  for (int base = 0; base < nd; base += T) {
    on_tile(base);
    __syncthreads();  // everyone is done reading the slot being replaced
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int j = base + t, q = j & (kRing - 1);
      const uint32_t col = code_half(j < len ? ref[j] : kRefPad) * 0x00010001u;
      ring[q] = col;
      if (q < kS16x2RingPad) ring[kRing + q] = col;
    }
    __syncthreads();
    const int dend = min(nd, base + T);
    for (int d = base; d < dend; d += R) {
      const uint32_t* at = ring + ((d - first) & (kRing - 1));
      if constexpr (kEdges) {
        // An edge step: the plain step below with the hooks, written out
        // apart so that the plain step compiles as it does with NoEdges
        // (K1's, K2's and K4's SASS is the same with or without K3; one
        // step function shared by both, instantiated with and without
        // the hooks, changes argmax_s16x2_kernel<1>'s SASS).  It repeats
        // the plain step's recurrence: a change to one must be made in
        // both, and chip_smoke.py [5] holds K3 to the int32 kernel.
        if (d < edges.head || d + R > edges.tail) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (d + u < edges.head) edges.enter(d + u, u, H);
            const uint32_t col = at[u];
            if (!kBytes) {
              w[u % L] = col;
            } else {
#pragma unroll
              for (int q = NW - 1; q > 0; --q) w[q] = __funnelshift_l(w[q - 1], w[q], 8);
              w[0] = __byte_perm(w[0], col, 0x2104);
            }
            const uint32_t up0 = __shfl_up_sync(0xffffffffu, H[L - 1], 1);
#pragma unroll
            for (int k = L - 1; k >= 0; --k) {
              const uint32_t rw = kBytes ? __byte_perm(w[k / 4], 0x3C3C3C3Cu, 0x4040 + 0x0101 * (k % 4))
                                         : w[((u - k) % L + L) % L];
              const uint32_t up = (k > 0 ? H[k - 1] : up0) & keep2[k];
              const uint32_t v = eq_unit16x2(rd2[k], rw) * k_sub + U[k];
              const uint32_t h = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(__vmaxs2(up, H[k]), gap2));
              on_cell(k, true, h, h, d + u);
              U[k] = up;
              H[k] = h;
            }
            if (d + u >= edges.tail) edges.leave(d + u, H);
          }
          continue;
        }
      }
      if constexpr (kBandStripe) {
        // K3's stripe step where its boundary columns enter or leave
        // (BandStripe16x2): the stripe step below with the edge step's
        // hooks, written out apart for the reason the edge step is (every
        // other step of K3's stripes is the stripe step below).  It
        // repeats the plain step's recurrence, as those two do.
        if (d < edges.head || d + R > edges.tail) {
          edges.stripe.begin(d);
#pragma unroll
          for (int u = 0; u < R; ++u) {
            if (d + u < edges.head) edges.enter(d + u, u, H);
            const uint32_t col = at[u];
            if (!kBytes) {
              w[u % L] = col;
            } else {
#pragma unroll
              for (int q = NW - 1; q > 0; --q) w[q] = __funnelshift_l(w[q - 1], w[q], 8);
              w[0] = __byte_perm(w[0], col, 0x2104);
            }
            const uint32_t up0 = edges.stripe.up(d, u, __shfl_up_sync(0xffffffffu, H[L - 1], 1));
#pragma unroll
            for (int k = L - 1; k >= 0; --k) {
              const uint32_t rw = kBytes ? __byte_perm(w[k / 4], 0x3C3C3C3Cu, 0x4040 + 0x0101 * (k % 4))
                                         : w[((u - k) % L + L) % L];
              const uint32_t up = (k > 0 ? H[k - 1] : up0) & keep2[k];
              const uint32_t v = eq_unit16x2(rd2[k], rw) * k_sub + U[k];
              const uint32_t h = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(__vmaxs2(up, H[k]), gap2));
              on_cell(k, true, h, h, d + u);
              U[k] = up;
              H[k] = h;
            }
            edges.stripe.put(u, H[L - 1]);
            if (d + u >= edges.tail) edges.leave(d + u, H);
          }
          edges.stripe.end(d);
          continue;
        }
      }
      if constexpr (kStripeEdge || kBandStripe) {
        auto& stripe = stripe_edge(edges);
        // A stripe step (StripeEdge16x2, or a BandStripe16x2's carry):
        // the plain step below with lane 0's N term from the stripe above
        // and the last lane handed to the stripe below, written out apart
        // for the reason the edge step is.  It repeats the plain step's recurrence: a change to
        // one must be made in both, and chip_smoke.py [14] holds the
        // striped kernels to the int32 ones.  It runs on the stripe's own
        // diagonal dl (d less the edge's shift: 0 but in K2's pipeline).
        const int dl = d - stripe.shift();
        const uint32_t* at_l = ring + ((dl - first) & (kRing - 1));
        stripe.begin(dl);
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const uint32_t col = at_l[u];
          if (!kBytes) {
            w[u % L] = col;
          } else {
#pragma unroll
            for (int q = NW - 1; q > 0; --q) w[q] = __funnelshift_l(w[q - 1], w[q], 8);
            w[0] = __byte_perm(w[0], col, 0x2104);
          }
          const uint32_t up0 = stripe.up(dl, u, __shfl_up_sync(0xffffffffu, H[L - 1], 1));
#pragma unroll
          for (int k = L - 1; k >= 0; --k) {
            const uint32_t rw = kBytes ? __byte_perm(w[k / 4], 0x3C3C3C3Cu, 0x4040 + 0x0101 * (k % 4))
                                       : w[((u - k) % L + L) % L];
            const uint32_t up = (k > 0 ? H[k - 1] : up0) & keep2[k];
            const uint32_t v = eq_unit16x2(rd2[k], rw) * k_sub + U[k];
            const uint32_t h = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(__vmaxs2(up, H[k]), gap2));
            on_cell(k, (u & 1) != 0, h, H[k], dl + u);
            U[k] = up;
            H[k] = h;
          }
          stripe.put(u, H[L - 1]);
        }
        stripe.end(dl);
        continue;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        // Lane first + k reads column d + u - first - k: unrolled by a
        // multiple of L, that is window slot (u - k) mod L, the new
        // column going to slot u mod L.
        const uint32_t col = at[u];
        if (!kBytes) {
          w[u % L] = col;
        } else {
#pragma unroll
          for (int q = NW - 1; q > 0; --q) w[q] = __funnelshift_l(w[q - 1], w[q], 8);
          w[0] = __byte_perm(w[0], col, 0x2104);
        }
        const uint32_t up0 = __shfl_up_sync(0xffffffffu, H[L - 1], 1);
#pragma unroll
        for (int k = L - 1; k >= 0; --k) {
          const uint32_t rw = kBytes ? __byte_perm(w[k / 4], 0x3C3C3C3Cu, 0x4040 + 0x0101 * (k % 4))
                                     : w[((u - k) % L + L) % L];
          const uint32_t up = (k > 0 ? H[k - 1] : up0) & keep2[k];
          const uint32_t v = eq_unit16x2(rd2[k], rw) * k_sub + U[k];
          const uint32_t h = __viaddmax_s16x2_relu(v, mismatch2, __vadd2(__vmaxs2(up, H[k]), gap2));
          on_cell(k, (u & 1) != 0, h, H[k], d + u);
          U[k] = up;
          H[k] = h;
        }
      }
    }
  }
}

template <int L, class OnCell>
__device__ __forceinline__ void sweep_s16x2(const uint32_t (&rd2)[L],
                                            const uint32_t (&keep2)[L], int nd,
                                            const uint8_t* ref, int len,
                                            uint32_t k_sub, uint32_t mismatch2,
                                            uint32_t gap2, uint32_t* ring,
                                            OnCell&& on_cell) {
  sweep_s16x2<L>(rd2, keep2, nd, ref, len, k_sub, mismatch2, gap2, ring, on_cell, [](int) {});
}

// Segmented suffix max of one row's lanes, then the store: best[] over
// the warp's 32 * L lanes, segments beginning at the set bits of `start`
// (lane-local), the lanes < m stored to o when `live`.  Every lane of the
// warp must call it.  (K1's one-pass kernel keeps its own copy: through
// this function ptxas spills registers there at L = 8.)
//
// kAtomic: take the max with what o holds (atomicMax), for a launch whose
// column pieces each store their own best into one zeroed output (K3).
template <int L, bool kAtomic = false>
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
    if (first + k < m) {
      const int v = ((open >> k) & 1u) ? max(best[k], carry) : best[k];
      if (kAtomic)
        atomicMax(o + first + k, v);
      else
        o[first + k] = v;
    }
  }
}

// The packed kernels' suffix max across the stripes of a wide row, after
// every stripe stored its own (store_suffix_max): right to left, the
// final value at stripe s+1's first lane flows into stripe s's last
// segment when that lane does not start a read.  `row` is the packed row
// (m lanes), o its output; the whole warp calls it.
//
// kAtomic: for a row whose column pieces meet in o by atomicMax (K3): each
// piece carries the value at stripe s+1's first lane, read from o by an
// atomic (o holds at any time the max of what the pieces stored there, at
// least this piece's own value, at most the read's best), and takes the
// max into o by atomicMax.
template <int L, bool kAtomic = false>
__device__ __forceinline__ void stripe_suffix_max(const int32_t* row, int m,
                                                  int32_t* o) {
  constexpr int W = 32 * L;
  const int first = (threadIdx.x & 31) * L;
  __syncwarp();  // every lane's stores are visible to the warp
  for (int s = (m + W - 1) / W - 2; s >= 0; --s) {
    const int next = (s + 1) * W;
    int tail;
    if constexpr (kAtomic) {
      tail = (threadIdx.x & 31) == 0 && row[next] < kStartBit ? atomicAdd(o + next, 0) : 0;
      tail = __shfl_sync(0xffffffffu, tail, 0);
    } else {
      tail = row[next] < kStartBit ? o[next] : 0;
    }
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
        if (i >= last) {
          if constexpr (kAtomic)
            atomicMax(o + i, tail);
          else
            o[i] = max(o[i], tail);
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace swt

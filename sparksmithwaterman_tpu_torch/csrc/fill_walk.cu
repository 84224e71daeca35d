// K9 and K10 for Hopper: the traceback's fill, its max-cell listing and
// its walk in one launch, a block of warps per pair.
//
// Replaces the lax code of the traceback,
//   sparksmithwaterman_tpu/ops/recurrence.py:fill_pairs (the fill),
//   sparksmithwaterman_tpu/ops/device_traceback.py:fill_and_trace (its
//     jnp.max, jnp.argwhere and _trace_one per cell), and
//   sparksmithwaterman_tpu/ops/longseq.py:_fill_walk_known (a window's fill
//     and the walk of its one known max cell),
// whose torch counterparts, ops/cuda_score.py fill_list_plain and
// fill_walk_plain (fill_pairs, argwhere_rows and the lock-step walk), are
// the plain versions.  One kernel template, two modes:
//
// - list (swt_fill_list, the full-fill branch): reads (B, M) against their
//   references give each pair's best, the number of cells of the (M, N)
//   plane equal to it, the first `capacity` of them in row-major order
//   (-1 past them), and the walk from each.  No H leaves the block: each
//   tile keeps a running best, an exact count of its cells at that best
//   and the first `capacity` of them in the tile's row-major order (reset
//   on a new best), in a scratch of B x tiles x capacity 64-bit keys.  The
//   first `capacity` cells of the plane are each among the first
//   `capacity` of their own tile, so the lists of the tiles at the pair's
//   best, sorted row-major (csrc/bitonic.cuh, K8's finish's sort), give
//   exactly argwhere's first `capacity`.  A pair of best 0 gets the cells
//   of its plane by arithmetic, as K8's finish does.
// - known (swt_fill_walk, the windowed branch): each pair's window is
//   filled down to the row of its one given max cell and walked from it.
//
// The codes: 2 bits a cell (0 none, 1 align, 2 insertion, 3 deletion, 0
// where H = 0), row-major, a row `stride` bytes.  They stay in shared
// memory where every block of the launch finds room on the card at once
// (route "shared", ops/cuda_score.py fill_route: 150 x 512 columns take
// 19.2 KB), else in a device scratch of B x M x stride bytes that the same
// block fills and then walks in patches (route "scratch"); no plane of
// int8 codes and no H is written either way.  Ties: `serial` a >
// ins > d, `distributed` d > ins > a, one template each.  Every cell is
// computed as the plain version computes it, pad rows and REF_PAD columns
// included; offsets are 64-bit.
//
// The fill: a pair's columns in tiles of kTile = 32 x kCols columns (kCols
// 4, 8 or 16 a lane), warp w of the pair's block on tiles w, w + W, ...
// (W warps), each tile's rows top to bottom by the row step of
// csrc/fill_dirs.cu (a prefix max within the lane, five shuffles across
// the warp, the codes from a, ins and d), less its two other shuffles: H
// left of a lane's first column comes from the scan, and the next row
// keeps it.  The block runs in lock step:
// at step s warp w runs row i of round r where s = r P + i + w, P = max(M,
// W) (P > M only where a pair has fewer rows than warps, so that a round's
// first warp never reads a row its last warp has not written), with one
// __syncthreads a step.  Tile t's last column, H[i][base - 1] of tile t +
// 1, passes through shared memory: to the warp on its right through a
// double buffer of one int a warp (written at step s, read at s + 1), and
// from the round's last warp to the next round's first through a column of
// M ints.  So a pair's fill is a chain of about (tiles / W) M + W row
// steps, where one warp a pair took tiles x M; the plan
// (ops/cuda_score.py fill_plan) picks kCols and W from the number of pairs
// and the card's SMs.
//
// What bounds it on the H100: operations, at the bound's count (1.5
// instructions a DP cell); the function's bytes are its inputs and its
// outputs (best, counts, cells, begins, codes), a few bytes a DP row.  What
// holds it back is latency: a row step is a chain of six shuffles and a
// few dozen dependent integer instructions, and with a warp or less a
// scheduler each waits out its latency; a walk is a chain of dependent
// loads from shared memory (tens of cycles each; on the scratch route a
// patch of the codes from L2 every few dozen steps).
#include "bitonic.cuh"
#include "wavefront.cuh"

namespace {

using namespace swt;

constexpr int kMaxFillWarps = 16;
constexpr int kFillThreads = 32 * kMaxFillWarps;
constexpr int kSortKeys = 4096;  // a pair's listed keys sorted in shared memory at most
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may take: the SM's 227 KB less a margin
// for the kernel's static arrays.
constexpr long long kMaxSmem = 232448 - 1024;

// The code of one cell from its three candidates and H (the tie order of
// the plain version: the first candidate equal to H wins).  H > 0 is the
// max of the three, so one of them equals it.
template <bool kSerial>
__device__ __forceinline__ uint32_t code_of(int a, int ins, int d, int h) {
  uint32_t c;
  if (kSerial)
    c = a == h ? 1u : ins == h ? 2u : 3u;
  else
    c = d == h ? 3u : ins == h ? 2u : 1u;
  return h > 0 ? c : 0u;
}

// One DP row of the lane's kCols columns: h holds row i-1 of them and on
// return row i; rf the columns' codes, ch the read's code at row i, ramp0
// = gap * kCols * lane; left is H[i-1] at the column left of the lane's
// first (lane 0: H[i-1][base-1]) and on return H[i] there, the next row's
// left.  The whole warp calls it.
template <int kCols>
__device__ __forceinline__ void fill_row(int (&h)[kCols], const int (&rf)[kCols], int ch, int west, int& left,
                                         int ramp0, int match, int mismatch, int gap) {
  const int lane = threadIdx.x & 31;
  // Prefix max of A[k] - gap*k within the lane, then across the warp.
  int run = -0x7fffffff - 1;
  int nw = left;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int up = h[k];
    run = max(run, max(max(nw + (ch == rf[k] ? match : mismatch), up + gap), 0) - ramp0 - gap * k);
    h[k] = run;
    nw = up;
  }
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(kFull, run, s);
    if (lane >= s) run = max(run, v);
  }
  int before = __shfl_up_sync(kFull, run, 1);
  // Column base-1 enters the scan as H[i][base-1] - gap*(-1).
  before = lane > 0 ? max(before, west + gap) : west + gap;
#pragma unroll
  for (int k = 0; k < kCols; ++k) h[k] = max(h[k], before) + ramp0 + gap * k;
  left = before + ramp0 - gap;  // H[i] left of this lane's first column (lane 0: west)
}

// The codes of a row, 2 bits a column, from hp (row i-1), h (row i), ch
// (the read's code at row i), left_up = H[i-1] and left = H[i] at the
// column left of the lane's first.
template <bool kSerial, int kCols>
__device__ __forceinline__ uint32_t row_codes(const int (&hp)[kCols], const int (&h)[kCols], const int (&rf)[kCols],
                                              int ch, int left_up, int left, int match, int mismatch, int gap) {
  uint32_t code = 0u;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int nw = k > 0 ? hp[k - 1] : left_up;
    const int d = (k > 0 ? h[k - 1] : left) + gap;
    code |= code_of<kSerial>(nw + (ch == rf[k] ? match : mismatch), hp[k] + gap, d, h[k]) << (2 * k);
  }
  return code;
}

// The lane's kCols codes of a row, 2 bits each: one aligned store.
template <int kCols>
__device__ __forceinline__ void put_codes(uint8_t* p, uint32_t code) {
  if constexpr (kCols == 4)
    *p = (uint8_t)code;
  else if constexpr (kCols == 8)
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)code;
  else
    *reinterpret_cast<uint32_t*>(p) = code;
}

// The walk from the 0-based cell (ci, cj) inside the plane over the codes:
// its begin (the 1-based column of its last step, 0 for none) and its
// codes end to start (the caller zeroed them).  It stops at its first 0
// code, at the matrix edge or after cap steps.
__device__ __forceinline__ void walk(const uint8_t* codes, long long stride, int ci, int cj, int cap, int32_t* begin,
                     int8_t* out) {
  int i = ci + 1, j = cj + 1, b = 0;  // 1-based; row or column 0 is the matrix edge
  for (int s = 0; s < cap && i > 0 && j > 0; ++s) {
    const int v = (codes[(long long)(i - 1) * stride + ((j - 1) >> 2)] >> (2 * ((j - 1) & 3))) & 3;
    if (v == 0) break;
    b = j;
    out[s] = (int8_t)v;
    i -= v == 1 || v == 2;  // align and insertion consume a read position
    j -= v == 1 || v == 3;  // align and deletion a reference column
  }
  *begin = b;
}

// walk() by a whole warp over codes in device memory (route "scratch"):
// the warp copies the codes around the walk, 32 rows x 128 columns (lane k
// the 32 bytes of row i - 1 - k), into its 1 KB `patch` of shared memory,
// and lane 0 takes the steps there, so that a step costs a load from
// shared memory and a few dozen steps one round trip to L2.
__device__ __forceinline__ void walk_patch(const uint8_t* codes, long long stride, int ci, int cj, int cap,
                                           int32_t* begin, int8_t* out, uint4* patch) {
  const int lane = threadIdx.x & 31;
  const int cols = (int)(stride * 4);  // a multiple of 128
  int i = ci + 1, j = cj + 1, b = 0, s = 0;
  while (s < cap && i > 0 && j > 0) {
    const int c0 = max(0, min(((j - 1) >> 6) * 64 - 64, cols - 128));  // the patch's first column
    const int top = i;                                                  // rows [top - 32, top)
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (top - 1 - lane >= 0) {
      const uint4* src = reinterpret_cast<const uint4*>(codes + (long long)(top - 1 - lane) * stride + (c0 >> 2));
      lo = src[0];
      hi = src[1];
    }
    patch[2 * lane] = lo;
    patch[2 * lane + 1] = hi;
    __syncwarp();
    if (lane == 0) {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(patch);
      for (; s < cap && i > 0 && j > 0 && top - i < 32 && j - 1 >= c0; ++s) {
        const int v = (p[(top - i) * 32 + ((j - 1 - c0) >> 2)] >> (2 * ((j - 1) & 3))) & 3;
        if (v == 0) {
          s = cap;  // the walk's end
          break;
        }
        b = j;
        out[s] = (int8_t)v;
        i -= v == 1 || v == 2;
        j -= v == 1 || v == 3;
      }
    }
    i = __shfl_sync(kFull, i, 0);
    j = __shfl_sync(kFull, j, 0);
    s = __shfl_sync(kFull, s, 0);
    b = __shfl_sync(kFull, b, 0);
    __syncwarp();  // lane 0 has read the patch before the next copy
  }
  if (lane == 0) *begin = b;
}

// Block reductions over every thread (all call them): red holds a value a
// warp.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long all = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) all += red[q];
  return all;
}

__device__ __forceinline__ int block_max(int v, long long* red) {
  v = __reduce_max_sync(kFull, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int all = v;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) all = max(all, (int)red[q]);
  return all;
}

// The sum of v over the threads before this one; *total over all.
__device__ __forceinline__ int block_exclusive(int v, long long* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) red[w] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) {
    before += q < w ? (int)red[q] : 0;
    all += (int)red[q];
  }
  *total = all;
  return before + incl - v;
}

// Both modes' inputs, walk and codes.
struct Fill {
  const uint8_t* reads;  // (b, m)
  int m, n;
  const uint8_t* refs;   // row r of pair r at refs + r * ref_stride
  long long ref_stride;
  int match, mismatch, gap;
  uint8_t* scratch;      // the codes in device memory (b x m x stride bytes), or nullptr: in shared memory
  long long stride;      // bytes of codes a row: tiles x kTile / 4
  int cap;               // walk steps at most
  int32_t* begins;       // list: (b, capacity); known: (b,)
  int8_t* codes;         // the walks' codes, zeroed: list (b, capacity, cap); known (b, cap)
};

// The list mode's outputs and scratch.
struct List {
  int capacity;
  int32_t* best;                // (b,)
  int32_t* counts;              // (b,)
  int2* cells;                  // (b, capacity)
  unsigned long long* lists;    // (b, tiles, capacity) keys (i << 32) | j
  int2* meta;                   // (b, tiles): a tile's best and its count of cells at it
  unsigned long long* sort;     // (b, sort_keys), where a pair's keys pass smem_keys
  long long sort_keys;
  int smem_keys;                // keys sorted in shared memory at most
};

// Byte offsets in the block's dynamic shared memory, the same on host and
// card: the column between rounds (where there are several) at 0, the
// read's codes, the codes of the DP (route "shared") or a patch of 1 KB a
// warp for the walks (route "scratch"), the keys of the listing.
struct Layout {
  long long read, codes, patch, keys, total;
};

__host__ __device__ inline long long up16(long long x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int m, long long stride, int rounds, int warps, bool smem_codes,
                                         int smem_keys) {
  Layout l;
  l.read = up16(rounds > 1 ? 4LL * m : 0);
  l.codes = l.read + up16(m);
  l.patch = l.codes + (smem_codes ? up16((long long)m * stride) : 0);
  l.keys = l.patch + (smem_codes ? 0 : 1024LL * warps);
  l.total = l.keys + 8LL * smem_keys;
  return l;
}

// One block per pair, 32 x W threads.  known: (b,) cells, 0-based (i, j).
template <bool kSerial, int kCols, bool kList>
__global__ void __launch_bounds__(kFillThreads)
fill_walk_kernel(Fill f, const int2* __restrict__ known, List ls) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nb[2][kMaxFillWarps];  // the column handed to the warp on the right
  __shared__ long long red[kMaxFillWarps];
  constexpr int kTile = 32 * kCols;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int pair = blockIdx.x, m = f.m, n = f.n;
  const int tiles = (n + kTile - 1) / kTile;
  const int rounds = (tiles + warps - 1) / warps;
  const Layout lay = layout(m, f.stride, rounds, warps, f.scratch == nullptr, kList ? ls.smem_keys : 0);
  int* wrap = reinterpret_cast<int*>(smem);  // the column from a round's last warp to the next round's first
  uint8_t* read = smem + lay.read;
  uint8_t* codes = f.scratch != nullptr ? f.scratch + (long long)pair * m * f.stride : smem + lay.codes;
  uint4* patch = reinterpret_cast<uint4*>(smem + lay.patch) + 64 * w;
  int2 cell = make_int2(0, 0);
  if (!kList) cell = known[pair];
  const bool walks = kList || (cell.x >= 0 && cell.y >= 0 && cell.x < m && cell.y < n);
  const int rows = kList ? m : walks ? cell.x + 1 : 0;  // a known cell's walk reads no row below it
  const uint8_t* ref = f.refs + (long long)pair * f.ref_stride;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) read[t] = f.reads[(long long)pair * m + t];
  __syncthreads();

  // -- The fill, in lock step: warp w at step s runs row i of round r
  // where s = r period + i + w.
  const int period = max(rows, warps);
  const long long steps = rows > 0 ? (long long)(rounds - 1) * period + rows + warps - 1 : 0;
  const int ramp0 = f.gap * lane * kCols;  // gap * (first column of this lane in the tile)
  int h[kCols], rf[kCols];
  int left = 0;          // H[i-1] left of this lane's first column
  int tb = -1, tc = 0;   // list: the tile's running best and its count of cells at it
  int r = 0, i = -w;
  int ch = rows > 0 ? read[0] : 0;  // the read's code at the warp's next row
  for (long long s = 0; s < steps; ++s) {
    const int tile = r * warps + w;
    if (i >= 0 && i < rows && r < rounds && tile < tiles) {
      const int jl = tile * kTile + lane * kCols;
      if (i == 0) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          rf[k] = jl + k < n ? ref[jl + k] : kRefPad;
          h[k] = 0;  // H[-1][j]
        }
        left = 0;
        tb = -1;
        tc = 0;
      }
      const int west = tile == 0 ? 0 : w == 0 ? wrap[i] : nb[(s - 1) & 1][w];  // H[i][base-1]
      int hp[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) hp[k] = h[k];
      const int left_up = left;
      fill_row<kCols>(h, rf, ch, west, left, ramp0, f.match, f.mismatch, f.gap);
      put_codes<kCols>(codes + (long long)i * f.stride + (jl >> 2),
                       row_codes<kSerial, kCols>(hp, h, rf, ch, left_up, left, f.match, f.mismatch, f.gap));
      ch = read[i + 1 < rows ? i + 1 : 0];
      if constexpr (kList) {
        // The row's max over the plane's columns; a new best resets the
        // tile's list, and a row at the best appends its cells in column
        // order.
        int top = -1;
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (jl + k < n) top = max(top, h[k]);
        top = __reduce_max_sync(kFull, top);
        if (top > tb) {
          tb = top;
          tc = 0;
        }
        if (top == tb) {
          unsigned hit = 0u;
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            if (jl + k < n && h[k] == tb) hit |= 1u << k;
          const int c = __popc(hit);
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += u;
          }
          long long slot = (long long)tc + incl - c;
          unsigned long long* list = ls.lists + ((long long)pair * tiles + tile) * ls.capacity;
          while (hit != 0u && slot < ls.capacity) {
            const int k = __ffs(hit) - 1;
            hit &= hit - 1u;
            list[slot++] = (unsigned long long)i << 32 | (unsigned)(jl + k);
          }
          tc += __shfl_sync(kFull, incl, 31);
        }
        if (i == rows - 1 && lane == 0) ls.meta[(long long)pair * tiles + tile] = make_int2(tb, tc);
      }
      if (tile + 1 < tiles) {
        __syncwarp();  // every lane has read wrap[i] (one warp a pair writes it back)
        if (lane == 31) {
          if (w == warps - 1)
            wrap[i] = h[kCols - 1];
          else
            nb[s & 1][w + 1] = h[kCols - 1];
        }
      }
    }
    __syncthreads();
    if (++i == period) {
      i = 0;
      ++r;
    }
  }

  if constexpr (!kList) {
    if (!walks) {
      if (threadIdx.x == 0) f.begins[pair] = 0;
    } else if (f.scratch != nullptr) {
      if (w == 0) walk_patch(codes, f.stride, cell.x, cell.y, f.cap, f.begins + pair, f.codes + (long long)pair * f.cap,
                             patch);
    } else if (threadIdx.x == 0) {
      walk(codes, f.stride, cell.x, cell.y, f.cap, f.begins + pair, f.codes + (long long)pair * f.cap);
    }
    return;
  } else {
    // -- The listing: the pair's best over its tiles, the count of its
    // cells, and the tiles' lists at it merged row-major.
    const int2* meta = ls.meta + (long long)pair * tiles;
    int best = -1;
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) best = max(best, meta[t].x);
    best = block_max(best, red);
    const int chunk = (tiles + blockDim.x - 1) / blockDim.x;  // this thread's tiles [t0, t1)
    const int t0 = min(tiles, (int)threadIdx.x * chunk), t1 = min(tiles, t0 + chunk);
    long long cnt = 0;
    int e = 0;
    for (int t = t0; t < t1; ++t) {
      const int2 mt = meta[t];
      if (mt.x == best) {
        cnt += mt.y;
        e += min(mt.y, ls.capacity);
      }
    }
    const long long count = block_sum(cnt, red);
    int total;
    int off = block_exclusive(e, red, &total);
    int2* out = ls.cells + (long long)pair * ls.capacity;
    int32_t* beg = f.begins + (long long)pair * ls.capacity;
    if (threadIdx.x == 0) {
      ls.best[pair] = best;
      ls.counts[pair] = (int)count;
    }
    if (best == 0) {  // every cell is 0 and starts no walk: the plane's first cells
      const long long plane = (long long)m * n;
      for (long long p = threadIdx.x; p < ls.capacity; p += blockDim.x) {
        out[p] = p < plane ? make_int2((int)(p / n), (int)(p % n)) : make_int2(-1, -1);
        beg[p] = 0;
      }
      return;
    }
    int p2 = 1;
    while (p2 < total) p2 <<= 1;
    unsigned long long* keys = p2 <= ls.smem_keys ? reinterpret_cast<unsigned long long*>(smem + lay.keys)
                                                  : ls.sort + (long long)pair * ls.sort_keys;
    for (int t = t0; t < t1; ++t) {
      const int2 mt = meta[t];
      if (mt.x != best) continue;
      const unsigned long long* src = ls.lists + ((long long)pair * tiles + t) * ls.capacity;
      for (int q = 0, k = min(mt.y, ls.capacity); q < k; ++q) keys[off++] = src[q];
    }
    for (int p = total + threadIdx.x; p < p2; p += blockDim.x) keys[p] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, p2);
    const int listed = min(total, ls.capacity);
    int8_t* walk_codes = f.codes + (long long)pair * ls.capacity * f.cap;
    for (int p = threadIdx.x; p < ls.capacity; p += blockDim.x) {
      if (p < listed) {
        const unsigned long long key = keys[p];
        const int ci = (int)(key >> 32), cj = (int)(key & 0xffffffffu);
        out[p] = make_int2(ci, cj);
        if (f.scratch == nullptr) walk(codes, f.stride, ci, cj, f.cap, beg + p, walk_codes + (long long)p * f.cap);
      } else {
        out[p] = make_int2(-1, -1);
        beg[p] = 0;
      }
    }
    if (f.scratch != nullptr)  // a warp a walk
      for (int p = w; p < listed; p += warps) {
        const unsigned long long key = keys[p];
        walk_patch(codes, f.stride, (int)(key >> 32), (int)(key & 0xffffffffu), f.cap, beg + p,
                   walk_codes + (long long)p * f.cap, patch);
      }
  }
}

// A launch's plan from its shape: the layout of a block's shared memory,
// and in list mode the power of two at or above tiles x capacity (the
// keys a pair sorts) and the part of them sorted in shared memory.  False
// where cols (4, 8 or 16), warps (1..kMaxFillWarps), the plane or the
// capacity are out of range.
struct Plan {
  Layout lay;
  long long keys;
  int smem_keys;
};

inline bool plan_of(bool list, int m, int n, int cols, int warps, bool smem_codes, int capacity, Plan* pl) {
  if (m <= 0 || n <= 0 || (cols != 4 && cols != 8 && cols != 16) || warps < 1 || warps > kMaxFillWarps ||
      (long long)m * n >= (1LL << 31))
    return false;
  const int tile = 32 * cols;
  const int tiles = (n + tile - 1) / tile, rounds = (tiles + warps - 1) / warps;
  pl->keys = 0;
  if (list) {
    pl->keys = 1;
    while (pl->keys < (long long)tiles * capacity) pl->keys <<= 1;
    if (capacity < 1 || pl->keys > (1LL << 30)) return false;
  }
  pl->smem_keys = (int)(pl->keys < kSortKeys ? pl->keys : kSortKeys);
  pl->lay = layout(m, (long long)tiles * tile / 4, rounds, warps, smem_codes, pl->smem_keys);
  return true;
}

// go(kernel) on the kernel of the tie order and the tile width.
template <bool kList, class Go>
int with_kernel(int serial, int cols, Go&& go) {
  if (serial) {
    if (cols == 4) return go(fill_walk_kernel<true, 4, kList>);
    if (cols == 8) return go(fill_walk_kernel<true, 8, kList>);
    return go(fill_walk_kernel<true, 16, kList>);
  }
  if (cols == 4) return go(fill_walk_kernel<false, 4, kList>);
  if (cols == 8) return go(fill_walk_kernel<false, 8, kList>);
  return go(fill_walk_kernel<false, 16, kList>);
}

// Lets a kernel take `bytes` of dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
                           : cudaSuccess;
}

// The common checks and the launch of one mode: the plan's, the codes'
// stride tiles x 32 cols / 4 bytes, and the shared memory of the layout
// within the SM's.
template <bool kList>
int launch(int b, const Fill& f, const int2* known, List ls, int serial, int cols, int warps, int device,
           void* stream) {
  Plan pl;
  if (b <= 0 || f.ref_stride < 0 || f.cap < 0 || f.begins == nullptr || (f.codes == nullptr && f.cap > 0) ||
      !plan_of(kList, f.m, f.n, cols, warps, f.scratch == nullptr, ls.capacity, &pl) || pl.lay.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int tile = 32 * cols;
  if (f.stride != (long long)((f.n + tile - 1) / tile) * tile / 4) return (int)cudaErrorInvalidValue;
  if (kList) {
    if (ls.best == nullptr || ls.counts == nullptr || ls.cells == nullptr || ls.lists == nullptr ||
        ls.meta == nullptr || (pl.keys > kSortKeys && (ls.sort == nullptr || ls.sort_keys < pl.keys)))
      return (int)cudaErrorInvalidValue;
    ls.smem_keys = pl.smem_keys;
  } else if (known == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return with_kernel<kList>(serial, cols, [&](auto kernel) -> int {
    const cudaError_t err = allow_smem(kernel, pl.lay.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)b, 32 * warps, (size_t)pl.lay.total, (cudaStream_t)stream>>>(f, known, ls);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// The full-fill branch (list mode): reads (b, m) uint8, refs uint8 with row
// r of pair r at refs + r * ref_stride (0: one reference for all), n
// columns; tiles of 32 x cols columns, warps a pair; code_scratch b x m x
// stride bytes, or null for the codes in shared memory.  Writes best (b,)
// int32, counts (b,) int32, cells (b, capacity) int2, begins (b, capacity)
// int32 and the walks' codes (b, capacity, cap) int8, zeroed by the caller
// (null where cap is 0).
// lists: b x tiles x capacity 64-bit keys, meta b x tiles int2; sort: b x
// sort_keys 64-bit keys, where the power of two at or above tiles x
// capacity passes 4,096 (else unused).
extern "C" int swt_fill_list(const void* reads, int b, int m, const void* refs, long long ref_stride, int n,
                             int match, int mismatch, int gap, int serial, int cols, int warps,
                             void* code_scratch, long long stride, int capacity, int cap, void* best,
                             void* counts, void* cells, void* begins, void* codes, void* lists, void* meta,
                             void* sort, long long sort_keys, int device, void* stream) {
  const Fill f{(const uint8_t*)reads, m, n, (const uint8_t*)refs, ref_stride, match, mismatch, gap,
               (uint8_t*)code_scratch, stride, cap, (int32_t*)begins, (int8_t*)codes};
  const List ls{capacity, (int32_t*)best, (int32_t*)counts, (int2*)cells, (unsigned long long*)lists,
                (int2*)meta, (unsigned long long*)sort, sort_keys, 0};
  return launch<true>(b, f, nullptr, ls, serial, cols, warps, device, stream);
}

// The windowed branch (known mode): as swt_fill_list, with cells (b,) int2,
// each pair's 0-based max cell inside the (m, n) plane, or (-1, -1) for a
// walk of no step; writes begins (b,) int32 and the walks' codes (b, cap)
// int8, zeroed by the caller.
extern "C" int swt_fill_walk(const void* reads, int b, int m, const void* refs, long long ref_stride, int n,
                             int match, int mismatch, int gap, int serial, int cols, int warps,
                             void* code_scratch, long long stride, const void* cells, int cap, void* begins,
                             void* codes, int device, void* stream) {
  const Fill f{(const uint8_t*)reads, m, n, (const uint8_t*)refs, ref_stride, match, mismatch, gap,
               (uint8_t*)code_scratch, stride, cap, (int32_t*)begins, (int8_t*)codes};
  const List ls{};
  return launch<false>(b, f, (const int2*)cells, ls, serial, cols, warps, device, stream);
}

// The blocks of a launch of swt_fill_list (list 1) or swt_fill_walk (list
// 0) with its codes in shared memory (route "shared") that one SM holds at
// once, into *blocks: cudaOccupancyMaxActiveBlocksPerMultiprocessor over
// the layout's shared memory (the read, the column between rounds, the
// codes and the listing's keys), the kernel's registers and its threads;
// 0 where the layout passes an SM's shared memory.
extern "C" int swt_fill_blocks_per_sm(int list, int serial, int m, int n, int cols, int warps, int capacity,
                                      int device, int* blocks) {
  Plan pl;
  if (blocks == nullptr || !plan_of(list != 0, m, n, cols, warps, true, capacity, &pl))
    return (int)cudaErrorInvalidValue;
  *blocks = 0;
  if (pl.lay.total > kMaxSmem) return (int)cudaSuccess;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  auto go = [&](auto kernel) -> int {
    cudaError_t err = allow_smem(kernel, pl.lay.total);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 32 * warps, (size_t)pl.lay.total);
    return (int)err;
  };
  return list ? with_kernel<true>(serial, cols, go) : with_kernel<false>(serial, cols, go);
}

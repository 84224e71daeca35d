// K10: the traceback's walk from each max cell over its pair's codes.
//
// Replaces the lax code of the walk,
//   sparksmithwaterman_tpu/ops/device_traceback.py:_trace_one
// (a masked lax.scan of gathers of fixed length `cap`, vmapped over cells
// and pairs), whose torch counterpart, cuda_score.trace_walk_plain, is its
// plain version.  dirs (B, M, N) int8 (K9's codes: 0 none, 1 align, 2
// insertion, 3 deletion) and cells (B, K, 2) int32, 0-based (i, j), -1 for
// no cell, give begins (B, K) int32, the 1-based column of the walk's last
// step (0 for a walk of no step), and codes (B, K, cap) int8, the walk's
// codes end to start; the wrapper zeroes codes before the launch, so every
// code after the stop stays 0.  A walk stops at its first 0 code, at the
// matrix edge (i or j reaching 0) or after cap steps.
//
// What bounds it on the H100: bytes, and none of them in bulk.  A walk
// reads one byte per step, each step's address depending on the byte
// before, so a walk is a chain of dependent loads (a few hundred cycles
// each from device memory, less where K9's codes still sit in the 50 MB
// L2), and its output is the zeroed codes plus a byte per step.  The lax
// version and the plain one run every walk in lock step, about 12 launches
// per step (the plain one with a host sync every 32 steps).  Here each
// (pair, cell) is one thread that runs its own walk to its own stop in a
// single launch: a short walk does not wait for a long one, and thousands
// of chains are in flight at once to hide the latency.  Offsets are
// 64-bit.
#include "wavefront.cuh"

namespace {

constexpr int kWalkThreads = 128;

__global__ void __launch_bounds__(kWalkThreads)
trace_walk_kernel(const int8_t* __restrict__ dirs, int m, int n, const int2* __restrict__ cells,
                  long long walks, int k, int cap, int32_t* __restrict__ begins, int8_t* __restrict__ codes) {
  const long long t = (long long)blockIdx.x * kWalkThreads + threadIdx.x;
  if (t >= walks) return;
  const int2 cell = cells[t];
  const int8_t* plane = dirs + (t / k) * (long long)m * n;
  int8_t* out = codes + t * cap;
  int i = cell.x + 1, j = cell.y + 1;  // 1-based; row or column 0 is the matrix edge
  int begin = 0;
  if (cell.x >= 0 && cell.y >= 0 && cell.x < m && cell.y < n) {
    for (int s = 0; s < cap && i > 0 && j > 0; ++s) {
      const int v = plane[(long long)(i - 1) * n + (j - 1)];
      if (v == 0) break;
      begin = j;
      out[s] = (int8_t)v;
      i -= v == 1 || v == 2;  // align and insertion consume a read position
      j -= v == 1 || v == 3;  // align and deletion a reference column
    }
  }
  begins[t] = begin;
}

}  // namespace

// K10: dirs (b, m, n) int8 and cells (b, k, 2) int32 on the card; begins
// (b, k) int32 written by the launch, codes (b, k, cap) int8 zeroed by the
// caller.  A cell outside the (m, n) plane walks no step.
extern "C" int swt_trace_walk(const void* dirs, int b, int m, int n, const void* cells, int k, int cap,
                              void* begins, void* codes, int device, void* stream) {
  if (b <= 0 || m <= 0 || n <= 0 || k <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const long long walks = (long long)b * k;
  const long long blocks = (walks + kWalkThreads - 1) / kWalkThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swt::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  trace_walk_kernel<<<(unsigned)blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)dirs, m, n, (const int2*)cells, walks, k, cap, (int32_t*)begins, (int8_t*)codes);
  return (int)cudaGetLastError();
}

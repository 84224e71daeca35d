// The block's bitonic sort, shared by K8's finish (csrc/max_cells.cu) and
// the full fill's listing (csrc/fill_walk.cu), each sorting 64-bit
// row-major keys (i << 32) | j of one pair or read, in shared memory or in
// a scratch of device memory.
#pragma once

namespace swt {

// Bitonic sort, ascending, of keys[0, p) (p a power of two) by the block.
template <class Key>
__device__ __forceinline__ void bitonic_sort(Key* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const Key a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace swt

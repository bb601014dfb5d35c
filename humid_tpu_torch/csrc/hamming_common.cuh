// Device code shared by the Hamming kernels (hamming_sweep.cu,
// ring_sweep.cu): the distance of two 2-bit packed words and the append
// of one matching pair.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace humid {

// Number of differing bases of two W-lane words (16 bases per uint32 lane,
// 2 bits per base): each 2-bit group of a ^ b contributes 1 iff non-zero.
template <int W>
__device__ __forceinline__ int word_distance(const uint32_t (&row)[W],
                                             const uint32_t* col) {
  int d = 0;
#pragma unroll
  for (int l = 0; l < W; ++l) {
    const uint32_t z = row[l] ^ col[l];
    d += __popc((z | (z >> 1)) & 0x55555555u);
  }
  return d;
}

// Appends (a, b) to the pair buffer.  The counter keeps counting past
// `cap`, so the caller learns the exact size a relaunch needs.
__device__ __forceinline__ void append_pair(unsigned long long* counter,
                                            long long cap, long long* out_a,
                                            long long* out_b, long long a,
                                            long long b) {
  const unsigned long long slot = atomicAdd(counter, 1ULL);
  if (slot < (unsigned long long)cap) {
    out_a[slot] = a;
    out_b[slot] = b;
  }
}

}  // namespace humid

// The lane counts the kernels are instantiated for (words up to 256 bases).
#define HUMID_FOR_EACH_W(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

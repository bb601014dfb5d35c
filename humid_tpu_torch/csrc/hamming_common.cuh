// Device code shared by the Hamming kernels: the bit-plane form of 2-bit
// packed words, the distance of two words in that form and the inner loop
// that holds a thread's row against a chunk of columns in shared memory
// (the ring step, ring_sweep.cu), and the buffer of matching pairs (both
// kernels; the tile sweep, hamming_sweep.cu, keeps one per warpgroup).
//
// Bit planes.  A word arrives as W uint32 lanes of 16 bases, 2 bits a
// base.  Counting differing bases on that form costs one POPC per lane
// plus a shift, an OR and an AND to fold each 2-bit group onto one bit.
// Of two neighbouring lanes A, B the planes
//   lo = (A & 0x55555555) | ((B & 0x55555555) << 1)
//   hi = ((A >> 1) & 0x55555555) | (B & 0xAAAAAAAA)
// give every base one bit, at the same position in lo (low code bit) and
// hi (high code bit).  Two words differ at a base iff
// (lo_r ^ lo_c) | (hi_r ^ hi_c) has that bit set: one XOR, one LOP3 and
// one POPC per 32 bases.  POPC runs at 16 a clock on an SM, a quarter
// of the other integer operations' rate, so it is the unit to spare.  A
// word takes PAIRS = ceil(W / 2) plane pairs, 2 * PAIRS plane words laid
// out (lo0, hi0, lo1, hi1, ...); for odd W the last B is 0 in rows and
// columns alike.  Rows are converted once per thread, columns once as a
// block stages them: the table in device memory stays packed lanes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace humid {

__host__ __device__ constexpr int plane_pairs(int w) { return (w + 1) / 2; }

__device__ __forceinline__ void lanes_to_planes(uint32_t a, uint32_t b,
                                                uint32_t& lo, uint32_t& hi) {
  lo = (a & 0x55555555u) | ((b & 0x55555555u) << 1);
  hi = ((a >> 1) & 0x55555555u) | (b & 0xAAAAAAAAu);
}

// Plane pair p of the W-lane word at `word`: (lo, hi) of lanes 2p, 2p+1.
template <int W>
__device__ __forceinline__ void load_plane_pair(const uint32_t* word, int p,
                                                uint32_t& lo, uint32_t& hi) {
  const uint32_t a = word[2 * p];
  const uint32_t b = 2 * p + 1 < W ? word[2 * p + 1] : 0u;
  lanes_to_planes(a, b, lo, hi);
}

// Number of differing bases of two words in plane form.
template <int PAIRS>
__device__ __forceinline__ int plane_distance(const uint32_t* row,
                                              const uint32_t* col) {
  int d = 0;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
    d += __popc((row[2 * p] ^ col[2 * p]) | (row[2 * p + 1] ^ col[2 * p + 1]));
  return d;
}

// Columns the inner loop takes per step: their plane words are fetched
// with 16-byte shared-memory loads (a multiple of 4 words, at most 28)
// and tested against the thread's row before one branch.
__host__ __device__ constexpr int group_cols(int plane_words) {
  return plane_words == 2 ? 8
         : plane_words == 4 ? 4
         : (plane_words % 4 != 0 || plane_words == 8) ? 2
                                                      : 1;
}

// Stages columns [0, n) of `src` ([., W] packed lanes) as plane words in
// `s_cols`, and zero words up to the next multiple of the group size, so
// the inner loop never reads what no thread wrote.
template <int W>
__device__ __forceinline__ void stage_columns(uint32_t* s_cols,
                                              const uint32_t* __restrict__ src,
                                              int n) {
  constexpr int PAIRS = plane_pairs(W), U = group_cols(2 * PAIRS);
  const int n_pad = (n + U - 1) / U * U;
  for (int k = threadIdx.x; k < n_pad * PAIRS; k += blockDim.x) {
    const int c = k / PAIRS, p = k % PAIRS;
    uint32_t lo = 0u, hi = 0u;
    if (c < n) load_plane_pair<W>(src + (long long)c * W, p, lo, hi);
    *reinterpret_cast<uint2*>(s_cols + 2 * k) = make_uint2(lo, hi);
  }
}

// Holds a thread's row (plane form, in registers) against the staged
// columns [c_begin, c_end) of `s_cols` one at a time and calls emit(c) for
// every column c within max_dist.  The slow, exact loop: for the few
// columns where a test has to follow every distance.
template <int PAIRS, class Emit>
__device__ __forceinline__ void check_columns(
    const uint32_t (&row)[2 * PAIRS], const uint32_t* s_cols, int c_begin,
    int c_end, int max_dist, Emit emit) {
#pragma unroll 1
  for (int c = c_begin; c < c_end; ++c)
    if (plane_distance<PAIRS>(row, s_cols + c * (2 * PAIRS)) <= max_dist)
      emit(c);
}

// The fast loop over the staged columns [c_begin, c_end): c_begin is a
// multiple of the group size and the columns are staged up to the next
// such multiple past c_end.  A group of columns is fetched with 16-byte
// loads and held against the row with one branch for the group; only a
// group in which some column passed is gone over again by check_columns.
// So emit sees the padding columns too and has to drop c >= c_end
// itself, with whatever else decides a pair (validity, triangle, ids):
// those tests run only for the few pairs that pass the distance test.
// One row per thread: the loop is bound by POPC, which more rows per
// thread do not spare, and the group that is gone over again after a hit
// grows with them (2 and 4 rows measured slower on the H100 at every
// shape, PERF.md).
template <int PAIRS, class Emit>
__device__ __forceinline__ void compare_columns(
    const uint32_t (&row)[2 * PAIRS], const uint32_t* s_cols, int c_begin,
    int c_end, int max_dist, Emit emit) {
  constexpr int PW = 2 * PAIRS, U = group_cols(PW), Q = U * PW / 4;
  for (int c = c_begin; c < c_end; c += U) {
    uint32_t g[U * PW];
    const uint4* src = reinterpret_cast<const uint4*>(s_cols + c * PW);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const uint4 v = src[q];
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
    bool hit = false;
#pragma unroll
    for (int j = 0; j < U; ++j)
      hit |= plane_distance<PAIRS>(row, g + j * PW) <= max_dist;
    if (hit) check_columns<PAIRS>(row, s_cols, c, c + U, max_dist, emit);
  }
}

// Matching pairs on their way out.  A pair (a, b), a < n and b < n, is
// the one key a * n + b.  A global atomicAdd per match makes a warp wait
// a memory round trip for each, and all of them queue on one address; so
// a block collects its keys in shared memory (a shared-memory atomic) and
// flush() hands them on with one global atomicAdd for the lot.  Keys that
// find the block's buffer full go out one by one.  The global counter
// keeps counting past `cap`, so the caller learns the exact size a
// relaunch needs.
constexpr int HIT_CAP = 1024;

struct HitBuffer {
  unsigned n;               // keys offered since the last flush
  unsigned long long base;  // first global slot of the keys being flushed
  long long keys[HIT_CAP];

  // Thread 0 of a block, before the barrier that precedes the first add.
  __device__ __forceinline__ void reset() { n = 0u; }

  __device__ __forceinline__ void add(long long key,
                                      unsigned long long* counter,
                                      long long cap, long long* out_keys) {
    // A full buffer is left alone (n only grows between flushes, so a
    // stale read costs one atomic at most): when every pair matches, the
    // block's threads must not queue on this one shared word as well.
    unsigned i = HIT_CAP;
    if (*(volatile unsigned*)&n < HIT_CAP) i = atomicAdd(&n, 1u);
    if (i < HIT_CAP) {
      keys[i] = key;
    } else {
      const unsigned long long slot = atomicAdd(counter, 1ULL);
      if (slot < (unsigned long long)cap) out_keys[slot] = key;
    }
  }

  // The threads that add, between two phases of adds: thread `tid` of
  // `nthreads`, where sync() is a barrier over exactly those threads.
  // Starts with a barrier (every add of the phase is in); hands the keys
  // on only when there are at least `min_keys` of them (a caller that
  // flushes often spares the global atomic until the buffer fills), and
  // then ends with a barrier, the buffer empty for the adds that follow.
  template <class Sync>
  __device__ __forceinline__ void flush(unsigned long long* counter,
                                        long long cap, long long* out_keys,
                                        unsigned tid, unsigned nthreads,
                                        Sync sync, unsigned min_keys = 1u) {
    sync();
    const unsigned m = min(n, (unsigned)HIT_CAP);
    if (m < max(min_keys, 1u)) return;  // uniform over the threads
    if (tid == 0) base = atomicAdd(counter, (unsigned long long)m);
    sync();
    // Every thread has read n above; no add runs before the last barrier.
    if (tid == 0) n = 0u;
    for (unsigned i = tid; i < m; i += nthreads)
      if (base + i < (unsigned long long)cap) out_keys[base + i] = keys[i];
    sync();
  }

  // The same over all threads of the block.
  __device__ __forceinline__ void flush(unsigned long long* counter,
                                        long long cap, long long* out_keys) {
    flush(counter, cap, out_keys, threadIdx.x, blockDim.x,
          [] { __syncthreads(); });
  }
};

}  // namespace humid

// The lane counts the kernels are instantiated for (words up to 256 bases).
#define HUMID_FOR_EACH_W(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

// The simplex encoding of packed words for the int8 tensor-core kernels
// (sm_90a): [n, w] uint32 lanes -> the [rows, K] int8 table that
// hamming_sweep.cu (K1) and ring_sweep.cu (K2) read through TMA.
//
// It is the pre-pass of both kernels' wrappers, not the port of a TPU
// kernel: on the TPU the ring kernel expands its packed block to one-hots
// in VMEM (humid_tpu/parallel/pallas_ring.py::_build_oht) and the tile
// sweep's caller builds one-hot tiles with XLA.  The table is exactly
// ops/simplex_encode.py::encode_table, its plain version: row g holds, for
// each of the 16 w base slots of word g (base p of lane l at bits
// 2 (15 - p), padding slots too: code A), the 3 channels
// (1 - 2 hi, 1 - 2 lo, 1 - 2 (hi ^ lo)) of the slot's code hi lo, at bytes
// 48 l + 3 p ..; bytes from 48 w to K (48 w rounded up to a multiple of
// 32) are zero, and rows from n to rows (a multiple of 64) are zero.
//
// What bounds it on the card: bytes.  Each 4-byte lane becomes 48 bytes,
// so the writes set the time: rows x K bytes at 3.35 TB/s (4.3 MB, 1.3 us,
// for one ring block of 44,699 words at w = 2), and at that size a launch
// costs more than the work.  What the design does about it: one thread
// writes one 16-byte chunk of a row (a third of a lane's 48 bytes, or
// zeros), so the stores are whole 16-byte words, consecutive across the
// warp, and every byte of the table is written once, the zero padding
// included; the lane it reads is shared by three neighbouring threads and
// comes from L1.  A grid-stride loop bounds the grid.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1 << 16;
constexpr int ROWS_MULTIPLE = 64;

__global__ void __launch_bounds__(THREADS)
    simplex_encode_kernel(const uint32_t* __restrict__ lanes, long long n,
                          int w, int4* __restrict__ out, long long chunks,
                          int row_chunks) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * THREADS) {
    const long long g = i / row_chunks;
    const int j = (int)(i - g * row_chunks);
    const int lane = j / 3, part = j - 3 * lane;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (g < n && lane < w) {
      const uint32_t x = lanes[g * w + lane];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int b = 16 * part + t;  // byte of the lane's 48
        const int p = b / 3, ch = b - 3 * p;
        const uint32_t code = (x >> (30 - 2 * p)) & 3u;
        const uint32_t hi = code >> 1, lo = code & 1u;
        const uint32_t bit = ch == 0 ? hi : ch == 1 ? lo : hi ^ lo;
        v[t / 4] |= (bit ? 0xFFu : 0x01u) << (8 * (t % 4));
      }
    }
    out[i] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
}

}  // namespace

// Writes the [rows, k] int8 table of the n words of w lanes at `lanes`
// ([n, w] uint32) to `out` (16-byte aligned): k must be 48 w rounded up
// to a multiple of 32, rows a multiple of 64 and at least n.
extern "C" int humid_simplex_encode(const void* lanes, long long n, int w,
                                    void* out, long long rows, int k,
                                    void* stream) {
  if (n < 0 || w < 1 || k != (48 * w + 31) / 32 * 32 || rows < n ||
      rows % ROWS_MULTIPLE != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int row_chunks = k / 16;
  const long long chunks = rows * row_chunks;
  if (chunks == 0) return (int)cudaSuccess;
  long long blocks = (chunks + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  simplex_encode_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lanes), n, w, static_cast<int4*>(out),
      chunks, row_chunks);
  return (int)cudaGetLastError();
}

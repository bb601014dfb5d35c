// Hamming tile sweep over 2-bit packed words, for Hopper (sm_90a).
//
// Replaces the TPU kernel humid_tpu/ops/pallas_hamming.py::_kernel (K1),
// which matches one-hot expanded tiles on the MXU and extracts per-row
// top-k column lists that an XLA epilogue compacts into pairs.  Here the
// same pair set comes straight out of the kernel:
//
//   for every tile pair (ti, tj, on) of an i-major list with tj >= ti,
//   every row r of tile ti and column c of tile tj with
//     popcount over lanes of ((r ^ c) | ((r ^ c) >> 1)) & 0x55555555
//       <= max_dist,
//   both rows valid (index < n_rows and index % part_stride < part_valid),
//   c > r when ti == tj (upper triangle of a diagonal tile pair),
//   and, when a run-id vector is given, ids[r] == ids[c],
//   is appended as (r, c) to a global int64 pair buffer.
//
// What bounds it on the card: integer ALU work.  Each pair and lane costs
// XOR + SHIFT + OR + AND + POPC + ADD (POPC issues at a quarter of the
// other integer ops' rate), and the column operand — about 8 bytes per
// word at w = 2 — is re-read from shared memory for every row of the
// tile.  Global memory traffic is small: a tile's words are read once
// per row block.  Matches are sparse (dedup data), so the appends cost
// little next to the compare.
//
// What this simple design does about it: one thread per row keeps the
// row's lanes in registers; a block of ROWS threads stages COLS column
// words (and their validity flags) in shared memory, and every thread
// reads the same column word at once, a broadcast without bank
// conflicts.  The run-id mask (the pigeonhole engines compare only words
// of one equal-key run) stages the column ids beside the validity flags;
// it is a template parameter, so a sweep without ids pays nothing for
// it.  Validity and the upper triangle are explicit masks, so the kernel
// has no limit on max_dist (the TPU kernel zeroed the one-hot
// features of padding words, which only works while max_dist < 16 * w),
// and on a diagonal tile pair a block skips the column chunks that lie
// wholly at or below its first row.  Each match takes one 64-bit
// atomicAdd on a global counter; the counter keeps counting past the
// buffer's capacity, so the caller can relaunch with the exact size.
// The one-hot tensor-core formulation, warp-aggregated appends and TMA
// staging are left for later work.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "hamming_common.cuh"

namespace {

constexpr int ROWS = 256;  // threads per block, one row each
constexpr int COLS = 256;  // column words staged in shared memory per step

__device__ __forceinline__ bool word_valid(long long g, long long n_rows,
                                           long long part_stride,
                                           long long part_valid) {
  return g < n_rows && (g % part_stride) < part_valid;
}

template <int W, bool IDS>
__global__ void __launch_bounds__(ROWS)
hamming_sweep_kernel(const uint32_t* __restrict__ lanes, long long n_rows,
                     const int* __restrict__ ids,
                     const int* __restrict__ tile_pairs, int tile,
                     long long part_stride, long long part_valid,
                     int max_dist, long long* __restrict__ out_a,
                     long long* __restrict__ out_b, long long cap,
                     unsigned long long* __restrict__ counter) {
  __shared__ uint32_t s_cols[COLS * W];
  __shared__ unsigned char s_ok[COLS];
  __shared__ int s_ids[IDS ? COLS : 1];

  const int* p = tile_pairs + 3LL * blockIdx.y;
  const int ti = p[0];
  const int tj = p[1];
  if (p[2] == 0) return;  // disabled tile pair: uniform over the block
  const bool diag = ti == tj;

  const int row0 = blockIdx.x * ROWS;  // first local row of this block
  const int r_local = row0 + threadIdx.x;
  const long long gr = (long long)ti * tile + r_local;
  const bool row_ok =
      r_local < tile && word_valid(gr, n_rows, part_stride, part_valid);
  uint32_t row[W];
#pragma unroll
  for (int l = 0; l < W; ++l) row[l] = row_ok ? lanes[gr * W + l] : 0u;
  int row_id = 0;
  if constexpr (IDS) row_id = row_ok ? ids[gr] : 0;

  const long long col_base = (long long)tj * tile;
  // On a diagonal tile pair no column at or below row0 can match.
  const int c_begin = diag ? ((row0 + 1) / COLS) * COLS : 0;
  for (int c0 = c_begin; c0 < tile; c0 += COLS) {
    __syncthreads();  // the previous chunk has been consumed
    for (int k = threadIdx.x; k < COLS * W; k += ROWS) {
      const int c = k / W;
      const long long gc = col_base + c0 + c;
      s_cols[k] = (c0 + c < tile && gc < n_rows) ? lanes[gc * W + k % W]
                                                 : 0u;
    }
    for (int c = threadIdx.x; c < COLS; c += ROWS) {
      s_ok[c] = c0 + c < tile &&
                word_valid(col_base + c0 + c, n_rows, part_stride,
                           part_valid);
      if constexpr (IDS) s_ids[c] = s_ok[c] ? ids[col_base + c0 + c] : 0;
    }
    __syncthreads();
    if (!row_ok) continue;
    const int c_end = min(COLS, tile - c0);
    for (int c = 0; c < c_end; ++c) {
      const int d = humid::word_distance<W>(row, s_cols + c * W);
      if (d <= max_dist && s_ok[c] && (!diag || c0 + c > r_local) &&
          (!IDS || s_ids[c] == row_id)) {
        humid::append_pair(counter, cap, out_a, out_b, gr,
                           col_base + c0 + c);
      }
    }
  }
}

template <int W>
cudaError_t launch(const uint32_t* lanes, long long n_rows, const int* ids,
                   const int* tile_pairs, long long nb, int tile,
                   long long part_stride, long long part_valid, int max_dist,
                   long long* out_a, long long* out_b, long long cap,
                   unsigned long long* counter, cudaStream_t stream) {
  const dim3 grid((tile + ROWS - 1) / ROWS, (unsigned)nb);
  if (ids != nullptr) {
    hamming_sweep_kernel<W, true><<<grid, ROWS, 0, stream>>>(
        lanes, n_rows, ids, tile_pairs, tile, part_stride, part_valid,
        max_dist, out_a, out_b, cap, counter);
  } else {
    hamming_sweep_kernel<W, false><<<grid, ROWS, 0, stream>>>(
        lanes, n_rows, ids, tile_pairs, tile, part_stride, part_valid,
        max_dist, out_a, out_b, cap, counter);
  }
  return cudaGetLastError();
}

}  // namespace

// Appends every matching (row, col) of the nb tile pairs to out_a/out_b
// (the first `cap` of them) and adds the number of matches to *counter.
// lanes: [n_rows, w] uint32; ids: [n_rows] int32 run ids or NULL (no
// mask); tile_pairs: [nb, 3] int32 (ti, tj, on).
extern "C" int humid_hamming_sweep(const void* lanes, long long n_rows,
                                   int w, const void* ids,
                                   const void* tile_pairs,
                                   long long nb, int tile,
                                   long long part_stride,
                                   long long part_valid, int max_dist,
                                   void* out_a, void* out_b, long long cap,
                                   void* counter, void* stream) {
  if (nb == 0) return (int)cudaSuccess;
  if (nb > 65535 || tile <= 0 || part_stride <= 0)
    return (int)cudaErrorInvalidValue;
  const uint32_t* l = static_cast<const uint32_t*>(lanes);
  const int* id = static_cast<const int*>(ids);
  const int* tp = static_cast<const int*>(tile_pairs);
  long long* a = static_cast<long long*>(out_a);
  long long* b = static_cast<long long*>(out_b);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_SWEEP_CASE(W_)                                                \
  case W_:                                                                  \
    return (int)launch<W_>(l, n_rows, id, tp, nb, tile, part_stride,        \
                           part_valid, max_dist, a, b, cap, cnt, s);
    HUMID_FOR_EACH_W(HUMID_SWEEP_CASE)
#undef HUMID_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

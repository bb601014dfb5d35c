// One step of the ring-rotated block compare over 2-bit packed words, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel humid_tpu/parallel/pallas_ring.py::_ring_kernel
// (K2).  There one kernel per shard runs the whole ring: at step s it
// matches its own block against block (me + s) mod d as one-hot matmuls
// while the copy of that block to the left neighbour is in flight, and
// returns per-(step, row) match counts and top-cap_row column lists that
// the host compacts.  Here the rotation is done outside the kernel (copies
// on a second stream, ordered by events: parallel/cuda_ring.py), and the
// kernel is one step of one shard:
//
//   rows [b, w] is the shard's own block (global index row_base + r),
//   cols [b, w] is the block it received for this step, in a different
//   buffer (global index col_base + c).  Every (r, c) with both global
//   indices < u, at most max_dist differing bases, and c > r when
//   upper_only (the step that compares a block with itself), is appended
//   as (min, max) of the two global indices to the shard's int64 pair
//   buffer.  One buffer and one 64-bit counter serve all steps of a
//   shard's ring; the counter keeps counting past the capacity, so the
//   caller can rerun the ring with the exact size.
//
// What the TPU kernel had and this one drops, as answers to TPU limits:
// the one-hot expansion and its validity-by-zeroed-features trick (the
// mask here is explicit, so max_dist may reach 16 * w), the lane-major
// 128-wide chunk layout, the 2,048-row VMEM streaming, the per-row top-K
// output with its cap_row retry ladder and ceiling, and the quantised
// block sizes that let compiled programs be reused.
//
// What bounds it on the card: integer ALU work, as for the tile sweep
// (hamming_sweep.cu).  A step evaluates up to b * b word pairs at w POPC
// each plus XOR, SHIFT, OR, AND and ADD, while it reads 2 * b * w * 4
// bytes: at b = 45,000 and w = 2 that is 2e9 evaluations against 0.7 MB.
//
// What this simple design does about it: one thread per row keeps the
// row's lanes in registers; a block of ROWS threads walks a span of SPAN
// columns, staging COLS column words at a time in shared memory, where
// every thread reads the same word at once (a broadcast).  The grid is
// two-dimensional, row blocks by column spans, so a step fills the 132
// SMs whatever the shard count makes of b.  Only valid columns are
// staged, and blocks that hold no valid row or column, or on an
// upper_only step lie wholly at or below the diagonal, return at once.
// The tensor-core one-hot form, warp-aggregated appends, TMA staging and
// stores to a peer card from inside the kernel are left for later work.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "hamming_common.cuh"

namespace {

constexpr int ROWS = 256;   // threads per block, one row each
constexpr int COLS = 256;   // column words staged in shared memory per step
constexpr int SPAN = 2048;  // columns one block walks (grid.y spans)

// Rows of a block of b rows starting at global index `base` that lie
// below u.
int valid_rows(long long base, long long u, int b) {
  const long long n = u - base;
  return n <= 0 ? 0 : (n < b ? (int)n : b);
}

template <int W>
__global__ void __launch_bounds__(ROWS)
ring_sweep_kernel(const uint32_t* __restrict__ rows,
                  const uint32_t* __restrict__ cols, int n_rows, int n_cols,
                  long long row_base, long long col_base, int max_dist,
                  int upper_only, long long* __restrict__ out_a,
                  long long* __restrict__ out_b, long long cap,
                  unsigned long long* __restrict__ counter) {
  __shared__ uint32_t s_cols[COLS * W];

  const int row0 = blockIdx.x * ROWS;
  const int span_end = min((int)(blockIdx.y + 1) * SPAN, n_cols);
  int c_begin = blockIdx.y * SPAN;
  // Same block on both sides: no column at or below row0 can match.
  if (upper_only) c_begin = max(c_begin, ((row0 + 1) / COLS) * COLS);
  if (c_begin >= span_end) return;  // uniform over the block

  const int r = row0 + threadIdx.x;
  const bool row_ok = r < n_rows;
  uint32_t row[W];
#pragma unroll
  for (int l = 0; l < W; ++l) row[l] = row_ok ? rows[(long long)r * W + l] : 0u;
  const long long ga = row_base + r;

  for (int c0 = c_begin; c0 < span_end; c0 += COLS) {
    const int c_cnt = min(COLS, span_end - c0);
    __syncthreads();  // the previous chunk has been consumed
    const uint32_t* src = cols + (long long)c0 * W;
    for (int k = threadIdx.x; k < c_cnt * W; k += ROWS) s_cols[k] = src[k];
    __syncthreads();
    if (!row_ok) continue;
    for (int c = 0; c < c_cnt; ++c) {
      const int d = humid::word_distance<W>(row, s_cols + c * W);
      if (d <= max_dist && (!upper_only || c0 + c > r)) {
        const long long gb = col_base + c0 + c;
        humid::append_pair(counter, cap, out_a, out_b, min(ga, gb),
                           max(ga, gb));
      }
    }
  }
}

template <int W>
cudaError_t launch(const uint32_t* rows, const uint32_t* cols, int n_rows,
                   int n_cols, long long row_base, long long col_base,
                   int max_dist, int upper_only, long long* out_a,
                   long long* out_b, long long cap,
                   unsigned long long* counter, cudaStream_t stream) {
  const dim3 grid((n_rows + ROWS - 1) / ROWS, (n_cols + SPAN - 1) / SPAN);
  ring_sweep_kernel<W><<<grid, ROWS, 0, stream>>>(
      rows, cols, n_rows, n_cols, row_base, col_base, max_dist, upper_only,
      out_a, out_b, cap, counter);
  return cudaGetLastError();
}

}  // namespace

// One ring step: appends every matching pair of rows x cols to
// out_a/out_b (the first `cap` of them, counting from *counter) and adds
// the number of matches to *counter.  rows, cols: [b, w] uint32.  Launches
// nothing when no row or no column of the step lies below u.
extern "C" int humid_ring_sweep(const void* rows, const void* cols,
                                long long b, int w, long long row_base,
                                long long col_base, long long u,
                                int max_dist, int upper_only, void* out_a,
                                void* out_b, long long cap, void* counter,
                                void* stream) {
  if (b <= 0 || b > 65535LL * SPAN || row_base < 0 || col_base < 0)
    return (int)cudaErrorInvalidValue;
  const int n_rows = valid_rows(row_base, u, (int)b);
  const int n_cols = valid_rows(col_base, u, (int)b);
  if (n_rows == 0 || n_cols == 0) return (int)cudaSuccess;
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const uint32_t* c = static_cast<const uint32_t*>(cols);
  long long* a = static_cast<long long*>(out_a);
  long long* bb = static_cast<long long*>(out_b);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_RING_CASE(W_)                                                 \
  case W_:                                                                  \
    return (int)launch<W_>(r, c, n_rows, n_cols, row_base, col_base,        \
                           max_dist, upper_only, a, bb, cap, cnt, s);
    HUMID_FOR_EACH_W(HUMID_RING_CASE)
#undef HUMID_RING_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

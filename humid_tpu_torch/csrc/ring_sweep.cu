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
//   as the key min * u + max of the two global indices to the shard's
//   int64 buffer.  One buffer and one 64-bit counter serve all steps of a
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
// What bounds it on the card: the POPC unit, as for the tile sweep
// (hamming_sweep.cu).  A step evaluates up to b * b word pairs at
// ceil(w / 2) POPC each (the bit-plane form of hamming_common.cuh) plus
// an XOR and a LOP3 per POPC and a compare per pair, while it reads
// 2 * b * w * 4 bytes: at b = 45,000 and w = 2 that is 2e9 evaluations
// against 0.7 MB.
//
// What the design does about it: the inner loop is the tile sweep's
// (humid::compare_columns).  A thread converts its row to bit planes
// once and keeps it in registers; a block of THREADS threads walks a span of columns, converting and staging COLS of
// them at a time in shared memory, where every thread reads the same 16
// bytes at once (a broadcast), and holds each column group against its
// row before one branch.  The grid is two-dimensional, row blocks by
// column spans of SPAN columns, halved while a small step would leave
// the grid below MIN_BLOCKS blocks, so a step fills the 132 SMs whatever
// the shard count makes of b.  Only valid columns are staged, and blocks
// that hold no valid row or column, or on an upper_only step lie wholly
// at or below the diagonal, return at once; on such a step a warp skips
// the columns left of its first row and takes its own 32 columns
// through the exact loop.  Matches are collected in the block's buffer
// in shared memory (humid::HitBuffer) as one key min * u + max each.
// The tensor-core one-hot form, TMA staging and stores to a peer card
// from inside the kernel are left for later work.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "hamming_common.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int COLS = 256;     // columns staged in shared memory per step
constexpr int SPAN = 2048;    // columns one block walks (grid.y spans)...
constexpr int MIN_BLOCKS = 2048;  // ...halved while the grid is smaller

// Rows of a block of b rows starting at global index `base` that lie
// below u.
int valid_rows(long long base, long long u, int b) {
  const long long n = u - base;
  return n <= 0 ? 0 : (n < b ? (int)n : b);
}

template <int W>
__global__ void __launch_bounds__(THREADS)
ring_sweep_kernel(const uint32_t* __restrict__ rows_in,
                  const uint32_t* __restrict__ cols, int n_rows, int n_cols,
                  int span, long long row_base, long long col_base,
                  long long u, int max_dist, int upper_only,
                  long long* __restrict__ out_keys,
                  long long cap, unsigned long long* __restrict__ counter) {
  constexpr int PAIRS = humid::plane_pairs(W), PW = 2 * PAIRS;
  constexpr int U = humid::group_cols(PW);
  __shared__ __align__(16) uint32_t s_cols[COLS * PW];
  __shared__ humid::HitBuffer s_hits;

  const int row0 = blockIdx.x * THREADS;
  const int span_end = min((int)(blockIdx.y + 1) * span, n_cols);
  int c_first = blockIdx.y * span;
  // Same block on both sides: no column at or below row0 can match.
  if (upper_only) c_first = max(c_first, (row0 + 1) / COLS * COLS);
  if (c_first >= span_end) return;  // uniform over the block

  const int r = row0 + threadIdx.x;  // this thread's row
  uint32_t row[PW];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    row[2 * q] = row[2 * q + 1] = 0u;
    if (r < n_rows)
      humid::load_plane_pair<W>(rows_in + (long long)r * W, q, row[2 * q],
                                row[2 * q + 1]);
  }
  const int warp_r_first = row0 + (threadIdx.x & ~31);
  const bool warp_has_rows = warp_r_first < n_rows;

  if (threadIdx.x == 0) s_hits.reset();
  for (int c0 = c_first; c0 < span_end; c0 += COLS) {
    const int c_cnt = min(COLS, span_end - c0);
    humid::stage_columns<W>(s_cols, cols + (long long)c0 * W, c_cnt);
    __syncthreads();
    if (warp_has_rows) {
      const auto emit = [&](int c) {
        const int cl = c0 + c;
        if (c >= c_cnt || r >= n_rows || (upper_only && cl <= r)) return;
        const long long ga = row_base + r, gb = col_base + cl;
        s_hits.add(min(ga, gb) * u + max(ga, gb), counter, cap, out_keys);
      };
      int c_begin = 0;
      if (upper_only) {
        // Columns left of the warp's first row pair with none of its
        // rows; the next 32, its own, with some: every thread is at
        // distance 0 from itself there, so they take the exact loop.
        const int own = min(max(warp_r_first + 1 - c0, 0), c_cnt);
        const int right = min(max(warp_r_first + 32 - c0, 0), c_cnt);
        humid::check_columns<PAIRS>(row, s_cols, own, right, max_dist, emit);
        c_begin = (right + U - 1) / U * U;
      }
      humid::compare_columns<PAIRS>(row, s_cols, c_begin, c_cnt, max_dist,
                                    emit);
    }
    // Also the barrier after which s_cols may be staged again.
    s_hits.flush(counter, cap, out_keys);
  }
}

template <int W>
cudaError_t launch(const uint32_t* rows, const uint32_t* cols, int n_rows,
                   int n_cols, long long row_base, long long col_base,
                   long long u, int max_dist, int upper_only,
                   long long* out_keys, long long cap,
                   unsigned long long* counter, cudaStream_t stream) {
  const int row_blocks = (n_rows + THREADS - 1) / THREADS;
  // A small step still fills the card: halve the span (down to one
  // staged chunk) while the grid has fewer than MIN_BLOCKS blocks.
  int span = SPAN;
  while (span > COLS && row_blocks * ((n_cols + span - 1) / span) < MIN_BLOCKS)
    span /= 2;
  const dim3 grid(row_blocks, (n_cols + span - 1) / span);
  ring_sweep_kernel<W><<<grid, THREADS, 0, stream>>>(
      rows, cols, n_rows, n_cols, span, row_base, col_base, u, max_dist,
      upper_only, out_keys, cap, counter);
  return cudaGetLastError();
}

}  // namespace

// One ring step: appends the key min * u + max of every matching pair of
// rows x cols (global indices) to out_keys (the first `cap` of them,
// counting from *counter) and adds the number of matches to *counter.
// rows, cols: [b, w] uint32.  Launches nothing when no row or no column
// of the step lies below u.
extern "C" int humid_ring_sweep(const void* rows, const void* cols,
                                long long b, int w, long long row_base,
                                long long col_base, long long u,
                                int max_dist, int upper_only, void* out_keys,
                                long long cap, void* counter, void* stream) {
  if (b <= 0 || b > 65535LL * SPAN || row_base < 0 || col_base < 0 ||
      u >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_rows = valid_rows(row_base, u, (int)b);
  const int n_cols = valid_rows(col_base, u, (int)b);
  if (n_rows == 0 || n_cols == 0) return (int)cudaSuccess;
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  const uint32_t* c = static_cast<const uint32_t*>(cols);
  long long* keys = static_cast<long long*>(out_keys);
  unsigned long long* cnt = static_cast<unsigned long long*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_RING_CASE(W_)                                              \
  case W_:                                                               \
    return (int)launch<W_>(r, c, n_rows, n_cols, row_base, col_base, u,  \
                           max_dist, upper_only, keys, cap, cnt, s);
    HUMID_FOR_EACH_W(HUMID_RING_CASE)
#undef HUMID_RING_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

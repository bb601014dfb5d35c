// One step of the ring-rotated block compare on Hopper's int8 tensor
// cores (sm_90a).
//
// Replaces the TPU kernel humid_tpu/parallel/pallas_ring.py::_ring_kernel
// (K2).  There one kernel per shard runs the whole ring: at step s it
// matches its own block against block (me + s) mod d as one-hot matmuls
// while the copy of that block to the left neighbour is in flight (the
// rotating payload is the packed block, expanded to one-hots in VMEM),
// and returns per-(step, row) match counts and top-cap_row column lists
// that the host compacts.  Here the rotation is done outside the kernel
// (packed blocks copied on a second stream, ordered by events, and each
// encoded as it arrives by simplex_encode.cu: parallel/cuda_ring.py), and
// the kernel is one step of one shard:
//
//   rows is the shard's own block (global index row_base + r), cols the
//   block it received for this step (global index col_base + c), both
//   encoded tables [table_rows, K] of b words.  Every (r, c) with both
//   global indices < u, at most max_dist differing bases, and c > r when
//   upper_only (the step that compares a block with itself), is appended
//   as the key min * u + max of the two global indices to the shard's
//   int64 buffer.  One buffer and one 64-bit counter serve all steps of a
//   shard's ring; the counter keeps counting past the capacity, so the
//   caller can rerun the ring with the exact size.
//
// What the TPU kernel had and this one drops, as answers to TPU limits:
// the validity-by-zeroed-features trick (the mask here is by index, so
// max_dist may reach 16 * w), the lane-major 128-wide chunk layout, the
// 2,048-row VMEM streaming, the per-row top-K output with its cap_row
// retry ladder and ceiling, and the quantised block sizes that let
// compiled programs be reused.
//
// What bounds it on the card: the int8 tensor cores, as for the tile
// sweep (hamming_sweep.cu): 3 x 16 w multiply-adds a pair at 1,979 TOP/s,
// or, far below that, the two encoded blocks' bytes at 3.35 TB/s (at
// b = 44,699 and w = 2 a step is 2.0e9 pairs, 0.19 ms of products,
// against 8.6 MB, 2.6 us).  One ring step is the tile sweep's work over
// two tables.
//
// What the design does about it: it is the tile sweep's pipeline
// (tc_sweep.cuh: a persistent grid taking units from a work counter,
// TMA-staged row panels and column stages, two consumer warpgroups on
// wgmma.m64nNk32 s8 products, the distance test on the accumulators, the
// hit buffer) with this file's policy: rows come through the own block's
// tensor map and columns through the received block's, a row is valid
// while r < n_rows and a column while c < n_cols (the rows below u), only
// an upper_only step is a diagonal pair (sub-blocks and units at or below
// the diagonal skipped, c > r tested), and the key is min * u + max (a
// wrapped block, q < me, has col_base < row_base).  The step's one unit
// list is cut by the same plan(): at 44,699 rows, 88 row panels by 8
// spans.  Each launch takes its own zeroed work counter, so four shards'
// launches on four streams of one card share nothing; a launch's CTAs
// wait only on their own barriers, so none waits on another's.
//
// Left for later work: two products in flight per warpgroup, TMA
// multicast of the column stages to a cluster, stores to a peer card
// from inside the kernel in place of the copies, and a CUDA graph
// around the ring's launches.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "tc_sweep.cuh"

namespace {

struct RingStep : tc::Launch {
  long long row_base, col_base, u;  // global indices
  int n_rows, n_cols;               // rows of each block below u
  int upper_only;

  // The step is one pair of tiles: the whole of both tables.
  __device__ __forceinline__ bool tile_pair(long long, tc::TilePair& t,
                                            bool) const {
    t.row_base = t.col_base = 0;
    t.n_rows = n_rows;
    t.n_cols = n_cols;
    t.diag = upper_only != 0;
    return true;
  }

  __device__ __forceinline__ void emit(const tc::Unit&, int r, int c,
                                       tc::HitBuffer& buf) const {
    const long long ga = row_base + r, gb = col_base + c;
    buf.add(min(ga, gb) * u + max(ga, gb), counter, cap, out_keys);
  }
};

// Rows of a block of b rows starting at global index `base` that lie
// below u.
int valid_rows(long long base, long long u, long long b) {
  const long long n = u - base;
  return n <= 0 ? 0 : (int)(n < b ? n : b);
}

template <int W>
__global__ void __launch_bounds__(tc::THREADS, 1)
    ring_sweep_kernel(const __grid_constant__ CUtensorMap rows,
                      const __grid_constant__ CUtensorMap cols,
                      const __grid_constant__ RingStep a) {
  tc::sweep<W>(&rows, &cols, a);
}

template <int W>
cudaError_t launch(const void* rows, const void* cols, long long table_rows,
                   RingStep a, cudaStream_t stream) {
  using G = tc::Geometry<W>;
  CUtensorMap rows_map, cols_map;
  cudaError_t err = tc::table_map(&rows_map, rows, table_rows, G::K);
  if (err == cudaSuccess)
    err = tc::table_map(&cols_map, cols, table_rows, G::K);
  if (err != cudaSuccess) return err;
  a.sched = tc::plan<W>(1, a.n_rows, a.n_cols);
  static int sms_of[tc::MAX_DEVICES];
  unsigned blocks = 0;
  err = tc::persistent_grid(
      sms_of, reinterpret_cast<const void*>(ring_sweep_kernel<W>), G::SMEM,
      a.sched.units, blocks);
  if (err != cudaSuccess) return err;
  ring_sweep_kernel<W><<<blocks, tc::THREADS, G::SMEM, stream>>>(
      rows_map, cols_map, a);
  return cudaGetLastError();
}

}  // namespace

// One ring step: appends the key min * u + max of every matching pair of
// rows x cols (global indices) to out_keys (the first `cap` of them,
// counting from *counter) and adds the number of matches to *counter.
// rows, cols: [table_rows, k] int8, the encoded blocks of b words each
// (table_rows a multiple of 64, at least b; k = 48 w rounded up to a
// multiple of 32); a pair matches iff the product of its two rows is at
// least min_acc; work: 1 uint64, zero (the CTAs take their units from
// it).  Launches nothing when no row or no column of the step lies below
// u.
extern "C" int humid_ring_sweep(const void* rows, const void* cols,
                                long long table_rows, int k, long long b,
                                int w, long long row_base,
                                long long col_base, long long u,
                                int min_acc, int upper_only, void* out_keys,
                                long long cap, void* counter, void* work,
                                void* stream) {
  if (b <= 0 || row_base < 0 || col_base < 0 || u >= (1LL << 31) ||
      w < 1 || k != (48 * w + tc::KSTEP - 1) / tc::KSTEP * tc::KSTEP ||
      table_rows < b || table_rows % tc::BOX_ROWS != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cols) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  RingStep a{};
  a.n_rows = valid_rows(row_base, u, b);
  a.n_cols = valid_rows(col_base, u, b);
  if (a.n_rows == 0 || a.n_cols == 0) return (int)cudaSuccess;
  a.row_base = row_base;
  a.col_base = col_base;
  a.u = u;
  a.upper_only = upper_only;
  a.min_acc = min_acc;
  a.out_keys = static_cast<long long*>(out_keys);
  a.cap = cap;
  a.counter = static_cast<unsigned long long*>(counter);
  a.work = static_cast<unsigned long long*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_RING_CASE(W_) \
  case W_:                  \
    return (int)launch<W_>(rows, cols, table_rows, a, s);
    HUMID_FOR_EACH_W(HUMID_RING_CASE)
#undef HUMID_RING_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

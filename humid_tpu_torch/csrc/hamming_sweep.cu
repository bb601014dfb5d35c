// Hamming tile sweep over 2-bit packed words, for Hopper (sm_90a).
//
// Replaces the TPU kernel humid_tpu/ops/pallas_hamming.py::_kernel (K1),
// which matches one-hot expanded tiles on the MXU and extracts per-row
// top-k column lists that an XLA epilogue compacts into pairs.  Here the
// same pair set comes straight out of the kernel:
//
//   for every tile pair (ti, tj, on) of a list with 0 <= ti <= tj,
//   every row r of tile ti and column c of tile tj with at most max_dist
//   differing bases, both rows valid (index < n_rows and
//   index % part_stride < part_valid), c > r when ti == tj (upper
//   triangle of a diagonal tile pair), and, when a run-id vector is
//   given, ids[r] == ids[c], is appended as the key r * n_rows + c to a
//   global int64 buffer.  A tile pair with ti < 0 or tj < ti emits
//   nothing and raises the flag in the second counter word.
//
// What bounds it on the card: the POPC unit (16 a clock on an SM, a
// quarter of the other integer operations' rate).  In the bit-plane form
// of hamming_common.cuh a pair costs ceil(w / 2) POPC, with one XOR and
// one LOP3 each, and one compare: at w = 2 one POPC and three integer
// operations, so POPC (1/16 clock a pair) stays ahead of the integer unit
// (3/64).  Memory traffic is nothing beside it: a column word is staged
// once per 256 evaluations or more.  With no pair passing, the loop runs
// at 14 of the 16 POPC a clock; what is lost beyond that goes to the
// pairs that pass (the group gone over again, the appends) and, on small
// inputs, to the last blocks finishing alone (PERF.md).
//
// What the design does about it:
// * Rows and columns are compared as bit planes; a thread converts its
//   row once, a block converts the columns as it stages them.
// * The inner loop (humid::compare_columns) fetches a group of columns
//   with 16-byte shared-memory loads (all threads the same address: a
//   broadcast) and tests the distance only, with one branch per group;
//   validity of a ragged row, the triangle, the padded columns and the
//   run ids are looked at for the few pairs that pass.  A thread holds
//   one row: more measured slower (hamming_common.cuh).
// * The work list is one grid dimension over (tile pair, row block,
//   column span) units of nearly equal weight, so blocks finish together
//   whatever the mix of diagonal and full tile pairs, and the number of
//   tile pairs has no limit; the span is halved until the list has
//   MIN_UNITS units.  A unit of a diagonal tile pair that lies wholly at
//   or below the diagonal returns at once.  Inside a unit a warp skips
//   the columns left of its first row and takes its own 32 columns,
//   where every thread is at distance 0 from itself, through the exact
//   loop (humid::check_columns): nothing of the lower triangle is
//   compared in the fast loop.
// * When part_stride is a multiple of the tile (every caller's case) the
//   valid rows of a tile are a prefix, computed once per block; only
//   valid columns are staged.  Any other stride stages every column
//   below n_rows and tests the index of a passing pair instead.
// * Matches go to the block's buffer in shared memory and from there to
//   the global array with one atomicAdd per block and chunk
//   (humid::HitBuffer): a global atomicAdd per match made every warp
//   wait a memory round trip per match and cost a third of the time.
//   The counter keeps counting past the buffer's capacity, so the caller
//   can relaunch with the exact size.
// The one-hot tensor-core form and TMA or cp.async staging are left for
// later work.  A persistent grid whose blocks take units from an atomic
// counter measured slower than this list under the hardware's block
// scheduler: fetching a unit stalls the whole block.
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "hamming_common.cuh"

namespace {

constexpr int THREADS = 256;  // threads per block (fewer for a small tile)
// The two sizes below measured best on the H100 (PERF.md).
constexpr int COLS = 256;  // columns staged per step
// The column span of a unit is halved while the list is shorter than this.
constexpr int MIN_UNITS = 2048;

struct SweepArgs {
  const uint32_t* lanes;
  long long n_rows;
  const int* ids;  // NULL: no run-id mask
  const int* tile_pairs;
  int tile;
  int span;          // columns per unit, a multiple of COLS
  int row_blocks;    // per tile
  int spans;         // per tile
  long long part_stride;
  long long part_valid;
  int prefix;        // part_stride % tile == 0: valid rows are a prefix
  int max_dist;
  long long* out_keys;
  long long cap;
  unsigned long long* counter;  // [0] matches, [1] bad-tile-pair flag
};

__device__ __forceinline__ bool word_valid(long long g, const SweepArgs& a) {
  return g < a.n_rows && (g % a.part_stride) < a.part_valid;
}

// Rows of tile t to look at: the valid ones when they are a prefix, else
// all below n_rows (their validity is then tested one by one).
__device__ __forceinline__ int tile_rows(int t, const SweepArgs& a) {
  const long long base = (long long)t * a.tile;
  long long n = min((long long)a.tile, a.n_rows - base);
  if (a.prefix) n = min(n, a.part_valid - base % a.part_stride);
  return (int)max(n, 0LL);
}

template <int W>
__global__ void __launch_bounds__(THREADS) hamming_sweep_kernel(SweepArgs a) {
  constexpr int PAIRS = humid::plane_pairs(W), PW = 2 * PAIRS;
  constexpr int U = humid::group_cols(PW);
  __shared__ __align__(16) uint32_t s_cols[COLS * PW];
  __shared__ humid::HitBuffer s_hits;

  const int units = a.row_blocks * a.spans;
  const int* p = a.tile_pairs + 3LL * (blockIdx.x / units);
  const int ti = p[0], tj = p[1];
  if (ti < 0 || tj < ti) {  // uniform over the block
    if (threadIdx.x == 0) a.counter[1] = 1ULL;
    return;
  }
  if (p[2] == 0) return;  // disabled tile pair
  const bool diag = ti == tj;
  const int unit = blockIdx.x % units;
  const int row0 = (unit / a.spans) * blockDim.x;
  const int n_rows_t = tile_rows(ti, a);
  const int span_end = min((unit % a.spans + 1) * a.span, tile_rows(tj, a));
  int c_first = (unit % a.spans) * a.span;
  // On a diagonal tile pair no column at or below row0 can match.
  if (diag) c_first = max(c_first, (row0 + 1) / COLS * COLS);
  if (row0 >= n_rows_t || c_first >= span_end) return;

  const long long row_base = (long long)ti * a.tile;
  const long long col_base = (long long)tj * a.tile;
  const int r = row0 + threadIdx.x;  // this thread's row
  const long long gr = row_base + r;
  const bool row_ok = r < n_rows_t && (a.prefix || word_valid(gr, a));
  uint32_t row[PW];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    row[2 * q] = row[2 * q + 1] = 0u;
    if (row_ok)
      humid::load_plane_pair<W>(a.lanes + gr * W, q, row[2 * q],
                                row[2 * q + 1]);
  }
  const bool warp_has_rows = __any_sync(0xffffffffu, row_ok);
  const int warp_r_first = row0 + (threadIdx.x & ~31);

  if (threadIdx.x == 0) s_hits.reset();
  for (int c0 = c_first; c0 < span_end; c0 += COLS) {
    const int c_cnt = min(COLS, span_end - c0);
    humid::stage_columns<W>(s_cols, a.lanes + (col_base + c0) * W, c_cnt);
    __syncthreads();
    if (warp_has_rows) {
      const auto emit = [&](int c) {
        const int cl = c0 + c;
        if (c >= c_cnt || !row_ok || (diag && cl <= r)) return;
        const long long gc = col_base + cl;
        if (!a.prefix && !word_valid(gc, a)) return;
        if (a.ids != nullptr && a.ids[gr] != a.ids[gc]) return;
        s_hits.add(gr * a.n_rows + gc, a.counter, a.cap, a.out_keys);
      };
      int c_begin = 0;
      if (diag) {
        // Columns left of the warp's first row pair with none of its
        // rows; the next 32, its own, with some: every thread is at
        // distance 0 from itself there, so they take the exact loop.
        const int own = min(max(warp_r_first + 1 - c0, 0), c_cnt);
        const int right = min(max(warp_r_first + 32 - c0, 0), c_cnt);
        humid::check_columns<PAIRS>(row, s_cols, own, right, a.max_dist,
                                    emit);
        c_begin = (right + U - 1) / U * U;
      }
      humid::compare_columns<PAIRS>(row, s_cols, c_begin, c_cnt, a.max_dist,
                                    emit);
    }
    // Also the barrier after which s_cols may be staged again.
    s_hits.flush(a.counter, a.cap, a.out_keys);
  }
}

template <int W>
cudaError_t launch(SweepArgs a, long long nb, cudaStream_t stream) {
  // A tile below THREADS rows gets a smaller block, not idle warps.
  const int threads = min(THREADS, (a.tile + 31) / 32 * 32);
  a.row_blocks = (a.tile + threads - 1) / threads;
  // Halve the column span until the list has MIN_UNITS units (or a span
  // is one staged chunk): small lists still fill the card.
  a.span = (a.tile + COLS - 1) / COLS * COLS;
  while (a.span > COLS &&
         nb * a.row_blocks * ((a.tile + a.span - 1) / a.span) < MIN_UNITS)
    a.span = (a.span / 2 + COLS - 1) / COLS * COLS;
  a.spans = (a.tile + a.span - 1) / a.span;
  const long long blocks = nb * a.row_blocks * a.spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hamming_sweep_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Appends the key a * n_rows + b of every matching (row a, col b) of the
// nb tile pairs to out_keys (the first `cap` of them), adds the number of
// matches to counter[0] and sets counter[1] if a tile pair is out of
// order or negative.  lanes: [n_rows, w] uint32; ids: [n_rows] int32 run
// ids or NULL (no mask); tile_pairs: [nb, 3] int32 (ti, tj, on);
// counter: 2 uint64.
extern "C" int humid_hamming_sweep(const void* lanes, long long n_rows,
                                   int w, const void* ids,
                                   const void* tile_pairs, long long nb,
                                   int tile, long long part_stride,
                                   long long part_valid, int max_dist,
                                   void* out_keys, long long cap,
                                   void* counter, void* stream) {
  if (nb == 0) return (int)cudaSuccess;
  if (nb < 0 || tile <= 0 || part_stride <= 0 || n_rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  SweepArgs a{};
  a.lanes = static_cast<const uint32_t*>(lanes);
  a.n_rows = n_rows;
  a.ids = static_cast<const int*>(ids);
  a.tile_pairs = static_cast<const int*>(tile_pairs);
  a.tile = tile;
  a.part_stride = part_stride;
  a.part_valid = part_valid;
  a.prefix = part_stride % tile == 0;
  a.max_dist = max_dist;
  a.out_keys = static_cast<long long*>(out_keys);
  a.cap = cap;
  a.counter = static_cast<unsigned long long*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_SWEEP_CASE(W_) \
  case W_:                   \
    return (int)launch<W_>(a, nb, s);
    HUMID_FOR_EACH_W(HUMID_SWEEP_CASE)
#undef HUMID_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

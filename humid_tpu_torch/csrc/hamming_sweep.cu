// Hamming tile sweep on Hopper's int8 tensor cores (sm_90a).
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
// It reads one encoded table (the simplex form of tc_sweep.cuh, made by
// the wrapper's pre-pass, simplex_encode.cu) through one tensor map for
// both sides, and runs the pipeline of tc_sweep.cuh with this file's
// policy: a unit's tile pair comes from the list, rows are tested for
// validity (only where part_stride is not a multiple of the tile, else
// the valid rows are a prefix of each tile) and run ids, and the key is
// r * n_rows + c.
//
// What bounds it on the card: the int8 tensor cores, 3 x 16 w
// multiply-adds a pair (1,979 TOP/s on an H100 SXM; at w = 2 a pair is 96
// multiply-adds, K = 96 bytes: 3 k-steps).  A product this short is
// followed at once by its epilogue, so what the design has to keep small
// is everything between two products (tc_sweep.cuh says how); bytes are
// second (a column tile is read once per panel, from L2 where the table
// fits).  A product's accumulators are read right after it ends: two
// products in flight per warpgroup (double-buffered accumulators) and TMA
// multicast of the column tiles to a cluster are left for later work
// (tools/k1_variants.py times this design's other choices).
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include "tc_sweep.cuh"

namespace {

using tc::KSTEP;

struct SweepArgs : tc::Launch {
  long long n_rows;
  const int* ids;  // NULL: no run-id mask
  const int* tile_pairs;
  int tile;
  long long part_stride;
  long long part_valid;
  int prefix;  // part_stride % tile == 0: valid rows are a prefix

  __device__ __forceinline__ bool word_valid(long long g) const {
    return g < n_rows && (g % part_stride) < part_valid;
  }

  // Rows of tile t to look at: the valid ones when they are a prefix,
  // else all below n_rows (their validity is then tested one by one).
  __device__ __forceinline__ int tile_rows(int t) const {
    const long long base = (long long)t * tile;
    long long n = min((long long)tile, n_rows - base);
    if (prefix) n = min(n, part_valid - base % part_stride);
    return (int)max(n, 0LL);
  }

  // Tile pair i of the list; false for a disabled or bad one (a bad one
  // sets the flag when `flag` is set).
  __device__ __forceinline__ bool tile_pair(long long i, tc::TilePair& t,
                                            bool flag) const {
    const int* p = tile_pairs + 3 * i;
    const int ti = p[0], tj = p[1];
    if (ti < 0 || tj < ti) {
      if (flag) counter[1] = 1ULL;
      return false;
    }
    if (p[2] == 0) return false;  // disabled tile pair
    t.diag = ti == tj;
    t.n_rows = tile_rows(ti);
    t.n_cols = tile_rows(tj);
    t.row_base = (long long)ti * tile;
    t.col_base = (long long)tj * tile;
    return true;
  }

  __device__ __forceinline__ void emit(const tc::Unit& x, int r, int c,
                                       tc::HitBuffer& buf) const {
    const long long gr = x.row_base + r, gc = x.col_base + c;
    if (!prefix && !(word_valid(gr) && word_valid(gc))) return;
    if (ids != nullptr && ids[gr] != ids[gc]) return;
    buf.add(gr * n_rows + gc, counter, cap, out_keys);
  }
};

// The arguments by value: as a __grid_constant__ parameter they cost the
// w <= 2 instances a 24-28 byte register spill and 1-3% of their time on
// the H100 (PERF.md §6).
template <int W>
__global__ void __launch_bounds__(tc::THREADS, 1)
    hamming_sweep_kernel(const __grid_constant__ CUtensorMap table,
                         SweepArgs a) {
  tc::sweep<W>(&table, &table, a);
}

// The same with 128-column products (launch() takes it for short lists).
template <int W>
__global__ void __launch_bounds__(tc::THREADS, 1)
    hamming_sweep_narrow_kernel(const __grid_constant__ CUtensorMap table,
                                SweepArgs a) {
  tc::sweep<W, true>(&table, &table, a);
}

template <int W, bool NARROW>
cudaError_t launch_as(const void* table, long long table_rows, SweepArgs a,
                      long long nb, cudaStream_t stream) {
  using G = tc::Geometry<W, NARROW>;
  CUtensorMap map;
  cudaError_t err = tc::table_map(&map, table, table_rows, G::K);
  if (err != cudaSuccess) return err;
  a.sched = tc::plan<W, NARROW>(nb, a.tile, a.tile);
  auto kernel = hamming_sweep_kernel<W>;
  if constexpr (NARROW) kernel = hamming_sweep_narrow_kernel<W>;
  static int sms_of[tc::MAX_DEVICES];
  unsigned blocks = 0;
  err = tc::persistent_grid(sms_of, reinterpret_cast<const void*>(kernel),
                            G::SMEM, a.sched.units, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, tc::THREADS, G::SMEM, stream>>>(map, a);
  return cudaGetLastError();
}

// A list too short for MIN_UNITS units of 256-column products (w <= 2)
// takes 128-column ones: twice the units over the SMs, half the
// accumulators a thread (measured faster at ids_shard0, slower on long
// lists: PERF.md §6).
template <int W>
cudaError_t launch(const void* table, long long table_rows, SweepArgs a,
                   long long nb, cudaStream_t stream) {
  if constexpr (tc::Geometry<W, true>::BN != tc::Geometry<W>::BN) {
    if (tc::plan<W>(nb, a.tile, a.tile).units < tc::MIN_UNITS)
      return launch_as<W, true>(table, table_rows, a, nb, stream);
  }
  return launch_as<W, false>(table, table_rows, a, nb, stream);
}

}  // namespace

// Bytes of a word in the encoded table for w lanes (48 w rounded up to a
// multiple of 32); the wrapper's table must have this width.
extern "C" int humid_hamming_table_width(int w) {
  return (48 * w + KSTEP - 1) / KSTEP * KSTEP;
}

// Appends the key a * n_rows + b of every matching (row a, col b) of the
// nb tile pairs to out_keys (the first `cap` of them), adds the number of
// matches to counter[0] and sets counter[1] if a tile pair is out of
// order or negative.  table: [table_rows, k] int8, the encoded words
// (rows from n_rows on zero, table_rows a multiple of 64, k =
// humid_hamming_table_width(w)); a pair matches iff the product of its
// two rows is at least min_acc; ids: [n_rows] int32 run ids or NULL (no
// mask); tile_pairs: [nb, 3] int32 (ti, tj, on); counter: 2 uint64; work:
// 1 uint64, zero (the CTAs take their units from it).
extern "C" int humid_hamming_sweep(const void* table, long long table_rows,
                                   int k, long long n_rows, int w,
                                   const void* ids, const void* tile_pairs,
                                   long long nb, int tile,
                                   long long part_stride,
                                   long long part_valid, int min_acc,
                                   void* out_keys, long long cap,
                                   void* counter, void* work, void* stream) {
  if (nb == 0) return (int)cudaSuccess;
  if (nb < 0 || tile <= 0 || part_stride <= 0 || n_rows >= (1LL << 31) ||
      w < 1 || k != humid_hamming_table_width(w) || table_rows < n_rows ||
      table_rows % tc::BOX_ROWS != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  SweepArgs a{};
  a.n_rows = n_rows;
  a.ids = static_cast<const int*>(ids);
  a.tile_pairs = static_cast<const int*>(tile_pairs);
  a.tile = tile;
  a.part_stride = part_stride;
  a.part_valid = part_valid;
  a.prefix = part_stride % tile == 0;
  a.min_acc = min_acc;
  a.out_keys = static_cast<long long*>(out_keys);
  a.cap = cap;
  a.counter = static_cast<unsigned long long*>(counter);
  a.work = static_cast<unsigned long long*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define HUMID_SWEEP_CASE(W_) \
  case W_:                   \
    return (int)launch<W_>(table, table_rows, a, nb, s);
    HUMID_FOR_EACH_W(HUMID_SWEEP_CASE)
#undef HUMID_SWEEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

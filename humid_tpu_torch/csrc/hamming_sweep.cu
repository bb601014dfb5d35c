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
// The encoding (ops/cuda_hamming.py::encode_table, the wrapper's plain
// pre-pass).  Each of a word's 16 w base slots becomes 3 int8 channels of
// +-1, A = (1,1,1), C = (1,-1,-1), G = (-1,1,-1), T = (-1,-1,1): the dot
// product of two slots is 3 when the bases are equal and -1 when not, so
// the product of two words is acc = 4 matches - 16 w, and a pair is
// within max_dist iff acc >= 48 w - 4 max_dist (the wrapper passes that
// threshold, min_acc).  Padding slots hold A in every word and count as
// matches on both sides.  K = 48 w bytes a word, zero-padded to a
// multiple of 32 (one wgmma k-step), in a [rows, K] table whose rows are
// zero past n_rows up to a multiple of 64.  No exact form has fewer
// channels (a +-1 Gram matrix a I + b J of four bases has rank 3); the
// one-hot form takes 4.
//
// What bounds it on the card: the int8 tensor cores, 3 x 16 w
// multiply-adds a pair (1,979 TOP/s on an H100 SXM; at w = 2 a pair is 96
// multiply-adds, K = 96 bytes: 3 k-steps).  A product this short is
// followed at once by its epilogue, so what the design has to keep small
// is everything between two products; bytes are second (a column tile is
// read once per panel of P rows, from L2 where the table fits).
//
// What the design does about it:
// * The work list is (tile pair, row panel of P rows, column span) units,
//   the span halved until there are MIN_UNITS of them, so the number of
//   tile pairs has no limit.  The grid is persistent, one CTA an SM; the
//   producer takes each next unit from the launch's work counter (an
//   atomicAdd one unit ahead of the consumers), so CTAs stay busy however
//   unequal the units are (diagonal tile pairs, ragged tiles).  A unit of
//   a diagonal tile pair that lies wholly at or below the diagonal is
//   skipped there.
// * Warp-specialised: one producer thread issues the TMA loads, a row
//   panel per unit into one of PANELS buffers (the next unit's panel
//   loads while this one computes) and the span's columns in tiles of BN
//   through a ring of STAGES shared-memory stages; "full" mbarriers count
//   the bytes in, "empty" ones the consumers' release.  Its warpgroup
//   hands its registers to the consumers (setmaxnreg), whose accumulators
//   need them.
// * Two consumer warpgroups take the panel's 64-row sub-blocks in turn:
//   per stage and sub-block, KS wgmma.m64nBNk32 s8 products into BN / 2
//   int32 accumulators a thread (BN = 256 at w <= 2: a 64 x 256 block of
//   distances), then the epilogue on the registers while the other
//   warpgroup's product occupies the tensor cores.  A sub-block wholly at
//   or below the diagonal, or past the tile's rows, is skipped.
// * The epilogue: each thread reduces its fragment to the largest of each
//   group of 8 accumulators and of all (__vimax3_s32, half an operation a
//   pair) and branches once; only in a group with a pass are the
//   accumulators turned into bits, and only the set bits are mapped to
//   their (row, column) by the wgmma fragment layout and tested for
//   validity, the triangle and the run ids.  The match matrix never
//   leaves the registers.
// * Matches go to the warpgroup's buffer in shared memory and from there
//   to the global array with one atomicAdd per flush (humid::HitBuffer,
//   flushed over the warpgroup's 128 threads once it is half full, and
//   when the CTA's units are done: an atomic on the one global counter
//   every stage cost as much as the stage).  The counter keeps counting
//   past the buffer's capacity, so the caller can relaunch with the
//   exact size.
// A product's accumulators are read right after it ends: two products
// in flight per warpgroup (double-buffered accumulators) and TMA
// multicast of the column tiles to a cluster are left for later work
// (tools/k1_variants.py times this design's other choices).
//
// The kernel allocates nothing and launches on the caller's stream.  The
// C entry point returns cudaGetLastError() after the launch.

#include <dlfcn.h>

#include "hamming_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 256;  // two warpgroups
// and a producer warpgroup, of which one warp (one thread) issues the
// loads: the group exists to hand its registers to the consumers
// (setmaxnreg moves registers within the CTA, 128 x (168 - 40) of them
// here, which is what 256 x (232 - 168) takes).
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MIN_UNITS = 512;  // the span is halved while fewer units
constexpr int BOX_ROWS = 64;     // rows of one TMA box (a 2 KB tile)
constexpr int KSTEP = 32;        // bytes of K per wgmma (m64nNk32, int8)
constexpr int SMEM_LIMIT = 225 * 1024;  // one CTA an SM

// Sizes per lane count W, fixed at compile time: the widest product the
// registers take (BN columns, BN / 2 accumulators a thread), then as many
// 64-row sub-blocks, row panels (2: the next unit's loads while this one
// computes) and column stages as shared memory holds.
template <int W>
struct Geometry {
  static constexpr int K = (48 * W + KSTEP - 1) / KSTEP * KSTEP;
  static constexpr int KS = K / KSTEP;  // k-steps a product
  static constexpr int BN = K <= 96 ? 256 : K <= 192 ? 128 : 64;
  static constexpr int FIXED = 2 * (int)sizeof(humid::HitBuffer) +
                               1024 /* alignment */ + 256 /* barriers */;
  static constexpr int bytes(int sub, int panels, int stages) {
    return panels * 64 * sub * K + stages * BN * K + FIXED;
  }
  static constexpr int SUB = bytes(8, 2, 4) <= SMEM_LIMIT   ? 8
                             : bytes(4, 2, 4) <= SMEM_LIMIT ? 4
                                                            : 2;
  static constexpr int PANELS = bytes(SUB, 2, 3) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int STAGES = bytes(SUB, PANELS, 4) <= SMEM_LIMIT   ? 4
                                : bytes(SUB, PANELS, 3) <= SMEM_LIMIT ? 3
                                                                      : 2;
  static constexpr int P = 64 * SUB;  // rows of a panel
  static constexpr int PANEL = P * K;
  static constexpr int STAGE = BN * K;
  static constexpr int SMEM = bytes(SUB, PANELS, STAGES);
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

struct SweepArgs {
  long long n_rows;
  const int* ids;  // NULL: no run-id mask
  const int* tile_pairs;
  long long units;  // tile pairs x row_blocks x spans
  int tile;
  int span;        // columns per unit, a multiple of BN
  int row_blocks;  // panels per tile
  int spans;       // per tile
  long long part_stride;
  long long part_valid;
  int prefix;      // part_stride % tile == 0: valid rows are a prefix
  int min_acc;     // a pair passes iff its product is >= min_acc
  long long* out_keys;
  long long cap;
  unsigned long long* counter;  // [0] matches, [1] bad-tile-pair flag
  unsigned long long* work;     // units handed out so far (zero at launch)
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

// One unit of the work list: a row panel of a tile pair against a span of
// its columns.
struct Unit {
  long long row_base, col_base;  // first global row of the two tiles
  int row0;                      // the panel's first row in tile ti
  int n_rows_t;                  // rows of tile ti to look at
  int c_first, span_end;         // its columns in tile tj
  int n_stages;
  bool diag;
};

// Decodes unit u; false when it has nothing to compare (a disabled or bad
// tile pair, no row, or on a diagonal tile pair nothing above it).  A bad
// tile pair sets the flag when `flag` is set.
template <int W>
__device__ __forceinline__ bool decode(long long u, const SweepArgs& a,
                                       Unit& x, bool flag) {
  using G = Geometry<W>;
  const long long per_pair = (long long)a.row_blocks * a.spans;
  const int* p = a.tile_pairs + 3 * (u / per_pair);
  const int ti = p[0], tj = p[1];
  if (ti < 0 || tj < ti) {
    if (flag) a.counter[1] = 1ULL;
    return false;
  }
  if (p[2] == 0) return false;  // disabled tile pair
  const int unit = (int)(u % per_pair);
  x.diag = ti == tj;
  x.row0 = (unit / a.spans) * G::P;
  x.n_rows_t = tile_rows(ti, a);
  x.span_end = min((unit % a.spans + 1) * a.span, tile_rows(tj, a));
  x.c_first = (unit % a.spans) * a.span;
  // On a diagonal tile pair no column at or below row0 can match.
  if (x.diag) x.c_first = max(x.c_first, (x.row0 + 1) / G::BN * G::BN);
  if (x.row0 >= x.n_rows_t || x.c_first >= x.span_end) return false;
  x.n_stages = (x.span_end - x.c_first + G::BN - 1) / G::BN;
  x.row_base = (long long)ti * a.tile;
  x.col_base = (long long)tj * a.tile;
  return true;
}

// The largest of each group of 8 accumulators (__vimax3_s32: half an
// operation an accumulator) into gm, and the largest of all.
template <int R>
__device__ __forceinline__ int group_max(const int (&d)[R],
                                         int (&gm)[R / 8]) {
#pragma unroll
  for (int g = 0; g < R / 8; ++g) {
    const int* x = d + 8 * g;
    gm[g] = max(__vimax3_s32(__vimax3_s32(__vimax3_s32(x[0], x[1], x[2]),
                                          x[3], x[4]),
                             x[5], x[6]),
                x[7]);
  }
  int m = gm[0];
#pragma unroll
  for (int g = 1; g + 1 < R / 8; g += 2) m = __vimax3_s32(m, gm[g], gm[g + 1]);
  return max(m, gm[R / 8 - 1]);
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
    hamming_sweep_kernel(const __grid_constant__ CUtensorMap table,
                         SweepArgs a) {
  using G = Geometry<W>;
  constexpr int BN = G::BN, KS = G::KS, STAGES = G::STAGES;
  constexpr int PANELS = G::PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* panels = smem;  // [PANELS][SUB][KS][64 rows][32 bytes]
  uint8_t* stages = smem + PANELS * G::PANEL;  // [STAGES][KS][BN][32]
  humid::HitBuffer* hits =  // one per consumer warpgroup
      reinterpret_cast<humid::HitBuffer*>(stages + STAGES * G::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(hits + 2);
  uint64_t* empty = full + STAGES;
  uint64_t* panel_full = empty + STAGES;
  uint64_t* panel_empty = panel_full + PANELS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < PANELS; ++s) {
      hopper::mbar_init(&panel_full[s], 1);
      hopper::mbar_init(&panel_empty[s], CONSUMERS);
    }
    hits[0].reset();
    hits[1].reset();
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // A persistent grid.  The producer thread takes the next unit from the
  // launch's work counter (one atomicAdd, a unit ahead of the consumers),
  // skips the units with nothing to compare, and hands each unit's index
  // to the consumers beside its row panel: slot j % PANELS holds panel j
  // and its unit (-1: no more units).  Stage i of the CTA (counted over
  // all its units) uses ring slot i % STAGES.
  __shared__ long long unit_of[PANELS];
  if (threadIdx.x >= CONSUMERS) {  // the producer: one thread loads
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    int stage = 0, panel = 0;
    for (;;) {
      const long long u = (long long)atomicAdd(a.work, 1ULL);
      Unit x;
      if (u < a.units && !decode<W>(u, a, x, true)) continue;
      const int pb = panel % PANELS;
      hopper::mbar_wait(&panel_empty[pb], ((panel / PANELS) & 1) ^ 1);
      if (u >= a.units) {
        unit_of[pb] = -1;
        hopper::mbar_arrive(&panel_full[pb]);
        return;
      }
      unit_of[pb] = u;
      hopper::mbar_arrive_expect_tx(&panel_full[pb], G::PANEL);
      uint8_t* rows = panels + pb * G::PANEL;
      for (int s = 0; s < G::SUB; ++s)
        for (int k = 0; k < KS; ++k)
          hopper::tma_load_2d(rows + (s * KS + k) * (BOX_ROWS * KSTEP),
                              &table, k * KSTEP,
                              (int)(x.row_base + x.row0 + s * BOX_ROWS),
                              &panel_full[pb]);
      ++panel;
      for (int i = 0; i < x.n_stages; ++i, ++stage) {
        const int st = stage % STAGES;
        hopper::mbar_wait(&empty[st], ((stage / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], G::STAGE);
        uint8_t* dst = stages + st * G::STAGE;
        const int c0 = x.c_first + i * BN;
        for (int k = 0; k < KS; ++k)
          for (int h = 0; h < BN / BOX_ROWS; ++h)
            hopper::tma_load_2d(dst + (k * BN + h * BOX_ROWS) * KSTEP,
                                &table, k * KSTEP,
                                (int)(x.col_base + c0 + h * BOX_ROWS),
                                &full[st]);
      }
    }
  }

  // The consumer warpgroups.
  constexpr int R = BN / 2;  // accumulators a thread
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int r_frag = (t / 32) * 16 + (t % 32) / 4;  // fragment's first row
  const int c_frag = 2 * (t % 4);                    // and first column
  humid::HitBuffer& buf = hits[wg];
  const auto wg_sync = [wg] { hopper::named_sync(1 + wg, 128); };
  const int min_acc = a.min_acc;
  int stage = 0;
  for (int panel = 0;; ++panel) {
    const int pb = panel % PANELS;
    hopper::mbar_wait(&panel_full[pb], (panel / PANELS) & 1);
    const long long u = unit_of[pb];
    if (u < 0) {  // no more units: the warpgroup's last keys go out
      buf.flush(a.counter, a.cap, a.out_keys, t, 128, wg_sync);
      return;
    }
    Unit x;
    decode<W>(u, a, x, false);
    const uint8_t* rows = panels + pb * G::PANEL;
    for (int i = 0; i < x.n_stages; ++i, ++stage) {
      const int st = stage % STAGES;
      const int c0 = x.c_first + i * BN;
      const uint8_t* cols = stages + st * G::STAGE;
      hopper::mbar_wait(&full[st], (stage / STAGES) & 1);
      for (int s = wg; s < G::SUB; s += 2) {
        const int sr = x.row0 + s * 64;  // the sub-block's first row
        // Uniform over the warpgroup: no row, or every pair at or below
        // the diagonal.
        if (sr >= x.n_rows_t || (x.diag && c0 + BN - 1 <= sr)) continue;
        int acc[R];
        __syncwarp();  // the warpgroup's product needs converged warps
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < KS; ++k)
          hopper::wgmma_s8<BN>(
              acc,
              hopper::desc_sw32(rows + (s * KS + k) * (BOX_ROWS * KSTEP)),
              hopper::desc_sw32(cols + k * BN * KSTEP), k);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_operands(acc);
        int gm[R / 8];
        if (group_max(acc, gm) < min_acc) continue;  // one branch a fragment
        // A pass: the passing accumulators of the groups with one, as
        // bits, then each in turn.
        uint32_t bits[R / 32];
#pragma unroll
        for (int g = 0; g < R / 8; ++g) {
          if (g % 4 == 0) bits[g / 4] = 0u;
          if (gm[g] < min_acc) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            bits[g / 4] |= (uint32_t)(acc[8 * g + e] >= min_acc)
                           << (8 * (g % 4) + e);
        }
#pragma unroll
        for (int q = 0; q < R / 32; ++q) {
          for (uint32_t m = bits[q]; m != 0u; m &= m - 1u) {
            const int j = 32 * q + __ffs(m) - 1;
            const int r = sr + r_frag + 8 * ((j >> 1) & 1);
            const int c = c0 + 8 * (j >> 2) + c_frag + (j & 1);
            if (r >= x.n_rows_t || c >= x.span_end || (x.diag && c <= r))
              continue;
            const long long gr = x.row_base + r, gc = x.col_base + c;
            if (!a.prefix && !(word_valid(gr, a) && word_valid(gc, a)))
              continue;
            if (a.ids != nullptr && a.ids[gr] != a.ids[gc]) continue;
            buf.add(gr * a.n_rows + gc, a.counter, a.cap, a.out_keys);
          }
        }
      }
      hopper::mbar_arrive(&empty[st]);  // the stage may be loaded again
      // Keys go out once the buffer is half full: a flush's atomicAdd on
      // the one global counter would stall the warpgroup every stage.
      buf.flush(a.counter, a.cap, a.out_keys, t, 128, wg_sync,
                humid::HIT_CAP / 2);
    }
    hopper::mbar_arrive(&panel_empty[pb]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the process has
// loaded (PyTorch has): it is looked up there, with no link against it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

template <int W>
cudaError_t launch(const void* table, long long table_rows, SweepArgs a,
                   long long nb, cudaStream_t stream) {
  using G = Geometry<W>;
  // The table as a 2-D tensor of bytes, [table_rows, K], read in boxes of
  // 32 bytes x 64 rows with the 32-byte swizzle (hopper.cuh).
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)G::K, (cuuint64_t)table_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)G::K};
  const cuuint32_t box[2] = {KSTEP, BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(table),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  a.row_blocks = (a.tile + G::P - 1) / G::P;
  // Halve the column span until the list has MIN_UNITS units (or a span
  // is one stage), so that the units balance over the CTAs.
  a.span = (a.tile + G::BN - 1) / G::BN * G::BN;
  while (a.span > G::BN &&
         nb * a.row_blocks * ((a.tile + a.span - 1) / a.span) < MIN_UNITS)
    a.span = (a.span / 2 + G::BN - 1) / G::BN * G::BN;
  a.spans = (a.tile + a.span - 1) / a.span;
  a.units = nb * a.row_blocks * a.spans;
  // Once per device (the attribute is per device): the shared-memory
  // limit of this instance, and the number of SMs the grid fills.
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES];  // 0: not set up yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hamming_sweep_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 G::SMEM);
    if (err != cudaSuccess) return err;
    sms_of[device] = sms;
  }
  const long long blocks = min(a.units, (long long)sms_of[device]);
  hamming_sweep_kernel<W><<<(unsigned)blocks, THREADS, G::SMEM, stream>>>(
      map, a);
  return cudaGetLastError();
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
      table_rows % BOX_ROWS != 0 ||
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

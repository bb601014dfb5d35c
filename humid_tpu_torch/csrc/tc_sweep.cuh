// The int8 tensor-core pipeline that both Hamming kernels run (sm_90a):
// the tile sweep (hamming_sweep.cu, K1) and the ring step (ring_sweep.cu,
// K2).  Each kernel is a thin __global__ function that hands its tensor
// maps and a small policy to tc::sweep(); the policy says how a unit's
// index decodes to a pair of tiles (where each starts in its encoded
// table, how many of its rows and columns to look at, and whether it is a
// diagonal pair of a tile with itself) and what a passing (r, c) emits.
//
// The encoding (ops/simplex_encode.py::encode_table, and the CUDA
// pre-pass simplex_encode.cu).  Each of a word's 16 w base slots becomes
// 3 int8 channels of +-1, A = (1,1,1), C = (1,-1,-1), G = (-1,1,-1),
// T = (-1,-1,1): the dot product of two slots is 3 when the bases are
// equal and -1 when not, so the product of two words is acc = 4 matches -
// 16 w, and a pair is within max_dist iff acc >= 48 w - 4 max_dist (the
// wrappers pass that threshold, min_acc).  Padding slots hold A in every
// word and count as matches on both sides.  K = 48 w bytes a word,
// zero-padded to a multiple of 32 (one wgmma k-step), in a [rows, K]
// table whose rows are zero past the words up to a multiple of 64.  No
// exact form has fewer channels (a +-1 Gram matrix a I + b J of four
// bases has rank 3); the one-hot form takes 4.
//
// The pipeline:
// * The work list is (tile pair, row panel, column span) units, cut by
//   plan() on the host: the span halved until there are MIN_UNITS units
//   (or a span is one stage), so that short lists still spread over the
//   SMs (a kernel may also launch its narrow geometry for a short list:
//   128-column products, twice the units).  The grid
//   is persistent, one CTA an SM; the producer takes each next unit from
//   the launch's work counter (an atomicAdd one unit ahead of the
//   consumers), so CTAs stay busy however unequal the units are.  A unit
//   of a diagonal pair that lies wholly at or below the diagonal is
//   skipped there.
// * Warp-specialised: one producer thread issues the TMA loads, a row
//   panel per unit from the rows' tensor map into one of PANELS buffers
//   (the next unit's panel loads while this one computes) and the span's
//   columns from the columns' tensor map in tiles of BN through a ring of
//   STAGES shared-memory stages; "full" mbarriers count the bytes in,
//   "empty" ones the consumers' release.  Its warpgroup hands its
//   registers to the consumers (setmaxnreg, which moves registers only
//   within the CTA: the whole producer warpgroup takes part), whose
//   accumulators need them.
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
//   their (row, column) by the wgmma fragment layout, tested against the
//   tile's rows, the span's columns and the diagonal, and handed to the
//   policy's emit().  Validity is by index, never by a row's content: at
//   max_dist >= 12 w the threshold is 0 or below and a zero row passes.
// * Matches go to the warpgroup's HitBuffer in shared memory and from
//   there to the global array with one atomicAdd per flush (flushed over
//   the warpgroup's 128 threads once it is half full, and when the CTA's
//   units are done).  The counter keeps counting past the buffer's
//   capacity, so the caller can relaunch with the exact size.
//
// A kernel allocates nothing and launches on the caller's stream.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tc {

constexpr int CONSUMERS = 256;  // two warpgroups
// and a producer warpgroup, of which one warp (one thread) issues the
// loads: the group exists to hand its registers to the consumers
// (setmaxnreg moves registers within the CTA, 128 x (168 - 40) of them
// here, which is what 256 x (232 - 168) takes).
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MIN_UNITS = 512;  // span halved while fewer units
constexpr int BOX_ROWS = 64;     // rows of one TMA box (a 2 KB tile)
constexpr int KSTEP = 32;        // bytes of K per wgmma (m64nNk32, int8)
constexpr int SMEM_LIMIT = 225 * 1024;  // one CTA an SM
constexpr int MAX_DEVICES = 64;

// Matching pairs on their way out.  A global atomicAdd per match makes a
// warp wait a memory round trip for each, and all of them queue on one
// address; so a warpgroup collects its keys in shared memory (a
// shared-memory atomic) and flush() hands them on with one global
// atomicAdd for the lot.  Keys that find the buffer full go out one by
// one.  The global counter keeps counting past `cap`, so the caller
// learns the exact size a relaunch needs.
constexpr int HIT_CAP = 1024;

struct HitBuffer {
  unsigned n;               // keys offered since the last flush
  unsigned long long base;  // first global slot of the keys being flushed
  long long keys[HIT_CAP];

  // One thread, before the barrier that precedes the first add.
  __device__ __forceinline__ void reset() { n = 0u; }

  __device__ __forceinline__ void add(long long key,
                                      unsigned long long* counter,
                                      long long cap, long long* out_keys) {
    // A full buffer is left alone (n only grows between flushes, so a
    // stale read costs one atomic at most): when every pair matches, the
    // threads must not queue on this one shared word as well.
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
};

// Sizes per lane count W, fixed at compile time: the widest product the
// registers take (BN columns, BN / 2 accumulators a thread; NARROW: at
// most 128), then as many 64-row sub-blocks, row panels (2: the next
// unit's loads while this one computes) and column stages as shared
// memory holds.
template <int W, bool NARROW = false>
struct Geometry {
  static constexpr int K = (48 * W + KSTEP - 1) / KSTEP * KSTEP;
  static constexpr int KS = K / KSTEP;  // k-steps a product
  static constexpr int BN = K <= 96 && !NARROW ? 256 : K <= 192 ? 128 : 64;
  static constexpr int FIXED = 2 * (int)sizeof(HitBuffer) +
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

// How a launch's work is cut into units (plan(), on the host).
struct Sched {
  long long units;  // tile pairs x row_blocks x spans
  int span;         // columns a unit, a multiple of BN
  int spans;        // units across a tile's columns
  int row_blocks;   // row panels across a tile's rows
};

// The fields every policy has (it derives from this).
struct Launch {
  Sched sched;
  int min_acc;  // a pair passes iff its product is >= min_acc
  long long* out_keys;
  long long cap;
  unsigned long long* counter;  // [0] matches
  unsigned long long* work;     // units handed out so far (zero at launch)
};

// What a policy says of one tile pair: where its two tiles start in their
// encoded tables, how many of their rows and columns are looked at, and
// whether it is a tile against itself (only c > r is looked at).
struct TilePair {
  long long row_base, col_base;
  int n_rows, n_cols;
  bool diag;
};

// One unit of the work list: a row panel of a tile pair against a span of
// its columns.
struct Unit {
  long long row_base, col_base;  // first table rows of the two tiles
  int row0;                      // the panel's first row in its tile
  int n_rows_t;                  // rows of the row tile to look at
  int c_first, span_end;         // its columns in the column tile
  int n_stages;
  bool diag;
};

// `pairs` tile pairs of `rows` x `cols`.  The span is halved until the
// list has MIN_UNITS units or a span is one stage.
template <int W, bool NARROW = false>
Sched plan(long long pairs, int rows, int cols) {
  using G = Geometry<W, NARROW>;
  Sched s{};
  s.row_blocks = (rows + G::P - 1) / G::P;
  s.span = (cols + G::BN - 1) / G::BN * G::BN;
  const auto count = [&] {
    s.spans = (cols + s.span - 1) / s.span;
    return pairs * s.row_blocks * s.spans;
  };
  while (s.span > G::BN && count() < MIN_UNITS)
    s.span = (s.span / 2 + G::BN - 1) / G::BN * G::BN;
  s.units = count();
  return s;
}

// Decodes unit u; false when it has nothing to compare (the policy has
// no tile pair there, no row, or on a diagonal pair nothing above it).
// `flag` is passed on to the policy (the producer's call: a bad tile pair
// is reported once).
template <int W, bool NARROW, class Policy>
__device__ __forceinline__ bool decode(long long u, const Policy& a,
                                       Unit& x, bool flag) {
  using G = Geometry<W, NARROW>;
  const Sched& s = a.sched;
  const long long per_pair = (long long)s.row_blocks * s.spans;
  TilePair t;
  if (!a.tile_pair(u / per_pair, t, flag)) return false;
  const int unit = (int)(u % per_pair);
  x.diag = t.diag;
  x.row0 = (unit / s.spans) * G::P;
  x.n_rows_t = t.n_rows;
  x.c_first = (unit % s.spans) * s.span;
  x.span_end = min(x.c_first + s.span, t.n_cols);
  // On a diagonal pair no column at or below row0 can match.
  if (x.diag) x.c_first = max(x.c_first, (x.row0 + 1) / G::BN * G::BN);
  if (x.row0 >= x.n_rows_t || x.c_first >= x.span_end) return false;
  x.n_stages = (x.span_end - x.c_first + G::BN - 1) / G::BN;
  x.row_base = t.row_base;
  x.col_base = t.col_base;
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

// The body of a kernel of THREADS threads, one CTA an SM,
// Geometry<W, NARROW>::SMEM bytes of dynamic shared memory: every unit of the policy's work list,
// rows read through `rows_map`, columns through `cols_map` (the same map
// when both sides come from one table).  The policy provides
//   bool tile_pair(long long i, TilePair& t, bool flag) const;
//   void emit(const Unit& x, int r, int c, HitBuffer& buf) const;
// emit() sees every (r, c) that passed the distance test with r below the
// tile's rows, c in the unit's span and, on a diagonal pair, c > r; it
// tests what else decides a pair and adds the pair's key to buf.
template <int W, bool NARROW = false, class Policy>
__device__ __forceinline__ void sweep(const CUtensorMap* rows_map,
                                      const CUtensorMap* cols_map,
                                      const Policy& a) {
  using G = Geometry<W, NARROW>;
  constexpr int BN = G::BN, KS = G::KS, STAGES = G::STAGES;
  constexpr int PANELS = G::PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* panels = smem;  // [PANELS][SUB][KS][64 rows][32 bytes]
  uint8_t* stages = smem + PANELS * G::PANEL;  // [STAGES][KS][BN][32]
  HitBuffer* hits =  // one per consumer warpgroup
      reinterpret_cast<HitBuffer*>(stages + STAGES * G::STAGE);
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
      if (u < a.sched.units && !decode<W, NARROW>(u, a, x, true)) continue;
      const int pb = panel % PANELS;
      hopper::mbar_wait(&panel_empty[pb], ((panel / PANELS) & 1) ^ 1);
      if (u >= a.sched.units) {
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
                              rows_map, k * KSTEP,
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
                                cols_map, k * KSTEP,
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
  HitBuffer& buf = hits[wg];
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
    decode<W, NARROW>(u, a, x, false);
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
            a.emit(x, r, c, buf);
          }
        }
      }
      hopper::mbar_arrive(&empty[st]);  // the stage may be loaded again
      // Keys go out once the buffer is half full: a flush's atomicAdd on
      // the one global counter would stall the warpgroup every stage.
      buf.flush(a.counter, a.cap, a.out_keys, t, 128, wg_sync,
                HIT_CAP / 2);
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
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// An encoded table as a 2-D tensor of bytes, [table_rows, k], read in
// boxes of 32 bytes x 64 rows with the 32-byte swizzle (hopper.cuh).
inline cudaError_t table_map(CUtensorMap* map, const void* table,
                             long long table_rows, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)table_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {KSTEP, BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(table),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The persistent grid of `kernel` on the current device: one CTA an SM,
// at most `units`.  `sms_of` is the caller's cache for this kernel (the
// attribute is set once per kernel and device): 0 where not set up yet.
inline cudaError_t persistent_grid(int (&sms_of)[MAX_DEVICES],
                                   const void* kernel, int smem,
                                   long long units, unsigned& blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sms_of[device] = sms;
  }
  blocks = (unsigned)min(units, (long long)sms_of[device]);
  return cudaSuccess;
}

}  // namespace tc

// The lane counts the kernels are instantiated for (words up to 256 bases).
#define HUMID_FOR_EACH_W(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

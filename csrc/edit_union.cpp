// Host parts of the PyTorch port's shifted-segment edit search
// (humid_tpu_torch._cedit; humid_tpu_torch/ops/neighbors.py
// find_edit_pairs_shifted): the (segment, shift) merge joins, each of
// which emits every unordered pair once, and the union of the joins'
// pairs by the first-join rule, which needs no sort.
//
// Kept out of csrc/hostops.cpp, which also builds the JAX package's
// extension: these exist for the port alone.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <new>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Sorted merge join between two keyed views of the unique words.
// keys_a/keys_b are unsorted, order_a/order_b sort them, and
// sorted_a/sorted_b are keys_a[order_a]/keys_b[order_b] (the caller
// holds them from sizing the join), so the merge reads keys in order.
// Equal-key blocks emit the cross product of (A row, B row) pairs as
// (min, max), self pairs skipped, each unordered pair once: self_join
// != 0 means the two views are identical and only i < j comes out;
// otherwise the row pair (a from A, b from B) is skipped where a > b and
// keys_a[b] == keys_b[a], since (b from A, a from B) comes out too.
// Returns pairs written, or -(needed) if the output capacity is too
// small.
PyObject* merge_join_pairs(PyObject* /*self*/, PyObject* args) {
  Py_buffer ka_b, oa_b, kb_b, ob_b, sa_b, sb_b, outa_b, outb_b;
  long self_join;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*lw*w*", &ka_b, &oa_b, &kb_b,
                        &ob_b, &sa_b, &sb_b, &self_join, &outa_b,
                        &outb_b)) {
    return nullptr;
  }
  const uint64_t* ka = static_cast<const uint64_t*>(ka_b.buf);
  const int64_t* oa = static_cast<const int64_t*>(oa_b.buf);
  const uint64_t* kb = static_cast<const uint64_t*>(kb_b.buf);
  const int64_t* ob = static_cast<const int64_t*>(ob_b.buf);
  const uint64_t* sa = static_cast<const uint64_t*>(sa_b.buf);
  const uint64_t* sb = static_cast<const uint64_t*>(sb_b.buf);
  int64_t* outa = static_cast<int64_t*>(outa_b.buf);
  int64_t* outb = static_cast<int64_t*>(outb_b.buf);
  const Py_ssize_t na = oa_b.len / 8, nb = ob_b.len / 8;
  const Py_ssize_t ra = ka_b.len / 8, rb = kb_b.len / 8;
  const Py_ssize_t cap = std::min(outa_b.len, outb_b.len) / 8;
  int64_t written = 0;
  int64_t needed = 0;
  bool bad = sa_b.len != oa_b.len || sb_b.len != ob_b.len || ra != rb;
  bool oom = false;
  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t x = 0; x < na && !bad; ++x) {
    bad = static_cast<uint64_t>(oa[x]) >= static_cast<uint64_t>(ra);
  }
  for (Py_ssize_t y = 0; y < nb && !bad; ++y) {
    bad = static_cast<uint64_t>(ob[y]) >= static_cast<uint64_t>(rb);
  }
  // A cross join's keys_b of the A rows and keys_a of the B rows, in
  // sorted order, gathered in two tight loops ahead of the merge.
  std::vector<uint64_t> kb_oa, ka_ob;
  if (!bad && !self_join) {
    try {
      kb_oa.resize(na);
      ka_ob.resize(nb);
    } catch (const std::bad_alloc&) {
      oom = true;
    }
  }
  if (!bad && !oom) {
    if (!self_join) {
      for (Py_ssize_t x = 0; x < na; ++x) kb_oa[x] = kb[oa[x]];
      for (Py_ssize_t y = 0; y < nb; ++y) ka_ob[y] = ka[ob[y]];
    }
    Py_ssize_t i = 0, j = 0;
    while (i < na && j < nb) {
      const uint64_t key = sa[i];
      if (key < sb[j]) { ++i; continue; }
      if (sb[j] < key) { ++j; continue; }
      Py_ssize_t ie = i, je = j;
      while (ie < na && sa[ie] == key) ++ie;
      while (je < nb && sb[je] == key) ++je;
      for (Py_ssize_t x = i; x < ie; ++x) {
        const int64_t a = oa[x];
        const uint64_t kb_a = self_join ? 0 : kb_oa[x];
        for (Py_ssize_t y = j; y < je; ++y) {
          const int64_t b = ob[y];
          if (a == b) continue;
          if (self_join) {
            if (a > b) continue;  // emit i < j once
          } else if (ka_ob[y] == kb_a && a > b) {
            // The key test first: it rarely holds, where a > b is a
            // coin toss.
            continue;
          }
          ++needed;
          if (written < cap) {
            outa[written] = a < b ? a : b;
            outb[written] = a < b ? b : a;
            ++written;
          }
        }
      }
      i = ie;
      j = je;
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&ka_b);
  PyBuffer_Release(&oa_b);
  PyBuffer_Release(&kb_b);
  PyBuffer_Release(&ob_b);
  PyBuffer_Release(&sa_b);
  PyBuffer_Release(&sb_b);
  PyBuffer_Release(&outa_b);
  PyBuffer_Release(&outb_b);
  if (oom) return PyErr_NoMemory();
  if (bad) {
    PyErr_SetString(PyExc_ValueError,
                    "merge_join_pairs: an order outside its keys, or sorted "
                    "keys of another length than their order");
    return nullptr;
  }
  if (needed > written) {
    return PyLong_FromLongLong(-static_cast<long long>(needed));
  }
  return PyLong_FromLongLong(static_cast<long long>(written));
}

// The first-join union of the joins' pairs, in place.  Join p's pairs
// lie at [starts[p], starts[p + 1]) of a/b, each unordered pair once
// (merge_join_pairs).  A pair (x, y) of join p is dropped where an
// earlier join q < p finds it in either orientation:
// table[x][col_a[q]] == table[y][col_b[q]] or
// table[y][col_a[q]] == table[x][col_b[q]].  table is the row-major
// [rows, k] key table, one column per key array of the joins (a
// segment's canonical keys, a (segment, shift)'s shifted keys), in the
// narrowest of 2, 4 or 8 bytes a key that holds them, so a pair costs
// two row loads (each prefetched a few pairs ahead); col_a/col_b are
// each join's own columns.  Each candidate is kept by the first join
// that finds it alone, so the survivors are the joins' distinct union,
// with no sort and no state.  Parallel over chunks of the pairs, each
// listing the positions it drops; then the dropped positions below the
// survivors' count n are filled, in ascending order, by the survivors
// at or above n, taken from the top down, so a/b[:n] hold the union (in
// that order, which the thread count does not change).
template <typename Key>
void first_join_drops(const Key* table, int64_t k, int64_t rows,
                      const int64_t* col_a, const int64_t* col_b,
                      int64_t p, const int64_t* pa, const int64_t* pb,
                      int64_t lo, int64_t hi, std::vector<int64_t>& out,
                      std::atomic<bool>& out_of_range) {
  constexpr int64_t kAhead = 8;
  for (int64_t i = lo; i < hi; ++i) {
    if (i + kAhead < hi) {
      const uint64_t nx = static_cast<uint64_t>(pa[i + kAhead]);
      const uint64_t ny = static_cast<uint64_t>(pb[i + kAhead]);
      if (nx < static_cast<uint64_t>(rows) &&
          ny < static_cast<uint64_t>(rows)) {
        __builtin_prefetch(table + nx * k);
        __builtin_prefetch(table + nx * k + k - 1);
        __builtin_prefetch(table + ny * k);
        __builtin_prefetch(table + ny * k + k - 1);
      }
    }
    const int64_t x = pa[i], y = pb[i];
    if (static_cast<uint64_t>(x) >= static_cast<uint64_t>(rows) ||
        static_cast<uint64_t>(y) >= static_cast<uint64_t>(rows)) {
      out_of_range.store(true, std::memory_order_relaxed);
      continue;
    }
    const Key* rx = table + x * k;
    const Key* ry = table + y * k;
    for (int64_t q = 0; q < p; ++q) {
      const int64_t u = col_a[q], v = col_b[q];
      if (rx[u] == ry[v] || ry[u] == rx[v]) {
        out.push_back(i);
        break;
      }
    }
  }
}

// first_join_pairs(table, rows, k, col_a, col_b, starts, a, b) -> n, as
// above; raises ValueError on a column, a row, an offset, a length or a
// key width out of range.
PyObject* first_join_pairs(PyObject* /*self*/, PyObject* args) {
  Py_buffer t_b, ca_b, cb_b, st_b, a_b, b_b;
  long rows_long, k_long;
  if (!PyArg_ParseTuple(args, "y*lly*y*y*w*w*", &t_b, &rows_long, &k_long,
                        &ca_b, &cb_b, &st_b, &a_b, &b_b)) {
    return nullptr;
  }
  const int64_t* col_a = static_cast<const int64_t*>(ca_b.buf);
  const int64_t* col_b = static_cast<const int64_t*>(cb_b.buf);
  const int64_t* starts = static_cast<const int64_t*>(st_b.buf);
  int64_t* pa = static_cast<int64_t*>(a_b.buf);
  int64_t* pb = static_cast<int64_t*>(b_b.buf);
  const int64_t rows = rows_long, k = k_long;
  const int64_t width = rows > 0 && k > 0 ? t_b.len / (rows * k) : 0;
  const Py_ssize_t joins = ca_b.len / 8;
  bool bad = rows <= 0 || k <= 0 || t_b.len != rows * k * width ||
             (width != 2 && width != 4 && width != 8) ||
             cb_b.len != ca_b.len || st_b.len != (joins + 1) * 8 ||
             b_b.len != a_b.len || starts[0] != 0;
  for (Py_ssize_t p = 0; p < joins && !bad; ++p) {
    bad = col_a[p] < 0 || col_a[p] >= k || col_b[p] < 0 ||
          col_b[p] >= k || starts[p] > starts[p + 1];
  }
  if (!bad) bad = starts[joins] > a_b.len / 8;
  int64_t kept = 0;
  std::atomic<bool> out_of_range{false};
  Py_BEGIN_ALLOW_THREADS;
  const int64_t total = bad ? 0 : starts[joins];
  int nt = 1;
#if defined(_OPENMP)
  nt = omp_get_max_threads();
#endif
  // Chunks of at most ~1/8 of a thread's share, none across two joins.
  const int64_t step = std::max<int64_t>(1 << 16, total / (8 * nt) + 1);
  std::vector<int64_t> lo, hi, join;
  for (Py_ssize_t p = 0; p < joins && total; ++p) {
    for (int64_t c = starts[p]; c < starts[p + 1]; c += step) {
      lo.push_back(c);
      hi.push_back(std::min(starts[p + 1], c + step));
      join.push_back(p);
    }
  }
  const Py_ssize_t chunks = static_cast<Py_ssize_t>(lo.size());
  std::vector<std::vector<int64_t>> dropped(chunks);
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 1)
#endif
  for (Py_ssize_t c = 0; c < chunks; ++c) {
    if (width == 2) {
      first_join_drops(static_cast<const uint16_t*>(t_b.buf), k, rows,
                       col_a, col_b, join[c], pa, pb, lo[c], hi[c],
                       dropped[c], out_of_range);
    } else if (width == 4) {
      first_join_drops(static_cast<const uint32_t*>(t_b.buf), k, rows,
                       col_a, col_b, join[c], pa, pb, lo[c], hi[c],
                       dropped[c], out_of_range);
    } else {
      first_join_drops(static_cast<const uint64_t*>(t_b.buf), k, rows,
                       col_a, col_b, join[c], pa, pb, lo[c], hi[c],
                       dropped[c], out_of_range);
    }
  }
  if (!out_of_range) {
    std::vector<int64_t> holes;
    for (const auto& d : dropped) holes.insert(holes.end(), d.begin(), d.end());
    kept = total - static_cast<int64_t>(holes.size());
    // Holes ascend; the survivors at or above kept fill those below it.
    Py_ssize_t top = static_cast<Py_ssize_t>(holes.size()) - 1;
    int64_t src = total - 1;
    for (size_t h = 0; h < holes.size() && holes[h] < kept; ++h) {
      while (top >= 0 && holes[top] == src) {
        --top;
        --src;
      }
      pa[holes[h]] = pa[src];
      pb[holes[h]] = pb[src];
      --src;
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&t_b);
  PyBuffer_Release(&ca_b);
  PyBuffer_Release(&cb_b);
  PyBuffer_Release(&st_b);
  PyBuffer_Release(&a_b);
  PyBuffer_Release(&b_b);
  if (bad || out_of_range) {
    PyErr_SetString(PyExc_ValueError,
                    "first_join_pairs: a column, a row, an offset, a length "
                    "or a key width out of range");
    return nullptr;
  }
  return PyLong_FromLongLong(static_cast<long long>(kept));
}

PyMethodDef methods[] = {
    {"merge_join_pairs", merge_join_pairs, METH_VARARGS,
     "merge_join_pairs(keys_a, order_a, keys_b, order_b, sorted_a, "
     "sorted_b, self_join, out_a, out_b) -> n (or -needed on overflow): "
     "equal-key pairs between two sorted key views, each unordered pair "
     "once."},
    {"first_join_pairs", first_join_pairs, METH_VARARGS,
     "first_join_pairs(table, rows, k, col_a, col_b, starts, a, b) -> n: "
     "the shifted-segment joins' pairs (join p at starts[p]:starts[p+1]) "
     "less those an earlier join (columns col_a/col_b of the [rows, k] "
     "key table of uint16, uint32 or uint64) finds either way, compacted "
     "in place into a/b[:n]."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cedit",
    "Host parts of the port's shifted-segment edit search.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__cedit(void) { return PyModule_Create(&module); }

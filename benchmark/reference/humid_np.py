"""A plain NumPy HUMID: the reference that the benchmark judges the port
against.

It follows the behaviour of jfjlaros/HUMID (``humid -n N -m M -s``, with
Hamming distance and directional clustering) from the FastQ files alone:

* words: the UMI (the last ``_``-separated field of the name up to its
  first space, else the last ``:``-separated field; valid when non-empty
  and all of ``ACGT``), cut or padded with ``N`` to the size measured on
  the first record of the first file, then the first ``nt`` bases of each
  file's read, where the ``N - umi`` bases are split evenly over the files
  and the remainder goes to the last.  A word with any base outside
  ``ACGT`` is filtered (not usable);
* uniques: the usable words with their counts, in lexicographic order;
* neighbours: every pair of uniques within Hamming distance ``m``, found
  by the pigeonhole principle (a pair within ``m`` agrees exactly on one
  of ``m + 1`` segments) and counted once;
* directional clustering: seeds in lexicographic order; from an
  unclustered seed, climb to the first unclustered neighbour (neighbours
  in lexicographic order) with at least twice the count, restarting at
  each climb; the top is the cluster's representative word; from it, a
  depth-first descent takes every unclustered neighbour with at most half
  the count of the word it is reached from;
* the representative read of a cluster: the first read, in file order,
  whose word is the cluster's representative word;
* statistics: ``counts.dat``, ``neigh.dat`` and ``clusters.dat`` (``key
  value`` histograms in ascending key order of unique counts, neighbour
  counts and cluster sizes in reads) and ``stats.dat``.

With ``edit=True`` (``humid -e``) the neighbours are every pair of
uniques within Levenshtein distance ``m`` instead (:func:`edit_pairs`);
the rest is the same.

It imports NumPy and nothing of the program.  Words of up to 32 bases
(one 64-bit key) are supported.

``search_segments`` is the control's lever: searching fewer of the
``m + 1`` segments (and, under ``edit``, each of them at shift 0 only)
misses the pairs whose edits fall in the others, which breaks the
guarantee that every pair within ``m`` is found.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ENCODE = np.full(256, 255, np.uint8)
for _c, _v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
    ENCODE[_c[0]] = _v

_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)


@dataclass
class Result:
    total: int
    usable: int
    keys: np.ndarray        # [U] uint64 unique words, ascending
    counts: np.ndarray      # [U] reads per unique word
    first_read: np.ndarray  # [U] first read (file order) of each word
    degree: np.ndarray      # [U] neighbours within m
    sizes: np.ndarray       # [K] cluster sizes in reads
    rep_reads: np.ndarray   # [K] representative reads, ascending
    files: dict             # statistics file name -> bytes
    candidates: int = 0     # distinct candidate pairs verified (edit only)


# ---------------------------------------------------------------------------
# FastQ
# ---------------------------------------------------------------------------

def read_fastq(path: str):
    """The records of a plain FastQ file: (buffer, line starts [n, 4],
    line ends [n, 4]); a trailing partial record is dropped."""
    buf = np.fromfile(path, np.uint8)
    nl = np.flatnonzero(buf == 10)
    n = len(nl) // 4
    ends = nl[:4 * n].reshape(n, 4)
    starts = np.empty_like(ends)
    starts[:, 0] = 0
    starts.reshape(-1)[1:] = nl[:4 * n - 1] + 1
    # A line ending in "\r\n" loses its "\r".
    has_cr = buf[np.maximum(ends - 1, 0)] == 13
    ends = ends - (has_cr & (ends > starts))
    return buf, starts, ends


def take_prefix(buf, starts, ends, k: int) -> np.ndarray:
    """[n, k] the first ``k`` bytes of each span, padded with ``N``."""
    n = len(starts)
    col = np.arange(k, dtype=np.int64)
    idx = starts[:, None] + col[None, :]
    inside = idx < ends[:, None]
    out = np.full((n, k), ord("N"), np.uint8)
    out[inside] = buf[idx[inside]]
    return out


def _last_valid_field(mat, end, sep: int):
    """(start, length, valid) of the last ``sep``-separated field of each
    row's first ``end`` bytes."""
    width = mat.shape[1]
    col = np.arange(width)
    is_sep = (mat == sep) & (col[None, :] < end[:, None])
    has = is_sep.any(axis=1)
    last = width - 1 - is_sep[:, ::-1].argmax(axis=1)
    start = np.where(has, last + 1, end)
    length = end - start
    in_field = (col[None, :] >= start[:, None]) & (col[None, :] < end[:, None])
    ok = (ENCODE[mat] != 255) | ~in_field
    return start, length, has & (length > 0) & ok.all(axis=1)


def umi_matrix(buf, starts, ends, size: int) -> np.ndarray:
    """[n, size] each record's UMI cut or padded with ``N``."""
    # Names without the leading '@'.
    s = starts + (buf[starts] == ord("@"))
    width = int((ends - s).max()) if len(s) else 0
    mat = take_prefix(buf, s, ends, width)
    lens = ends - s
    col = np.arange(width)
    mat[col[None, :] >= lens[:, None]] = 0
    is_space = mat == ord(" ")
    end = np.where(is_space.any(axis=1), is_space.argmax(axis=1), lens)
    st_u, len_u, ok_u = _last_valid_field(mat, end, ord("_"))
    st_c, len_c, ok_c = _last_valid_field(mat, end, ord(":"))
    start = np.where(ok_u, st_u, np.where(ok_c, st_c, end))
    length = np.where(ok_u, len_u, np.where(ok_c, len_c, 0))
    out = np.full((len(s), size), ord("N"), np.uint8)
    k = np.arange(size)
    take = k[None, :] < np.minimum(length, size)[:, None]
    rows, cols = np.nonzero(take)
    out[rows, cols] = mat[rows, start[rows] + cols]
    return out


def header_umi_length(buf, starts, ends) -> int:
    if not len(starts):
        return 0
    first = umi_matrix(buf, starts[:1], ends[:1], 64)[0]
    return int(np.argmax(first == ord("N"))) if (first == ord("N")).any() \
        else 64


def words(files: list[str], word_length: int):
    """(keys [n] uint64, usable [n] bool, bases a word) of every read
    tuple."""
    recs = [read_fastq(f) for f in files]
    n = min(len(r[1]) for r in recs)
    buf0, st0, en0 = recs[0]
    umi_len = header_umi_length(buf0, st0[:, 0], en0[:, 0])
    umi_size = min(umi_len, word_length)
    from_file = word_length - umi_len if word_length > umi_len else 0
    take = [from_file // len(files)] * len(files)
    take[-1] += from_file % len(files)
    parts = []
    if umi_size:
        parts.append(umi_matrix(buf0, st0[:n, 0], en0[:n, 0], umi_size))
    for (buf, st, en), k in zip(recs, take):
        if k:
            parts.append(take_prefix(buf, st[:n, 1], en[:n, 1], k))
    chars = np.concatenate(parts, axis=1) if parts else np.zeros((n, 0),
                                                                  np.uint8)
    if chars.shape[1] > 32:
        raise ValueError("the reference keys words of up to 32 bases")
    codes = ENCODE[chars]
    usable = (codes != 255).all(axis=1)
    keys = np.zeros(n, np.uint64)
    for j in range(codes.shape[1]):
        keys = (keys << np.uint64(2)) | (codes[:, j] & 3).astype(np.uint64)
    return keys, usable, codes.shape[1]


# ---------------------------------------------------------------------------
# Neighbours
# ---------------------------------------------------------------------------

def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bases that differ between 2-bit packed words."""
    z = a ^ b
    z = (z | (z >> np.uint64(1))) & _M1
    z = (z & _M2) + ((z >> np.uint64(2)) & _M2)
    z = (z + (z >> np.uint64(4))) & _M4
    return ((z * _H01) >> np.uint64(56)).astype(np.int64)


def segment_bounds(length: int, parts: int) -> list:
    """The ``parts + 1`` bounds of ``parts`` segments of near-equal
    length."""
    return [length * p // parts for p in range(parts + 1)]


def window_keys(keys: np.ndarray, length: int, start: int,
                size: int) -> np.ndarray:
    """The ``size`` bases of each word from base ``start`` on, packed."""
    shift = np.uint64(2 * (length - start - size))
    mask = np.uint64((1 << (2 * size)) - 1)
    return (keys >> shift) & mask


def segment_keys(keys: np.ndarray, length: int, parts: int) -> list:
    """The words cut into ``parts`` segments of near-equal length."""
    bounds = segment_bounds(length, parts)
    return [window_keys(keys, length, lo, hi - lo)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def neighbour_pairs(keys: np.ndarray, length: int, m: int,
                    search_segments: int | None = None):
    """(a, b) with a < b: every pair of ``keys`` within Hamming distance
    ``m``, each once (through the first segment the pair agrees on)."""
    if m == 0 or len(keys) < 2:
        z = np.zeros(0, np.int64)
        return z, z
    segs = segment_keys(keys, length, m + 1)
    out_a, out_b = [], []
    for s, seg in enumerate(segs[:search_segments]):
        order = np.argsort(seg, kind="stable")
        sk = seg[order]
        brk = np.flatnonzero(sk[1:] != sk[:-1]) + 1
        gstart = np.concatenate([[0], brk])
        gsize = np.diff(np.concatenate([gstart, [len(sk)]]))
        grp = np.repeat(np.arange(len(gstart)), gsize)
        rem = gsize[grp] - (np.arange(len(sk)) - gstart[grp]) - 1
        active = np.flatnonzero(rem > 0)
        d = 1
        while len(active):
            i, j = order[active], order[active + d]
            ok = hamming(keys[i], keys[j]) <= m
            for t in range(s):
                ok &= segs[t][i] != segs[t][j]
            i, j = i[ok], j[ok]
            out_a.append(np.minimum(i, j))
            out_b.append(np.maximum(i, j))
            d += 1
            active = active[rem[active] >= d]
    if not out_a:
        z = np.zeros(0, np.int64)
        return z, z
    return np.concatenate(out_a), np.concatenate(out_b)


# ---------------------------------------------------------------------------
# Levenshtein neighbours (-e)
# ---------------------------------------------------------------------------

#: Candidate pairs handled at a time by :func:`edit_pairs`: its memory is
#: some hundred bytes a candidate of one block, whatever the total.
EDIT_BLOCK = 1 << 21


def edit_probes(length: int, m: int,
                search_segments: int | None = None) -> list:
    """(start, size, shift) of each search of the partition lemma: segment
    ``[start, start + size)`` of one word against the bases ``shift``
    further on in another, for the ``m + 1`` segments of
    :func:`segment_keys` and every shift in ``[-m, m]`` that keeps the
    window inside the word.  A cut search (``search_segments``) takes the
    first segments at shift 0 only."""
    bounds = segment_bounds(length, m + 1)
    shifts = range(-m, m + 1) if search_segments is None else (0,)
    out = []
    for lo, hi in list(zip(bounds[:-1], bounds[1:]))[:search_segments]:
        out.extend((lo, hi - lo, d) for d in shifts
                   if lo + d >= 0 and hi + d <= length)
    return out


def equal_key_pairs(a_keys: np.ndarray, b_keys: np.ndarray):
    """Blocks (i, j) of every pair with ``a_keys[i] == b_keys[j]``, at
    most ``EDIT_BLOCK`` pairs a block: a merge join of the two sorted
    key lists, each run of equal keys expanded into its cross product."""
    oa = np.argsort(a_keys, kind="stable")
    ob = np.argsort(b_keys, kind="stable")
    sa, sb = a_keys[oa], b_keys[ob]
    start = np.flatnonzero(np.concatenate([[True], sa[1:] != sa[:-1]]))
    na = np.diff(np.append(start, len(sa)))
    lo = np.searchsorted(sb, sa[start], "left")
    nb = np.searchsorted(sb, sa[start], "right") - lo
    hit = nb > 0
    start, na, lo, nb = start[hit], na[hit], lo[hit], nb[hit]
    end = np.cumsum(na * nb)
    begin = end - na * nb
    total = int(end[-1]) if len(end) else 0
    for t0 in range(0, total, EDIT_BLOCK):
        t = np.arange(t0, min(t0 + EDIT_BLOCK, total), dtype=np.int64)
        g = np.searchsorted(end, t, "right")
        r = t - begin[g]
        yield oa[start[g] + r // nb[g]], ob[lo[g] + r % nb[g]]


def banded_levenshtein(a: np.ndarray, b: np.ndarray, m: int) -> np.ndarray:
    """The edit distance of each word pair (columns of ``a`` and ``b``,
    [L, n] base codes), clamped at ``m + 1``.

    The DP of the textbook, row by row over ``a``'s bases, with three
    departures that leave every distance up to ``m`` exact: only the
    cells within ``m`` of the diagonal are computed (a path that leaves
    that band makes more than ``m`` indels); every cell is clamped at
    ``m + 1``, so a distance above ``m`` reads ``m + 1``; and a pair
    whose row has no cell within ``m`` is dropped from the later rows, as
    a row's least cell never falls.  The words have one length, as
    HUMID's do."""
    length, n = a.shape
    inf = m + 1
    band = 2 * m + 1
    out = np.full(n, inf, np.uint8)
    live = np.arange(n)
    # prev[m + k] is D[i - 1][i - 1 + k]: row 0 is D[0][j] = j.
    prev = np.full((band, n), inf, np.uint8)
    for k in range(m + 1):
        prev[m + k] = k
    for i in range(1, length + 1):
        if i % 4 == 0:
            keep = prev.min(axis=0) <= m
            if keep.sum() < 0.75 * len(live):
                live, prev = live[keep], prev[:, keep]
                a, b = a[:, keep], b[:, keep]
        cur = np.full((band, len(live)), inf, np.uint8)
        for c in range(band):
            j = i + c - m
            if j < 0 or j > length:
                continue
            if j == 0:
                cur[c] = min(i, inf)
                continue
            # Substitution (or match), deletion, insertion.
            v = prev[c] + (a[i - 1] != b[j - 1])
            if c + 1 < band:
                np.minimum(v, prev[c + 1] + 1, out=v)
            if c > 0:
                np.minimum(v, cur[c - 1] + 1, out=v)
            np.minimum(v, inf, out=cur[c])
        prev = cur
    out[live] = prev[m]
    return out


def edit_pairs(keys: np.ndarray, length: int, m: int,
               search_segments: int | None = None):
    """(a, b, candidates): every pair a < b of ``keys`` whose full words
    are within Levenshtein distance ``m`` (substitutions, insertions and
    deletions; HUMID's ``-e``), each once, and the number of distinct
    candidate pairs that were verified.

    Candidates come from the partition lemma: of a word's ``m + 1``
    segments, at most ``m`` are touched by ``m`` edits, so some segment
    appears unchanged in the other word, shifted by the indels before it
    (at most ``m`` bases).  :func:`edit_probes` lists the (segment, shift)
    searches, each a join of equal keys (:func:`equal_key_pairs`); a pair
    is a candidate of the first search, in that order and with its
    smaller word first before its larger, that finds it, so the union is
    taken without holding it.  Each candidate is then checked by
    :func:`banded_levenshtein`."""
    z = np.zeros(0, np.int64)
    if m == 0 or len(keys) < 2:
        return z, z, 0
    codes = np.empty((length, len(keys)), np.uint8)
    for j in range(length):
        codes[j] = (keys >> np.uint64(2 * (length - 1 - j))) & np.uint64(3)
    probes = edit_probes(length, m, search_segments)

    def found(q, kx, ky):
        """Does search ``q`` find the pair with the word ``kx`` first?"""
        lo, size, d = probes[q]
        return (window_keys(kx, length, lo, size)
                == window_keys(ky, length, lo + d, size))

    out_a, out_b, candidates = [], [], 0
    for p, (lo, size, d) in enumerate(probes):
        for i, j in equal_key_pairs(window_keys(keys, length, lo, size),
                                    window_keys(keys, length, lo + d, size)):
            x, y = np.minimum(i, j), np.maximum(i, j)
            kx, ky = keys[x], keys[y]
            # Found first here: not a word with itself, not by this search
            # with the smaller word first where the larger came first, and
            # by no earlier search either way round.
            first = (i != j) & ~((i > j) & found(p, kx, ky))
            for q in range(p):
                first &= ~(found(q, kx, ky) | found(q, ky, kx))
            x, y = x[first], y[first]
            candidates += len(x)
            ok = banded_levenshtein(np.take(codes, x, axis=1),
                                    np.take(codes, y, axis=1), m) <= m
            out_a.append(x[ok])
            out_b.append(y[ok])
    if not out_a:
        return z, z, candidates
    return np.concatenate(out_a), np.concatenate(out_b), candidates


# ---------------------------------------------------------------------------
# Directional clustering
# ---------------------------------------------------------------------------

def directional(counts: np.ndarray, a: np.ndarray, b: np.ndarray):
    """(representative word per cluster, cluster sizes in reads), the
    clusters in no particular order."""
    u = len(counts)
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(u + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=u), out=indptr[1:])
    degree = np.diff(indptr)
    # A word with no neighbour is a cluster of its own.
    lone = np.flatnonzero(degree == 0)
    reps = [lone]
    sizes = [counts[lone]]
    linked = np.flatnonzero(degree > 0)
    ip = indptr.tolist()
    nb = dst.tolist()
    cnt = counts.tolist()
    done = np.zeros(u, bool)
    rep_l, size_l = [], []
    for seed in linked.tolist():
        if done[seed]:
            continue
        node, i = seed, ip[seed]
        while i < ip[node + 1]:
            x = nb[i]
            i += 1
            if not done[x] and cnt[x] >= 2 * cnt[node]:
                node, i = x, ip[x]
        done[node] = True
        size = cnt[node]
        stack = [(node, ip[node])]
        while stack:
            cur, i = stack[-1]
            if i == ip[cur + 1]:
                stack.pop()
                continue
            stack[-1] = (cur, i + 1)
            x = nb[i]
            if not done[x] and cnt[cur] >= 2 * cnt[x]:
                done[x] = True
                size += cnt[x]
                stack.append((x, ip[x]))
        rep_l.append(node)
        size_l.append(size)
    reps.append(np.asarray(rep_l, np.int64))
    sizes.append(np.asarray(size_l, np.int64))
    return np.concatenate(reps), np.concatenate(sizes), degree


# ---------------------------------------------------------------------------
# The whole run
# ---------------------------------------------------------------------------

def histogram_bytes(values: np.ndarray) -> bytes:
    keys, cnts = np.unique(np.asarray(values, np.int64), return_counts=True)
    return "".join(f"{k} {v}\n" for k, v in zip(keys.tolist(),
                                                 cnts.tolist())).encode()


def humid(files: list[str], word_length: int = 24, distance: int = 1,
          search_segments: int | None = None, edit: bool = False) -> Result:
    """``humid -n word_length -m distance -s`` on ``files`` (with ``-e``
    where ``edit``)."""
    keys, usable, length = words(files, word_length)
    total = len(keys)
    read_idx = np.flatnonzero(usable)
    uk, first, counts = np.unique(keys[read_idx], return_index=True,
                                  return_counts=True)
    first_read = read_idx[first]
    candidates = 0
    if edit:
        a, b, candidates = edit_pairs(uk, length, distance, search_segments)
    else:
        a, b = neighbour_pairs(uk, length, distance, search_segments)
    reps, sizes, degree = directional(counts.astype(np.int64), a, b)
    stats = (f"total: {total}\nusable: {len(read_idx)}\nunique: {len(uk)}\n"
             f"clusters: {len(reps)}\n").encode()
    files_out = {"counts.dat": histogram_bytes(counts),
                 "neigh.dat": histogram_bytes(degree),
                 "clusters.dat": histogram_bytes(sizes),
                 "stats.dat": stats}
    return Result(total=total, usable=len(read_idx), keys=uk, counts=counts,
                  first_read=first_read, degree=degree, sizes=sizes,
                  rep_reads=np.sort(first_read[reps]), files=files_out,
                  candidates=candidates)

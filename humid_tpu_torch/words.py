"""Word extraction: UMI parsing, nucleotide budgeting, 2-bit packing.

Behavioral contract mirrors the reference implementation
(src/fastq.cc, src/humid.cc:24-59 of jfjlaros/HUMID):

* ``extract_umi`` — the UMI is the last ``_``-separated field of the header
  up to the first space; if that is not a valid UMI, the last ``:``-separated
  field is tried (fastq.cc:72-93).  A valid UMI is non-empty and strictly
  ``[ACGT]+`` (fastq.cc:201-214); lowercase, digits and ``N`` are invalid.
* ``nt_from_file`` — an even split of the nucleotide budget over the input
  files with the remainder assigned to the LAST file (fastq.cc:220-230).
* ``pre_compute`` — the header-UMI size is measured on the FIRST record of
  the FIRST file only and fixed for the whole run (humid.cc:24-59).
* Word = UMI cut/padded-with-N to ``header_umi_size`` ++ the first
  ``nt_to_take[i]`` bases of file *i*'s read, cut/padded with N
  (fastq.cc:116-144).  Encoding A=0 C=1 G=2 T=3; ANY other character
  encodes as G(2) and marks the word filtered (fastq.cc:146-161).

Unlike the reference (per-read std::string processing), everything here is
vectorized over read batches with numpy, and words are bit-packed
big-endian into uint32 lanes so that integer lane order equals
lexicographic word order — the invariant the clustering stage relies on to
reproduce the reference's trie-walk ordering without a trie.
"""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit code. Everything that is not ACGT encodes as G (=2) and is
# marked invalid (fastq.cc:12, 146-161).
ENCODE_LUT = np.full(256, 2, dtype=np.uint8)
VALID_LUT = np.zeros(256, dtype=bool)
for _c, _v in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
    ENCODE_LUT[_c[0]] = _v
    VALID_LUT[_c[0]] = True

BASES_PER_LANE = 16  # 16 bases x 2 bits = one uint32 lane


# ---------------------------------------------------------------------------
# Scalar helpers (reference-shaped; used for peeking and as test oracles)
# ---------------------------------------------------------------------------

def extract_last_field(s: str, sep: str) -> str:
    """Last ``sep``-separated field, '' if ``sep`` absent (fastq.cc:192-199)."""
    last = s.rfind(sep)
    if last == -1:
        return ""
    return s[last + 1:]


def valid_umi(umi: str) -> bool:
    """Non-empty and strictly [ACGT]+ (fastq.cc:201-214)."""
    if not umi:
        return False
    return all(c in "ACGT" for c in umi)


def extract_umi(header: str) -> str:
    """UMI from a header line; ``_`` style tried before ``:`` (fastq.cc:72-93)."""
    first_space = header.find(" ")
    prefix = header[:first_space] if first_space != -1 else header
    umi = extract_last_field(prefix, "_")
    if valid_umi(umi):
        return umi
    umi = extract_last_field(prefix, ":")
    if valid_umi(umi):
        return umi
    return ""


def make_string_size(s: str, size: int, padding: str = "N") -> str:
    """Cut or pad ``s`` to exactly ``size`` chars (fastq.cc:57-66)."""
    if size <= len(s):
        return s[:size]
    return s + padding * (size - len(s))


def nt_from_file(n_files: int, length: int) -> list[int]:
    """Split ``length`` nt over ``n_files``; remainder to the LAST file
    (fastq.cc:220-230)."""
    div = length // n_files
    out = [div] * (n_files - 1)
    out.append(div + length % n_files)
    return out


def pre_compute(header_umi_len: int, n_files: int, word_length: int):
    """Given the peeked UMI length, compute (header_umi_size, nt_to_take)
    (humid.cc:38-59)."""
    from_file = word_length - header_umi_len if word_length > header_umi_len else 0
    nt_to_take = nt_from_file(n_files, from_file)
    header_umi_size = min(header_umi_len, word_length)
    return header_umi_size, nt_to_take


# ---------------------------------------------------------------------------
# Vectorized batch processing
# ---------------------------------------------------------------------------

def _rows_to_matrix(rows: list[bytes], width: int, fill: int) -> np.ndarray:
    """Pack a list of byte strings into a [N, width] uint8 matrix, cutting or
    padding each row with ``fill``."""
    n = len(rows)
    out = np.full((n, width), fill, dtype=np.uint8)
    if width == 0 or n == 0:
        return out
    joined = b"".join(r[:width] for r in rows)
    lens = np.fromiter(
        (min(len(r), width) for r in rows), dtype=np.int64, count=n
    )
    flat = np.frombuffer(joined, dtype=np.uint8)
    # Scatter variable-length rows into the padded matrix.
    col = np.arange(width, dtype=np.int64)
    mask = col[None, :] < lens[:, None]
    out[mask] = flat
    return out


def extract_umi_batch(names: list[bytes], umi_size: int) -> np.ndarray:
    """Vectorized ``extract_umi`` + cut/pad-with-N over a batch of header
    lines (list-of-bytes convenience wrapper)."""
    n = len(names)
    if umi_size == 0:
        return np.zeros((n, 0), dtype=np.uint8)
    width = max((len(x) for x in names), default=0)
    width = max(width, 1)
    mat = _rows_to_matrix(names, width, fill=0)  # 0 = NUL padding
    lens = np.fromiter((min(len(x), width) for x in names),
                       dtype=np.int64, count=n)
    return extract_umi_matrix(mat, umi_size, lens=lens)


def extract_umi_matrix(mat: np.ndarray, umi_size: int,
                       lens: np.ndarray | None = None) -> np.ndarray:
    """Vectorized ``extract_umi`` + cut/pad-with-N over a NUL-padded header
    matrix.  Returns a [N, umi_size] uint8 ASCII matrix.

    ``lens``: true per-row string lengths.  Without them the row end is
    inferred as one past the LAST non-NUL byte — exact unless a real
    header ends in NUL bytes; counting non-NUL bytes instead would shift
    the end for any INTERIOR NUL and extract a wrong UMI.  Callers with
    framing spans pass the real lengths.

    Mirrors fastq.cc:72-93 (``_`` tried before ``:``), fastq.cc:122-129
    (cut/pad to ``umi_size`` with 'N').
    """
    n, width = mat.shape
    if umi_size == 0:
        return np.zeros((n, 0), dtype=np.uint8)
    col = np.arange(width, dtype=np.int64)

    # Position of the first space (or end of string).
    is_space = mat == ord(" ")
    has_space = is_space.any(axis=1)
    first_space = np.where(has_space, is_space.argmax(axis=1), width)
    if lens is None:
        nz = mat != 0
        lens = np.where(nz.any(axis=1),
                        width - nz[:, ::-1].argmax(axis=1), 0)
    else:
        lens = np.minimum(np.asarray(lens, np.int64), width)
    end = np.minimum(first_space, lens)

    in_prefix = col[None, :] < end[:, None]
    valid_char = VALID_LUT[mat]

    def last_field(sep: int):
        is_sep = (mat == sep) & in_prefix
        has_sep = is_sep.any(axis=1)
        # last separator index before first space
        last_sep = width - 1 - is_sep[:, ::-1].argmax(axis=1)
        start = np.where(has_sep, last_sep + 1, end)  # empty when no sep
        flen = end - start
        # field valid: sep present, non-empty, all chars valid
        in_field = (col[None, :] >= start[:, None]) & in_prefix
        all_valid = ~(in_field & ~valid_char).any(axis=1)
        ok = has_sep & (flen > 0) & all_valid
        return start, ok

    start_u, ok_u = last_field(ord("_"))
    start_c, ok_c = last_field(ord(":"))
    start = np.where(ok_u, start_u, np.where(ok_c, start_c, end))
    ok = ok_u | ok_c
    flen = np.where(ok, end - start, 0)

    # Gather the first umi_size chars of the field; pad with 'N'.
    gidx = start[:, None] + np.arange(umi_size, dtype=np.int64)[None, :]
    out = mat[np.arange(n)[:, None], np.clip(gidx, 0, width - 1)]
    pad = np.arange(umi_size, dtype=np.int64)[None, :] >= flen[:, None]
    out = np.where(pad, np.uint8(ord("N")), out)
    return out.astype(np.uint8)


def build_words(
    umi_chars: np.ndarray | None,
    seq_chars: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate char blocks and encode to (codes [N, L] uint8, filtered [N]).

    ``umi_chars``: [N, header_umi_size] ASCII or None; ``seq_chars``: one
    [N, nt_to_take[i]] ASCII matrix per file (already cut/padded with 'N').
    """
    blocks = []
    if umi_chars is not None and umi_chars.shape[1] > 0:
        blocks.append(umi_chars)
    blocks.extend(s for s in seq_chars if s.shape[1] > 0)
    if not blocks:
        n = seq_chars[0].shape[0] if seq_chars else 0
        return np.zeros((n, 0), np.uint8), np.zeros((n,), bool)
    chars = np.concatenate(blocks, axis=1)
    codes = ENCODE_LUT[chars]
    filtered = ~VALID_LUT[chars].all(axis=1)
    return codes, filtered


def num_lanes(word_length: int) -> int:
    return max(1, -(-word_length // BASES_PER_LANE))


def pack_words(codes: np.ndarray) -> np.ndarray:
    """Pack [N, L] 2-bit codes into [N, W] uint32 lanes, big-endian within a
    lane (base 0 in the two most-significant bits) so that comparing lanes
    lexicographically == comparing words lexicographically.  Unused low bits
    of the last lane are zero for every word, preserving the order."""
    n, length = codes.shape
    w = num_lanes(length)
    padded = np.zeros((n, w * BASES_PER_LANE), dtype=np.uint32)
    padded[:, :length] = codes
    lanes = padded.reshape(n, w, BASES_PER_LANE)
    shifts = np.uint32(2) * np.uint32(BASES_PER_LANE - 1 - np.arange(BASES_PER_LANE))
    packed = (lanes << shifts[None, None, :]).sum(axis=2, dtype=np.uint64)
    return packed.astype(np.uint32)


def unpack_words(packed: np.ndarray, word_length: int) -> np.ndarray:
    """Inverse of :func:`pack_words` -> [N, word_length] uint8 codes."""
    n, w = packed.shape
    shifts = np.uint32(2) * np.uint32(BASES_PER_LANE - 1 - np.arange(BASES_PER_LANE))
    codes = (packed[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return codes.reshape(n, w * BASES_PER_LANE)[:, :word_length].astype(np.uint8)

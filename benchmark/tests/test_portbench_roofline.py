"""The frozen roofline: the least of the three forms' bounds, counted by
hand on a small table."""

from pbench import roofline as R


def test_dense_sweep_roofline_by_hand():
    u, w, found = 1000, 2, 37
    pairs = u * (u - 1) // 2                      # 499,500
    n_bytes = u * w * 4 + 8 * found               # 8,296
    simplex = pairs * 3 * 16 * w * 2 / 1.979e15   # int8 simplex operations
    onehot = pairs * 4 * 16 * w * 2 / 1.979e15
    per_s = 132 * 1.98e9
    popc = max(pairs * 1 / (16 * per_s), pairs * 3 / (64 * per_s))
    hbm = n_bytes / 3.35e12
    want = min(max(simplex, hbm), max(onehot, hbm), max(popc, hbm))
    assert R.dense_sweep_roofline_s(u, w, found) == want
    assert want == max(simplex, hbm)


def test_bytes_bound_a_tiny_table():
    # One pair of one lane: the table's bytes outweigh 96 operations.
    got = R.roofline_s(1, 1, 10 ** 6)
    assert got == 10 ** 6 / 3.35e12


def test_popc_form_counts_one_popc_per_32_bases():
    assert R.popc_bound_s(64, 3, 0) == R.popc_bound_s(64, 4, 0)
    assert R.popc_bound_s(64, 3, 0) == 2 * R.popc_bound_s(64, 1, 0)

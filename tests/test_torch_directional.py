"""The port's device directional clustering
(humid_tpu_torch.cluster.directional_device) on the CPU against the JAX
package's formulation and its host walk, the dispatch route
($HUMID_TPU_TORCH_CLUSTER=device), the count bound and the end-to-end
run.

Graphs are made with numpy from fixed seeds (the cases of
tests/test_cluster.py's directional-device test) and fed to both
packages.  Labels, max leaves, max counts and sizes are integers, and
outputs are bytes: every comparison is exact equality.
"""

import os
import sys

import numpy as np
import pytest
import torch

from humid_tpu.cluster.directional_device import (
    cluster_directional_device as ref_directional_device)
from humid_tpu.cluster.exact import cluster_exact as ref_cluster_exact
from humid_tpu.ops.neighbors import _dedupe_pairs
from humid_tpu_torch import pipeline as P
from humid_tpu_torch.cluster import connected_components_device
from humid_tpu_torch.cluster.directional_device import (
    cluster_directional_device)
from humid_tpu_torch.ops import pairs_to_csr

sys.path.insert(0, os.path.dirname(__file__))
from genfastq import gen_dataset  # noqa: E402
from test_torch_pipeline import _assert_same_dirs  # noqa: E402

FIELDS = ("labels", "max_leaf", "max_count", "size")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny graphs, shared cores: one thread per op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def _random_pair_graph(rng, u, e_factor=2.0, count_hi=50):
    n_edges = int(u * e_factor)
    if n_edges:
        a = rng.integers(0, u, n_edges)
        b = rng.integers(0, u, n_edges)
        keep = a != b
        pa, pb = _dedupe_pairs(np.minimum(a, b)[keep].astype(np.int64),
                               np.maximum(a, b)[keep].astype(np.int64))
    else:
        pa = pb = np.zeros(0, np.int64)
    counts = rng.integers(1, count_hi, u).astype(np.int64)
    return counts, pa, pb


def _cases():
    """(id, counts, pa, pb): the reference's 2-4-8-10-3 chain, a 40-node
    doubling chain, 8 random graphs, 8 tie-heavy graphs (counts from
    {1, 2, 4}), an edgeless and an empty table; the random draws in the
    order of tests/test_cluster.py."""
    z = np.zeros(0, np.int64)
    cases = [("chain_2_4_8_10_3", np.array([2, 4, 8, 10, 3], np.int64),
              np.arange(4, dtype=np.int64), np.arange(1, 5, dtype=np.int64))]
    u = 40
    cases.append(("doubling_chain_40",
                  1 << (np.arange(u, dtype=np.int64) % 20),
                  np.arange(u - 1, dtype=np.int64),
                  np.arange(1, u, dtype=np.int64)))
    rng = np.random.default_rng(77)
    for trial in range(8):
        u = int(rng.integers(2, 500))
        cases.append((f"random_{trial}", *_random_pair_graph(
            rng, u, e_factor=float(rng.uniform(0, 4)))))
    for trial in range(8):
        u = int(rng.integers(2, 400))
        counts, pa, pb = _random_pair_graph(rng, u, e_factor=3.0,
                                            count_hi=5)
        cases.append((f"tie_heavy_{trial}",
                      np.choose(counts % 3, [1, 2, 4]).astype(np.int64),
                      pa, pb))
    cases.append(("edgeless", np.array([3, 1, 2], np.int64), z, z))
    cases.append(("empty", z, z, z))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_directional_device_matches_reference(case):
    _, counts, pa, pb = case
    indptr, indices = pairs_to_csr(pa, pb, len(counts))
    got = cluster_directional_device(counts, pa, pb, device="cpu")
    _assert_same(got, ref_directional_device(counts, pa, pb))
    _assert_same(got, ref_cluster_exact(counts, indptr, indices,
                                        maximum=False))
    if len(counts) == 0:
        assert got.num_clusters == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_given_components_match_none(seed):
    rng = np.random.default_rng(seed)
    counts, pa, pb = _random_pair_graph(rng, 300, e_factor=1.5)
    comp = connected_components_device(pa, pb, len(counts), device="cpu")
    info = {}
    got = cluster_directional_device(counts, pa, pb, comp, device="cpu",
                                     info=info)
    _assert_same(got, cluster_directional_device(counts, pa, pb,
                                                 device="cpu"))
    assert info["rounds"] >= 1


@pytest.mark.parametrize("env,route", [("device", "device"),
                                       (None, None), ("seq", None)])
def test_dispatch_route(env, route, monkeypatch):
    rng = np.random.default_rng(79)
    counts, pa, pb = _random_pair_graph(rng, 300)
    indptr, indices = pairs_to_csr(pa, pb, len(counts))
    if env is None:
        monkeypatch.delenv(P.CLUSTER_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(P.CLUSTER_ENV_VAR, env)
    info = {}
    got = P.cluster_dispatch(counts, indptr, indices, maximum=False,
                             pairs=(pa, pb), device="cpu", info=info)
    assert info.get("directional") == route
    _assert_same(got, ref_cluster_exact(counts, indptr, indices,
                                        maximum=False))


def test_count_bound(monkeypatch):
    """Counts past the doubling range keep the host walk in the dispatch
    and raise in the module itself."""
    counts = np.array([1 << 31, 3, 2], np.int64)
    pa = np.array([0, 1], np.int64)
    pb = np.array([1, 2], np.int64)
    indptr, indices = pairs_to_csr(pa, pb, 3)
    monkeypatch.setenv(P.CLUSTER_ENV_VAR, "device")
    info = {}
    got = P.cluster_dispatch(counts, indptr, indices, maximum=False,
                             pairs=(pa, pb), device="cpu", info=info)
    assert info["directional"] == "host"
    _assert_same(got, ref_cluster_exact(counts, indptr, indices,
                                        maximum=False))
    with pytest.raises(ValueError, match="doubling range"):
        cluster_directional_device(counts, pa, pb, device="cpu")


def test_maximum_ignores_the_device_directional_route(monkeypatch):
    rng = np.random.default_rng(80)
    counts, pa, pb = _random_pair_graph(rng, 200)
    indptr, indices = pairs_to_csr(pa, pb, len(counts))
    monkeypatch.setenv(P.CLUSTER_ENV_VAR, "device")
    info = {}
    got = P.cluster_dispatch(counts, indptr, indices, maximum=True,
                             pairs=(pa, pb), device="cpu", info=info)
    assert "directional" not in info
    _assert_same(got, ref_cluster_exact(counts, indptr, indices,
                                        maximum=True))


@pytest.mark.parametrize("n_files,umi_style", [(1, "none"),
                                               (2, "underscore")])
def test_run_with_device_directional_matches_jax_run(n_files, umi_style,
                                                     tmp_path, monkeypatch):
    from humid_tpu.pipeline import run as ref_run
    from humid_tpu_torch import run

    gen_dataset(np.random.default_rng(83 + n_files), str(tmp_path),
                n_reads=600, n_files=n_files, umi_style=umi_style,
                ragged=True, n_frac=0.1)
    files = [str(tmp_path / f"file{i}.fastq") for i in range(n_files)]
    kw = dict(log_name=os.devnull, run_stats=True, write_annotated=True)
    ref_run(files, dir_name=str(tmp_path / "jax"), **kw)
    monkeypatch.setenv(P.CLUSTER_ENV_VAR, "device")
    res = run(files, dir_name=str(tmp_path / "port"), device="cpu", **kw)
    assert res.extra["engine"]["directional"] == "device"
    _assert_same_dirs(tmp_path / "jax", tmp_path / "port")


def test_multi_host_replicated_cluster_takes_the_route(tmp_path,
                                                       monkeypatch):
    """The replicated cluster step of run_distributed (two hosts in
    threads) reaches the device route through cluster_dispatch and writes
    the single-process bytes."""
    from test_torch_distributed import _run_hosts, _same_dirs

    from humid_tpu_torch import run
    from humid_tpu_torch.parallel import pipeline as PP

    gen_dataset(np.random.default_rng(85), str(tmp_path), n_reads=600,
                n_files=2, umi_style="underscore")
    files = [str(tmp_path / f"file{i}.fastq") for i in range(2)]
    kw = dict(run_stats=True, write_annotated=True)
    run(files, dir_name=str(tmp_path / "one"), log_name=os.devnull,
        device="cpu", **kw)
    monkeypatch.setenv("HUMID_TPU_TORCH_CLUSTER_SHARDED", "0")
    monkeypatch.setenv(P.CLUSTER_ENV_VAR, "device")
    _run_hosts(files, 2, str(tmp_path / "dist"), **kw)
    assert PP.LAST_ENGINE["cluster"] == "replicated"
    assert PP.LAST_ENGINE["directional"] == "device"
    _same_dirs(str(tmp_path / "one"), str(tmp_path / "dist"))

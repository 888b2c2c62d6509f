"""Port parity: synthetic probe graphs and the host-side graph helpers of
``dragonfly2_tpu_torch`` are bit-identical to the JAX package's."""

import numpy as np
import pytest

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.models import graph_transformer as jgt
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.models import graph_transformer as tgt


@pytest.mark.parametrize("n_hosts,n_edges,seed", [(60, 3000, 0),
                                                  (200, 800, 7),
                                                  (33, 5, 3)])
def test_probe_graph_bit_identical(n_hosts, n_edges, seed):
    ref = JaxCluster(n_hosts=n_hosts, seed=seed).probe_graph(n_edges)
    got = SyntheticCluster(n_hosts=n_hosts, seed=seed).probe_graph(n_edges)
    assert got.n_nodes == ref.n_nodes and got.n_edges == ref.n_edges
    np.testing.assert_array_equal(got.node_ids, ref.node_ids)
    for name in ("node_features", "edge_src", "edge_dst", "edge_rtt_ns"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_host_pool_bit_identical():
    ref = JaxCluster(n_hosts=120, seed=5).hosts
    got = SyntheticCluster(n_hosts=120, seed=5).hosts
    for name in ("region", "zone", "rack", "idc", "is_seed", "upload_bw",
                 "upload_limit"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    a, b = np.arange(120), np.arange(120)[::-1].copy()
    np.testing.assert_array_equal(got.proximity(a, b), ref.proximity(a, b))


@pytest.mark.parametrize("cap", [4, 16, 128])
def test_neighbor_lists_bit_identical(cap):
    g = SyntheticCluster(n_hosts=80, seed=1).probe_graph(4000)
    ref = jgt.build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                   g.edge_rtt_ns, cap=cap)
    got = tgt.build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                   g.edge_rtt_ns, cap=cap)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("multiple", [1, 8, 64, 100])
def test_pad_graph_sparse_bit_identical(multiple):
    g = SyntheticCluster(n_hosts=50, seed=2).probe_graph(1500)
    nbr, val = tgt.build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                        g.edge_rtt_ns, cap=8)
    ref = jgt.pad_graph_sparse(g.node_features, nbr, val, multiple)
    got = tgt.pad_graph_sparse(g.node_features, nbr, val, multiple)
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_constants_and_block_helpers_match():
    assert tgt.PAD_ID == jgt.PAD_ID and tgt.PAD_ID.dtype == jgt.PAD_ID.dtype
    assert tgt.NEG_INF == jgt.NEG_INF
    for n_data in (1, 2, 6, 8):
        for chunk in (16, 1024):
            for n in (1, 15, 1023, 1026, 20000):
                assert (tgt.pad_multiple(n_data, chunk, n)
                        == jgt.pad_multiple(n_data, chunk, n))
    for n in (1, 7, 104, 112, 20480):
        for chunk in (16, 128, 1024):
            assert tgt._divisor_block(n, chunk) == jgt._divisor_block(n, chunk)
            assert tgt._flash_block(n, chunk) == jgt._flash_block(n, chunk)

"""The port's synthetic data and CSR batcher against the JAX package's."""
import numpy as np
import pytest
import torch

from infomax3d_tpu.data.synthetic import SyntheticMolecules as JaxMolecules
from infomax3d_tpu.graphs.batch import BucketSpec as JaxBucket
from infomax3d_tpu.graphs.batch import batch_graphs as jax_batch_graphs
from infomax3d_tpu_torch.data.synthetic import SyntheticMolecules
from infomax3d_tpu_torch.graphs.batch import (BucketSpec, batch_graphs,
                                              bucket_for, to_graph_batch)


@pytest.mark.parametrize("seed,n_min,n_max", [(0, 10, 26), (7, 4, 28)])
def test_synthetic_molecules_bit_identical(seed, n_min, n_max):
    mine = SyntheticMolecules(12, seed=seed, n_min=n_min, n_max=n_max)
    ref = JaxMolecules(12, seed=seed, n_min=n_min, n_max=n_max)
    np.testing.assert_array_equal(mine.targets, ref.targets)
    for a, b in zip(mine.mols, ref.mols):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _bucket_pair(graphs, n_graphs):
    b = bucket_for(graphs, n_graphs)
    return b, JaxBucket(b.n_graphs, b.n_nodes, b.n_edges, max_deg=b.max_deg,
                        csr=True, nmax=b.nmax)


@pytest.mark.parametrize("num,n_graphs", [(16, 16), (9, 12)])
def test_csr_batch_matches_jax(num, n_graphs):
    graphs = [SyntheticMolecules(num, seed=5, n_min=4, n_max=20).graph2d(i)
              for i in range(num)]
    mine_b, jax_b = _bucket_pair(graphs, n_graphs)
    mine = batch_graphs(graphs, mine_b)
    ref = jax_batch_graphs(graphs, jax_b)
    for k, v in mine.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_bench_shapes():
    """500 molecules at the bench's sizes give the bench's bucket."""
    ds = SyntheticMolecules(500, seed=0, n_min=10, n_max=26)
    graphs = [ds.graph2d(i) for i in range(500)]
    b = bucket_for(graphs, 500)
    assert (b.n_graphs, b.n_nodes, b.n_edges, b.max_deg, b.nmax) == \
        (500, 9216, 18432, 4, 26)
    arr = batch_graphs(graphs, b)
    assert int(arr["csr_row_ptr"][-1]) == 18180
    assert int(arr["node_mask"].sum()) == 9027


def test_receiver_sort_stable_with_padding_last():
    graphs = [SyntheticMolecules(6, seed=2).graph2d(i) for i in range(6)]
    b = bucket_for(graphs, 8)
    arr = batch_graphs(graphs, b)
    recv, N = arr["receivers"], b.n_nodes
    assert (np.diff(recv) >= 0).all()
    e_real = int(arr["csr_row_ptr"][-1])
    assert (recv[e_real:] == N).all() and (arr["senders"][e_real:] == N).all()
    rp = arr["csr_row_ptr"]
    for n in range(N):
        assert (recv[rp[n]:rp[n + 1]] == n).all()
        np.testing.assert_array_equal(arr["csr_pos"][rp[n]:rp[n + 1]],
                                      np.arange(rp[n + 1] - rp[n]))


def test_batcher_errors():
    graphs = [SyntheticMolecules(4, seed=1, n_min=10, n_max=12).graph2d(i)
              for i in range(4)]
    b = bucket_for(graphs, 4)
    with pytest.raises(ValueError, match="csr buckets need max_deg"):
        batch_graphs(graphs, BucketSpec(4, b.n_nodes, b.n_edges, csr=True))
    with pytest.raises(ValueError, match="exceeds mailbox width"):
        batch_graphs(graphs, BucketSpec(4, b.n_nodes, b.n_edges, max_deg=1,
                                        csr=True, nmax=b.nmax))
    with pytest.raises(ValueError, match="bucket.nmax"):
        batch_graphs(graphs, BucketSpec(4, b.n_nodes, b.n_edges,
                                        max_deg=b.max_deg, csr=True, nmax=2))
    with pytest.raises(ValueError, match="graphs > bucket"):
        batch_graphs(graphs, BucketSpec(3, b.n_nodes, b.n_edges))
    with pytest.raises(ValueError, match="> bucket"):
        batch_graphs(graphs, BucketSpec(4, 8, b.n_edges))


def test_graph_batch_tensors():
    graphs = [SyntheticMolecules(5, seed=4).graph2d(i) for i in range(5)]
    b = bucket_for(graphs, 5)
    arr = batch_graphs(graphs, b)
    g = to_graph_batch(arr, b, "cpu")
    assert g.max_deg == b.max_deg and g.nmax == b.nmax
    assert g.num_nodes == b.n_nodes and g.graph_mask.shape == (5,)
    assert g.senders.dtype == torch.int32 and g.node_mask.dtype == torch.bool
    np.testing.assert_array_equal(g.csr_row_ptr.numpy(), arr["csr_row_ptr"])
    assert g.to("cpu").rd_node_idx.shape == (5, b.nmax)
    # a non-CSR bucket (the segment path's batch) carries no CSR arrays
    # and, without nmax, no readout regroup; a CSR bucket needs its arrays
    plain = BucketSpec(5, b.n_nodes, b.n_edges)
    g = to_graph_batch(batch_graphs(graphs, plain), plain, "cpu")
    assert not g.csr and g.csc_perm is None and g.rd_node_idx is None
    np.testing.assert_array_equal(g.in_degree.numpy(), arr["in_degree"])
    with pytest.raises(ValueError, match="carry csr_row_ptr"):
        to_graph_batch(batch_graphs(graphs, plain), b, "cpu")

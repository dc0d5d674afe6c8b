"""2-D (dcn × ici) hierarchical mesh: every index family must produce
identical contents on a (hosts × chips) mesh as on the flat 1-D mesh.

The reference's two-level hashing (kmer_hash.hpp:24-54 — hash prefix picks
the process, suffix the local bucket) maps here to a 2-D device mesh whose
leading axis is the DCN (host) dimension; ownership is a flat shard id over
(host, chip) in host-major order, so all routing collectives become
topology-aware without any index-level changes."""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.index.sorted_api import SortedCountIndex
from kmerind_jax.debruijn.graph import DeBruijnGraph
from kmerind_jax.parallel.mesh import (
    make_mesh, make_mesh_2d, axes_of, DCN_AXIS, ICI_AXIS)

import oracle
from test_io import py_parse_fastq


def _mesh2d(n_hosts):
    import jax
    return make_mesh_2d(n_hosts=n_hosts, devices=jax.devices())


def test_mesh2d_shape_and_axes():
    m = _mesh2d(2)
    assert m.devices.shape == (2, 4)
    assert m.axis_names == (DCN_AXIS, ICI_AXIS)
    assert axes_of(m) == (DCN_AXIS, ICI_AXIS)
    assert axes_of(make_mesh(4)) == "shards"
    with pytest.raises(ValueError):
        make_mesh_2d(n_hosts=3)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_count_index_2d_equals_1d(ref_data_dir, n_hosts):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx2 = CountIndex(spec, mesh=_mesh2d(n_hosts))
    idx2.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    assert idx2.to_dict() == dict(expect)


def test_count_query_erase_2d(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = CountIndex(spec, mesh=_mesh2d(2))
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)

    keys = sorted(expect)[:64]
    kwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 21, 2)) for v in keys])
    got = idx.count(kwords)
    np.testing.assert_array_equal(got, [expect[k] for k in keys])

    nerased = idx.erase(kwords)
    assert nerased == len(keys)
    assert idx.size() == len(expect) - len(keys)


def test_position_index_2d_equals_oracle(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx1 = PositionIndex(spec, mesh=make_mesh(8), id_kind="short")
    idx1.build(path)
    idx2 = PositionIndex(spec, mesh=_mesh2d(2), id_kind="short")
    idx2.build(path)
    assert idx1.size() == idx2.size()
    assert idx1.unique_size() == idx2.unique_size()
    d1, d2 = idx1.to_dict(), idx2.to_dict()
    assert {k: sorted(v) for k, v in d1.items()} == \
           {k: sorted(v) for k, v in d2.items()}


def test_sorted_count_index_2d(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh2d(2))
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    assert idx.to_dict() == dict(expect)
    keys = sorted(expect)[:32]
    kwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 21, 2)) for v in keys])
    np.testing.assert_array_equal(idx.count(kwords),
                                  [expect[k] for k in keys])


def test_debruijn_2d(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    g1 = DeBruijnGraph(spec, mesh=make_mesh(8))
    g1.build(path)
    g2 = DeBruijnGraph(spec, mesh=_mesh2d(2))
    g2.build(path)
    assert g1.size() == g2.size()
    assert g1.to_dict() == g2.to_dict()

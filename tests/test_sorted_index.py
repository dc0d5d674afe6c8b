"""Range-partitioned (sorted) distributed index vs the oracle — the analog
of the reference's sorted-map tests (dsc::sorted_map/sorted_multimap/
counting_sorted_map, distributed_sorted_map.hpp:1407-2825): contents must
match the hash strategy and be invariant to shard count, and shards must
hold contiguous key ranges."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.index.sorted_api import (
    SortedCountIndex, SortedPositionIndex, SortedPositionQualityIndex)
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq


def _mesh(n):
    return make_mesh(n)


@pytest.mark.parametrize("p,canonical", [(1, True), (4, True), (8, True),
                                         (8, False)])
def test_sorted_count_any_p(ref_data_dir, p, canonical):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh(p), canonical=canonical)
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=canonical)
    assert idx.to_dict() == dict(expect), f"p={p}"


def test_sorted_count_globally_range_partitioned(ref_data_dir):
    """Shard i's keys must ALL precede shard i+1's (the defining layout of
    the sorted strategy) and match the splitter table."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    p = 8
    idx = SortedCountIndex(spec, mesh=_mesh(p))
    idx.build(path)
    idx._flush()
    keys = np.asarray(idx.store.keys)
    sizes = np.asarray(idx.store.size)
    per_shard = []
    for sp in range(p):
        vals = [spec.to_int(keys[sp, i]) for i in range(int(sizes[sp]))]
        assert vals == sorted(vals), f"shard {sp} not locally sorted"
        per_shard.append(vals)
    flat = [v for vals in per_shard for v in vals]
    assert flat == sorted(flat), "shards not globally range-partitioned"
    # splitters bound each shard's range
    splits = idx.splitter_table()
    for sp in range(p - 1):
        bound = spec.to_int(splits[sp])
        for v in per_shard[sp]:
            assert v < bound or sp == p - 1 or True  # owner = #splitters <= key
    # owner rule: shard of key k == number of splitters <= k
    bounds = [spec.to_int(splits[i]) for i in range(p - 1)]
    for sp, vals in enumerate(per_shard):
        for v in vals:
            assert sum(1 for b in bounds if b <= v) == sp


def test_sorted_count_queries_and_erase(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh(8))
    idx.build(path)
    expect = idx.to_dict()
    items = list(expect.items())[:30]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 21, 2)) for v, _ in items])
    got = idx.count(qwords)
    np.testing.assert_array_equal(got, [c for _, c in items])
    # find pairs
    fw, fc = idx.find(qwords)
    assert fc.tolist() == [c for _, c in items]
    # erase 10 keys
    nerased = idx.erase(qwords[:10])
    assert nerased == 10
    np.testing.assert_array_equal(idx.count(qwords[:10]), [0] * 10)
    assert idx.size() == len(expect) - 10
    # erase_if: drop singletons
    singles = sum(1 for v, c in idx.to_dict().items() if c == 1)
    assert idx.erase_if(lambda k, c: c == 1) == singles
    assert all(c >= 2 for c in idx.to_dict().values())


def test_sorted_count_incremental_inserts_resort(ref_data_dir):
    """Inserts after a flush mark the index dirty; the next query triggers
    a re-sort whose contents include both old and new rows."""
    spec = KmerSpec(15, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh(4), canonical=False)
    idx.insert(["A" * 15, "C" * 15, "A" * 15])
    assert idx.count(["A" * 15, "C" * 15, "G" * 15]).tolist() == [2, 1, 0]
    idx.insert(["G" * 15, "A" * 15])
    assert idx.count(["A" * 15, "C" * 15, "G" * 15]).tolist() == [3, 1, 1]
    assert idx.size() == 3
    # weighted inserts
    idx.insert_counts(["T" * 14 + "A"], [7])
    assert idx.count(["T" * 14 + "A"]).tolist() == [7]


def test_sorted_count_range_scan(ref_data_dir):
    """items_in_range: the capability hash distribution cannot offer."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh(8))
    idx.build(path)
    expect = idx.to_dict()
    all_keys = sorted(expect)
    lo, hi = all_keys[5], all_keys[25]
    lo_w = oracle.int_to_codes(lo, 21, 2)
    hi_w = oracle.int_to_codes(hi, 21, 2)
    got = idx.items_in_range(spec.pack_codes(lo_w), spec.pack_codes(hi_w))
    want = sorted((v, expect[v]) for v in all_keys if lo <= v < hi)
    assert got == want


def test_sorted_count_save_load(tmp_path, ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = SortedCountIndex(spec, mesh=_mesh(4))
    idx.build(path)
    f = tmp_path / "sorted.npz"
    idx.save(f)
    idx2 = SortedCountIndex.load(f, mesh=_mesh(8))
    assert idx2.to_dict() == idx.to_dict()


@pytest.mark.parametrize("p", [1, 8])
def test_sorted_position_any_p(ref_data_dir, p):
    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = SortedPositionIndex(spec, mesh=_mesh(p), id_kind="short")
    idx.build(path)
    # must equal the hash multimap's contents exactly
    href = PositionIndex(spec, mesh=_mesh(p), id_kind="short")
    href.build(path)
    assert idx.to_dict() == href.to_dict(), f"p={p}"


def test_sorted_position_find_and_erase(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = SortedPositionIndex(spec, mesh=_mesh(8), id_kind="short")
    idx.build(path)
    expect = idx.to_dict()
    items = list(expect.items())[:20]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, k, 2)) for v, _ in items])
    ids, mask = idx.find(qwords, max_per_query=16)
    for i, (v, want) in enumerate(items):
        got = sorted(int(x) for x in ids[i][mask[i]])
        assert got == want
    cnt = idx.count(qwords)
    np.testing.assert_array_equal(cnt, [len(w) for _, w in items])
    # erase by key
    want_erased = sum(len(expect[v]) for v, _ in items[:5])
    assert idx.erase(qwords[:5]) == want_erased
    np.testing.assert_array_equal(idx.count(qwords[:5]), [0] * 5)


def test_sorted_count_matches_hash_index(ref_data_dir):
    """Strategy equivalence: identical contents from either distribution
    (the reference's guarantee across its map families)."""
    path = ref_data_dir / "test.medium.fastq"
    if not path.exists():
        path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(31, DNA)
    sidx = SortedCountIndex(spec, mesh=_mesh(8))
    sidx.build(path)
    hidx = CountIndex(spec, mesh=_mesh(8))
    hidx.build(path)
    assert sidx.to_dict() == hidx.to_dict()


def test_sorted_position_explicit_insert_and_predicates():
    """SortedPositionIndex.insert + count_if/find_if mirror the hash
    multimap surface (sorted_multimap, distributed_sorted_map.hpp:2333)."""
    import jax.numpy as jnp
    spec = KmerSpec(9, DNA)
    idx = SortedPositionIndex(spec, mesh=make_mesh(4))
    kmers = ["ACGTACGTA", "ACGTACGTA", "CCCCCCCCC", "GGGGGGGGG"]
    ids = np.array([11, 22, 33, 44], np.uint64)
    idx.insert(kmers, ids)
    d = idx.to_dict()
    acgt = spec.to_int(spec.pack_codes(DNA.encode("ACGTACGTA")))
    cccc = spec.to_int(spec.pack_codes(DNA.encode("CCCCCCCCC")))
    gggg = spec.to_int(spec.pack_codes(DNA.encode("GGGGGGGGG")))
    assert sorted(d[acgt]) == [11, 22]
    assert d[cccc] == [33] and d[gggg] == [44]

    got = idx.count_if(lambda w, c: c == 2, kmers=["ACGTACGTA", "CCCCCCCCC"])
    np.testing.assert_array_equal(got, [2, 0])
    pairs = idx.count_if(lambda k, hi, lo, q: (lo & 1) == 1)
    assert dict(pairs) == {acgt: 1, cccc: 1}
    ids_out, mask = idx.find_if(lambda w, c: c == 2,
                                kmers=["ACGTACGTA", "CCCCCCCCC"])
    assert mask.sum() == 2
    assert sorted(ids_out[0][mask[0]].tolist()) == [11, 22]

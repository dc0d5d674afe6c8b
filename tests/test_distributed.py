"""Distributed index over an 8-device CPU mesh vs the oracle — the analog of
the reference's mpirun -np sweeps (mpi_test_distribute.cpp,
test strategy SURVEY §4): index contents must be invariant to shard count."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.io import read_file
from kmerind_jax.parallel.mesh import make_mesh
from kmerind_jax.parallel import distribute as dist
from kmerind_jax.parallel.mesh import SHARD_AXIS

import oracle
from test_io import py_parse_fastq


def _mesh(n):
    return make_mesh(n)


# ---------------------------------------------------------------- distribute
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_distribute_roundtrip(p):
    """distribute + undistribute is the identity on routed values
    (A2ADistributeTest analog, src/io/test/mpi_test_distribute.cpp:31-90)."""
    from jax.sharding import PartitionSpec as P

    mesh = _mesh(p)
    n = 64
    cap = 64
    rng = np.random.default_rng(p)
    vals = rng.integers(0, 1 << 30, size=(p, n)).astype(np.uint32)
    owners = rng.integers(0, p, size=(p, n)).astype(np.int32)
    valid = rng.random((p, n)) < 0.9

    def body(v, o, va):
        (rv,), rvalid, route = dist.distribute(
            (v[0],), o[0], va[0], p, cap, SHARD_AXIS)
        # reply = received value + 1; returned to requester
        reply = jnp.where(rvalid, rv + 1, 0)
        (back,) = dist.undistribute((reply,), route, p, cap, SHARD_AXIS)
        return back[None], route.overflow[None]

    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 3,
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS))))
    back, ovf = f(jnp.asarray(vals), jnp.asarray(owners), jnp.asarray(valid))
    back = np.asarray(back)
    assert int(np.asarray(ovf).max()) == 0
    np.testing.assert_array_equal(back[valid], vals[valid] + 1)


@pytest.mark.parametrize("p", [2, 4])
def test_distribute_overflow_reported(p):
    from jax.sharding import PartitionSpec as P

    mesh = _mesh(p)
    n, cap = 32, 4  # everything to owner 0 -> guaranteed overflow
    vals = np.arange(p * n, dtype=np.uint32).reshape(p, n)
    owners = np.zeros((p, n), np.int32)
    valid = np.ones((p, n), bool)

    def body(v, o, va):
        (rv,), rvalid, route = dist.distribute(
            (v[0],), o[0], va[0], p, cap, SHARD_AXIS)
        return route.overflow[None]

    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 3,
        out_specs=P(SHARD_AXIS)))
    ovf = np.asarray(f(jnp.asarray(vals), jnp.asarray(owners), jnp.asarray(valid)))
    assert ovf.max() == n - cap


# ------------------------------------------------------------- count index
@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_index_any_p(ref_data_dir, p, canonical):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = CountIndex(spec, mesh=_mesh(p), canonical=canonical)
    idx.build(path)

    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=canonical)
    assert idx.to_dict() == dict(expect), f"p={p}"


def test_count_query_and_erase(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = CountIndex(spec, mesh=_mesh(8))
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)

    # query by string (canonicalized internally)
    qstr = [seqs[0][i:i + 21] for i in range(10)]
    got = idx.count(qstr)
    want = [expect[min(oracle.kmer_int([int(c) for c in DNA.encode(s)], 2),
                       oracle.revcomp_int(oracle.kmer_int([int(c) for c in DNA.encode(s)], 2), 21, DNA))]
            for s in qstr]
    np.testing.assert_array_equal(got, want)

    # erase half the distinct keys, recount
    keys = sorted(expect)[::2]
    kwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 21, 2)) for v in keys])
    nerased = idx.erase(kwords)
    assert nerased == len(keys)
    assert idx.size() == len(expect) - len(keys)
    got2 = idx.count(kwords)
    assert np.all(got2 == 0)


def test_count_incremental_two_files(ref_data_dir):
    """Insert two batches; counts must merge (multi-file build)."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(15, DNA)
    idx = CountIndex(spec, mesh=_mesh(4))
    idx.build(path)
    idx.build(path)  # same file again -> all counts doubled
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = {k: 2 * v for k, v in
              oracle.count_index(seqs, 15, DNA, canonical=True).items()}
    assert idx.to_dict() == expect


def test_count_insert_explicit_kmers():
    spec = KmerSpec(9, DNA)
    idx = CountIndex(spec, mesh=_mesh(4), canonical=False)
    kmers = ["ACGTACGTA", "ACGTACGTA", "CCCCCCCCC"]
    idx.insert(kmers)
    got = idx.count(["ACGTACGTA", "CCCCCCCCC", "GGGGGGGGG"])
    np.testing.assert_array_equal(got, [2, 1, 0])


# ---------------------------------------------------------- position index
@pytest.mark.parametrize("p", [1, 4, 8])
def test_position_index_any_p(ref_data_dir, p):
    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = PositionIndex(spec, mesh=_mesh(p), id_kind="short")
    idx.build(path)

    recs = py_parse_fastq(path.read_text())
    seqs_ids = []
    for hdr, seq, qual, rstart, sstart in recs:
        ids = [(rstart << 16) | (sstart - rstart + i)
               for i in range(len(seq) - k + 1)]
        seqs_ids.append((seq, ids))
    expect = oracle.position_index(seqs_ids, k, DNA, canonical=False)
    assert idx.to_dict() == expect, f"p={p}"


def test_position_find(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = PositionIndex(spec, mesh=_mesh(8), id_kind="short")
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


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_sample_sort_global_order(p):
    """Distributed sample sort: concatenated shard outputs are globally
    sorted and a permutation of the valid inputs (mxx::sort /
    samplesort_buf semantics)."""
    from kmerind_jax.parallel.sample_sort import make_sample_sort_step

    mesh = _mesh(p)
    n, w = 256, 2
    rng = np.random.default_rng(p)
    words = rng.integers(0, 1 << 31, size=(p, n, w)).astype(np.uint32)
    valid = rng.random((p, n)) < 0.9
    cap = 2 * n  # generous headroom

    step = make_sample_sort_step(mesh, p, cap)
    s_words, s_valid, ovf = map(np.asarray, step(
        jnp.asarray(words), jnp.asarray(valid)))
    assert ovf.max() == 0

    # collect valid rows in shard-then-position order
    got = []
    for sp in range(p):
        rows = s_words[sp][s_valid[sp]]
        got.append(rows)
    flat = np.concatenate(got)
    ints = [(int(r[0]) << 32) | int(r[1]) for r in flat]
    assert ints == sorted(ints), "not globally sorted"
    want = sorted((int(r[0]) << 32) | int(r[1])
                  for r in words[valid])
    assert ints == want, "not a permutation of inputs"


def test_position_find_truncation_and_growth(ref_data_dir):
    """High-multiplicity keys: find must either auto-grow the gather width
    (grow_to_fit, default) or report the true multiplicity so truncation is
    visible (the reference two-pass size estimation,
    distributed_densehash_map.hpp:328-420)."""
    spec = KmerSpec(15, DNA)
    idx = PositionIndex(spec, mesh=_mesh(4), id_kind="short",
                        canonical=False)
    hot = "ACGTACGTACGTACG"
    rare = "C" * 15
    words = np.stack([spec.from_string(hot)] * 100
                     + [spec.from_string(rare)])
    idx._insert_pairs(words, np.zeros(101, np.uint32),
                      np.arange(101).astype(np.uint32),
                      np.zeros(101, np.float32))
    # default: auto-grows past max_per_query=8
    ids, mask = idx.find([hot, rare, "G" * 15], max_per_query=8)
    assert mask.shape[1] >= 100
    np.testing.assert_array_equal(mask.sum(axis=1), [100, 1, 0])
    assert sorted(int(x) for x in ids[0][mask[0]]) == list(range(100))
    # explicit truncation reporting
    ids, mask, counts = idx.find([hot, rare], max_per_query=8,
                                 grow_to_fit=False)
    assert mask.shape[1] == 8
    np.testing.assert_array_equal(counts, [100, 1])
    np.testing.assert_array_equal(mask.sum(axis=1), [8, 1])


@pytest.mark.parametrize("p", [1, 8])
def test_position_erase_family(ref_data_dir, p):
    """Multimap erase/erase_if/filter (densehash_multimap erase paths,
    distributed_densehash_map.hpp:1603+)."""
    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = PositionIndex(spec, mesh=_mesh(p), id_kind="short")
    idx.build(path)
    expect = idx.to_dict()
    items = list(expect.items())
    # erase by key: pick 5 keys, all their pairs disappear
    victims = [v for v, _ in items[:5]]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, k, 2)) for v in victims])
    want_erased = sum(len(expect[v]) for v in victims)
    assert idx.erase(qwords) == want_erased
    np.testing.assert_array_equal(idx.count(qwords), [0] * 5)
    assert idx.size() == sum(len(v) for v in expect.values()) - want_erased
    # erase_if: drop pairs with odd id_lo
    import jax.numpy as _jnp
    n_odd = sum(1 for ids in idx.to_dict().values()
                for i in ids if i & 1)
    got = idx.erase_if(lambda kk, h, l, q: (l & 1) == 1)
    assert got == n_odd
    assert all((i & 1) == 0 for ids in idx.to_dict().values() for i in ids)
    # filter: keep nothing with id_lo > 1000
    before = idx.size()
    kept = sum(1 for ids in idx.to_dict().values()
               for i in ids if (i & 0xFFFFFFFF) <= 1000)
    idx.filter(lambda kk, h, l, q: l <= 1000)
    assert idx.size() == kept <= before


def test_query_exchange_capacity_scales_inverse_p(ref_data_dir):
    """Query paths must size per-destination buckets ~mq/p (not mq), so the
    exchanged tensor stays ~mq instead of p*mq (the reference's all2allv
    ships exact counts, incremental_mxx.hpp:1087-1098)."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    p = 8
    idx = CountIndex(spec, mesh=_mesh(p), canonical=False)
    idx.build(path)
    expect = idx.to_dict()
    # 4096 distinct queries (hash-uniform routing): a mix of present and
    # absent keys
    rng = np.random.default_rng(0)
    qints = list(expect)[:64] + sorted(
        {int(x) for x in rng.integers(0, 1 << 42, size=4096)})[:4032]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 21, 2)) for v in qints])
    got = idx.count(qwords)
    np.testing.assert_array_equal(
        got, [expect.get(v, 0) for v in qints])
    count_keys = [kk for kk in idx._step_cache if kk[0] == "count"]
    assert count_keys, "no count step compiled"
    mq, bucket_cap = count_keys[-1][1], count_keys[-1][2]
    # started at ~mq/p (pow2-rounded with fill headroom); the retry loop may
    # double it a bounded number of times, but it stays well under mq
    assert bucket_cap < mq, (mq, bucket_cap)


def test_position_explicit_insert_and_predicates(ref_data_dir):
    """PositionIndex.insert of explicit (kmer, id) pairs + count_if/find_if
    (the generic Index::insert/count_if/find_if surface, kmer_index.hpp:
    157-201, applied to the multimap)."""
    import jax.numpy as jnp
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.index.api import PositionIndex
    from kmerind_jax.parallel.mesh import make_mesh

    spec = KmerSpec(9, DNA)
    idx = PositionIndex(spec, mesh=make_mesh(4))  # single-strand default
    kmers = ["ACGTACGTA", "ACGTACGTA", "CCCCCCCCC", "GGGGGGGGG"]
    ids = np.array([11, 22, 33, 44], np.uint64)
    idx.insert(kmers, ids)
    d = idx.to_dict()
    acgt = spec.to_int(spec.pack_codes(DNA.encode("ACGTACGTA")))
    cccc = spec.to_int(spec.pack_codes(DNA.encode("CCCCCCCCC")))
    gggg = spec.to_int(spec.pack_codes(DNA.encode("GGGGGGGGG")))
    assert sorted(d[acgt]) == [11, 22]
    assert d[cccc] == [33] and d[gggg] == [44]

    # canonical preset folds GGGG... into CCCC... on explicit insert too
    cidx = PositionIndex(spec, mesh=make_mesh(4), canonical=True)
    cidx.insert(kmers, ids)
    dc = cidx.to_dict()
    assert sorted(dc[cccc]) == [33, 44] and gggg not in dc

    # count_if with kmers: zero out queries whose multiplicity != 2
    got = idx.count_if(lambda w, c: c == 2, kmers=["ACGTACGTA", "CCCCCCCCC"])
    np.testing.assert_array_equal(got, [2, 0])  # CCCC multiplicity is 1
    got = idx.count_if(lambda w, c: c > 2, kmers=["ACGTACGTA"])
    np.testing.assert_array_equal(got, [0])

    # full-scan count_if over pair columns: pairs with an odd id
    pairs = idx.count_if(lambda k, hi, lo, q: (lo & 1) == 1)
    assert dict(pairs) == {acgt: 1, cccc: 1}  # ids 11 and 33 are odd

    # find_if with kmers: CCCC fails the pred, its pairs are masked out
    ids_out, mask = idx.find_if(lambda w, c: c == 2,
                                kmers=["ACGTACGTA", "CCCCCCCCC"])
    assert mask.sum() == 2
    assert sorted(ids_out[0][mask[0]].tolist()) == [11, 22]
    ids_out, mask = idx.find_if(lambda w, c: c > 5, kmers=["ACGTACGTA"])
    assert mask.sum() == 0

"""De Bruijn graph construction vs a Python oracle on the reference's own
de Bruijn fixture (test.debruijn.small.fastq — the input of
test_de_bruijn_graph_construction.cpp)."""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.debruijn import DeBruijnGraph
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq

K = 21  # the reference driver's k (test_de_bruijn_graph_construction.cpp:118)


def _rev4(x):
    """DNA16 complement == 4-bit reversal."""
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def oracle_debruijn(seqs, k, canonical=True):
    """kmer_int -> [outA,C,G,T, inA,C,G,T, self] — edge_counts semantics
    (de_bruijn_node_trait.hpp:195-245): neighbor chars encode as DNA16
    nibbles from the RAW character ('N' -> 0xF = all four), one increment
    per set bit; canonical flip swaps sides and 4-bit-reverses each."""
    from kmerind_jax.alphabets import DNA16
    nodes = {}
    for seq in seqs:
        codes = [int(c) for c in DNA.encode(seq)]
        nibs = [int(DNA16.from_ascii[ord(c)]) for c in seq]
        for i in range(len(codes) - k + 1):
            v = oracle.kmer_int(codes[i:i + k], 2)
            left = nibs[i - 1] if i > 0 else 0
            right = nibs[i + k] if i + k < len(codes) else 0
            if canonical:
                rc = oracle.revcomp_int(v, k, DNA)
                if rc < v:
                    v = rc
                    left, right = _rev4(right), _rev4(left)
            cnt = nodes.setdefault(v, [0] * 9)
            cnt[8] += 1
            for b in range(4):
                if (right >> b) & 1:
                    cnt[b] += 1        # out edge
                if (left >> b) & 1:
                    cnt[4 + b] += 1    # in edge
    return {v: tuple(c) for v, c in nodes.items()}


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("canonical", [True, False])
def test_debruijn_vs_oracle(ref_data_dir, p, canonical):
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    g = DeBruijnGraph(spec, mesh=make_mesh(p), canonical=canonical)
    g.build(path)

    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle_debruijn(seqs, K, canonical=canonical)
    got = g.to_dict()
    assert set(got) == set(expect), f"p={p}"
    for v in expect:
        assert got[v] == expect[v], f"node {v:x} p={p}"


def test_debruijn_queries(ref_data_dir):
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    g = DeBruijnGraph(spec, mesh=make_mesh(4))
    g.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle_debruijn(seqs, K, canonical=True)

    # node_counts on known nodes
    items = list(expect.items())[:20]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, K, 2)) for v, _ in items])
    vals, found = g.node_counts(qwords)
    assert found.all()
    for i, (v, want) in enumerate(items):
        assert tuple(vals[i]) == want

    # edge_exists flags match counters
    flags = g.edge_exists(qwords)
    for i, (v, want) in enumerate(items):
        np.testing.assert_array_equal(flags[i], np.array(want[:8]) > 0)

    # absent node
    vals0, found0 = g.node_counts(["A" * K])
    if spec.to_int(spec.from_string("A" * K)) not in expect:
        assert not found0[0]

    # neighbors of an interior node: walk one step and verify key exists
    interior = next(v for v, c in expect.items()
                    if sum(c[:4]) > 0 and sum(c[4:8]) > 0)
    kstr = DNA.decode(np.array(oracle.int_to_codes(interior, K, 2), np.uint8))
    ins, outs = g.neighbors(kstr)
    assert ins and outs
    for nbr, cnt in outs:
        assert cnt == expect[interior][["A", "C", "G", "T"].index(nbr[-1])]


def test_debruijn_record_boundaries():
    """First/last kmers of a read must have no left/right edge."""
    import tempfile, pathlib
    seq = "ACGTACGTTGCAACGTTGCAGGTACCGGTA"
    text = f"@r\n{seq}\n+\n{'I' * len(seq)}\n"
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "one.fastq"
        path.write_text(text)
        spec = KmerSpec(K, DNA)
        g = DeBruijnGraph(spec, mesh=make_mesh(2), canonical=False)
        g.build(path)
    got = g.to_dict()
    first = oracle.kmer_int([int(c) for c in DNA.encode(seq[:K])], 2)
    # first kmer: no in edges
    assert sum(got[first][4:8]) == 0
    last = oracle.kmer_int([int(c) for c in DNA.encode(seq[-K:])], 2)
    assert sum(got[last][:4]) == 0


def test_debruijn_chunked_insert(ref_data_dir):
    """Chunked streaming build must produce identical edge counters
    (regression: chunks need 1 base of left context)."""
    from kmerind_jax.io import read_file
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    whole = DeBruijnGraph(spec, mesh=make_mesh(2)).build(path)
    chunked = DeBruijnGraph(spec, mesh=make_mesh(2))
    chunked.insert_batch(read_file(path, DNA), chunk_bases=97)
    assert chunked.to_dict() == whole.to_dict()


def test_neighbors_of_noncanonical_query(ref_data_dir):
    """Regression: querying neighbors via the non-canonical strand used to
    walk from the wrong orientation."""
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    g = DeBruijnGraph(spec, mesh=make_mesh(2))
    g.build(path)
    d = g.to_dict()
    interior = next(v for v, c in d.items() if sum(c[:4]) and sum(c[4:8]))
    canon_str = DNA.decode(np.array(oracle.int_to_codes(interior, K, 2), np.uint8))
    rc_int = oracle.revcomp_int(interior, K, DNA)
    rc_str = DNA.decode(np.array(oracle.int_to_codes(rc_int, K, 2), np.uint8))
    assert oracle.revcomp_int(rc_int, K, DNA) == interior
    a = g.neighbors(canon_str)
    b = g.neighbors(rc_str)   # same node queried via the other strand
    assert a == b


# ---------------------------------------------------------------- quality
def oracle_debruijn_quality(seqs, quals, k):
    """kmer_int -> (counters..., n_windows, quality_sum) — the
    QualityDeBruijnGraph payload: DeBruijnGraph's counters + the window
    count + the sum of windowed scores (exp2 of the summed log2 base
    probabilities, 0.0 when any base is 'incorrect' —
    quality_score_iterator.hpp:162-173)."""
    from kmerind_jax.quality import ILLUMINA18
    lut = ILLUMINA18.decode_lut.astype(np.float64)
    f32_lowest = float(np.finfo(np.float32).min)
    lut32 = np.where(lut == np.finfo(np.float64).min, f32_lowest,
                     lut).astype(np.float32)
    base = oracle_debruijn(seqs, k, canonical=True)
    out = {v: list(c) + [0, 0.0] for v, c in base.items()}
    for seq, q in zip(seqs, quals):
        codes = [int(c) for c in DNA.encode(seq)]
        logp = lut32[np.clip(np.frombuffer(q.encode(), np.uint8)
                             .astype(np.int32) - ILLUMINA18.min_input,
                             0, 95)]
        bad = (logp <= f32_lowest) | (logp >= 0.0)
        for i in range(len(codes) - k + 1):
            v = oracle.kmer_int(codes[i:i + k], 2)
            rc = oracle.revcomp_int(v, K, DNA)
            v = min(v, rc)
            if bad[i:i + k].any():
                score = 0.0
            else:
                score = float(np.exp2(np.sum(logp[i:i + k],
                                             dtype=np.float64)))
            out[v][9] += 1
            out[v][10] += score
    return out


def test_quality_debruijn_vs_oracle(ref_data_dir):
    from kmerind_jax.debruijn import QualityDeBruijnGraph
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    g = QualityDeBruijnGraph(spec, mesh=make_mesh(4))
    g.build(path)
    recs = py_parse_fastq(path.read_text())
    seqs = [r[1] for r in recs]
    quals = [r[2] for r in recs]
    expect = oracle_debruijn_quality(seqs, quals, K)
    got = g.to_dict()
    assert set(got) == set(expect)
    for v, exp in expect.items():
        assert got[v][:10] == tuple(exp[:10]), f"node {v:x}"
        np.testing.assert_allclose(got[v][10], exp[10], rtol=2e-4,
                                   atol=1e-6)

    # plain counters agree with the quality-free graph
    g0 = DeBruijnGraph(spec, mesh=make_mesh(4)).build(path)
    base = g0.to_dict()
    for v in base:
        assert got[v][:9] == base[v]

    # node_quality reports the mean window score
    items = [v for v in expect if expect[v][9] > 0][:16]
    qwords = np.stack([
        spec.pack_codes(oracle.int_to_codes(v, K, 2)) for v in items])
    mean, n, found = g.node_quality(qwords)
    assert found.all()
    for j, v in enumerate(items):
        assert int(n[j]) == expect[v][9]
        np.testing.assert_allclose(
            mean[j], expect[v][10] / expect[v][9], rtol=2e-4, atol=1e-6)


def test_quality_debruijn_save_load(ref_data_dir, tmp_path):
    from kmerind_jax.debruijn import QualityDeBruijnGraph
    path = ref_data_dir / "test.debruijn.small.fastq"
    spec = KmerSpec(K, DNA)
    g = QualityDeBruijnGraph(spec, mesh=make_mesh(4)).build(path)
    f = tmp_path / "qdbg.npz"
    g.save(f)
    back = QualityDeBruijnGraph.load(f, mesh=make_mesh(8))
    a, b = g.to_dict(), back.to_dict()
    assert set(a) == set(b)
    for v in a:
        assert a[v][:10] == b[v][:10]
        # float32 sums re-accumulate in routed order after load, and the
        # run store reads them back as prefix-sum differences — both
        # reorder the additions
        np.testing.assert_allclose(a[v][10], b[v][10], rtol=1e-3,
                                   atol=1e-5)


def test_node_counts_accepts_big_int_keys(ref_data_dir):
    """Regression: _to_words overflowed uint32 for int keys of k>16
    k-mers (spec.to_int values are arbitrary-precision)."""
    spec = KmerSpec(K, DNA)
    g = DeBruijnGraph(spec, initial_capacity=1 << 8)
    g.build(ref_data_dir / "test.debruijn.small.fastq")
    d = g.to_dict()
    keys = list(d.keys())[:5]
    counts, found = g.node_counts(keys)
    assert found.all()
    for k, got in zip(keys, counts):
        assert tuple(int(x) for x in got) == tuple(d[k])
    np.testing.assert_array_equal(
        spec.from_int(keys[0]),
        spec.from_int(spec.to_int(spec.from_int(keys[0]))))

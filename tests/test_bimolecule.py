"""Bimolecule map preset (kmer_index.hpp:436-562): keys hashed/compared in
CANONICAL form — both strands answer the same entry — but the stored
(reported) key keeps the INPUT-strand orientation of the earliest
occurrence.  Validated against a pure-Python oracle on the reference's own
fixtures, invariant to shard count (the mpirun -np sweep analog)."""

from collections import Counter

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import BimoleculeCountIndex, CountIndex
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq


def _mesh(n):
    return make_mesh(n)


def bimol_oracle(seqs, k, alphabet=DNA):
    """{input_strand_kmer_int: count} — counts accumulate canonically;
    the reported key is the input-strand orientation of the FIRST
    occurrence in file order."""
    counts = Counter()
    rep = {}
    for seq in seqs:
        for v in oracle.seq_kmers(seq, k, alphabet):
            c = min(v, oracle.revcomp_int(v, k, alphabet))
            counts[c] += 1
            if c not in rep:
                rep[c] = v
    return {rep[c]: n for c, n in counts.items()}


def _int_to_words(spec, v):
    return spec.pack_codes(
        oracle.int_to_codes(v, spec.k, spec.bits_per_char))


@pytest.mark.parametrize("p", [1, 2, 8])
def test_bimol_build_any_p(ref_data_dir, p):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(p))
    idx.build(path)

    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = bimol_oracle(seqs, 21)
    assert idx.to_dict() == expect, f"p={p}"


def test_bimol_counts_match_canonical(ref_data_dir):
    """Counts (by canonical key) must equal the canonical CountIndex's."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(15, DNA)
    bi = BimoleculeCountIndex(spec, mesh=_mesh(4)).build(path)
    ca = CountIndex(spec, mesh=_mesh(4)).build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, 15, DNA, canonical=True)
    keys = sorted(expect)
    kwords = np.stack([_int_to_words(spec, v) for v in keys])
    np.testing.assert_array_equal(bi.count(kwords), ca.count(kwords))
    np.testing.assert_array_equal(bi.count(kwords),
                                  [expect[v] for v in keys])


def test_bimol_both_strands_answer_same_entry():
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4))
    # GGGGGGGGT: rc = ACCCCCCCC < input, so the input strand is NOT
    # canonical — stored orientation must still be the input strand
    idx.insert(["GGGGGGGGT", "GGGGGGGGT"])
    np.testing.assert_array_equal(
        idx.count(["GGGGGGGGT", "ACCCCCCCC"]), [2, 2])
    d = idx.to_dict()
    v = oracle.kmer_int([int(c) for c in DNA.encode("GGGGGGGGT")], 2)
    assert d == {v: 2}


def test_bimol_first_occurrence_wins():
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(2))
    idx.insert(["GGGGGGGGT"])      # earlier occurrence, reverse strand
    idx.insert(["ACCCCCCCC"])      # same canonical key, forward strand
    d = idx.to_dict()
    v = oracle.kmer_int([int(c) for c in DNA.encode("GGGGGGGGT")], 2)
    assert d == {v: 2}


def test_bimol_find_reports_stored_orientation():
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4))
    idx.insert(["GGGGGGGGT", "AAAAAAAAC"])
    words, counts = idx.find(["ACCCCCCCC", "AAAAAAAAC", "TTTTTTTTT"])
    got = {spec.to_int(words[i]): int(counts[i])
           for i in range(words.shape[0])}
    vg = oracle.kmer_int([int(c) for c in DNA.encode("GGGGGGGGT")], 2)
    va = oracle.kmer_int([int(c) for c in DNA.encode("AAAAAAAAC")], 2)
    assert got == {vg: 1, va: 1}


def test_bimol_erase_and_erase_if(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4)).build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = bimol_oracle(seqs, 21)
    total = len(expect)

    # erase half the keys, queried by their STORED (input-strand) form
    keys = sorted(expect)[::2]
    kwords = np.stack([_int_to_words(spec, v) for v in keys])
    nerased = idx.erase(kwords)
    assert nerased == len(keys)
    assert idx.size() == total - len(keys)
    assert np.all(idx.count(kwords) == 0)

    # erase_if over local entries: drop all remaining singletons
    import jax.numpy as jnp
    n1 = sum(1 for v, c in expect.items() if c == 1 and v not in set(keys))
    got = idx.erase_if(lambda k, c: c == 1)
    assert got == n1
    left = {v: c for v, c in expect.items()
            if c > 1 and v not in set(keys)}
    assert idx.to_dict() == left


def test_bimol_save_load_roundtrip(tmp_path, ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4)).build(path)
    expect = idx.to_dict()
    f = tmp_path / "bimol.npz"
    idx.save(f)
    idx2 = BimoleculeCountIndex.load(f, mesh=_mesh(8))
    assert idx2.to_dict() == expect


def test_bimol_saturating_counts():
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(2), saturate=3)
    idx.insert(["GGGGGGGGT"] * 7)
    np.testing.assert_array_equal(idx.count(["ACCCCCCCC"]), [3])


def test_bimol_balanced_flush_capacity_bounded():
    """Growth under merge (the round-5 regression fix): merging each
    pending run into the consolidated store one at a time doubled the
    capacity per run (next_pow2(big + small) == 2*big — 51 GB RSS on a
    9 KB corpus before the balanced tree).  Streaming MANY small batches
    must keep capacity ~next_pow2(total routed rows), and counts exact."""
    rng = np.random.default_rng(3)
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4),
                               initial_capacity=1 << 6)
    seqs = []
    for i in range(40):  # 40 separate pending runs before one flush
        s = "".join(rng.choice(list("ACGT"), size=24))
        seqs.append(s)
        idx.insert([s[j:j + 9] for j in range(len(s) - 8)])
    # oracle: canonical counts (orientation checked elsewhere)
    from collections import Counter
    cnt = Counter()
    for s in seqs:
        for j in range(len(s) - 8):
            km = s[j:j + 9]
            rc = km.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            cnt[min(km, rc)] += 1
    assert idx.size() == len(cnt)
    qs = list(cnt)
    np.testing.assert_array_equal(idx.count(qs), [cnt[q] for q in qs])
    # capacity is bounded by a small multiple of the routed rows
    # (worst-case all rows to one shard; runs are pow2-padded)
    total_rows = sum(len(s) - 8 for s in seqs)
    assert idx.capacity <= 16 * (1 << (total_rows - 1).bit_length()), (
        idx.capacity, total_rows)


def test_bimol_note_weight_true_total_reread():
    """The int32 weight-overflow guard's first escape: when the
    conservative host counter crosses the budget, the TRUE per-shard
    totals are re-read from the device csum and the counter tightens
    instead of raising (api.BimoleculeCountIndex._note_weight)."""
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(2))
    idx.insert(["ACGTACGTA"] * 5)
    idx._flush()
    # pretend we already ingested near the budget; the true total is 5
    idx._ingested_weight = CountIndex._I32_WEIGHT_GUARD - 1
    idx._note_weight(10)
    assert idx._ingested_weight == 5 + 10
    np.testing.assert_array_equal(idx.count(["ACGTACGTA"]), [5])


def test_bimol_note_weight_saturate_compact_escape():
    """Second escape: a SATURATING bimolecule map relieves true weight
    pressure by compacting with the clamp (exact — saturation is
    monotone), rebounding the counter to size * saturate."""
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(2), saturate=3)
    idx.insert(["ACGTACGTA"] * 7 + ["CCCCGGGGA"] * 2)
    idx._flush()
    idx._ingested_weight = CountIndex._I32_WEIGHT_GUARD - 1
    # true totals can't relieve (pretend they equal the counter): force
    # the saturate-compact branch by making the re-read also too big
    real_fetch = idx._fetch
    calls = {"n": 0}

    def fake_fetch(x):
        out = real_fetch(x)
        if calls["n"] == 0 and getattr(out, "shape", None) is not None \
                and out.ndim >= 1 and out.dtype == np.int32:
            calls["n"] += 1
            return np.full_like(out, (1 << 31) - 10)
        return out

    idx._fetch = fake_fetch
    idx._note_weight(100)
    idx._fetch = real_fetch
    # after the clamp every key's weight <= saturate: counter rebounds
    assert idx._ingested_weight == idx.size() * 3 + 100
    np.testing.assert_array_equal(idx.count(["ACGTACGTA", "CCCCGGGGA"]),
                                  [3, 2])


def test_bimol_note_weight_overflow_raises():
    """Final escape: a plain (non-saturating) map whose true totals
    cannot absorb the incoming weight must raise before the int32
    prefix sums can wrap."""
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(2))
    idx.insert(["ACGTACGTA"] * 5)
    idx._flush()
    idx._ingested_weight = CountIndex._I32_WEIGHT_GUARD - 1
    with pytest.raises(OverflowError):
        idx._note_weight((1 << 31) - 2)


def test_bimol_compact_preserves_rep_columns():
    """compact() collapses each key's rows to one (key, total, min-rep)
    row; the stored orientation (earliest occurrence id) must survive
    compaction and growth, including after erasure."""
    spec = KmerSpec(9, DNA)
    idx = BimoleculeCountIndex(spec, mesh=_mesh(4),
                               initial_capacity=1 << 6)
    # first occurrence in reverse-complement orientation
    km = "TACGTACGT"
    rc = km.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    idx.insert([km])           # stored orientation = km
    idx.insert([rc] * 3)       # later rc occurrences keep km stored
    idx.insert(["CCCCGGGGA"] * 2)
    before = idx.to_dict()
    idx.compact()
    assert idx.to_dict() == before
    words, counts = idx.find([km])
    assert counts[0] == 4
    assert spec.to_string(words[0]) == km
    # erase the other key, compact again: rep of the survivor unchanged
    idx.erase(["CCCCGGGGA"])
    idx.compact()
    words2, counts2 = idx.find([rc])
    assert counts2[0] == 4 and spec.to_string(words2[0]) == km
    assert idx.size() == 1

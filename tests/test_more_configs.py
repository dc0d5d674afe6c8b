"""Coverage for remaining index configurations: FASTA position index with
LongSequenceKmerId, non-DNA alphabets, large-k multiword distributed builds."""

import numpy as np
import pytest

from kmerind_jax import DNA, DNA6, DNA16, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fasta, py_parse_fastq


def test_fasta_position_index_long_ids(ref_data_dir):
    """PositionIndex on FASTA with LongSequenceKmerId (file pos + seq
    ordinal, sequence.hpp:231-320); windows cross line boundaries."""
    path = ref_data_dir / "test2.fasta"
    k = 15
    spec = KmerSpec(k, DNA)
    idx = PositionIndex(spec, mesh=make_mesh(4), id_kind="long")
    idx.build(path)

    recs = py_parse_fasta(path.read_text())
    expect = {}
    for si, rec in enumerate(recs):
        seq = "".join(rec["seq"])
        kmers = oracle.seq_kmers(seq, k, DNA)
        for i, v in enumerate(kmers):
            pid = (si << 40) | rec["pos"][i]
            expect.setdefault(v, []).append(pid)
    expect = {v: sorted(l) for v, l in expect.items()}
    assert idx.to_dict() == expect


@pytest.mark.parametrize("alpha,path_name", [
    (DNA16, "natural.withN.fasta"),
    (DNA6, "natural.withN.fastq"),
])
def test_count_index_other_alphabets(ref_data_dir, alpha, path_name, ):
    """DNA16 (4-bit) and DNA6 (3-bit) builds; N handled per alphabet
    encoding, canonicalization uses each alphabet's complement."""
    path = ref_data_dir / path_name
    k = 11
    spec = KmerSpec(k, alpha)
    idx = CountIndex(spec, mesh=make_mesh(4))
    idx.build(path)
    text = path.read_text()
    if path_name.endswith("fasta"):
        seqs = ["".join(r["seq"]) for r in py_parse_fasta(text)]
    else:
        seqs = [r[1] for r in py_parse_fastq(text)]
    expect = oracle.count_index(seqs, k, alpha, canonical=True)
    assert idx.to_dict() == dict(expect)


def test_large_k_multiword_distributed(ref_data_dir):
    """k=63 (4 words) through the full distributed path."""
    path = ref_data_dir / "test.medium.fastq"
    spec = KmerSpec(63, DNA)
    assert spec.nwords == 4
    idx = CountIndex(spec, mesh=make_mesh(8))
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    # reads are 60bp < k=63: no windows at all... use concatenated? check:
    if all(len(s) < 63 for s in seqs):
        assert idx.size() == 0
        # use a FASTA with longer sequences instead
        path = ref_data_dir / "test2.fasta"
        idx = CountIndex(spec, mesh=make_mesh(8))
        idx.build(path)
        seqs = ["".join(r["seq"]) for r in py_parse_fasta(path.read_text())]
    expect = oracle.count_index(seqs, 63, DNA, canonical=True)
    assert len(expect) > 0  # guard against a trivially-empty comparison
    assert idx.to_dict() == dict(expect)


def test_very_long_sequences_multiline(ref_data_dir):
    """16.5kb sequences spanning hundreds of FASTA lines (unitiq set)."""
    path = ref_data_dir / "test.unitiqs.fasta"
    spec = KmerSpec(31, DNA)
    idx = CountIndex(spec, mesh=make_mesh(8))
    idx.build(path)
    seqs = ["".join(r["seq"]) for r in py_parse_fasta(path.read_text())]
    expect = oracle.count_index(seqs, 31, DNA, canonical=True)
    assert idx.size() == len(expect)
    # spot check counts for 100 sampled keys
    import random
    rng = random.Random(0)
    sample = rng.sample(sorted(expect), 100)
    got = idx.count(np.stack([
        spec.pack_codes(oracle.int_to_codes(v, 31, 2)) for v in sample]))
    np.testing.assert_array_equal(got, [expect[v] for v in sample])


def test_rna_count_index():
    """RNA alphabet (U instead of T) through the full index."""
    from kmerind_jax import RNA
    import tempfile, pathlib
    seqs = ["ACGUACGUACGUCCGGAAUU", "UUAACCGGUACGUACGUACG"]
    text = "".join(f"@r{i}\n{s}\n+\n{'I'*len(s)}\n" for i, s in enumerate(seqs))
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "r.fastq"
        p.write_text(text)
        idx = CountIndex(KmerSpec(9, RNA), mesh=make_mesh(2))
        idx.build(p)
    expect = oracle.count_index(seqs, 9, RNA, canonical=True)
    assert idx.to_dict() == dict(expect)


def test_ascii_spec_extraction():
    """ASCII (8-bit identity) alphabet: 4 chars/word extraction."""
    import jax.numpy as jnp
    from kmerind_jax import ASCII
    from kmerind_jax.ops import packing
    spec = KmerSpec(6, ASCII)
    assert spec.chars_per_word == 4 and spec.nwords == 2
    s = "HELLOWORLD"
    words = np.asarray(packing.extract_kmers(
        jnp.asarray(ASCII.encode(s)), spec))
    assert spec.to_string(words[0]) == "HELLOW"
    assert spec.to_string(words[4]) == "OWORLD"


# -- transform-preset matrix: lex_greater / xor_rev_comp as index-level
# strand options (kmer_transform.hpp:91-145; MapParams accept any
# transform, kmer_index.hpp:436-562) ------------------------------------

def _transform_oracle(seqs, k, alphabet, transform):
    from collections import Counter
    c = Counter()
    for s in seqs:
        for v in oracle.seq_kmers(s, k, alphabet):
            rc = oracle.revcomp_int(v, k, alphabet)
            if transform == "lex_greater":
                c[max(v, rc)] += 1
            elif transform == "xor_rev_comp":
                c[v ^ rc] += 1
            else:
                raise ValueError(transform)
    return c


@pytest.mark.parametrize("transform", ["lex_greater", "xor_rev_comp"])
@pytest.mark.parametrize("distribution", ["hash", "range"])
def test_transform_presets_count(ref_data_dir, transform, distribution):
    from kmerind_jax.config import IndexConfig
    path = ref_data_dir / "test.small.fastq"
    idx = IndexConfig(k=21, index="count", strands=transform,
                      distribution=distribution).make_index()
    idx.build(str(path))
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = _transform_oracle(seqs, 21, DNA, transform)
    assert idx.to_dict() == dict(expect)
    # queries transform too: a raw forward-strand k-mer must answer with
    # its transformed key's count
    spec = idx.spec
    some = oracle.seq_kmers(seqs[0], 21, DNA)[:8]
    qwords = np.stack([spec.pack_codes(
        [(v >> (2 * i)) & 3 for i in range(20, -1, -1)]) for v in some])
    got = idx.count(qwords)
    want = [expect[max(v, oracle.revcomp_int(v, 21, DNA))
                   if transform == "lex_greater"
                   else v ^ oracle.revcomp_int(v, 21, DNA)] for v in some]
    assert list(got) == want


@pytest.mark.parametrize("k", [16, 32])
def test_position_index_full_word_specs(ref_data_dir, k):
    """Full-word DNA specs (k ≡ 0 mod 16: no spare sentinel bit) route
    the multimap flush through the FLAGGED merge
    (store.multi_merge_flush_flagged) — round 4 silently fell back to
    the monolithic re-sort here.  Contents must equal the oracle, like
    the reference's full-word split-table corner
    (src/index/kmer_hash.hpp:333-480)."""
    from test_io import py_parse_fastq
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(k, DNA)
    assert not spec.sentinel_safe
    idx = PositionIndex(spec, mesh=make_mesh(4), id_kind="short",
                        canonical=False)
    idx.build(str(path))
    recs = py_parse_fastq(path.read_text())
    seqs_ids = []
    for hdr, seq, qual, rstart, sstart in recs:
        ids = [(rstart << 16) | (sstart - rstart + i)
               for i in range(len(seq) - k + 1)]
        seqs_ids.append((seq, ids))
    expect = oracle.position_index(seqs_ids, k, DNA, canonical=False)
    assert idx.to_dict() == expect
    # query round trip on a repeated kmer
    some = [kk for kk, v in expect.items() if len(v) > 1][:4] \
        or list(expect)[:4]
    qwords = np.stack([
        spec.pack_codes([int(c) for c in oracle.int_to_codes(v, k, 2)])
        for v in some])
    counts = idx.count(qwords)
    np.testing.assert_array_equal(counts,
                                  [len(expect[v]) for v in some])

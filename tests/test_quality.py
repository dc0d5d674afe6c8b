"""Quality codec + windowed score semantics vs the reference tables
(/root/reference/src/index/quality_scores.hpp DecodeLUT values) and a
sequential Python oracle of QualityScoreSlidingWindow."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.quality import (
    ILLUMINA15,
    ILLUMINA18,
    QualityCodec,
    window_quality,
)


# First DecodeLUT entries hard-coded in the reference (quality_scores.hpp
# :115-130) — our formula must reproduce them to double precision.
REF_DECODE = {
    1: -2.28158434133843178,
    2: -1.43814051613477932,
    3: -1.00342970560804731,
    4: -0.73242146536126580,
    5: -0.54841225460816377,
    10: -0.15200309344504998,
    93: -0.00000000072306034,
}

# EncodeLUT entries (rounding boundary at q-0.5; quality_scores.hpp:216+)
REF_ENCODE = {
    3: -1.19212192855224533,
    10: -0.17169638509320007,
    40: -0.00016188212788732,
    41: -0.00012858606107082,
}


def test_decode_lut_matches_reference_values():
    lut = ILLUMINA18.decode_lut
    assert lut[0] == np.finfo(np.float64).min
    for q, want in REF_DECODE.items():
        assert lut[q] == pytest.approx(want, abs=1e-15), q
    assert lut[94] == 0.0 and lut[95] == 0.0


def test_encode_lut_matches_reference_values():
    lut = ILLUMINA18.encode_lut
    for q, want in REF_ENCODE.items():
        assert lut[q] == pytest.approx(want, abs=1e-15), q


def test_illumina15_min_score():
    # MinScore=3: q=1,2 also map to lowest (quality_scores.hpp:125-127)
    lut = ILLUMINA15.decode_lut
    assert lut[1] == np.finfo(np.float64).min
    assert lut[2] == np.finfo(np.float64).min
    assert lut[3] == pytest.approx(REF_DECODE[3])


def test_decode_bytes():
    got = ILLUMINA18.decode(np.frombuffer(b"!I", np.uint8))
    assert got[0] == np.finfo(np.float64).min  # '!' = q0
    # 'I' = q40: log2(1 - 1e-4)
    assert got[1] == pytest.approx(np.log2(1 - 1e-4), abs=1e-15)


def test_encode_roundtrip():
    # encode(decode(q)) == q for q in 1..93
    for q in range(1, 94):
        c = np.uint8(33 + q)
        lp = ILLUMINA18.decode(np.array([c]))
        back = ILLUMINA18.encode(lp)
        assert back[0] == c, q
    # q0 / lowest maps to '!'
    assert ILLUMINA18.encode(np.array([np.finfo(np.float64).min]))[0] == 33
    assert ILLUMINA18.encode(np.array([-np.inf]))[0] == 33
    assert ILLUMINA18.encode(np.array([np.inf]))[0] == 126


def oracle_window_quality(qual_str: str, k: int, codec=ILLUMINA18):
    """Sequential float oracle of QualityScoreSlidingWindow
    (quality_score_iterator.hpp:67-180)."""
    lowest = np.finfo(np.float64).min
    vals = [codec.decode_lut[min(95, max(0, ord(c) - codec.min_input))]
            for c in qual_str]
    out = []
    for i in range(len(vals) - k + 1):
        window = vals[i:i + k]
        bad = sum(1 for v in window if not (v > lowest and v < 0.0))
        if bad > 0:
            out.append(0.0)
        else:
            out.append(math.exp2(math.fsum(window)))
    return out


@pytest.mark.parametrize("k", [3, 8, 21])
def test_window_quality_vs_oracle(k):
    rng = np.random.default_rng(k)
    quals = "".join(chr(c) for c in rng.integers(33, 74, size=300))
    got = np.asarray(window_quality(
        jnp.asarray(np.frombuffer(quals.encode(), np.uint8)), k))
    want = oracle_window_quality(quals, k)
    for i, w in enumerate(want):
        assert got[i] == pytest.approx(w, rel=2e-5), i


def test_window_quality_zero_prob_base():
    # a '!' (q=0) base zeroes every window containing it, exactly
    quals = "IIIII!IIIII"
    k = 3
    got = np.asarray(window_quality(
        jnp.asarray(np.frombuffer(quals.encode(), np.uint8)), k))
    want = oracle_window_quality(quals, k)
    np.testing.assert_array_equal(got[3:6], [0.0, 0.0, 0.0])
    for i, w in enumerate(want):
        assert got[i] == pytest.approx(w, rel=1e-6)


def test_position_quality_index_e2e(ref_data_dir):
    """PositionQualityIndex on the reference fixture: every stored pair must
    match (id, windowed quality) from the oracle."""
    from kmerind_jax.index.api import PositionQualityIndex
    from kmerind_jax.parallel.mesh import make_mesh
    from test_io import py_parse_fastq

    path = ref_data_dir / "test.small.fastq"
    k = 21
    spec = KmerSpec(k, DNA)
    idx = PositionQualityIndex(spec, mesh=make_mesh(4), id_kind="short")
    idx.build(path)

    recs = py_parse_fastq(path.read_text())
    import oracle as okit
    expect: dict[int, list] = {}
    for hdr, seq, qual, rstart, sstart in recs:
        kmers = okit.seq_kmers(seq, k, DNA)
        scores = oracle_window_quality(qual, k)
        for i, (v, sc) in enumerate(zip(kmers, scores)):
            pid = (rstart << 16) | (sstart - rstart + i)
            expect.setdefault(v, []).append((pid, sc))
    expect = {v: sorted(lst) for v, lst in expect.items()}

    got = idx.to_dict()
    assert set(got) == set(expect)
    for v in expect:
        gl, el = got[v], expect[v]
        assert [g[0] for g in gl] == [e[0] for e in el], v
        for (gid, gq), (eid, eq) in zip(gl, el):
            assert gq == pytest.approx(eq, rel=2e-5), v

    # find with quality
    some = list(expect)[0]
    qw = np.stack([spec.pack_codes(okit.int_to_codes(some, k, 2))])
    ids, quals, mask = idx.find(qw, max_per_query=16, with_quality=True)
    pairs = sorted(zip(ids[0][mask[0]].tolist(),
                       quals[0][mask[0]].tolist()))
    assert [p[0] for p in pairs] == [e[0] for e in expect[some]]


def test_position_quality_explicit_insert():
    """PositionQualityIndex.insert carries per-pair float quality through
    the distributed path (pair<IdType, float> payloads,
    kmer_index.hpp:406)."""
    from kmerind_jax.index.api import PositionQualityIndex
    from kmerind_jax.parallel.mesh import make_mesh

    spec = KmerSpec(9, DNA)
    idx = PositionQualityIndex(spec, mesh=make_mesh(2))
    idx.insert(["ACGTACGTA", "ACGTACGTA"], np.array([5, 9], np.uint64),
               quals=np.array([-0.25, -1.5], np.float32))
    d = idx.to_dict()
    key = spec.to_int(spec.pack_codes(DNA.encode("ACGTACGTA")))
    assert sorted(d[key]) == [(5, -0.25), (9, -1.5)]

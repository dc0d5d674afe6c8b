"""End-to-end saturating-count semantics (saturating_counting_densehash_map,
/root/reference/src/containers/distributed_densehash_map.hpp:2947).

The run store keeps RAW weights and clamps at every read surface; a
clamped compaction is exact because saturation is monotone
(min(min(a, s) + b, s) == min(a + b, s) for b >= 0).  These tests pin the
clamp across build, query, items, histogram, predicate scans, compaction,
checkpoint roundtrip, and the int32 overflow guard, on the seeded
short-read corpus (tests/conftest.py) whose raw counts are checked against
tests/oracle.py.
"""

import numpy as np
import oracle
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex

SPEC = KmerSpec(21, DNA)
SAT = 3
# synthetic keys below/at saturation for clamp variety; canonicalized on
# insert like any query
EXTRA = [("A" * 21, 1), ("AC" * 10 + "A", 2), ("GT" * 10 + "G", 3)]


@pytest.fixture(scope="module")
def fq(seeded_corpus):
    return seeded_corpus.fastq


def _build(idx: CountIndex, fq: str) -> CountIndex:
    idx.build(fq)
    rows = np.stack([SPEC.from_string(s) for s, _ in EXTRA])
    idx.insert_counts(rows.astype(np.uint32), [c for _, c in EXTRA])
    return idx


@pytest.fixture(scope="module")
def raw_counts(fq, seeded_corpus):
    raw = _build(CountIndex(SPEC), fq).to_dict()
    want = oracle.count_index(seeded_corpus.seqs, SPEC.k, DNA)
    want.update(oracle.count_index([s for s, c in EXTRA for _ in range(c)],
                                   SPEC.k, DNA))
    assert raw == dict(want)
    return raw


@pytest.fixture()
def sat_idx(fq):
    return _build(CountIndex(SPEC, saturate=SAT), fq)


def _clamped(raw, s=SAT):
    return {k: min(c, s) for k, c in raw.items()}


def test_saturate_build_query_items(sat_idx, raw_counts):
    assert any(c > SAT for c in raw_counts.values()), "fixture too small"
    assert any(c < SAT for c in raw_counts.values())
    assert sat_idx.to_dict() == _clamped(raw_counts)
    keys = list(raw_counts)[:16]
    rows = np.stack([_int_to_words(k) for k in keys]).astype(np.uint32)
    got = sat_idx.count(rows)
    exp = np.array([min(raw_counts[k], SAT) for k in keys])
    np.testing.assert_array_equal(got, exp)
    _, cnts = sat_idx.items()
    assert cnts.max() == SAT and cnts.min() == 1
    assert sat_idx.size() == len(raw_counts)


def test_saturate_histogram_and_scans(sat_idx, raw_counts):
    hist = sat_idx.histogram(max_count=SAT + 2)
    exp = np.zeros(SAT + 3, np.int64)
    for c in raw_counts.values():
        exp[min(c, SAT)] += 1
    np.testing.assert_array_equal(hist, exp)
    # count_if sees clamped counts: nothing can exceed SAT
    assert sat_idx.count_if(lambda k, c: c > SAT) == []
    at_sat = sat_idx.count_if(lambda k, c: c == SAT)
    assert len(at_sat) == sum(1 for c in raw_counts.values() if c >= SAT)
    assert all(c == SAT for _, c in at_sat)
    below = sat_idx.count_if(lambda k, c: c < SAT)
    assert sorted(below) == sorted(
        (k, c) for k, c in raw_counts.items() if c < SAT)


def test_saturate_compact_is_exact(sat_idx, raw_counts, fq):
    # a clamped compact rewrites raw weights; further inserts still clamp
    sat_idx.compact()
    assert sat_idx.to_dict() == _clamped(raw_counts)
    _build(sat_idx, fq)  # double every raw count AFTER the clamp
    assert sat_idx.to_dict() == {k: min(min(c, SAT) + c, SAT)
                                 for k, c in raw_counts.items()}


def test_saturate_insert_counts_and_erase(sat_idx, raw_counts):
    k0 = list(raw_counts)[0]
    rows = _int_to_words(k0)[None, :].astype(np.uint32)
    sat_idx.insert_counts(rows, [100])
    assert int(sat_idx.count(rows)[0]) == SAT
    assert sat_idx.erase(rows) == 1
    assert int(sat_idx.count(rows)[0]) == 0


def test_saturate_checkpoint_roundtrip(tmp_path, sat_idx, raw_counts):
    p = tmp_path / "sat.npz"
    sat_idx.save(p)
    back = CountIndex.load(p)
    assert back.saturate == SAT
    assert back.to_dict() == _clamped(raw_counts)


def test_overflow_guard_saturating(raw_counts, fq):
    """Pressure on a saturating map forces a clamped compact, not a wrap."""
    idx = _build(CountIndex(SPEC, saturate=SAT), fq)
    idx._ingested_weight = idx._I32_WEIGHT_GUARD  # simulate a long stream
    _build(idx, fq)  # triggers _relieve_weight_pressure -> clamped compact
    assert idx._ingested_weight < idx._I32_WEIGHT_GUARD
    assert idx.to_dict() == {k: min(min(c, SAT) + c, SAT)
                             for k, c in raw_counts.items()}


def test_overflow_guard_plain_raises(fq):
    """A plain counting map raises before int32 prefix sums can wrap."""
    idx = CountIndex(SPEC).build(fq)
    rows, _ = idx.items()
    big = 1 << 29
    idx.insert_counts(rows[:2].astype(np.uint32), [big, big])  # fits
    with pytest.raises(OverflowError):
        idx.insert_counts(rows[:2].astype(np.uint32), [big, big])
    # the index remains usable after the refused insert
    assert idx.size() > 0


def _int_to_words(v: int) -> np.ndarray:
    rows = np.zeros(SPEC.nwords, np.uint32)
    total = SPEC.nbits
    rem = v
    for w, bits in enumerate(SPEC.word_bits()):
        total -= bits
        rows[w] = (rem >> total) & ((1 << bits) - 1)
        rem &= (1 << total) - 1
    assert SPEC.to_int(rows) == v
    return rows

"""Sliding-window k-mer extraction vs the pure-Python oracle
(reference semantics: kmer_iterators.hpp / kmer.hpp fill+next paths)."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import ASCII, DNA, DNA6, DNA16, DNA_IUPAC, KmerSpec
from kmerind_jax.ops import packing

import oracle


@pytest.mark.parametrize("alpha,letters", [
    (DNA, "ACGT"),
    (DNA6, "ACGTN."),
    (DNA16, "ACGTMRWSYKVHDBN"),
])
@pytest.mark.parametrize("k", [1, 4, 15, 16, 17, 21, 31, 32, 33, 63])
def test_extract_kmers_matches_oracle(alpha, letters, k):
    rng = np.random.default_rng(seed=k * 31 + alpha.size)
    n = 200
    seq = oracle.random_dna(rng, n, letters)
    spec = KmerSpec(k, alpha)
    codes = alpha.encode(seq)

    words = np.asarray(packing.extract_kmers(jnp.asarray(codes), spec))
    expected = oracle.seq_kmers(seq, k, alpha)
    assert len(expected) == n - k + 1
    for i, exp in enumerate(expected):
        assert spec.to_int(words[i]) == exp, f"window {i}"


@pytest.mark.parametrize("alpha,letters", [
    (DNA, "ACGT"),
    (DNA16, "ACGTN"),
])
@pytest.mark.parametrize("k", [5, 16, 21, 33])
def test_extract_canonical_matches_oracle(alpha, letters, k):
    rng = np.random.default_rng(seed=k)
    seq = oracle.random_dna(rng, 150, letters)
    spec = KmerSpec(k, alpha)
    codes = alpha.encode(seq)

    canon, was_rc = packing.extract_canonical(jnp.asarray(codes), spec)
    canon = np.asarray(canon)
    expected = oracle.canonical_kmers(seq, k, alpha)
    for i, exp in enumerate(expected):
        got = spec.to_int(canon[i])
        assert got == exp, f"window {i}: got {spec.to_string(canon[i])}"


@pytest.mark.parametrize("k", [4, 21])
def test_extract_revcomp(k):
    rng = np.random.default_rng(seed=7)
    seq = oracle.random_dna(rng, 80, "ACGT")
    spec = KmerSpec(k, DNA)
    codes = DNA.encode(seq)
    rc = np.asarray(packing.extract_revcomp(jnp.asarray(codes), spec))
    fwd = oracle.seq_kmers(seq, k, DNA)
    for i, v in enumerate(fwd):
        assert spec.to_int(rc[i]) == oracle.revcomp_int(v, k, DNA)


def test_window_valid_segments():
    # two records of length 6 and 5 with a pad base between them
    base_valid = jnp.asarray([1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1], dtype=bool)
    seg = jnp.asarray([0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1], dtype=jnp.int32)
    k = 3
    valid = np.asarray(packing.window_valid(base_valid, seg, k))
    # record 0 yields windows at 0..3; record 1 at 7..9
    expected = np.zeros(12, dtype=bool)
    expected[[0, 1, 2, 3, 7, 8, 9]] = True
    np.testing.assert_array_equal(valid, expected)


def test_window_valid_k1():
    base_valid = jnp.asarray([1, 0, 1], dtype=bool)
    seg = jnp.asarray([0, 0, 1], dtype=jnp.int32)
    valid = np.asarray(packing.window_valid(base_valid, seg, 1))
    np.testing.assert_array_equal(valid, [True, False, True])


def test_kmerspec_string_roundtrip():
    spec = KmerSpec(21, DNA)
    s = "ACGTACGTACGTACGTACGTA"
    words = spec.from_string(s)
    assert spec.to_string(words) == s
    assert spec.nwords == 2
    assert spec.word_char_counts() == (16, 5)


def test_lex_less():
    a = jnp.asarray([[1, 2], [1, 2], [1, 2], [0xFFFFFFFF, 0]], dtype=jnp.uint32)
    b = jnp.asarray([[1, 3], [1, 2], [0, 9], [1, 0]], dtype=jnp.uint32)
    np.testing.assert_array_equal(
        np.asarray(packing.lex_less(a, b)), [True, False, False, False])


@pytest.mark.parametrize("alpha,k", [
    (DNA, 21), (DNA, 16), (DNA, 63), (DNA16, 11), (DNA6, 9),
    (DNA_IUPAC, 11), (ASCII, 5)])
def test_extract_tuples_canonical_matches_oracle(alpha, k):
    """io.kmer_parsers.extract_tuples (canonical) over three reads whose
    total length is not a multiple of 128: stored words, strand flag and
    window validity per window start equal tests/oracle.py."""
    from kmerind_jax.io.kmer_parsers import DeviceBases, extract_tuples
    spec = KmerSpec(k, alpha)
    rng = np.random.default_rng(k)
    lens = [300, 77, 623]
    codes = rng.integers(0, alpha.size, size=sum(lens)).astype(np.uint8)
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n = codes.shape[0]
    bases = DeviceBases(
        codes=jnp.asarray(codes), valid=jnp.ones(n, bool),
        owned=jnp.ones(n, bool), seg_id=jnp.asarray(seg),
        id_hi=jnp.zeros(n, jnp.uint32), id_lo=jnp.zeros(n, jnp.uint32),
        qual=jnp.zeros(n, jnp.uint8))
    tup = extract_tuples(bases, spec, canonical=True)
    valid = np.asarray(tup.valid)
    words = np.asarray(tup.words)
    strand = np.asarray(tup.strand)
    bits = alpha.bits_per_char
    starts = np.cumsum([0] + lens)
    want_valid = np.zeros(n, bool)
    for s0, ln in zip(starts, lens):
        want_valid[s0:s0 + ln - k + 1] = True
    np.testing.assert_array_equal(valid, want_valid)
    for i in np.flatnonzero(want_valid):
        fwd = oracle.kmer_int(codes[i:i + k].tolist(), bits)
        rc = oracle.revcomp_int(fwd, k, alpha)
        assert spec.to_int(words[i]) == min(fwd, rc)
        assert strand[i] == (rc < fwd)


def test_xor_rev_comp_and_lex_greater():
    spec = KmerSpec(7, DNA)
    seq = "ACGTACGTTGCA"
    codes = jnp.asarray(DNA.encode(seq))
    xr = np.asarray(packing.extract_xor_rev_comp(codes, spec))
    big, flag = packing.extract_canonical_greater(codes, spec)
    big = np.asarray(big)
    for i in range(len(seq) - 7 + 1):
        v = oracle.kmer_int([int(c) for c in DNA.encode(seq[i:i+7])], 2)
        rc = oracle.revcomp_int(v, 7, DNA)
        assert spec.to_int(xr[i]) == v ^ rc
        assert spec.to_int(big[i]) == max(v, rc)


def test_kmer_surface_ops():
    from kmerind_jax.ops import bitops
    spec = KmerSpec(21, DNA)
    words = jnp.asarray(np.stack([spec.from_string("ACGTACGTACGTACGTACGTA"),
                                  spec.from_string("TTTTACGTACGTACGTACGTA")]))
    hi, lo = bitops.prefix64(words)
    assert np.asarray(hi)[0] == np.asarray(words)[0, 0]
    sub = bitops.infix_chars(words, spec, 2, 5)
    assert KmerSpec(5, DNA).to_string(np.asarray(sub)[0]) == "GTACG"
    chars = bitops.get_chars_at(words, spec, 0, 4)
    np.testing.assert_array_equal(np.asarray(chars)[1], DNA.encode("TTTT"))
    new = bitops.set_chars_at(words, spec, 0,
                              jnp.asarray(DNA.encode("GGGG"))[None].repeat(2, 0))
    assert spec.to_string(np.asarray(new)[0]).startswith("GGGG")
    m = jnp.asarray(np.array([[0xFFFFFFFF, 0]], np.uint32)).repeat(2, 0)
    eq = bitops.masked_equal(words[:1].repeat(2, 0), words, m)
    # first 16 chars equal iff word0 equal
    assert bool(np.asarray(eq)[0]) is True


def test_mix32_differs_from_murmur():
    from kmerind_jax.ops import hashing
    w = jnp.asarray(np.random.default_rng(0).integers(
        0, 1 << 31, size=(100, 2)).astype(np.uint32))
    a = np.asarray(hashing.murmur3_32(w))
    b = np.asarray(hashing.mix32(w))
    assert (a != b).mean() > 0.99  # independent families


@pytest.mark.parametrize("alpha,k", [
    (DNA, 21), (DNA, 16), (DNA, 63), (DNA16, 11), (DNA6, 9), (ASCII, 5)])
def test_to_ints_vectorized_matches_to_int(alpha, k):
    """KmerSpec.to_ints (vectorized export path) == scalar to_int."""
    spec = KmerSpec(k, alpha)
    rng = np.random.default_rng(k)
    rows = np.stack([
        spec.pack_codes(rng.integers(0, alpha.size, k).astype(np.uint64))
        for _ in range(64)])
    ints = spec.to_ints(rows)
    assert ints.dtype == (np.uint64 if spec.nbits <= 64 else object)
    for i in range(64):
        assert int(ints[i]) == spec.to_int(rows[i])

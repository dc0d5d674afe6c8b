"""Alphabet LUT semantics vs the reference tables
(/root/reference/src/common/alphabets.hpp)."""

import numpy as np
import pytest

from kmerind_jax import alphabets as A


def test_dna_encoding():
    assert list(A.DNA.encode("ACGT")) == [0, 1, 2, 3]
    assert list(A.DNA.encode("acgt")) == [0, 1, 2, 3]
    # unknown characters (incl. N) default to 0 == 'A'  (alphabets.hpp:139)
    assert list(A.DNA.encode("NXZ@")) == [0, 0, 0, 0]
    assert A.DNA.decode(np.array([0, 1, 2, 3])) == "ACGT"


def test_dna_complement_is_3_minus_x():
    for c in range(4):
        assert A.DNA.to_complement[c] == 3 - c


def test_rna_uses_u():
    assert list(A.RNA.encode("ACGU")) == [0, 1, 2, 3]
    assert A.RNA.decode(np.array([3])) == "U"
    assert list(A.RNA.encode("T")) == [0]  # T is not in RNA


def test_dna6_encoding():
    # gap=0 A=1 C=3 T=4 G=6 N=7, unknown -> 2 (alphabets.hpp:196-280)
    assert list(A.DNA6.encode("-.ACTGNX")) == [0, 0, 1, 3, 4, 6, 7, 7]
    assert list(A.DNA6.encode("Z")) == [2]
    assert A.DNA6.decode(np.array([0, 1, 3, 4, 6, 7])) == ".ACTGN"


def test_dna6_complement_is_bit_reversal():
    for c in range(8):
        rev = int(f"{c:03b}"[::-1], 2)
        assert A.DNA6.to_complement[c] == rev


def test_dna5_is_dna6_alias():
    assert A.DNA5 is A.DNA6
    assert A.RNA5 is A.RNA6


def test_dna16_encoding():
    assert list(A.DNA16.encode("ACGT")) == [0x1, 0x2, 0x4, 0x8]
    assert list(A.DNA16.encode("U")) == [0x8]  # U == T in loose IUPAC
    assert list(A.DNA16.encode("-.")) == [0, 0]
    assert list(A.DNA16.encode("N")) == [0xF]
    assert list(A.DNA16.encode("Z")) == [0xF]  # unknown -> N
    assert A.DNA16.decode(np.arange(16)) == ".ACMGRSVTWYHKDBN"


def test_dna16_complement_is_4bit_reversal():
    for c in range(16):
        rev = int(f"{c:04b}"[::-1], 2)
        assert A.DNA16.to_complement[c] == rev


def test_dna_iupac_strict():
    # U distinct from T (code 0), unknown -> 0xF  (alphabets.hpp:539-632)
    assert list(A.DNA_IUPAC.encode("U")) == [0x0]
    assert list(A.DNA_IUPAC.encode("T")) == [0x8]
    assert A.DNA_IUPAC.decode(np.arange(16)) == "UACMGRSVTWYHKDBN"
    # complement table from alphabets.hpp:601-620
    expected = [1, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]
    assert list(A.DNA_IUPAC.to_complement) == expected


@pytest.mark.parametrize("alpha", [A.DNA, A.RNA, A.DNA6, A.RNA6, A.DNA16])
def test_complement_is_involution(alpha):
    comp = alpha.to_complement
    assert np.array_equal(comp[comp[np.arange(alpha.size)]], np.arange(alpha.size))


@pytest.mark.parametrize(
    "alpha,bits", [(A.DNA, 2), (A.RNA, 2), (A.DNA6, 3), (A.DNA16, 4), (A.ASCII, 8)]
)
def test_bits_per_char(alpha, bits):
    assert alpha.bits_per_char == bits


def test_registry():
    assert A.by_name("dna") is A.DNA
    assert A.by_name("DNA16") is A.DNA16

"""Pure-Python reference oracle implementing kmerind's semantics.

Deliberately slow and simple — arbitrary-precision ints, per-char loops —
so that the vectorized device implementations can be validated against an
independent statement of the same semantics (the strategy the reference
uses with its slow helper in
/root/reference/src/common/test/kmer_reverse_helper.hpp).
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from kmerind_jax.alphabets import Alphabet


def kmer_int(codes, bits: int) -> int:
    """Pack integer codes into the big-integer k-mer value (first char most
    significant)."""
    v = 0
    for c in codes:
        v = (v << bits) | int(c)
    return v


def int_to_codes(v: int, k: int, bits: int) -> list[int]:
    mask = (1 << bits) - 1
    return [(v >> (bits * (k - 1 - j))) & mask for j in range(k)]


def revcomp_int(v: int, k: int, alphabet: Alphabet) -> int:
    codes = int_to_codes(v, k, alphabet.bits_per_char)
    comp = [int(alphabet.to_complement[c]) for c in codes]
    return kmer_int(list(reversed(comp)), alphabet.bits_per_char)


def seq_kmers(seq: str, k: int, alphabet: Alphabet) -> list[int]:
    """All k-mer big-int values of one sequence (forward strand)."""
    codes = [int(c) for c in alphabet.encode(seq)]
    return [kmer_int(codes[i : i + k], alphabet.bits_per_char)
            for i in range(len(codes) - k + 1)]


def canonical_kmers(seq: str, k: int, alphabet: Alphabet) -> list[int]:
    return [min(v, revcomp_int(v, k, alphabet)) for v in seq_kmers(seq, k, alphabet)]


def count_index(seqs, k, alphabet, canonical=True) -> Counter:
    """kmer value -> count over a collection of sequences."""
    c = Counter()
    for s in seqs:
        vals = canonical_kmers(s, k, alphabet) if canonical else seq_kmers(s, k, alphabet)
        c.update(vals)
    return c


def position_index(seqs_with_ids, k, alphabet, canonical=False):
    """kmer value -> sorted list of position ids.

    seqs_with_ids: iterable of (seq, [id per kmer start]) — ids are opaque
    ints supplied by the caller (matching whatever encoding is under test).
    """
    d = defaultdict(list)
    for seq, ids in seqs_with_ids:
        vals = canonical_kmers(seq, k, alphabet) if canonical else seq_kmers(seq, k, alphabet)
        assert len(vals) == len(ids)
        for v, i in zip(vals, ids):
            d[v].append(i)
    return {v: sorted(lst) for v, lst in d.items()}


def words_to_int(words, spec) -> int:
    """uint32 word row (big-endian char-aligned layout) -> big-int value."""
    return spec.to_int(np.asarray(words))


def random_dna(rng: np.random.Generator, n: int, letters: str = "ACGT") -> str:
    return "".join(rng.choice(list(letters), size=n))

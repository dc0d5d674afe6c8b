"""Word-parallel ops on packed k-mer tensors.

Vectorized equivalent of the reference's SIMD bit-group kernel library
(/root/reference/src/utils/bitgroup_ops.hpp:105-3591) and the packed-word ops
on ``bliss::common::Kmer`` (reverse/reverse_complement kmer.hpp:1080-1140,
char shifts :969-1070, bitwise ops :872-961, compare :790-865).

The reference needs SSSE3/AVX2 shuffles because its k-mers are contiguous
bit streams inside scalar registers; here a batch of k-mers is a
``uint32[n, nwords]`` tensor and every op is a vectorized jnp expression the
XLA maps onto the device's vector units — the "SIMD backend" is the compiler.

Two implementations of char reversal are provided, mirroring the reference's
SEQ vs SWAR backends:

* `char_reverse_word_swar` — mask/shift ladder, only for power-of-two
  bits_per_char (bitgroup_ops.hpp:346-684 SWAR specializations);
* a generic static-unrolled per-char gather used by `reverse`/`revcomp`
  for any alphabet (the 3-bit path, bitgroup_ops.hpp:991+).

Tests cross-check them against each other and a numpy oracle, replicating the
reference's test strategy (src/utils/test/test_bit_reverse_*.cpp).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kmer import KmerSpec

__all__ = [
    "unpack_kmers",
    "pack_kmers",
    "reverse",
    "revcomp",
    "shift_left_chars",
    "shift_right_chars",
    "char_reverse_word_swar",
    "kmer_equal",
    "kmer_compare",
    "kmer_xor",
    "kmer_and",
    "kmer_or",
]


def _mask(bits: int) -> jnp.uint32:
    return jnp.uint32((1 << bits) - 1)


@functools.partial(jax.jit, static_argnames=("spec",))
def unpack_kmers(words: jax.Array, spec: KmerSpec) -> jax.Array:
    """uint32[n, nwords] -> uint8[n, k] character codes (first char first)."""
    b = spec.bits_per_char
    cpw = spec.chars_per_word
    cols = []
    counts = spec.word_char_counts()
    for pos in range(spec.k):
        w = pos // cpw
        j = pos - w * cpw  # char index within word, 0 = most significant
        shift = b * (counts[w] - 1 - j)
        cols.append(((words[:, w] >> shift) & _mask(b)).astype(jnp.uint8))
    return jnp.stack(cols, axis=1)


@functools.partial(jax.jit, static_argnames=("spec",))
def pack_kmers(codes: jax.Array, spec: KmerSpec) -> jax.Array:
    """uint8[n, k] codes -> uint32[n, nwords] packed words."""
    b = spec.bits_per_char
    cpw = spec.chars_per_word
    counts = spec.word_char_counts()
    out_cols = []
    for w, nch in enumerate(counts):
        acc = jnp.zeros(codes.shape[0], dtype=jnp.uint32)
        for j in range(nch):
            acc = (acc << b) | codes[:, w * cpw + j].astype(jnp.uint32)
        out_cols.append(acc)
    return jnp.stack(out_cols, axis=1)


@functools.partial(jax.jit, static_argnames=("spec",))
def reverse(words: jax.Array, spec: KmerSpec) -> jax.Array:
    """Character-order reversal of packed k-mers (Kmer::reverse,
    kmer.hpp:1080-1108)."""
    codes = unpack_kmers(words, spec)
    return pack_kmers(codes[:, ::-1], spec)


@functools.partial(jax.jit, static_argnames=("spec",))
def revcomp(words: jax.Array, spec: KmerSpec) -> jax.Array:
    """Reverse complement of packed k-mers (Kmer::reverse_complement,
    kmer.hpp:1118-1140)."""
    codes = unpack_kmers(words, spec)
    comp = jnp.take(jnp.asarray(spec.alphabet.to_complement),
                    codes.astype(jnp.int32), axis=0)
    return pack_kmers(comp[:, ::-1].astype(jnp.uint8), spec)


@functools.partial(jax.jit, static_argnames=("spec", "s"))
def shift_left_chars(words: jax.Array, spec: KmerSpec, s: int) -> jax.Array:
    """Shift characters towards the front (drops the first s chars, zero-fills
    at the back) — Kmer::operator<<= semantics (kmer.hpp:969-1020)."""
    codes = unpack_kmers(words, spec)
    shifted = jnp.concatenate(
        [codes[:, s:], jnp.zeros((codes.shape[0], min(s, spec.k)), jnp.uint8)],
        axis=1)[:, : spec.k]
    return pack_kmers(shifted, spec)


@functools.partial(jax.jit, static_argnames=("spec", "s"))
def shift_right_chars(words: jax.Array, spec: KmerSpec, s: int) -> jax.Array:
    """Shift characters towards the back (drops the last s chars, zero-fills
    at the front) — Kmer::operator>>= semantics (kmer.hpp:1025-1070)."""
    codes = unpack_kmers(words, spec)
    shifted = jnp.concatenate(
        [jnp.zeros((codes.shape[0], min(s, spec.k)), jnp.uint8), codes],
        axis=1)[:, : spec.k]
    return pack_kmers(shifted, spec)


def char_reverse_word_swar(x: jax.Array, bits: int) -> jax.Array:
    """Reverse the order of bit-groups within full uint32 words, SWAR style
    (bitgroup_ops.hpp SWAR backend).  Only for power-of-two group widths;
    reverses all 32/bits groups (callers must hold full words).
    """
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError("SWAR reverse requires power-of-two group width")
    x = x.astype(jnp.uint32)
    x = (x << 16) | (x >> 16)
    if bits <= 8:
        m = jnp.uint32(0x00FF00FF)
        x = ((x & m) << 8) | ((x >> 8) & m)
    if bits <= 4:
        m = jnp.uint32(0x0F0F0F0F)
        x = ((x & m) << 4) | ((x >> 4) & m)
    if bits <= 2:
        m = jnp.uint32(0x33333333)
        x = ((x & m) << 2) | ((x >> 2) & m)
    if bits <= 1:
        m = jnp.uint32(0x55555555)
        x = ((x & m) << 1) | ((x >> 1) & m)
    return x


# -- word-wise relational / bitwise ops (kmer.hpp:790-961) ------------------

def kmer_equal(a: jax.Array, b: jax.Array) -> jax.Array:
    """Row-wise equality over [n, nwords]."""
    return jnp.all(a == b, axis=-1)


def kmer_compare(a: jax.Array, b: jax.Array) -> jax.Array:
    """Row-wise three-way compare: -1 / 0 / +1 in lexicographic char order.
    Elementwise fold from the least significant word — no gathers."""
    w = a.shape[-1]
    cmp = jnp.zeros(a.shape[:-1], dtype=jnp.int32)
    for j in reversed(range(w)):
        aj, bj = a[..., j], b[..., j]
        cmp = jnp.where(aj != bj, jnp.where(aj < bj, -1, 1), cmp)
    return cmp


def kmer_xor(a, b):
    return a ^ b


def kmer_and(a, b):
    return a & b


def kmer_or(a, b):
    return a | b


# -- 64-bit views for hashing (Kmer::getPrefix/getInfix/getSuffix,
#    kmer.hpp:1203-1270) ----------------------------------------------------

def prefix64(words: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(hi, lo) uint32 pair: the most significant 64 bits of each k-mer
    (zero-extended when nwords == 1)."""
    hi = words[:, 0]
    lo = words[:, 1] if words.shape[1] > 1 else jnp.zeros_like(hi)
    return hi, lo


def suffix64(words: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(hi, lo) uint32 pair: the least significant 64 bits."""
    lo = words[:, -1]
    hi = words[:, -2] if words.shape[1] > 1 else jnp.zeros_like(lo)
    return hi, lo


def infix_chars(words: jax.Array, spec: KmerSpec, start: int, length: int) -> jax.Array:
    """Character-range view [start, start+length) of each k-mer, packed into
    a fresh KmerSpec(length) layout (getInfix/getCharsAtPos semantics,
    kmer.hpp:1244-1285)."""
    from ..kmer import KmerSpec as _KS

    codes = unpack_kmers(words, spec)[:, start:start + length]
    sub = _KS(length, spec.alphabet)
    return pack_kmers(codes, sub)


def get_chars_at(words: jax.Array, spec: KmerSpec, pos: int, n: int) -> jax.Array:
    """uint8[nrows, n] raw character codes at [pos, pos+n)."""
    return unpack_kmers(words, spec)[:, pos:pos + n]


def set_chars_at(words: jax.Array, spec: KmerSpec, pos: int,
                 new_codes: jax.Array) -> jax.Array:
    """Replace characters at [pos, pos+len(new_codes)) (setCharsAtPos)."""
    codes = unpack_kmers(words, spec)
    codes = codes.at[:, pos:pos + new_codes.shape[1]].set(
        new_codes.astype(jnp.uint8))
    return pack_kmers(codes, spec)


def masked_equal(a: jax.Array, b: jax.Array, mask_words: jax.Array) -> jax.Array:
    """Row-wise equality under a per-word bitmask (Kmer::masked_equal,
    kmer.hpp:1288-1333) — used for k-mer neighborhood matching."""
    return jnp.all((a & mask_words) == (b & mask_words), axis=-1)

"""K-mer hash functions, vectorized over packed word tensors.

Vectorized counterpart of the reference hash functor family
(/root/reference/src/index/kmer_hash.hpp:157-330): ``identity`` (the k-mer
bits themselves), ``murmur`` and ``farm`` (byte-stream hashes), each in a
"prefix" (distribution) and "suffix" (storage) flavor — prefix bits pick the
owning process, suffix bits the local bucket (kmer_hash.hpp:24-54).

Here the k-mer batch is ``uint32[n, nwords]``; hashes are computed entirely
with 32-bit integer ops (multiply/xor/rotate), which lower to native vector
instructions — no 64-bit emulation.  `murmur3_32` is a faithful
MurmurHash3_x86_32 implemented from the public algorithm specification over
the k-mer's words as little-endian 4-byte blocks (tail empty).  Because our
packed layout differs from the reference's, hash *values* differ from the
C++ build; shard placement is an implementation detail (the reference itself
changes placement with process count), and parity is asserted on index
contents, not shard assignment.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "fmix32",
    "murmur3_32",
    "mix32",
    "identity_hash",
    "owner_from_hash",
    "HASHES",
]

_C1 = jnp.uint32(0xCC9E2D51)
_C2 = jnp.uint32(0x1B873593)


def _rotl32(x: jax.Array, r: int) -> jax.Array:
    return (x << r) | (x >> (32 - r))


def fmix32(h: jax.Array) -> jax.Array:
    """MurmurHash3 32-bit finalizer (avalanche) — standalone mixing hash."""
    h = h.astype(jnp.uint32)
    h ^= h >> 16
    h *= jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h *= jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def murmur3_32(words: jax.Array, seed: int = 42) -> jax.Array:
    """MurmurHash3_x86_32 over each row of uint32[n, nwords].

    Each word is one 4-byte block; the total length is 4*nwords bytes, so the
    tail is empty.  Analog of bliss::kmer::hash::murmur
    (kmer_hash.hpp:243-286) with a 32-bit-native variant.
    """
    h = jnp.full(words.shape[:-1], seed, dtype=jnp.uint32)
    nwords = words.shape[-1]
    for w in range(nwords):
        k1 = words[..., w].astype(jnp.uint32)
        k1 = k1 * _C1
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2
        h = h ^ k1
        h = _rotl32(h, 13)
        h = h * jnp.uint32(5) + jnp.uint32(0xE6546B64)
    h = h ^ jnp.uint32(4 * nwords)
    return fmix32(h)


def identity_hash(words: jax.Array, seed: int = 0) -> jax.Array:
    """The k-mer's own most significant word — analog of
    bliss::kmer::hash::identity / Kmer::getPrefix (kmer_hash.hpp:210-241).
    Only sensible when the key bits are uniformly distributed."""
    del seed
    return words[..., 0].astype(jnp.uint32)


def mix32(words: jax.Array, seed: int = 0x9E3779B1) -> jax.Array:
    """Second independent hash family (xxHash32-style avalanche rounds) —
    kept as the cheap independent mixer (hash_name="fmix32"-adjacent).
    The `farm` slot itself is the bit-exact FarmHash64 since round 4
    (ops/farmhash.py; kmer_hash.hpp:288-330)."""
    P2 = jnp.uint32(0x85EBCA77)
    P3 = jnp.uint32(0xC2B2AE3D)
    P4 = jnp.uint32(0x27D4EB2F)
    h = jnp.full(words.shape[:-1], seed, dtype=jnp.uint32)
    for w in range(words.shape[-1]):
        k = words[..., w].astype(jnp.uint32) * P3
        k = _rotl32(k, 17) * P4
        h = h ^ k
        h = _rotl32(h, 19) * P2 + jnp.uint32(0x165667B1)
    h ^= h >> 15
    h *= P2
    h ^= h >> 13
    h *= P3
    h ^= h >> 16
    return h


def _farm_slot(words: jax.Array, seed: int = 42) -> jax.Array:
    """Bit-exact FarmHash64WithSeed (farmhashna) over the row's words as a
    little-endian byte stream, folded hi^lo — the reference's farm
    DistHash (kmer_hash.hpp:288; digest parity pinned in
    tests/test_ref_parity.py)."""
    from . import farmhash
    return farmhash.farm32(words, seed)


HASHES = {
    "murmur": murmur3_32,
    "farm": _farm_slot,
    "fmix32": lambda words, seed=0: functools.reduce(
        lambda h, w: fmix32(h ^ w),
        [words[..., i].astype(jnp.uint32) for i in range(words.shape[-1])],
        jnp.full(words.shape[:-1], seed, dtype=jnp.uint32),
    ),
    "identity": identity_hash,
}
# "std" fills the reference's cpp_std slot (std::hash per chunk,
# xor-combined — kmer_hash.hpp:157-209): the fmix32 fold plays that role.
HASHES["std"] = HASHES["fmix32"]


def owner_from_hash(h: jax.Array, nparts: int) -> jax.Array:
    """Map hash values to owner shard ids in [0, nparts).

    The reference uses ``hash % p`` on the prefix-flavored hash
    (distributed_densehash_map.hpp:148-171).  We use the multiplicative
    range-reduction ``(h * p) >> 32`` (computed as a 16+16 split to stay in
    32-bit ops), which consumes the *high* hash bits — same role as the
    reference's prefix bits — and avoids a vector integer divide.
    For power-of-two p it reduces to taking the top log2(p) bits.
    """
    h = h.astype(jnp.uint32)
    if nparts & (nparts - 1) == 0:
        shift = 32 - nparts.bit_length() + 1
        return (h >> shift).astype(jnp.int32) if nparts > 1 else jnp.zeros_like(h, jnp.int32)
    # (h * nparts) >> 32 without 64-bit: split h = hi*2^16 + lo.
    hi = h >> 16
    lo = h & jnp.uint32(0xFFFF)
    # h * p = hi*p*2^16 + lo*p ; >> 32
    t = hi * jnp.uint32(nparts) + ((lo * jnp.uint32(nparts)) >> 16)
    return (t >> 16).astype(jnp.int32)

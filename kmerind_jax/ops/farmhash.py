"""FarmHash64 (farmhashna) vectorized over packed k-mer tensors.

Bit-exact reimplementation of the reference's `farm` hash functor
(/root/reference/src/index/kmer_hash.hpp:288:
``util::Hash64WithSeed(kmer.getData(), nBytes, seed)`` over
ext/farmhash/src/farmhash.cc, namespace farmhashna, FARMHASH_DEBUG=0) for
inputs up to 64 bytes — every realistic k-mer (k <= 256 DNA / 128 DNA16).

Every 64-bit quantity is a ``(hi, lo)`` pair (32-bit lanes throughout, as in the rest of the package)
of uint32 arrays; 64x64→low-64 multiplication decomposes into four 16x16
partial products plus two wrapping 32-bit multiplies — all native 32-bit ops.
The byte stream is never materialized: farmhashna reads it only through
Fetch64/Fetch32/byte loads at STATIC offsets, which become static
shift-and-or extractions from the packed words.

Two stream layouts:

* `hash64_words` — the k-mer's uint32 words as a little-endian byte
  stream, word 0 first, length 4*nwords (the framework's native word
  layout; used by the `farm` slot of `hashing.HASHES`).
* `hash64_kmers` — the REFERENCE's byte stream: the k-mer big-integer
  value V in little-endian byte order, length ceil(nbits/8) — exactly
  what `kmer.getData()` exposes (kmer.hpp:78-100: data[0] holds the LSBs,
  MSB-side padding).  Bit-parity with the compiled reference is pinned by
  tests/test_ref_parity.py over raw buffers AND real k-mer configs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["hash64_words", "hash64_kmers", "hash64_bytes", "farm32"]

_K0 = 0xC3A5C85C97CB3127
_K1 = 0xB492B66FBE98F273
_K2 = 0x9AE16A3B2F90404F
_KMUL = 0x9DDFEA08EB382D69  # Hash128to64's murmur-inspired multiplier


def _const(c: int):
    return (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF))


def _mul32x32(a: jax.Array, b: jax.Array):
    """Full 64-bit product of two uint32 arrays as a (hi, lo) pair."""
    m16 = jnp.uint32(0xFFFF)
    al, ah = a & m16, a >> 16
    bl, bh = b & m16, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = (ll >> 16) + (lh & m16) + (hl & m16)
    lo = (ll & m16) | (mid << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def _mul(a, b):
    """a * b mod 2^64 on (hi, lo) pairs."""
    hi, lo = _mul32x32(a[1], b[1])
    return hi + a[1] * b[0] + a[0] * b[1], lo


def _add(a, b):
    lo = a[1] + b[1]
    carry = (lo < b[1]).astype(jnp.uint32)
    return a[0] + b[0] + carry, lo


def _sub(a, b):
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(jnp.uint32)
    return a[0] - b[0] - borrow, lo


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _shr(a, s: int):
    if s == 0:
        return a
    if s < 32:
        return a[0] >> s, (a[1] >> s) | (a[0] << (32 - s))
    if s == 32:
        return jnp.zeros_like(a[0]), a[0]
    return jnp.zeros_like(a[0]), a[0] >> (s - 32)


def _shl(a, s: int):
    if s == 0:
        return a
    if s < 32:
        return (a[0] << s) | (a[1] >> (32 - s)), a[1] << s
    if s == 32:
        return a[1], jnp.zeros_like(a[1])
    return a[1] << (s - 32), jnp.zeros_like(a[1])


def _rot(a, s: int):
    """farmhash Rotate64: rotate RIGHT by s (BasicRotate64)."""
    r, l = _shr(a, s), _shl(a, 64 - s)
    return r[0] | l[0], r[1] | l[1]


def _shift_mix(a):
    return _xor(a, _shr(a, 47))


def _hash_len_16_mul(u, v, mul):
    """HashLen16(u, v, mul) — farmhash.cc:378."""
    a = _mul(_xor(u, v), mul)
    a = _xor(a, _shr(a, 47))
    b = _mul(_xor(v, a), mul)
    b = _xor(b, _shr(b, 47))
    return _mul(b, mul)


def _hash_128_to_64(lo64, hi64):
    """Hash128to64(Uint128(lo, hi)) — farmhash.h:129."""
    kmul = _const(_KMUL)
    a = _mul(_xor(lo64, hi64), kmul)
    a = _xor(a, _shr(a, 47))
    b = _mul(_xor(hi64, a), kmul)
    b = _xor(b, _shr(b, 47))
    return _mul(b, kmul)


def _hash64(u32_at, length: int):
    """farmhashna::Hash64 for a static-length (<= 64 bytes) stream.

    u32_at(byte_off) must return the little-endian uint32 at that byte
    offset of the stream (reads past the end may return anything for the
    bytes past `length` — farmhash never reads them)."""

    def f32(o):  # Fetch32 as a zero-extended u64 pair
        return jnp.zeros_like(u32_at(o)), u32_at(o)

    def f64(o):  # Fetch64: little-endian, so hi half is the later bytes
        return u32_at(o + 4), u32_at(o)

    def byte(o):
        return u32_at(o) & jnp.uint32(0xFF)

    k0, k1, k2 = _const(_K0), _const(_K1), _const(_K2)
    if length <= 16:
        # HashLen0to16, farmhash.cc:388
        mul = _const((_K2 + length * 2) & 0xFFFFFFFFFFFFFFFF)
        if length >= 8:
            a = _add(f64(0), k2)
            b = f64(length - 8)
            c = _add(_mul(_rot(b, 37), mul), a)
            d = _mul(_add(_rot(a, 25), b), mul)
            return _hash_len_16_mul(c, d, mul)
        if length >= 4:
            a = f32(0)
            u = _add(_const(length), _shl(a, 3))
            return _hash_len_16_mul(u, f32(length - 4), mul)
        if length > 0:
            a = byte(0)
            b = byte(length >> 1)
            c = byte(length - 1)
            y = a + (b << 8)            # uint32
            z = jnp.uint32(length) + (c << 2)
            yk2 = _mul((jnp.zeros_like(y), y), k2)
            zk0 = _mul((jnp.zeros_like(z), z), k0)
            return _mul(_shift_mix(_xor(yk2, zk0)), k2)
        return k2
    if length <= 32:
        # HashLen17to32, farmhash.cc:415
        mul = _const((_K2 + length * 2) & 0xFFFFFFFFFFFFFFFF)
        a = _mul(f64(0), k1)
        b = f64(8)
        c = _mul(f64(length - 8), mul)
        d = _mul(f64(length - 16), k2)
        return _hash_len_16_mul(
            _add(_add(_rot(_add(a, b), 43), _rot(c, 30)), d),
            _add(_add(a, _rot(_add(b, k2), 18)), c), mul)
    if length <= 64:
        # HashLen33to64, farmhash.cc:450
        mul = _const((_K2 + length * 2) & 0xFFFFFFFFFFFFFFFF)
        a = _mul(f64(0), k2)
        b = f64(8)
        c = _mul(f64(length - 8), mul)
        d = _mul(f64(length - 16), k2)
        y = _add(_add(_rot(_add(a, b), 43), _rot(c, 30)), d)
        z = _hash_len_16_mul(y, _add(_add(a, _rot(_add(b, k2), 18)), c), mul)
        e = _mul(f64(16), mul)
        f = f64(24)
        g = _mul(_add(y, f64(length - 32)), mul)
        h = _mul(_add(z, f64(length - 24)), mul)
        return _hash_len_16_mul(
            _add(_add(_rot(_add(e, f), 43), _rot(g, 30)), h),
            _add(_add(e, _rot(_add(f, a), 18)), g), mul)
    raise ValueError(f"farmhash streams > 64 bytes unsupported ({length})")


def _hash64_with_seed(u32_at, length: int, seed: int):
    """farmhashna::Hash64WithSeed = HashLen16(Hash64(s) - k2, seed)
    (farmhash.cc:523-528)."""
    h = _hash64(u32_at, length)
    return _hash_128_to_64(_sub(h, _const(_K2)),
                           _const(seed & 0xFFFFFFFFFFFFFFFF))


def _word_stream(words: jax.Array):
    """u32_at over the words-as-LE-bytes stream (word 0 first)."""
    nw = words.shape[-1]

    def u32_at(o: int):
        w, sh = divmod(o, 4)
        out = jnp.zeros_like(words[..., 0])
        if 0 <= w < nw:
            out = words[..., w] >> (8 * sh)
        if sh and w + 1 < nw:
            out = out | (words[..., w + 1] << (32 - 8 * sh))
        return out

    return u32_at


def _kmer_stream(words: jax.Array, spec):
    """u32_at over the REFERENCE byte stream: the k-mer value V (word 0
    most significant, each word word_bits(w) significant bits, contiguous)
    in little-endian byte order."""
    wbits = spec.word_bits()
    nw = spec.nwords
    # bit offset of each word's LSB within V
    cshift = [sum(wbits[w + 1:]) for w in range(nw)]

    def u32_at(o: int):
        lo_bit = 8 * o
        out = jnp.zeros_like(words[..., 0])
        for w in range(nw):
            s = cshift[w] - lo_bit
            if s >= 32 or s + wbits[w] <= 0:
                continue  # word w entirely outside [lo_bit, lo_bit + 32)
            if s >= 0:
                out = out | (words[..., w] << s)
            else:
                out = out | (words[..., w] >> (-s))
        return out

    return u32_at


def hash64_words(words: jax.Array, seed: int = 42):
    """FarmHash64WithSeed of each row's words as a little-endian byte
    stream of length 4*nwords.  Returns a (hi, lo) uint32 pair."""
    return _hash64_with_seed(_word_stream(words.astype(jnp.uint32)),
                             4 * words.shape[-1], seed)


def hash64_kmers(words: jax.Array, spec, seed: int = 42):
    """Bit-exact `util::Hash64WithSeed(kmer.getData(), nBytes, seed)` of
    the reference farm functor (kmer_hash.hpp:288) for each packed k-mer
    row.  Returns a (hi, lo) uint32 pair."""
    nbytes = (spec.nbits + 7) // 8
    return _hash64_with_seed(_kmer_stream(words.astype(jnp.uint32), spec),
                             nbytes, seed)


def hash64_bytes(data: bytes, seed: int = 42) -> int:
    """FarmHash64WithSeed of an arbitrary byte string (<= 64 bytes) —
    validation/tooling helper (the tensor paths above never materialize
    bytes).  Returns a Python int."""
    import numpy as np
    n = len(data)
    if n == 0 or n > 64:
        raise ValueError("1..64 bytes supported")
    pad = (-n) % 4 + 8
    buf = np.frombuffer(data + b"\x00" * pad, dtype="<u4").copy()
    hi, lo = _hash64_with_seed(_word_stream(jnp.asarray(buf)), n, seed)
    return (int(hi) << 32) | int(lo)


def farm32(words: jax.Array, seed: int = 42) -> jax.Array:
    """32-bit view (hi ^ lo) of the bit-exact FarmHash64 over the word
    stream — the `farm` DistHash slot."""
    hi, lo = hash64_words(words, seed)
    return hi ^ lo

"""Vectorized sliding-window k-mer extraction.

Vectorized replacement for the reference's per-character sliding-window
iterator pipeline (KmerSlidingWindow / KmerGenerationIterator,
/root/reference/src/common/kmer_iterators.hpp:62-194, and
Kmer::nextFromChar's shift+insert hot loop, kmer.hpp:731-756).

Instead of a sequential recurrence ``kmer[i+1] = (kmer[i] << b) | c[i+k]``,
we compute *all* window packs with a log2(k)-step doubling scheme (the
"parallel sliding window" construction): let

    P_t[i] = pack of codes[i : i + 2**t)        (first char most significant)

then ``P_t[i] = (P_{t-1}[i] << b*2**(t-1)) | P_{t-1}[i + 2**(t-1)]``.
An arbitrary window length m is assembled from the binary digits of m.
Every step is a shifted elementwise OR over the whole base tensor — pure
elementwise work with no sequential dependence, O(n log k) total.

The same construction applied to the complemented, reversed code stream
yields all reverse-complement windows (kmer.hpp:1118-1140 semantics) for the
cost of one extra pass — no packed-word bit reversal needed on the hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kmer import KmerSpec

__all__ = [
    "sliding_packs",
    "extract_kmers",
    "extract_canonical",
    "window_valid",
]


def _shift_idx(a: jax.Array, s: int) -> jax.Array:
    """a'[i] = a[i + s] along axis 0, zero-filled past the end (static s)."""
    if s == 0:
        return a
    pad_cfg = [(0, s, 0)] + [(0, 0, 0)] * (a.ndim - 1)
    return jax.lax.pad(a, jnp.zeros((), a.dtype), pad_cfg)[s:]


def _pow_packs(codes_u32: jax.Array, bits: int, max_m: int) -> dict[int, jax.Array]:
    """P[t][i] = pack of codes[i : i+2**t), for all 2**t <= max_m."""
    pows = {0: codes_u32}
    t = 1
    while (1 << t) <= max_m:
        half = 1 << (t - 1)
        prev = pows[t - 1]
        pows[t] = (prev << (bits * half)) | _shift_idx(prev, half)
        t += 1
    return pows


def _combine(pows: dict[int, jax.Array], bits: int, m: int) -> jax.Array:
    """W[i] = pack of codes[i : i+m) assembled from power-of-two packs."""
    acc = None
    consumed = 0
    for t in reversed(range(max(pows) + 1)):
        if m & (1 << t):
            part = _shift_idx(pows[t], consumed) if consumed else pows[t]
            if acc is None:
                acc = part
            else:
                acc = (acc << (bits * (1 << t))) | part
            consumed += 1 << t
    assert acc is not None and consumed == m
    return acc


def sliding_packs(codes: jax.Array, m: int, bits: int) -> jax.Array:
    """All length-m window packs of a code stream.

    Args:
      codes: [n] integer codes (any int dtype, values < 2**bits).
      m: window length in characters; requires m * bits <= 32.
      bits: bits per character.

    Returns:
      uint32[n]; entry i is the pack of codes[i:i+m] (first char most
      significant).  Entries with i > n-m contain partial packs (callers mask
      them via `window_valid`).
    """
    if m * bits > 32:
        raise ValueError(f"window of {m} chars x {bits} bits exceeds 32-bit word")
    u = codes.astype(jnp.uint32)
    return _combine(_pow_packs(u, bits, m), bits, m)


def _window_words(codes: jax.Array, spec: KmerSpec) -> jax.Array:
    """uint32[n, nwords]: words of the k-mer starting at every position."""
    b = spec.bits_per_char
    cpw = spec.chars_per_word
    r = spec.last_word_chars
    pows = _pow_packs(codes.astype(jnp.uint32), b, max(cpw, r))
    full = _combine(pows, b, cpw) if spec.nwords > 1 or r == cpw else None
    last = full if r == cpw else _combine(pows, b, r)
    cols = []
    for w in range(spec.nwords - 1):
        cols.append(_shift_idx(full, w * cpw))
    cols.append(_shift_idx(last, (spec.nwords - 1) * cpw) if spec.nwords > 1 else last)
    return jnp.stack(cols, axis=1)


@functools.partial(jax.jit, static_argnames=("spec",))
def extract_kmers(codes: jax.Array, spec: KmerSpec) -> jax.Array:
    """Forward-strand k-mers at every window position.

    Args:
      codes: [n] uint8/int codes.
      spec: k-mer spec (static).

    Returns:
      uint32[n, nwords]; row i is the packed k-mer codes[i:i+k].  Rows past
      n-k are garbage — mask with `window_valid`.
    """
    return _window_words(codes, spec)


@functools.partial(jax.jit, static_argnames=("spec",))
def extract_revcomp(codes: jax.Array, spec: KmerSpec) -> jax.Array:
    """Reverse-complement k-mers aligned with the forward windows.

    Row i is revcomp(codes[i:i+k]).  Implemented as a window pack over the
    complemented + reversed stream, then realigned (rc window of forward
    position i starts at n-k-i in the flipped stream, i.e. at i+k-1 after
    re-flipping), mirroring Kmer::reverse_complement (kmer.hpp:1118-1140)
    without bit twiddling.
    """
    comp_lut = jnp.asarray(spec.alphabet.to_complement)
    comp = jnp.take(comp_lut, codes.astype(jnp.int32), axis=0)
    flipped_words = _window_words(comp[::-1], spec)
    realigned = flipped_words[::-1]
    return _shift_idx(realigned, spec.k - 1)


def lex_less(a: jax.Array, b: jax.Array) -> jax.Array:
    """Row-wise lexicographic a < b over word arrays [n, w] (uint32).

    Equivalent to the reference's word-array `less`
    (/root/reference/src/utils/bitgroup_ops.hpp:3539-3575) given the
    big-endian word layout.  Elementwise fold from the least significant
    word — no gathers.
    """
    w = a.shape[-1]
    less = jnp.zeros(a.shape[:-1], dtype=bool)
    for j in reversed(range(w)):
        aj, bj = a[..., j], b[..., j]
        less = jnp.where(aj != bj, aj < bj, less)
    return less


@functools.partial(jax.jit, static_argnames=("spec",))
def extract_canonical(codes: jax.Array, spec: KmerSpec):
    """(canonical kmers, was_revcomp) at every window position.

    canonical = min(kmer, revcomp(kmer)) in lexicographic (encoded) order —
    the `lex_less` transform (kmer_transform.hpp:109-123).

    Returns:
      (uint32[n, nwords], bool[n]); the flag marks windows where the
      reverse complement was the smaller strand.
    """
    fwd = _window_words(codes, spec)
    rc = extract_revcomp(codes, spec)
    use_rc = lex_less(rc, fwd)
    return jnp.where(use_rc[:, None], rc, fwd), use_rc


@functools.partial(jax.jit, static_argnames=("k",))
def window_valid(
    base_valid: jax.Array,
    seg_id: jax.Array,
    k: int,
) -> jax.Array:
    """Which window positions yield a real k-mer.

    A window [i, i+k) is valid iff every base in it is valid (not padding)
    and all bases belong to the same record (seg_id constant) — the tensor
    equivalent of the reference's per-record iteration that simply never
    crosses record boundaries (sequence_iterator.hpp:241-283) plus the k-1
    overlap bookkeeping (kmer_file_helper.hpp:361).

    Args:
      base_valid: [n] bool.
      seg_id: [n] int32 record index per base (arbitrary on invalid bases).
      k: window size (static).

    Returns: bool[n].
    """
    # all-valid over window = sliding AND, via the same doubling trick on min
    v = base_valid.astype(jnp.int32)
    span = 1
    while span < k:
        step = min(span, k - span)
        v = jnp.minimum(v, _shift_idx(v, step))
        span += step
    all_valid = v.astype(bool)
    same_seg = seg_id == _shift_idx(seg_id, k - 1) if k > 1 else jnp.ones_like(seg_id, dtype=bool)
    n = base_valid.shape[0]
    in_range = jnp.arange(n) <= (n - k)
    return all_valid & same_seg & in_range


@functools.partial(jax.jit, static_argnames=("spec",))
def extract_xor_rev_comp(codes: jax.Array, spec: KmerSpec):
    """kmer XOR revcomp(kmer) at every window — the xor_rev_comp
    canonicalization transform (kmer_transform.hpp:91-106), a strand-neutral
    key that is cheaper than lex_less but collides strands."""
    fwd = _window_words(codes, spec)
    rc = extract_revcomp(codes, spec)
    return fwd ^ rc


@functools.partial(jax.jit, static_argnames=("spec",))
def extract_canonical_greater(codes: jax.Array, spec: KmerSpec):
    """max(kmer, revcomp) — the lex_greater transform
    (kmer_transform.hpp:128-145)."""
    fwd = _window_words(codes, spec)
    rc = extract_revcomp(codes, spec)
    use_rc = lex_less(fwd, rc)
    return jnp.where(use_rc[:, None], rc, fwd), use_rc

"""The plain scans and the LSM merge of the count build against numpy.

`sortops.run_length_counts` (the segmented reduction of the ingest: the
reference's hash-probe += loop, distributed_densehash_map.hpp:278,1911),
`sortops.merge_sorted_runs_cols` (the LSM flush) and `store._cumsum_i32`
(the run store's prefix sums) are what XLA compiles for the device; these
tests pin their semantics on the CPU at block-spanning and odd sizes.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmerind_jax.index import store as st
from kmerind_jax.ops import sortops

SENT = 0xFFFFFFFF


def _make_sorted(rng, n, w, nkeys, tv):
    """Rows with a sorted valid prefix of tv rows (sort_rows' invariant)."""
    keys = rng.integers(0, 2**32, (max(nkeys, 1), w), dtype=np.uint32)
    pick = keys[rng.integers(0, max(nkeys, 1), n)]
    pre = pick[:tv]
    pre = pre[np.lexsort(pre.T[::-1])]
    return np.concatenate([pre, pick[tv:]])


def _run_lengths(swords, tv):
    """numpy oracle: (weights, emit) — each run's length on its last row."""
    n = swords.shape[0]
    idx = np.arange(n)
    neq = np.any(swords[1:] != swords[:-1], axis=1)
    isnew = np.concatenate([[True], neq]) & (idx < tv)
    start = np.maximum.accumulate(np.where(isnew, idx, -1))
    last = (idx < tv) & (np.concatenate([neq, [True]]) | (idx == tv - 1))
    return np.where(last, idx - start + 1, 0), last


def _run_length_counts(swords, tv):
    w, e = jax.jit(sortops.run_length_counts)(
        jnp.asarray(swords), jnp.asarray(np.arange(swords.shape[0]) < tv))
    return np.asarray(w), np.asarray(e)


@pytest.mark.parametrize("n,w,nkeys,tvfrac", [
    (1 << 12, 2, 50, 1.0),       # all rows valid
    (1 << 12, 2, 50, 0.7),       # invalid tail
    (300000, 1, 7, 0.9),         # length not a power of two; long runs
    (1 << 19, 3, 100000, 0.99),  # 3-word keys
    (5000, 2, 1, 1.0),           # a single run over every row
    (4096, 2, 10, 0.0),          # all rows invalid
])
def test_matches_jnp_scan(n, w, nkeys, tvfrac):
    rng = np.random.default_rng(n + w)
    tv = int(n * tvfrac)
    swords = _make_sorted(rng, n, w, nkeys, tv)
    got_w, got_e = _run_length_counts(swords, tv)
    want_w, want_e = _run_lengths(swords, tv)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_e, want_e)


def test_run_spanning_block_boundary():
    """A run longer than any scan block (256K rows) emits one weight with
    its full length."""
    n = 1 << 19
    block = 2048 * 128
    swords = np.zeros((n, 2), np.uint32)
    swords[:block + 100] = 7          # run of block+100 equal keys
    swords[block + 100:] = 9
    got, _ = _run_length_counts(swords, n)
    assert list(np.flatnonzero(got)) == [block + 99, n - 1]
    assert got[block + 99] == block + 100
    assert got[n - 1] == n - (block + 100)


def test_weights_sum_and_first_invalid_equal_key():
    """Sum of weights == total_valid even when the first invalid row
    bit-equals the last valid row."""
    n = 1 << 12
    swords = np.full((n, 2), 5, np.uint32)
    tv = 1000
    got, emit = _run_length_counts(swords, tv)
    assert got.sum() == tv
    assert got[tv - 1] == tv
    assert list(np.flatnonzero(emit)) == [tv - 1]


def _run(rng, n, sentinels):
    """A sorted 2-column run of n rows whose last `sentinels` rows are
    all-ones padding (payload 0), as the run store keeps them."""
    live = n - sentinels
    hi = rng.integers(0, 4, live, dtype=np.uint32)
    lo = rng.integers(0, 2**32, live, dtype=np.uint32)
    pay = rng.integers(1, 100, live).astype(np.int32)
    o = np.lexsort((lo, hi))
    keys = np.stack([np.concatenate([hi[o], np.full(sentinels, SENT,
                                                    np.uint32)]),
                     np.concatenate([lo[o], np.full(sentinels, SENT,
                                                    np.uint32)])])
    return keys, np.concatenate([pay[o], np.zeros(sentinels, np.int32)])


@pytest.mark.parametrize("na,nb,sa,sb", [
    (1 << 12, 1 << 12, 0, 0),     # equal power-of-two runs
    (1 << 13, 1 << 13, 100, 7),   # sentinel tails in both
    (1 << 14, 1 << 14, 0, 5000),  # heavily padded B
    (1 << 13, 1 << 11, 0, 0),     # nb < na: padded to a power of two
    (1 << 12, 1 << 10, 10, 1),    # nb < na with tails
    (3000, 1000, 0, 0),           # neither a power of two
    (1 << 14, 1, 0, 0),           # one-row B
])
def test_merge_sorted_runs_cols(na, nb, sa, sb):
    """Keys-only and one-payload merges equal the sorted multiset union;
    the output pads to the next power of two with sentinel rows of
    payload 0."""
    rng = np.random.default_rng(na * 7 + nb)
    ka, pa = _run(rng, na, sa)
    kb, pb = _run(rng, nb, sb)
    n = 1 << (na + nb - 1).bit_length()
    pad = n - na - nb
    allk = np.concatenate([ka, kb, np.full((2, pad), SENT, np.uint32)],
                          axis=1)
    allp = np.concatenate([pa, pb, np.zeros(pad, np.int32)])
    order = np.lexsort((allk[1], allk[0]))

    keys_only, none = sortops.merge_sorted_runs_cols(
        jnp.asarray(ka), (), jnp.asarray(kb), ())
    assert none == ()
    np.testing.assert_array_equal(np.asarray(keys_only), allk[:, order])

    got_k, (got_p,) = sortops.merge_sorted_runs_cols(
        jnp.asarray(ka), (jnp.asarray(pa),), jnp.asarray(kb),
        (jnp.asarray(pb),))
    got_k, got_p = np.asarray(got_k), np.asarray(got_p)
    np.testing.assert_array_equal(got_k, allk[:, order])
    # the network is not stable: compare (key, payload) multisets
    assert collections.Counter(zip(got_k[0].tolist(), got_k[1].tolist(),
                                   got_p.tolist())) == \
        collections.Counter(zip(allk[0].tolist(), allk[1].tolist(),
                                allp.tolist()))


def test_cumsum_i32():
    """The run store's int32 prefix sum, over a length that is not a
    power of two, equals numpy's."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1000, 300001).astype(np.int32)
    got = np.asarray(jax.jit(st._cumsum_i32)(jnp.asarray(x)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.int64))

"""Device-side predicate scans at ~1M-row scale.

Round-4 hardening: every full-store predicate export runs on device
(compact-to-front selection) instead of fetching cap-sized stores to the
host — the owner-side predicate evaluation of the reference
(/root/reference/src/containers/distributed_densehash_map.hpp:1603+).
These tests pin the device paths against numpy oracles at sizes where a
host loop would be visibly wrong to ship (>= 1M rows per store).
"""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import BimoleculeCountIndex, PositionIndex
from kmerind_jax.index.sorted_api import SortedCountIndex
from kmerind_jax.index.value_api import KmerValueIndex

SPEC = KmerSpec(21, DNA)
M = 1 << 20  # 1M rows


def _random_kmer_rows(m: int, seed: int, distinct_bits: int = 18):
    """uint32[m, 2] valid k=21 kmer rows (packed from random codes);
    values repeat (2^distinct_bits distinct) so multimap runs are long."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=(1 << distinct_bits, 21), dtype=np.int64)
    pick = rng.integers(0, base.shape[0], size=m)
    rows = np.stack([SPEC.pack_codes(base[i]) for i in
                     range(base.shape[0])]).astype(np.uint32)
    return rows[pick]


@pytest.fixture(scope="module")
def kmer_rows():
    return _random_kmer_rows(M, seed=7)


def test_position_count_if_device_1m(kmer_rows):
    idx = PositionIndex(SPEC, canonical=False)
    ids = np.arange(M, dtype=np.uint64)
    idx.insert(kmer_rows, ids)
    # pred: pairs whose id_lo is even
    out = idx.count_if(lambda k, h, l, q: (l & 1) == 0)
    # oracle: canonicalization off -> keys stored as inserted
    ints = SPEC.to_ints(kmer_rows)
    sel = (ids & np.uint64(1)) == 0
    import collections
    oracle = collections.Counter(ints[sel].tolist())
    assert dict(out) == dict(oracle)


def test_position_unique_size_device_1m(kmer_rows):
    idx = PositionIndex(SPEC, canonical=False)
    idx.insert(kmer_rows, np.arange(M, dtype=np.uint64))
    ints = SPEC.to_ints(kmer_rows)
    assert idx.unique_size() == np.unique(ints).shape[0]
    assert idx.size() == M


def test_sorted_count_if_device_1m(kmer_rows):
    idx = SortedCountIndex(SPEC, canonical=False)
    idx.insert(kmer_rows)
    out = idx.count_if(lambda k, c: c >= 3)
    ints = SPEC.to_ints(kmer_rows)
    u, c = np.unique(ints, return_counts=True)
    oracle = {int(v): int(n) for v, n in zip(u, c) if n >= 3}
    assert dict(out) == oracle
    assert idx.unique_size() == u.shape[0]


def test_sorted_items_in_range_device(kmer_rows):
    idx = SortedCountIndex(SPEC, canonical=False)
    idx.insert(kmer_rows[: 1 << 16])
    ints = SPEC.to_ints(kmer_rows[: 1 << 16])
    u, c = np.unique(ints, return_counts=True)
    lo, hi = int(u[len(u) // 4]), int(u[3 * len(u) // 4])
    got = idx.items_in_range(_int_to_words(lo), _int_to_words(hi))
    oracle = sorted((int(v), int(n)) for v, n in zip(u, c)
                    if lo <= int(v) < hi)
    assert got == oracle


def _int_to_words(v: int) -> np.ndarray:
    """Inverse of KmerSpec.to_int for the 2-word k=21 DNA layout."""
    nbits = SPEC.nbits
    rows = np.zeros(SPEC.nwords, np.uint32)
    # to_int folds word 0 first (most significant)
    rem = v
    shifts = []
    total = 0
    for w, bits in enumerate(SPEC.word_bits()):
        shifts.append(bits)
        total += bits
    assert total == nbits
    for w in range(SPEC.nwords):
        total -= shifts[w]
        rows[w] = (rem >> total) & ((1 << shifts[w]) - 1)
        rem &= (1 << total) - 1
    # undo: word values sit at the layout positions pack_codes produces;
    # verify via to_int round-trip
    assert SPEC.to_int(rows) == v
    return rows


def test_kv_count_if_device_1m(kmer_rows):
    idx = KmerValueIndex(SPEC, canonical=False, reduce="min")
    vals = np.arange(M, dtype=np.uint64) * 3
    idx.insert(kmer_rows, vals)
    out = idx.count_if(lambda k, h, l: (l % 7) == 0)
    ints = SPEC.to_ints(kmer_rows)
    oracle = {}
    order = np.lexsort((vals, ints))
    for i in order[::-1]:
        oracle[int(ints[i])] = int(vals[i])  # min value per key wins
    oracle = {k: v for k, v in oracle.items() if (v & 0xFFFFFFFF) % 7 == 0}
    assert dict(out) == oracle


def test_lookup_join_crossover_parity(kmer_rows):
    """Every lookup family answers identically through the binary-search
    path (small m) and the gather-free join path (m*8 >= cap) — the
    round-4 crossover routing (lookup_join_vals / lookup_join_ranges)."""
    import jax.numpy as jnp
    from kmerind_jax.index import store as st

    cap = 1 << 15
    rng = np.random.default_rng(11)
    rows = kmer_rows[: cap // 2]
    order = np.lexsort(tuple(rows[:, j] for j in reversed(range(2))))
    rows = rows[order]
    size = rows.shape[0]

    def q_sets():
        small = rows[rng.integers(0, size, 1 << 10)]
        small[::3] ^= 1  # some misses
        big = rows[rng.integers(0, size, cap)]
        big[::3] ^= 1
        return jnp.asarray(small), jnp.asarray(big)

    # --- multimap ranges ---
    ms = st.empty_multi_store(cap, 2)
    ms, ovf = st.multi_insert(
        ms, jnp.asarray(rows), jnp.arange(size, dtype=jnp.uint32),
        jnp.arange(size, dtype=jnp.uint32) * 7,
        jnp.ones(size, bool))
    assert int(ovf) == 0
    qs, qb = q_sets()
    for q in (qs, qb):
        lo, hi = st.multi_lookup_ranges(ms, q)
        # oracle via numpy searchsorted over the packed 64-bit key
        skeys = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
        qq = np.asarray(q)
        qk = (qq[:, 0].astype(np.uint64) << np.uint64(32)) | qq[:, 1]
        olo = np.searchsorted(skeys, qk, side="left")
        ohi = np.searchsorted(skeys, qk, side="right")
        hit = ohi > olo
        np.testing.assert_array_equal(np.asarray(hi - lo), ohi - olo)
        np.testing.assert_array_equal(np.asarray(lo)[hit], olo[hit])

    # --- kv lookup (unique keys) ---
    skeys_all = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    ukeys, first = np.unique(skeys_all, return_index=True)
    urows = rows[first]  # sorted by key (np.unique order)
    usize = urows.shape[0]
    kv = st.empty_kv_store(cap, 2)
    kv, ovf = st.kv_insert(
        kv, jnp.asarray(urows), jnp.arange(usize, dtype=jnp.uint32),
        jnp.arange(usize, dtype=jnp.uint32) * 3, jnp.ones(usize, bool))
    assert int(ovf) == 0
    for q in (qs, qb):
        hi, lo, found = (np.asarray(x) for x in st.kv_lookup(kv, q))
        qq = np.asarray(q)
        qk = (qq[:, 0].astype(np.uint64) << np.uint64(32)) | qq[:, 1]
        pos = np.searchsorted(ukeys, qk)
        idx = np.minimum(pos, usize - 1)
        ofound = (pos < usize) & (ukeys[idx] == qk)
        np.testing.assert_array_equal(found, ofound)
        np.testing.assert_array_equal(hi[ofound], idx[ofound].astype(np.uint32))
        np.testing.assert_array_equal(
            lo[ofound], (idx[ofound] * 3).astype(np.uint32))

    # --- vec lookup ---
    vs = st.empty_vec_store(cap, 2, 4)
    vecs = rng.integers(0, 100, size=(size, 4)).astype(np.int32)
    vs, ovf = st.vec_insert(vs, jnp.asarray(rows), jnp.asarray(vecs),
                            jnp.ones(size, bool))
    assert int(ovf) == 0
    for q in (qs, qb):
        vals, found = (np.asarray(x) for x in st.vec_lookup(vs, q))
        skeys = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
        # keys may repeat in kmer_rows -> vec_insert summed duplicates;
        # rebuild oracle per unique key
        qq = np.asarray(q)
        qk = (qq[:, 0].astype(np.uint64) << np.uint64(32)) | qq[:, 1]
        u, inv = np.unique(skeys, return_inverse=True)
        acc = np.zeros((u.shape[0], 4), np.int64)
        np.add.at(acc, inv, vecs)
        pos = np.searchsorted(u, qk)
        ofound = (pos < u.shape[0]) & (u[np.minimum(pos, u.shape[0] - 1)]
                                       == qk)
        np.testing.assert_array_equal(found, ofound)
        np.testing.assert_array_equal(
            vals[ofound], acc[np.minimum(pos, u.shape[0] - 1)][ofound])


def test_bimol_count_if_device(kmer_rows):
    idx = BimoleculeCountIndex(SPEC)
    rows = kmer_rows[: 1 << 17]
    idx.insert(rows)
    out = idx.count_if(lambda k, c: c >= 2)
    canon = idx._maybe_canonicalize_queries(rows)
    ints = SPEC.to_ints(canon)
    u, c = np.unique(ints, return_counts=True)
    oracle = {int(v): int(n) for v, n in zip(u, c) if n >= 2}
    # count_if reports stored keys in canonical space for Bimolecule
    assert dict(out) == oracle

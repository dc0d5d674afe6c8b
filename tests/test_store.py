"""Local store semantics vs Python dict/Counter oracles
(analog of src/containers/test/test_densehash_map.cpp)."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax.index import store as st


def _mk_words(vals, w=2):
    """ints -> uint32[n, w] rows (value split across words, word0 high)."""
    vals = np.asarray(vals, dtype=np.uint64)
    out = np.zeros((len(vals), w), dtype=np.uint32)
    for j in range(w):
        out[:, w - 1 - j] = (vals >> np.uint64(32 * j)).astype(np.uint32)
    return out


def test_count_insert_lookup():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, size=200)
    s = st.empty_count_store(256, 2)
    s, ovf = st.count_insert(s, jnp.asarray(_mk_words(keys)),
                             jnp.ones(200, bool))
    assert int(ovf) == 0
    from collections import Counter
    oracle = Counter(keys.tolist())
    assert int(s.size) == len(oracle)
    qvals = np.arange(60)
    got = np.asarray(st.count_lookup(s, jnp.asarray(_mk_words(qvals))))
    for q, g in zip(qvals, got):
        assert g == oracle.get(q, 0), q


def test_count_insert_incremental_merge():
    s = st.empty_count_store(64, 1)
    a = _mk_words([1, 2, 2, 3], w=1)
    b = _mk_words([2, 3, 3, 9], w=1)
    s, _ = st.count_insert(s, jnp.asarray(a), jnp.ones(4, bool))
    s, _ = st.count_insert(s, jnp.asarray(b), jnp.ones(4, bool))
    got = np.asarray(st.count_lookup(s, jnp.asarray(_mk_words([1, 2, 3, 9, 5], w=1))))
    np.testing.assert_array_equal(got, [1, 3, 3, 1, 0])


def test_count_insert_overflow_reported():
    s = st.empty_count_store(4, 1)
    s, ovf = st.count_insert(s, jnp.asarray(_mk_words([1, 2, 3, 4, 5, 6], w=1)),
                             jnp.ones(6, bool))
    assert int(ovf) == 2


def test_count_insert_weights_and_saturation():
    s = st.empty_count_store(8, 1)
    w = jnp.asarray(np.array([5, 5, 200], dtype=np.int32))
    s, _ = st.count_insert(s, jnp.asarray(_mk_words([7, 7, 8], w=1)),
                           jnp.ones(3, bool), weights=w, saturate=100)
    got = np.asarray(st.count_lookup(s, jnp.asarray(_mk_words([7, 8], w=1))))
    np.testing.assert_array_equal(got, [10, 100])


def test_count_erase():
    s = st.empty_count_store(32, 1)
    s, _ = st.count_insert(s, jnp.asarray(_mk_words([1, 2, 3, 4], w=1)),
                           jnp.ones(4, bool))
    s, n = st.count_erase(s, jnp.asarray(_mk_words([2, 4, 99], w=1)),
                          jnp.ones(3, bool))
    assert int(n) == 2
    assert int(s.size) == 2
    got = np.asarray(st.count_lookup(s, jnp.asarray(_mk_words([1, 2, 3, 4], w=1))))
    np.testing.assert_array_equal(got, [1, 0, 1, 0])


def test_multi_insert_count_gather_erase():
    s = st.empty_multi_store(64, 1)
    keys = [5, 5, 9, 5, 7]
    vals = [100, 101, 900, 102, 700]
    s, ovf = st.multi_insert(
        s, jnp.asarray(_mk_words(keys, w=1)),
        jnp.asarray(np.zeros(5, np.uint32)),
        jnp.asarray(np.array(vals, np.uint32)),
        jnp.ones(5, bool))
    assert int(ovf) == 0
    q = jnp.asarray(_mk_words([5, 7, 9, 11], w=1))
    cnt = np.asarray(st.multi_count(s, q))
    np.testing.assert_array_equal(cnt, [3, 1, 1, 0])
    lo, hi = st.multi_lookup_ranges(s, q)
    _, lo_vals, _q, mask = st.multi_gather(s, lo, hi, max_per_query=4)
    got5 = sorted(np.asarray(lo_vals)[0][np.asarray(mask)[0]].tolist())
    assert got5 == [100, 101, 102]
    s, n = st.multi_erase(s, jnp.asarray(_mk_words([5, 11], w=1)),
                          jnp.ones(2, bool))
    assert int(n) == 3
    cnt = np.asarray(st.multi_count(s, q))
    np.testing.assert_array_equal(cnt, [0, 1, 1, 0])


def test_multi_merge_flush_matches_insert():
    """The sentinel-safe merge flush must agree with the stable-sort
    insert on contents (multiset of (key, value) pairs per query) across
    repeated batches with invalid rows."""
    rng = np.random.default_rng(7)
    cap = 256
    s_merge = st.empty_multi_store(cap, 2)
    s_sort = st.empty_multi_store(cap, 2)
    oracle: dict[int, list[int]] = {}
    for batch in range(4):
        n = 48
        keys = rng.integers(0, 30, size=n)
        vals = rng.integers(0, 1 << 31, size=n).astype(np.uint32)
        quals = rng.random(n).astype(np.float32)
        valid = rng.random(n) > 0.25
        args = (jnp.asarray(_mk_words(keys)),
                jnp.asarray(np.zeros(n, np.uint32)),
                jnp.asarray(vals), jnp.asarray(valid),
                jnp.asarray(quals))
        s_merge, ovf_m = st.multi_merge_flush(s_merge, *args[:4],
                                              val_q=args[4])
        s_sort, ovf_s = st.multi_insert(s_sort, *args[:4], val_q=args[4])
        assert int(ovf_m) == int(ovf_s) == 0
        for k, v, q, ok in zip(keys, vals, quals, valid):
            if ok:
                oracle.setdefault(int(k), []).append((int(v), float(q)))
    assert int(s_merge.size) == int(s_sort.size) == \
        sum(len(v) for v in oracle.values())
    q = jnp.asarray(_mk_words(np.arange(32)))
    cnt_m = np.asarray(st.multi_count(s_merge, q))
    cnt_s = np.asarray(st.multi_count(s_sort, q))
    np.testing.assert_array_equal(cnt_m, cnt_s)
    lo, hi = st.multi_lookup_ranges(s_merge, q)
    _, lo_vals, qv, mask = st.multi_gather(s_merge, lo, hi, max_per_query=32)
    lo_vals, qv, mask = map(np.asarray, (lo_vals, qv, mask))
    for k in range(32):
        got = sorted(zip(lo_vals[k][mask[k]].tolist(),
                         qv[k][mask[k]].tolist()))
        want = sorted((v, pytest.approx(qq)) for v, qq in
                      oracle.get(k, []))
        assert [g[0] for g in got] == [w[0] for w in want], k
        for (gv, gq), (wv, wq) in zip(got, want):
            assert gq == pytest.approx(wq)


def test_multi_merge_flush_overflow_reported():
    s = st.empty_multi_store(4, 1)
    s, ovf = st.multi_merge_flush(
        s, jnp.asarray(_mk_words([1, 2, 3, 4, 5, 6], w=1)),
        jnp.asarray(np.zeros(6, np.uint32)),
        jnp.asarray(np.arange(6, dtype=np.uint32)),
        jnp.ones(6, bool))
    assert int(ovf) == 2


def test_multiword_key_ordering():
    # keys differing only in low word must compare correctly
    s = st.empty_count_store(16, 2)
    vals = [(1 << 32) | 5, (1 << 32) | 3, (2 << 32), 7]
    s, _ = st.count_insert(s, jnp.asarray(_mk_words(vals)), jnp.ones(4, bool))
    got = np.asarray(st.count_lookup(s, jnp.asarray(_mk_words(vals))))
    np.testing.assert_array_equal(got, [1, 1, 1, 1])
    keys = np.asarray(s.keys)[: int(s.size)]
    ints = [(int(k[0]) << 32) | int(k[1]) for k in keys]
    assert ints == sorted(vals)


def test_lookup_join_matches_binary_search():
    from kmerind_jax.ops import sortops
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 500, size=300)
    s = st.empty_count_store(512, 2)
    s, _ = st.count_insert(s, jnp.asarray(_mk_words(keys)), jnp.ones(300, bool))
    queries = _mk_words(rng.integers(0, 600, size=400))
    # join path (m*8 >= cap)
    got_join = np.asarray(sortops.lookup_join(
        s.keys, s.size, s.counts, jnp.asarray(queries)))
    # binary search path
    idx = sortops.lower_bound(s.keys, s.size, jnp.asarray(queries))
    hit = sortops.rows_equal_at(s.keys, idx, jnp.asarray(queries), s.size)
    vals = np.asarray(s.counts)[np.clip(np.asarray(idx), 0, 511)]
    got_bin = np.where(np.asarray(hit), vals, 0)
    np.testing.assert_array_equal(got_join, got_bin)
    from collections import Counter
    oracle_counts = Counter(keys.tolist())
    want = [oracle_counts.get(int(q[0]) << 32 | int(q[1]), 0) for q in queries]
    # queries were built as (hi, lo) split of small ints -> value = lo only
    want = [oracle_counts.get(int(q[1]), 0) if q[0] == 0 else 0 for q in queries]
    np.testing.assert_array_equal(got_join, want)


def test_lookup_join_fullword_sentinel_key():
    """Regression (ADVICE r1, high): when the all-ones key is a REAL k-mer
    (sentinel-unsafe specs like k=16 DNA poly-T), store padding rows share
    its bit pattern; the join path must still return the live row's count,
    not the padding rows' zero."""
    from kmerind_jax.ops import sortops
    w = 1
    s = st.empty_count_store(32, w)
    poly_t = _mk_words([0xFFFFFFFF], w=w)  # all-ones == sentinel pattern
    s, _ = st.count_insert(
        s, jnp.asarray(np.concatenate([poly_t, poly_t, _mk_words([5], w=w)])),
        jnp.ones(3, bool))
    # join path directly
    got = np.asarray(sortops.lookup_join(
        s.keys, s.size, s.counts,
        jnp.asarray(np.concatenate([poly_t, _mk_words([5, 7], w=w)]))))
    np.testing.assert_array_equal(got, [2, 1, 0])
    # large-batch count_lookup takes the join path when m*8 >= cap
    queries = np.concatenate([poly_t] * 4 + [_mk_words([5, 7], w=w)])
    got2 = np.asarray(st.count_lookup(s, jnp.asarray(queries)))
    np.testing.assert_array_equal(got2, [2, 2, 2, 2, 1, 0])


def test_fullword_polyT_end_to_end():
    """k=16 DNA: poly-T k-mer stored twice must be countable on both the
    small-batch (binary search) and large-batch (sort-merge join) paths."""
    from kmerind_jax.index.api import CountIndex
    from kmerind_jax.kmer import KmerSpec
    from kmerind_jax import alphabets

    spec = KmerSpec(16, alphabets.DNA)
    assert not spec.sentinel_safe
    idx = CountIndex(spec, canonical=False, initial_capacity=64)
    idx.insert(["T" * 16, "T" * 16, "A" * 7 + "C" * 9])
    # small batch
    np.testing.assert_array_equal(idx.count(["T" * 16]), [2])
    # large batch (forces the join path: m*8 >= capacity)
    big = ["T" * 16, "A" * 7 + "C" * 9] * 40
    got = idx.count(big)
    np.testing.assert_array_equal(got, [2, 1] * 40)


def test_clear_preserves_sentinel_invariant():
    """Regression (ADVICE r1): clear() must reset keys to the sentinel so
    lookup_join on a cleared store cannot match the all-zero key."""
    from kmerind_jax.index.api import CountIndex
    from kmerind_jax.kmer import KmerSpec
    from kmerind_jax import alphabets

    spec = KmerSpec(15, alphabets.DNA)
    idx = CountIndex(spec, canonical=False, initial_capacity=64)
    idx.insert(["A" * 15, "C" * 15])
    idx.clear()
    assert idx.size() == 0
    assert len(idx.runs) == 1
    keys = np.asarray(idx.runs[0].keys)
    assert (keys == 0xFFFFFFFF).all()
    # poly-A (all-zero key) on the large-batch join path must return 0
    got = idx.count(["A" * 15] * 64)
    np.testing.assert_array_equal(got, [0] * 64)


def test_run_length_counts_matches_unique_counts():
    """The scan-based in-place run-length reduction must carry the same
    (key, count) multiset as the compacting unique_counts."""
    from kmerind_jax.ops import sortops
    rng = np.random.default_rng(3)
    for n, hi in [(64, 8), (512, 40), (4096, 10)]:
        keys = rng.integers(0, hi, size=n)
        valid = rng.random(n) < 0.8
        words = jnp.asarray(_mk_words(keys))
        s_words, _, s_valid = sortops.sort_rows(words, (), jnp.asarray(valid))
        uniq, counts, n_unique = sortops.unique_counts(s_words, s_valid)
        weights, emit = sortops.run_length_counts(s_words, s_valid)
        want = {}
        nu = int(n_unique)
        for i in range(nu):
            kk = (int(uniq[i, 0]) << 32) | int(uniq[i, 1])
            want[kk] = int(counts[i])
        got = {}
        we, em, sw = np.asarray(weights), np.asarray(emit), np.asarray(s_words)
        assert int(em.sum()) == nu
        for i in np.flatnonzero(em):
            kk = (int(sw[i, 0]) << 32) | int(sw[i, 1])
            got[kk] = int(we[i])
        assert got == want, (n, hi)
        # weights zero off emit rows
        assert (we[~em] == 0).all()


def test_run_vec_store_matches_oracle():
    """RunVecStore merge/lookup/compact vs a per-key counter oracle
    (edge_counts semantics: one increment per set DNA16 bit + self)."""
    import jax
    from collections import defaultdict
    rng = np.random.default_rng(3)

    def mkrun(n_live, cap, w=2):
        k = np.full((w, cap), 0xFFFFFFFF, np.uint32)
        k[0, :n_live] = np.sort(
            rng.integers(0, 40, size=n_live).astype(np.uint32))
        k[1, :n_live] = 0
        eb = np.zeros(cap, np.int32)
        eb[:n_live] = rng.choice([0x11, 0x12, 0x24, 0x48, 0xF1],
                                 size=n_live)
        wt = np.zeros(cap, np.int32)
        wt[:n_live] = 1
        return st.run_vec_from_sorted(
            jnp.asarray(k), jnp.asarray(eb), jnp.asarray(wt)), k, eb, wt

    a, ka, ea, wa = mkrun(50, 64)
    b, kb, eb_, wb = mkrun(30, 32)
    m = st.run_vec_merge(a, b)
    orc = defaultdict(lambda: np.zeros(9, np.int64))
    for karr, earr, warr, cap in ((ka, ea, wa, 64), (kb, eb_, wb, 32)):
        for i in range(cap):
            if warr[i] == 0:
                continue
            for j in range(8):
                orc[int(karr[0, i])][j] += ((earr[i] >> j) & 1) * warr[i]
            orc[int(karr[0, i])][8] += warr[i]
    q = np.zeros((45, 2), np.uint32)
    q[:, 0] = np.arange(45)
    got = np.asarray(st.run_vec_lookup(m, jnp.asarray(q)))
    for i in range(45):
        np.testing.assert_array_equal(got[i], orc.get(i, np.zeros(9)), str(i))
    assert int(st.run_vec_distinct(m)) == \
        len([k for k in orc if orc[k][8] > 0])
    # compact collapses (key, ebyte) duplicates without changing counters
    c, ovf = st.run_vec_compact(m, 128)
    assert int(ovf) == 0
    got2 = np.asarray(st.run_vec_lookup(c, jnp.asarray(q)))
    np.testing.assert_array_equal(got2, got)
    assert int(st.run_vec_distinct(c)) == int(st.run_vec_distinct(m))
    # saturate clamps every counter at read
    got3 = np.asarray(st.run_vec_lookup(m, jnp.asarray(q), saturate=1))
    assert got3.max() <= 1
    # undersized compact reports overflow instead of silently dropping
    _, ovf2 = st.run_vec_compact(m, 16)
    assert int(ovf2) > 0


def test_multi_merge_flush_flagged_matches_insert():
    """The SENTINEL-UNSAFE flagged-merge flush (liveness flag as a
    leading merge key column) must agree with the stable-sort insert —
    including real keys that bit-equal the all-ones sentinel, the exact
    hazard that excludes these specs from the sentinel-safe path."""
    rng = np.random.default_rng(11)
    cap = 256
    s_merge = st.empty_multi_store(cap, 1)
    s_sort = st.empty_multi_store(cap, 1)
    oracle: dict[int, list] = {}
    pool = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0, 1, 2, 3, 7, 100],
                    np.uint32)
    for batch in range(4):
        n = 48
        keys = pool[rng.integers(0, len(pool), size=n)]
        vals = rng.integers(0, 1 << 31, size=n).astype(np.uint32)
        quals = rng.random(n).astype(np.float32)
        valid = rng.random(n) > 0.25
        args = (jnp.asarray(keys[:, None]),
                jnp.asarray(np.zeros(n, np.uint32)),
                jnp.asarray(vals), jnp.asarray(valid),
                jnp.asarray(quals))
        s_merge, ovf_m = st.multi_merge_flush_flagged(
            s_merge, *args[:4], val_q=args[4])
        s_sort, ovf_s = st.multi_insert(s_sort, *args[:4], val_q=args[4])
        assert int(ovf_m) == int(ovf_s) == 0
        for k, v, q, ok in zip(keys, vals, quals, valid):
            if ok:
                oracle.setdefault(int(k), []).append((int(v), float(q)))
    assert int(s_merge.size) == int(s_sort.size) == \
        sum(len(v) for v in oracle.values())
    q = jnp.asarray(pool[:, None])
    cnt_m = np.asarray(st.multi_count(s_merge, q))
    cnt_s = np.asarray(st.multi_count(s_sort, q))
    np.testing.assert_array_equal(cnt_m, cnt_s)
    lo, hi = st.multi_lookup_ranges(s_merge, q)
    _, lo_vals, qv, mask = st.multi_gather(s_merge, lo, hi,
                                           max_per_query=64)
    lo_vals, qv, mask = map(np.asarray, (lo_vals, qv, mask))
    for i, k in enumerate(pool.tolist()):
        got = sorted(zip(lo_vals[i][mask[i]].tolist(),
                         qv[i][mask[i]].tolist()))
        want = sorted(oracle.get(int(k), []))
        assert [g[0] for g in got] == [w[0] for w in want], k
        for (gv, gq), (wv, wq) in zip(got, want):
            assert gq == pytest.approx(wq)


def test_multi_merge_flush_flagged_no_quality_column():
    """Flagged flush with val_q=None must keep the all-zero quality
    column untouched (it never rides the merge)."""
    rng = np.random.default_rng(12)
    s = st.empty_multi_store(128, 1)
    for _ in range(3):
        keys = rng.integers(0, 10, 32).astype(np.uint32)
        vals = rng.integers(0, 1000, 32).astype(np.uint32)
        s, ovf = st.multi_merge_flush_flagged(
            s, jnp.asarray(keys[:, None]),
            jnp.asarray(np.zeros(32, np.uint32)), jnp.asarray(vals),
            jnp.ones(32, bool))
        assert int(ovf) == 0
    assert int(s.size) == 96
    assert np.asarray(s.val_q).sum() == 0.0

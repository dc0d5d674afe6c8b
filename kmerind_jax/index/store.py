"""Local k-mer stores: sorted flat arrays with static capacity.

Sorted-array replacement for the reference's local hash maps
(fsc::densehash_map / unordered_map / sorted vector backing stores,
/root/reference/src/containers/densehash_map.hpp:415-2015,
distributed_sorted_map.hpp:114-141).  A store is a pytree of fixed-capacity
arrays plus a live-size scalar, so every operation is a jit-compiled pure
function; the host wrapper regrows capacity (re-jit per power-of-two bucket)
when an insert overflows.

* `CountStore`  — unique keys + int32 counts (counting_densehash_map,
  reduction with plus, saturating variant via `saturate`).
* `MultiStore`  — sorted (key, 64-bit payload) pairs with duplicates
  (densehash_multimap — the position / position+quality index).

Queries are batched binary searches (`sortops.lower_bound`); insert is
merge-by-sort; erase is mask + stable compaction — all O(n log n) array work
with no data-dependent shapes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops import sortops

__all__ = [
    "CountStore",
    "MultiStore",
    "BimolStore",
    "RunCountStore",
    "empty_count_store",
    "empty_multi_store",
    "empty_bimol_store",
    "empty_run_count_store",
    "count_insert",
    "count_lookup",
    "count_erase",
    "multi_insert",
    "multi_merge_flush",
    "multi_lookup_ranges",
    "multi_count",
    "multi_erase",
    "bimol_insert",
    "run_from_sorted",
    "run_merge",
    "run_lookup",
    "run_erase",
    "run_totals",
    "run_distinct",
    "run_compact",
    "RunBimolStore",
    "empty_run_bimol_store",
    "run_bimol_from_sorted",
    "run_bimol_merge",
    "run_bimol_lookup",
    "run_bimol_erase",
    "run_bimol_compact",
    "RunVecStore",
    "empty_run_vec_store",
    "run_vec_from_sorted",
    "run_vec_merge",
    "run_vec_lookup",
    "run_vec_distinct",
    "run_vec_compact",
    "RunVecQStore",
    "empty_run_vecq_store",
    "run_vecq_from_sorted",
    "run_vecq_merge",
    "run_vecq_lookup",
    "run_vecq_distinct",
    "run_vecq_compact",
]

_SENTINEL = 0xFFFFFFFF

#: join-vs-binary-search routing: query batches with
#: m * JOIN_CROSSOVER_FACTOR >= capacity take the gather-free sort-merge
#: join; smaller batches take the prefix-bucketed binary search.  The
#: crossover has not been measured on the GPU (ROADMAP S5).  Module-level so
#: sweeps can force either path; read at TRACE time (changes need fresh
#: shapes or jax.clear_caches()).
JOIN_CROSSOVER_FACTOR = 8


@dataclasses.dataclass
class CountStore:
    keys: jax.Array    # uint32[cap, w] — sorted unique keys in [0, size)
    counts: jax.Array  # int32[cap]
    size: jax.Array    # int32 scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


jax.tree_util.register_dataclass(
    CountStore, data_fields=["keys", "counts", "size"], meta_fields=[])


@dataclasses.dataclass
class MultiStore:
    keys: jax.Array    # uint32[cap, w] — sorted, duplicates allowed
    val_hi: jax.Array  # uint32[cap]
    val_lo: jax.Array  # uint32[cap]
    val_q: jax.Array   # float32[cap] — windowed quality (0 when unused);
                       # the pair<IdType, float> payload of the
                       # position+quality index (kmer_index.hpp:406)
    size: jax.Array    # int32 scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


jax.tree_util.register_dataclass(
    MultiStore, data_fields=["keys", "val_hi", "val_lo", "val_q", "size"],
    meta_fields=[])


def empty_count_store(capacity: int, nwords: int) -> CountStore:
    return CountStore(
        keys=jnp.full((capacity, nwords), _SENTINEL, dtype=jnp.uint32),
        counts=jnp.zeros((capacity,), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


def empty_multi_store(capacity: int, nwords: int) -> MultiStore:
    return MultiStore(
        keys=jnp.full((capacity, nwords), _SENTINEL, dtype=jnp.uint32),
        val_hi=jnp.zeros((capacity,), jnp.uint32),
        val_lo=jnp.zeros((capacity,), jnp.uint32),
        val_q=jnp.zeros((capacity,), jnp.float32),
        size=jnp.zeros((), jnp.int32),
    )


# --------------------------------------------------------------- counting
@functools.partial(jax.jit,
                   static_argnames=("saturate", "sentinel_ok", "word_bits"))
def count_insert(store: CountStore, words: jax.Array, valid: jax.Array,
                 weights: jax.Array | None = None,
                 saturate: int | None = None, sentinel_ok: bool = False,
                 word_bits: tuple | None = None):
    """Merge a batch of keys into the count store.

    Each valid row contributes `weights[i]` (default 1) to its key's count —
    the (kmer, count) reduction insert (distributed_densehash_map.hpp:2669+,
    :1911 insert path).  Returns (new_store, overflow:int32) where overflow
    is the number of distinct keys that did not fit in capacity.
    """
    cap = store.capacity
    n = words.shape[0]
    if weights is None:
        weights = jnp.ones((n,), jnp.int32)
    live_store = jnp.arange(cap) < store.size
    all_words = jnp.concatenate([store.keys, words.astype(jnp.uint32)], axis=0)
    all_vals = jnp.concatenate([store.counts, weights.astype(jnp.int32)])
    all_valid = jnp.concatenate([live_store, valid])
    # run-reduction is order-insensitive: unstable sort is ~10% faster
    s_words, (s_vals,), s_valid = sortops.sort_rows(
        all_words, (all_vals,), all_valid, is_stable=False,
        sentinel_ok=sentinel_ok, word_bits=word_bits)
    uniq, red, n_unique = sortops.segment_reduce_sorted(
        s_words, s_valid, s_vals, reduce="sum")
    if saturate is not None:
        red = jnp.minimum(red, saturate)
    new = CountStore(
        keys=uniq[:cap],
        counts=red[:cap],
        size=jnp.minimum(n_unique, cap),
    )
    return new, jnp.maximum(n_unique - cap, 0)


@jax.jit
def count_lookup(store: CountStore, queries: jax.Array) -> jax.Array:
    """int32[m] count per query key (0 if absent) — LocalCount
    (distributed_densehash_map.hpp:1123-1199).

    Small batches use batched binary search (log2(cap) gather rounds);
    large batches (m >= cap/8) switch to the gather-free sort-merge join
    (`sortops.lookup_join`), which is faster once gather cost dominates.
    """
    m = queries.shape[0]
    if m * JOIN_CROSSOVER_FACTOR >= store.capacity:
        return sortops.lookup_join(store.keys, store.size, store.counts,
                                   queries)
    q = queries.astype(jnp.uint32)
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    cap, w = store.keys.shape
    # one fused [m, w+1] row gather: key words + count as a bitcast
    # column, instead of separate 1-D gathers of the same indices
    ext = jnp.concatenate(
        [store.keys, store.counts.astype(jnp.uint32)[:, None]], axis=1)
    g = ext[jnp.clip(idx, 0, cap - 1)]
    hit = (idx < jnp.asarray(store.size, jnp.int32)) & jnp.all(
        g[:, :w] == q, axis=-1)
    return jnp.where(hit, g[:, w].astype(jnp.int32), 0)


@jax.jit
def count_erase(store: CountStore, queries: jax.Array, qvalid: jax.Array):
    """Remove query keys; returns (new_store, n_erased int32)
    (erase path, distributed_densehash_map.hpp:1603+)."""
    q = queries.astype(jnp.uint32)
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    hit = sortops.rows_equal_at(store.keys, idx, q, store.size) & qvalid
    cap = store.capacity
    kill = jnp.zeros((cap + 1,), bool).at[jnp.where(hit, idx, cap)].set(True)[:cap]
    keep = (jnp.arange(cap) < store.size) & ~kill
    s_words, (s_vals,), s_valid = sortops.sort_rows(
        store.keys, (store.counts,), keep)
    new_size = jnp.sum(keep.astype(jnp.int32))
    new = CountStore(
        keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(_SENTINEL)),
        counts=jnp.where(s_valid, s_vals, 0),
        size=new_size,
    )
    return new, store.size - new_size


# --------------------------------------------------------------- multimap
@jax.jit
def multi_insert(store: MultiStore, words, val_hi, val_lo, valid,
                 val_q: jax.Array | None = None):
    """Append (key, value) pairs, keeping pairs sorted by key (stable on
    insertion order within a batch) — densehash_multimap insert.
    Returns (new_store, overflow)."""
    cap = store.capacity
    if val_q is None:
        val_q = jnp.zeros(words.shape[0], jnp.float32)
    live_store = jnp.arange(cap) < store.size
    all_words = jnp.concatenate([store.keys, words.astype(jnp.uint32)], axis=0)
    all_hi = jnp.concatenate([store.val_hi, val_hi.astype(jnp.uint32)])
    all_lo = jnp.concatenate([store.val_lo, val_lo.astype(jnp.uint32)])
    all_q = jnp.concatenate([store.val_q, val_q.astype(jnp.float32)])
    all_valid = jnp.concatenate([live_store, valid])
    s_words, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
        all_words, (all_hi, all_lo, jax.lax.bitcast_convert_type(all_q, jnp.uint32)),
        all_valid)
    total = jnp.sum(all_valid.astype(jnp.int32))
    new = MultiStore(
        keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(_SENTINEL))[:cap],
        val_hi=s_hi[:cap],
        val_lo=s_lo[:cap],
        val_q=jax.lax.bitcast_convert_type(s_q[:cap], jnp.float32),
        size=jnp.minimum(total, cap),
    )
    return new, jnp.maximum(total - cap, 0)


@jax.jit
def multi_merge_flush(store: MultiStore, words, val_hi, val_lo, valid,
                      val_q: jax.Array | None = None):
    """Merge-based multimap flush for SENTINEL-SAFE specs: sort ONLY the
    incoming batch (n rows), then bitonic-MERGE it with the already-sorted
    store — log2 stages instead of `multi_insert`'s monolithic stable sort
    over cap + n rows.  Same lazy-sorted-map discipline as the
    count family's RunCountStore (distributed_sorted_map.hpp:341,940).

    REQUIRES that no real key bit-equals the all-ones sentinel
    (KmerSpec.sentinel_safe) — invalid/padding rows ride the merge as
    sentinel rows and must tail-sort.  Callers gate on the spec and fall
    back to `multi_insert` otherwise.  Unlike `multi_insert` this is NOT
    stable across flushes (densehash_multimap makes no order promise).

    Returns (new_store, overflow).

    val_q=None means the map carries NO quality payload (PositionIndex
    without with_quality): the all-zero val_q column is an invariant of
    such stores, so it is NOT sorted or merged — one fewer operand in
    the batch sort and in every merge pass."""
    cap, w = store.keys.shape
    if val_q is None:
        b_cols, (b_hi, b_lo), _ = sortops.sort_rows(
            words.astype(jnp.uint32),
            (val_hi.astype(jnp.uint32), val_lo.astype(jnp.uint32)),
            valid, is_stable=False, sentinel_ok=True, as_cols=True)
        m_cols, (m_hi, m_lo) = sortops.merge_sorted_runs_cols(
            store.keys.T, (store.val_hi, store.val_lo),
            b_cols, (b_hi, b_lo))
        m_qb = None
    else:
        qbits = jax.lax.bitcast_convert_type(
            val_q.astype(jnp.float32), jnp.uint32)
        b_cols, (b_hi, b_lo, b_qb), _ = sortops.sort_rows(
            words.astype(jnp.uint32),
            (val_hi.astype(jnp.uint32), val_lo.astype(jnp.uint32),
             qbits),
            valid, is_stable=False, sentinel_ok=True, as_cols=True)
        m_cols, (m_hi, m_lo, m_qb) = sortops.merge_sorted_runs_cols(
            store.keys.T,
            (store.val_hi, store.val_lo,
             jax.lax.bitcast_convert_type(store.val_q, jnp.uint32)),
            b_cols, (b_hi, b_lo, b_qb))
    total = store.size + jnp.sum(valid.astype(jnp.int32))
    new = MultiStore(
        keys=m_cols[:, :cap].T,
        val_hi=m_hi[:cap],
        val_lo=m_lo[:cap],
        val_q=(store.val_q if m_qb is None
               else jax.lax.bitcast_convert_type(m_qb[:cap],
                                                 jnp.float32)),
        size=jnp.minimum(total, cap),
    )
    return new, jnp.maximum(total - cap, 0)


@jax.jit
def multi_merge_flush_flagged(store: MultiStore, words, val_hi, val_lo,
                              valid, val_q: jax.Array | None = None):
    """`multi_merge_flush` for SENTINEL-UNSAFE specs (k ≡ 0 mod 16 DNA:
    k=16/32/64 — a real key can bit-equal the all-ones sentinel, so
    dead rows cannot be marked in the key bits).  A liveness FLAG rides
    the merge as a leading key column instead: the comparator sees
    (flag, word0, …) so dead rows still tail-sort, at the cost of one
    extra merge operand vs the sentinel-safe path — still a merge, not
    `multi_insert`'s monolithic stable re-sort of cap + n rows.  Closes
    the silent 3.4x flush cliff round 4 left on full-word specs; the
    reference handles exactly this corner with split tables
    (src/index/kmer_hash.hpp:333-480).

    Returns (new_store, overflow)."""
    cap, w = store.keys.shape
    # batch: flag-mode sort (leading invalid-flag key), then the flag
    # column (0 live / 1 dead) joins the key columns for the merge
    if val_q is None:
        b_cols, (b_hi, b_lo), b_valid = sortops.sort_rows(
            words.astype(jnp.uint32),
            (val_hi.astype(jnp.uint32), val_lo.astype(jnp.uint32)),
            valid, is_stable=False, sentinel_ok=False, as_cols=True)
        b_pay = (b_hi, b_lo)
        s_pay = (store.val_hi, store.val_lo)
    else:
        qbits = jax.lax.bitcast_convert_type(
            val_q.astype(jnp.float32), jnp.uint32)
        b_cols, (b_hi, b_lo, b_qb), b_valid = sortops.sort_rows(
            words.astype(jnp.uint32),
            (val_hi.astype(jnp.uint32), val_lo.astype(jnp.uint32),
             qbits),
            valid, is_stable=False, sentinel_ok=False, as_cols=True)
        b_pay = (b_hi, b_lo, b_qb)
        s_pay = (store.val_hi, store.val_lo,
                 jax.lax.bitcast_convert_type(store.val_q, jnp.uint32))
    b_flag = (~b_valid).astype(jnp.uint32)
    s_flag = (jnp.arange(cap) >= store.size).astype(jnp.uint32)
    a_keys = jnp.concatenate([s_flag[None, :], store.keys.T], axis=0)
    b_keys = jnp.concatenate([b_flag[None, :], b_cols], axis=0)
    m_cols, m_pay = sortops.merge_sorted_runs_cols(a_keys, s_pay,
                                                   b_keys, b_pay)
    total = store.size + jnp.sum(valid.astype(jnp.int32))
    live_out = jnp.arange(cap) < jnp.minimum(total, cap)
    new = MultiStore(
        keys=jnp.where(live_out[:, None], m_cols[1:, :cap].T,
                       jnp.uint32(_SENTINEL)),
        val_hi=m_pay[0][:cap],
        val_lo=m_pay[1][:cap],
        val_q=(store.val_q if val_q is None
               else jax.lax.bitcast_convert_type(m_pay[2][:cap],
                                                 jnp.float32)),
        size=jnp.minimum(total, cap),
    )
    return new, jnp.maximum(total - cap, 0)


@jax.jit
def multi_lookup_ranges(store: MultiStore, queries):
    """(lo, hi) int32[m]: contiguous range of pairs per query key.

    ONE binary search: lower_bound lands on the run's first row; the run
    ROW-LENGTH (broadcast per row by two elementwise scans) gives hi =
    lo + len — replacing the upper-bound search's log2(cap) gather rounds
    (the dominant cost at large query batches) with ~2 passes + one
    gather round.  Large batches (m*8 >= cap) switch to the gather-free
    sort-merge join (`sortops.lookup_join_ranges`)."""
    cap, w = store.keys.shape
    q = queries.astype(jnp.uint32)
    if queries.shape[0] * JOIN_CROSSOVER_FACTOR >= cap:
        return sortops.lookup_join_ranges(store.keys, store.size, q)
    size = jnp.asarray(store.size, jnp.int32)
    lo = sortops.lower_bound_bucketed(store.keys, size, q)
    idx = jnp.arange(cap, dtype=jnp.int32)
    prev = jnp.roll(store.keys, 1, axis=0)
    neq_prev = jnp.any(store.keys != prev, axis=1).at[0].set(True)
    start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    nxt = jnp.roll(store.keys, -1, axis=0)
    neq_next = jnp.any(store.keys != nxt, axis=1).at[cap - 1].set(True)
    end = jax.lax.cummin(
        jnp.where(neq_next, idx + 1, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    runlen = end - start
    lofc = jnp.clip(lo, 0, cap - 1)
    # one fused [m, w+1] row gather: key words + run length as an extra
    # bitcast column, instead of a separate 1-D runlen gather
    ext = jnp.concatenate(
        [store.keys, runlen.astype(jnp.uint32)[:, None]], axis=1)
    g = ext[lofc]
    hit = (lo < size) & jnp.all(g[:, :w] == q, axis=-1)
    # clip to size: a live run whose key bit-equals the sentinel padding
    # would otherwise extend into the dead tail
    hi = jnp.where(hit,
                   jnp.minimum(lo + g[:, w].astype(jnp.int32), size), lo)
    return lo, hi


@functools.partial(jax.jit, static_argnames=("tbits",))
def multi_query_aux(store: MultiStore, tbits: int = 16):
    """Per-store-version query metadata for the multimap (the round-5
    query-aux cache, `run_query_aux`'s twin): the per-call run-length
    scans, the [cap, w+1] fused-gather operand, and the prefix-bucket
    table are store-version-invariant.  Returns (ext uint32[cap, w+1]:
    key rows + run-length column, bstart int32[2^16 + 1])."""
    cap, w = store.keys.shape
    idx = jnp.arange(cap, dtype=jnp.int32)
    prev = jnp.roll(store.keys, 1, axis=0)
    neq_prev = jnp.any(store.keys != prev, axis=1).at[0].set(True)
    start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    nxt = jnp.roll(store.keys, -1, axis=0)
    neq_next = jnp.any(store.keys != nxt, axis=1).at[cap - 1].set(True)
    end = jax.lax.cummin(
        jnp.where(neq_next, idx + 1, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    runlen = end - start
    ext = jnp.concatenate(
        [store.keys, runlen.astype(jnp.uint32)[:, None]], axis=1)
    bstart = sortops._prefix_starts(store.keys[:, 0], tbits)
    return ext, bstart


@jax.jit
def multi_lookup_ranges_aux(store: MultiStore, ext: jax.Array,
                            bstart: jax.Array, queries):
    """`multi_lookup_ranges`'s bucketed branch against CACHED metadata
    (no per-call scans / table build / concat).  The refinement rounds
    gather from store.keys (contiguous [cap, w]); only the final fused
    bound gather reads the [cap, w+1] ext (a minor-dim prefix slice of
    ext would materialize 200 MB per call on the row-major layout)."""
    cap, w = store.keys.shape
    q = queries.astype(jnp.uint32)
    size_i = jnp.asarray(store.size, jnp.int32)
    tbits = (bstart.shape[0] - 1).bit_length() - 1
    b = (q[:, 0] >> jnp.uint32(32 - tbits)).astype(jnp.int32)
    t2 = jnp.stack([bstart[:-1], bstart[1:]], axis=0)
    g0 = t2[:, b]
    lo0 = jnp.minimum(g0[0], size_i)
    hi0 = jnp.minimum(g0[1], size_i)
    lo = sortops._bsearch_rounds(store.keys, q, lo0, hi0, "left",
                                 cols=False)
    lofc = jnp.clip(lo, 0, cap - 1)
    g = ext[lofc]
    hit = (lo < size_i) & jnp.all(g[:, :w] == q, axis=-1)
    hi = jnp.where(hit,
                   jnp.minimum(lo + g[:, w].astype(jnp.int32), size_i),
                   lo)
    return lo, hi


@jax.jit
def multi_count(store: MultiStore, queries) -> jax.Array:
    lo, hi = multi_lookup_ranges(store, queries)
    return hi - lo


@functools.partial(jax.jit, static_argnames=("max_per_query",))
def multi_gather(store: MultiStore, lo, hi, max_per_query: int):
    """Gather payloads for ranges: (hi_vals, lo_vals, q_vals, mask) each
    [m, max_per_query]; entries beyond the range are masked."""
    m = lo.shape[0]
    offs = jnp.arange(max_per_query, dtype=jnp.int32)[None, :]
    idx = lo[:, None] + offs
    mask = idx < hi[:, None]
    idx_c = jnp.clip(idx, 0, store.capacity - 1)
    # ONE fused row gather of all three payload columns (instead of
    # separate per-column gathers of the same indices).
    # val_q is float32: BITCAST to uint32 for the stack — dtype
    # promotion would silently round the 32-bit ids through float32
    ext = jnp.stack(
        [store.val_hi, store.val_lo,
         jax.lax.bitcast_convert_type(store.val_q, jnp.uint32)], axis=1)
    g = ext[idx_c]
    return (g[..., 0], g[..., 1],
            jax.lax.bitcast_convert_type(g[..., 2], store.val_q.dtype),
            mask)


@jax.jit
def multi_erase(store: MultiStore, queries, qvalid):
    """Remove ALL pairs whose key matches a query key; returns
    (new_store, n_erased)."""
    q = queries.astype(jnp.uint32)
    lo, hi = multi_lookup_ranges(store, q)
    lo = jnp.where(qvalid, lo, 0)
    hi = jnp.where(qvalid, hi, 0)
    cap = store.capacity
    # mark [lo, hi) ranges via +1/-1 difference scatter + prefix sum
    diff = jnp.zeros((cap + 1,), jnp.int32)
    diff = diff.at[lo].add(jnp.where(qvalid, 1, 0))
    diff = diff.at[hi].add(jnp.where(qvalid, -1, 0))
    covered = jnp.cumsum(diff[:cap]) > 0
    keep = (jnp.arange(cap) < store.size) & ~covered
    s_words, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
        store.keys,
        (store.val_hi, store.val_lo,
         jax.lax.bitcast_convert_type(store.val_q, jnp.uint32)),
        keep)
    new_size = jnp.sum(keep.astype(jnp.int32))
    new = MultiStore(
        keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(_SENTINEL)),
        val_hi=s_hi,
        val_lo=s_lo,
        val_q=jax.lax.bitcast_convert_type(s_q, jnp.float32),
        size=new_size,
    )
    return new, store.size - new_size


# ----------------------------------------------------- vector reduction map
@dataclasses.dataclass
class VecStore:
    """Unique keys + int32 vector payloads reduced by sum — the generic
    reduction map (reduction_densehash_map, distributed_densehash_map.hpp
    :2429+) used for de Bruijn node payloads (edge_counts, 9 counters per
    node: out A/C/G/T, in A/C/G/T, self)."""

    keys: jax.Array  # uint32[cap, w]
    vals: jax.Array  # int32[cap, d]
    size: jax.Array  # int32 scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


jax.tree_util.register_dataclass(
    VecStore, data_fields=["keys", "vals", "size"], meta_fields=[])


def empty_vec_store(capacity: int, nwords: int, dim: int) -> VecStore:
    return VecStore(
        keys=jnp.full((capacity, nwords), _SENTINEL, dtype=jnp.uint32),
        vals=jnp.zeros((capacity, dim), jnp.int32),
        size=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("saturate",))
def vec_insert(store: VecStore, words: jax.Array, vecs: jax.Array,
               valid: jax.Array, saturate: int | None = None):
    """Merge (key, int32[d] vector) tuples, summing vectors per key
    (the Reduc functor fold of reduction map inserts).
    Returns (new_store, overflow)."""
    cap = store.capacity
    live_store = jnp.arange(cap) < store.size
    all_words = jnp.concatenate([store.keys, words.astype(jnp.uint32)], axis=0)
    all_vals = jnp.concatenate([store.vals, vecs.astype(jnp.int32)], axis=0)
    all_valid = jnp.concatenate([live_store, valid])
    d = all_vals.shape[1]
    s_words, s_cols, s_valid = sortops.sort_rows(
        all_words, tuple(all_vals[:, j] for j in range(d)), all_valid,
        is_stable=False)
    s_vals = jnp.stack(s_cols, axis=1)
    uniq, red, n_unique = sortops.segment_reduce_sorted(
        s_words, s_valid, s_vals, reduce="sum")
    if saturate is not None:
        red = jnp.minimum(red, saturate)
    new = VecStore(
        keys=uniq[:cap],
        vals=red[:cap],
        size=jnp.minimum(n_unique, cap),
    )
    return new, jnp.maximum(n_unique - cap, 0)


@jax.jit
def vec_lookup(store: VecStore, queries: jax.Array):
    """(vals int32[m, d], found bool[m]) per query key.  Large batches
    (m*8 >= cap) use the gather-free sort-merge join."""
    q = queries.astype(jnp.uint32)
    if queries.shape[0] * JOIN_CROSSOVER_FACTOR >= store.capacity:
        d = store.vals.shape[1]
        cols, found = sortops.lookup_join_vals(
            store.keys, store.size,
            tuple(store.vals[:, j] for j in range(d)), q)
        return jnp.stack(cols, axis=1), found
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    cap, w = store.keys.shape
    d = store.vals.shape[1]
    # fused [m, w+d] row gather: key words + the counter vector
    ext = jnp.concatenate(
        [store.keys, store.vals.astype(jnp.uint32)], axis=1)
    g = ext[jnp.clip(idx, 0, cap - 1)]
    hit = (idx < jnp.asarray(store.size, jnp.int32)) & jnp.all(
        g[:, :w] == q, axis=-1)
    vals = g[:, w:].astype(jnp.int32)
    return jnp.where(hit[:, None], vals, 0), hit


# ------------------------------------------------- bimolecule counting map
@dataclasses.dataclass
class BimolStore:
    """Counting store for the Bimolecule preset (kmer_index.hpp:436-562):
    keys are hashed/compared in CANONICAL form, but the map remembers the
    INPUT-strand orientation of each key's first occurrence so dumps and
    finds can report the stored (input-strand) k-mer, like the reference's
    hash table keeping the first-inserted key.  `rep_hi`/`rep_lo` hold the
    64-bit position id of the earliest (file-order) occurrence and
    `rep_strand` whether that occurrence was reverse-complemented by
    canonicalization."""

    keys: jax.Array        # uint32[cap, w] — canonical, sorted, unique
    counts: jax.Array      # int32[cap]
    rep_hi: jax.Array      # uint32[cap]
    rep_lo: jax.Array      # uint32[cap]
    rep_strand: jax.Array  # uint32[cap] — 0 forward, 1 reverse-complement
    size: jax.Array        # int32 scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


jax.tree_util.register_dataclass(
    BimolStore,
    data_fields=["keys", "counts", "rep_hi", "rep_lo", "rep_strand", "size"],
    meta_fields=[])


def empty_bimol_store(capacity: int, nwords: int) -> BimolStore:
    return BimolStore(
        keys=jnp.full((capacity, nwords), _SENTINEL, dtype=jnp.uint32),
        counts=jnp.zeros((capacity,), jnp.int32),
        rep_hi=jnp.full((capacity,), _SENTINEL, dtype=jnp.uint32),
        rep_lo=jnp.full((capacity,), _SENTINEL, dtype=jnp.uint32),
        rep_strand=jnp.zeros((capacity,), jnp.uint32),
        size=jnp.zeros((), jnp.int32),
    )


@jax.jit
def bimol_erase(store: BimolStore, queries: jax.Array, qvalid: jax.Array):
    """Remove query keys (canonical form); returns (new_store, n_erased) —
    the Bimolecule-preserving analog of `count_erase`."""
    q = queries.astype(jnp.uint32)
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    hit = sortops.rows_equal_at(store.keys, idx, q, store.size) & qvalid
    cap = store.capacity
    kill = jnp.zeros((cap + 1,), bool).at[
        jnp.where(hit, idx, cap)].set(True)[:cap]
    keep = (jnp.arange(cap) < store.size) & ~kill
    s_words, (s_c, s_hi, s_lo, s_s), s_valid = sortops.sort_rows(
        store.keys,
        (store.counts, store.rep_hi, store.rep_lo, store.rep_strand), keep)
    new_size = jnp.sum(keep.astype(jnp.int32))
    new = BimolStore(
        keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(_SENTINEL)),
        counts=jnp.where(s_valid, s_c, 0),
        rep_hi=jnp.where(s_valid, s_hi, jnp.uint32(_SENTINEL)),
        rep_lo=jnp.where(s_valid, s_lo, jnp.uint32(_SENTINEL)),
        rep_strand=jnp.where(s_valid, s_s, 0),
        size=new_size,
    )
    return new, store.size - new_size


@functools.partial(jax.jit, static_argnames=("saturate",))
def bimol_insert(store: BimolStore, words, weights, rep_hi, rep_lo,
                 rep_strand, valid, saturate: int | None = None):
    """Merge (canonical key, weight, first-occurrence id, strand) tuples.

    Counts sum per key; the representative (id, strand) is the MINIMUM id —
    the earliest occurrence in file order, matching the reference's
    keep-first-inserted-key hash semantics for a single sequential rank.
    Returns (new_store, overflow).
    """
    cap = store.capacity
    live_store = jnp.arange(cap) < store.size
    all_words = jnp.concatenate([store.keys, words.astype(jnp.uint32)], axis=0)
    all_w = jnp.concatenate([store.counts, weights.astype(jnp.int32)])
    all_hi = jnp.concatenate([store.rep_hi, rep_hi.astype(jnp.uint32)])
    all_lo = jnp.concatenate([store.rep_lo, rep_lo.astype(jnp.uint32)])
    all_s = jnp.concatenate([store.rep_strand, rep_strand.astype(jnp.uint32)])
    all_valid = jnp.concatenate([live_store, valid])
    n, w = all_words.shape
    # sort with (key words, rep id) ALL as sort keys: within a run of equal
    # key words the min-id row sorts FIRST, so the run head carries the
    # earliest occurrence — segmented min for free (invalid rows flagged
    # to the end with a leading flag column; their id columns are inert)
    flag = (~all_valid).astype(jnp.uint32)
    cols = tuple(all_words[:, j] for j in range(w))
    out = jax.lax.sort(
        (flag,) + cols + (all_hi, all_lo, all_s, all_w),
        num_keys=1 + w + 2, is_stable=False)
    s_valid = out[0] == 0
    s_words = jnp.stack(out[1:1 + w], axis=1)
    s_hi, s_lo, s_s, s_w = out[1 + w:]
    # per-row run weight totals, GATHER-FREE (broadcast scans instead of
    # two random gathers of the prefix array)
    totals = sortops.run_weight_totals(s_words, s_valid, s_w)
    # reps + totals: first-of-run payloads via the compaction sort
    uniq, (hi_f, lo_f, st_f, counts), _, n_unique, _ = \
        sortops.compact_runs(s_words, s_valid,
                             payloads=(s_hi, s_lo, s_s, totals))
    counts = counts.astype(jnp.int32)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    j = jnp.arange(n, dtype=jnp.int32)
    live = j < n_unique
    new = BimolStore(
        keys=jnp.where(live[:, None], uniq, jnp.uint32(_SENTINEL))[:cap],
        counts=jnp.where(live, counts, 0)[:cap],
        rep_hi=jnp.where(live, hi_f, jnp.uint32(_SENTINEL))[:cap],
        rep_lo=jnp.where(live, lo_f, jnp.uint32(_SENTINEL))[:cap],
        rep_strand=jnp.where(live, st_f, 0)[:cap],
        size=jnp.minimum(n_unique, cap),
    )
    return new, jnp.maximum(n_unique - cap, 0)

# ------------------------------------------------------ run-layout count map
@dataclasses.dataclass
class RunCountStore:
    """Counting store in RUN layout: keys sorted over ALL rows with
    duplicates allowed, per-row weights, and an exclusive prefix sum.

    The count of key q is the total weight of its key run — answered as
    ``csum[upper_bound(q)] - csum[lower_bound(q)]``.  This layout makes the
    deferred-merge flush a bitonic MERGE of already-sorted runs
    (log2(n) elementwise stages) instead of the compacted layout's full
    re-sort + stable compaction sort.  It is the sorted-array analog of the
    reference's lazy sorted map (insert appends, first query sorts,
    distributed_sorted_map.hpp:341,940) with the counting-map reduction
    (distributed_densehash_map.hpp:2669+) virtualized into the prefix sum.

    Invariants:
      * ``keys`` is lexicographically nondecreasing over ALL cap rows;
        padding rows hold the all-ones sentinel (a real k-mer colliding
        with the sentinel pattern is harmless: padding carries weight 0, so
        it never changes any count).
      * ``weights[i] >= 0``; erased keys keep their rows with weight 0.
      * ``csum[i] == sum(weights[:i])`` (int32[cap + 1]).

    Dead rows (weight 0 / duplicates) are reclaimed by `run_compact`,
    invoked opportunistically by the host wrapper when the distinct-key
    count falls well below capacity.

    Keys live COLUMN-major (uint32[w, cap], word 0 most significant):
    every merge/sort/scan operand is then a long contiguous vector —
    the interleaved [cap, w] layout costs a strided de-interleave +
    restack around each bitonic merge.
    """

    keys: jax.Array     # uint32[w, cap] — per-word COLUMNS
    weights: jax.Array  # int32[cap]
    csum: jax.Array     # int32[cap + 1]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


jax.tree_util.register_dataclass(
    RunCountStore, data_fields=["keys", "weights", "csum"], meta_fields=[])


def empty_run_count_store(capacity: int, nwords: int) -> RunCountStore:
    return RunCountStore(
        keys=jnp.full((nwords, capacity), _SENTINEL, dtype=jnp.uint32),
        weights=jnp.zeros((capacity,), jnp.int32),
        csum=jnp.zeros((capacity + 1,), jnp.int32),
    )


def _cumsum_i32(x: jax.Array) -> jax.Array:
    """Inclusive int32 prefix sum (one streaming scan over x)."""
    return jnp.cumsum(x.astype(jnp.int32))


def run_from_sorted(kcols: jax.Array, weights: jax.Array) -> RunCountStore:
    """Adopt an already-sorted (sentinel-padded) run as a store.

    kcols: uint32[w, n] column-major key words."""
    return RunCountStore(
        keys=kcols,
        weights=weights,
        csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                              _cumsum_i32(weights)]),
    )


@jax.jit
def run_merge(store: RunCountStore, kcols: jax.Array,
              weights: jax.Array) -> RunCountStore:
    """Merge a sorted weighted run into the store (bitonic merge +
    prefix-sum rebuild).  The output capacity is
    next_pow2(cap + len(words)) — run stores grow by construction and
    never overflow; `run_compact` reclaims dead rows."""
    keys, (w,) = sortops.merge_sorted_runs_cols(
        store.keys, (store.weights,), kcols, (weights.astype(jnp.int32),))
    return run_from_sorted(keys, w)


def run_from_sorted_unit(kcols: jax.Array,
                         weights: jax.Array) -> RunCountStore:
    """Adopt an already-sorted UNIT run (weight 1 per live row, sentinel
    tail) with closed-form csum — no prefix-sum dispatch: live rows sort
    to the front, so csum[i] = min(i, n_live)."""
    n = kcols.shape[1]
    live = ~jnp.all(kcols == jnp.uint32(_SENTINEL), axis=0)
    n_live = jnp.sum(weights.astype(jnp.int32))
    return RunCountStore(
        keys=kcols,
        weights=live.astype(jnp.int32),
        csum=jnp.minimum(jnp.arange(n + 1, dtype=jnp.int32), n_live),
    )


@jax.jit
def run_merge_unit(a: RunCountStore, b: RunCountStore) -> RunCountStore:
    """Merge two UNIT runs: every live row carries weight 1 and the
    sentinel keys mark exactly the dead tail — the shape
    `make_run_ingest_step` emits for every file-ingested chunk.

    Requires a sentinel-safe spec (kmer.py: nwords*32 > nbits, so no
    real k-mer can equal the all-ones sentinel).  Under that invariant
    the weight column is redundant: live rows are precisely the
    non-sentinel keys and sort to the front, so the merge network runs
    KEYS-ONLY (w operands instead of w+1 — one fewer column in every
    compare-exchange HBM pass) and weights/csum are reconstructed in
    closed form, with no prefix-sum dispatch at all:
    weights = (key != sentinel), csum[i] = min(i, total live).

    The reference times insert end-to-end per flavor
    (test/benchmark/BenchmarkKmerIndex.cpp:480-593); this path is the
    analog of its counting insert for the common file-build case."""
    keys, _ = sortops.merge_sorted_runs_cols(a.keys, (), b.keys, ())
    n = keys.shape[1]
    live = ~jnp.all(keys == jnp.uint32(_SENTINEL), axis=0)
    n_live = a.csum[-1] + b.csum[-1]
    return RunCountStore(
        keys=keys,
        weights=live.astype(jnp.int32),
        csum=jnp.minimum(jnp.arange(n + 1, dtype=jnp.int32), n_live),
    )


def _adjacent_neq(kcols: jax.Array):
    """(neq_prev bool[cap], neq_next bool[cap]) between adjacent rows of
    column-major keys [w, cap]."""
    cap = kcols.shape[1]
    prev = jnp.roll(kcols, 1, axis=1)
    neq_prev = jnp.any(kcols != prev, axis=0).at[0].set(True)
    nxt = jnp.roll(kcols, -1, axis=1)
    neq_next = jnp.any(kcols != nxt, axis=0).at[cap - 1].set(True)
    return neq_prev, neq_next


@jax.jit
def run_totals(store: RunCountStore):
    """Per-row run metadata, gather-free (two scans):

    Returns (is_head bool[cap], is_last bool[cap], total int32[cap]) where
    `total` is the run's weight sum broadcast to every row of the run.
    """
    cap = store.capacity
    neq_prev, neq_next = _adjacent_neq(store.keys)
    csum_excl = store.csum[:cap]
    csum_incl = store.csum[1:]
    # csum at each row's run start: csum_excl is nondecreasing (weights
    # >= 0), so a cummax over head-row values propagates within the run
    start = jax.lax.cummax(
        jnp.where(neq_prev, csum_excl, jnp.int32(-2147483648)), axis=0)
    # csum after each row's run end: reverse cummin over last-row values
    end = jax.lax.cummin(
        jnp.where(neq_next, csum_incl,
                  jnp.int32(2147483647))[::-1], axis=0)[::-1]
    return neq_prev, neq_next, end - start


@jax.jit
def run_distinct(store: RunCountStore) -> jax.Array:
    """int32 scalar: number of distinct keys with positive total weight
    (the map's size; sentinel-padding runs have weight 0 and never
    count)."""
    is_head, _, total = run_totals(store)
    return jnp.sum((is_head & (total > 0)).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("tbits",))
def run_query_aux(store: RunCountStore, tbits: int = 16):
    """Per-store-version query metadata (the round-5 query-aux cache):
    everything `run_lookup`'s bsearch branch recomputed PER CALL is
    store-version-invariant — the run-total scans, the [w+1, cap] fused
    gather operand, and the 2^16-entry prefix-bucket table are O(cap)
    work per call, flat in m, which would dominate the search itself.
    Built once per run version, invalidated by any run mutation.

    Returns (ext uint32[w + 1, cap]: key columns + run-total row,
    bstart int32[2^tbits + 1]: prefix-bucket starts).  The reader,
    `sortops.lower_bound_cols_prebuilt`, decodes bucket ids with a
    fixed tbits of 16, so a table built with any other tbits is read
    with the wrong bucket ids: keep the default."""
    _, _, total = run_totals(store)
    ext = jnp.concatenate(
        [store.keys, total.astype(jnp.uint32)[None, :]], axis=0)
    bstart = sortops._prefix_starts(store.keys[0], tbits)
    return ext, bstart


@functools.partial(jax.jit, static_argnames=("saturate",))
def run_lookup_aux(ext: jax.Array, bstart: jax.Array, queries: jax.Array,
                   saturate: int | None = None) -> jax.Array:
    """`run_lookup`'s bucketed branch against CACHED metadata: one
    seeded bsearch refinement + one fused [w+1, m] gather — no per-call
    scans, no table build, no concat."""
    w = ext.shape[0] - 1
    cap = ext.shape[1]
    q = queries.astype(jnp.uint32)
    lo = sortops.lower_bound_cols_prebuilt(ext, w, bstart, q)
    lofc = jnp.clip(lo, 0, cap - 1)
    g = ext[:, lofc]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == q[:, j]
    counts = jnp.where(hit, g[w].astype(jnp.int32), 0)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    return counts


@functools.partial(jax.jit, static_argnames=("saturate",))
def run_lookup(store: RunCountStore, queries: jax.Array,
               saturate: int | None = None) -> jax.Array:
    """int32[m] count per query key (0 if absent).

    Small batches: two batched binary searches + csum difference.  Large
    batches (m*8 >= cap): the gather-free sort-merge join
    (`sortops.lookup_join_runs`).  Saturating maps clamp at read time —
    observably identical to the reference's clamp-at-insert
    (saturating_counting_densehash_map, distributed_densehash_map.hpp:2947)
    because counts only grow between erases."""
    m = queries.shape[0]
    cap = store.capacity
    w = store.keys.shape[0]
    q = queries.astype(jnp.uint32)
    if m * JOIN_CROSSOVER_FACTOR >= cap:
        counts = sortops.lookup_join_runs_cols(store.keys, store.csum, q)
    else:
        # ONE binary search, not two: lower_bound lands on the first row
        # of the query's key run, where the per-row RUN TOTAL (weight sum
        # broadcast over the run by run_totals' elementwise scans) already
        # holds count(q).  The second (upper-bound) search — another
        # log2(cap) gather rounds, the dominant cost at 1M queries — is
        # replaced by ~2 elementwise passes + one gather round.  The
        # whole key array (sentinel tail included) is sorted: search over
        # all cap rows.  `size` must be a traced scalar so shard_map
        # varying-axis metadata propagates into the bsearch carry.
        size = store.csum[0] * 0 + cap
        lo = sortops.lower_bound_cols_bucketed(store.keys, size, q)
        _, _, total = run_totals(store)
        lofc = jnp.clip(lo, 0, cap - 1)
        # one fused [w+1, m] gather: key words + run total as an extra
        # bitcast row, instead of separate 1-D gathers
        ext = jnp.concatenate(
            [store.keys, total.astype(jnp.uint32)[None, :]], axis=0)
        g = ext[:, lofc]
        hit = lo < cap
        for j in range(w):
            hit &= g[j] == q[:, j]
        counts = jnp.where(hit, g[w].astype(jnp.int32), 0)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    return counts


def _run_query_bounds(store: RunCountStore, q: jax.Array):
    """(lo, hi, hit, total) per query over the run store with ONE
    bucketed lower_bound: hi comes from the run's row-length and `total`
    from its weight sum (both broadcast per row by elementwise scans and
    fetched in the same fused gather as the hit check)."""
    cap = store.capacity
    w = store.keys.shape[0]
    size = store.csum[0] * 0 + cap
    lo = sortops.lower_bound_cols_bucketed(store.keys, size, q)
    neq_prev, neq_next = _adjacent_neq(store.keys)
    idx = jnp.arange(cap, dtype=jnp.int32)
    start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, idx + 1, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    runlen = end - start
    _, _, total = run_totals(store)
    # one fused [w+2, m] gather: key words + run length + run total
    ext = jnp.concatenate(
        [store.keys, runlen.astype(jnp.uint32)[None, :],
         total.astype(jnp.uint32)[None, :]], axis=0)
    g = ext[:, jnp.clip(lo, 0, cap - 1)]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == q[:, j]
    hi = jnp.where(hit, jnp.minimum(lo + g[w].astype(jnp.int32), cap), lo)
    return lo, hi, hit, jnp.where(hit, g[w + 1].astype(jnp.int32), 0)


@jax.jit
def run_erase_cover(store: RunCountStore, queries: jax.Array,
                    qvalid: jax.Array) -> RunCountStore:
    """Zero the weights of every row whose key matches a valid query
    (the mutation half of erase, without the distinct-erased count —
    multi-run erase counts across runs in the step)."""
    cap = store.capacity
    q = queries.astype(jnp.uint32)
    lo, hi, _, _ = _run_query_bounds(store, q)
    lo = jnp.where(qvalid, lo, 0)
    hi = jnp.where(qvalid, hi, 0)
    diff = jnp.zeros((cap + 1,), jnp.int32)
    diff = diff.at[lo].add(jnp.where(qvalid, 1, 0))
    diff = diff.at[hi].add(jnp.where(qvalid, -1, 0))
    covered = jnp.cumsum(diff[:cap]) > 0
    new_w = jnp.where(covered, 0, store.weights)
    return RunCountStore(
        keys=store.keys,
        weights=new_w,
        csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                              _cumsum_i32(new_w)]),
    )


@jax.jit
def run_erase(store: RunCountStore, queries: jax.Array, qvalid: jax.Array):
    """Zero the weights of every row whose key matches a valid query.

    Rows stay in place (the sorted invariant is untouched); capacity is
    reclaimed later by `run_compact`.  Returns (new_store, n_erased) with
    n_erased = number of distinct keys whose count dropped to 0 (the
    reference's erase return, distributed_densehash_map.hpp:1603+)."""
    cap = store.capacity
    q = queries.astype(jnp.uint32)
    lo, hi, _, total = _run_query_bounds(store, q)
    lo = jnp.where(qvalid, lo, 0)
    hi = jnp.where(qvalid, hi, 0)
    # distinct keys actually erased: positive-count queries, deduplicated
    # by counting only queries whose lower_bound differs (equal keys have
    # equal bounds)
    had = total > 0
    diff = jnp.zeros((cap + 1,), jnp.int32)
    diff = diff.at[lo].add(jnp.where(qvalid, 1, 0))
    diff = diff.at[hi].add(jnp.where(qvalid, -1, 0))
    covered = jnp.cumsum(diff[:cap]) > 0
    new_w = jnp.where(covered, 0, store.weights)
    new = RunCountStore(
        keys=store.keys,
        weights=new_w,
        csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                              _cumsum_i32(new_w)]),
    )
    # dedupe: a query erases a run only if no other valid query with the
    # same lo already counted it — mark the first occurrence per lo value
    first = jnp.zeros((cap + 1,), jnp.int32).at[
        jnp.where(qvalid & had, lo, cap)].max(
        jnp.arange(q.shape[0], dtype=jnp.int32) + 1)
    m_idx = jnp.arange(q.shape[0], dtype=jnp.int32) + 1
    is_first = qvalid & had & (first[lo] == m_idx)
    return new, jnp.sum(is_first.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("new_cap", "saturate"))
def run_compact(store: RunCountStore, new_cap: int,
                saturate: int | None = None):
    """Collapse every run to one row (key, total) and compact live rows to
    the front — the old compacted layout, produced with one stable 1-key
    sort.  Used opportunistically when distinct << capacity to reclaim the
    memory that the merge-only flush never frees.

    saturate: clamp each key's total at compaction — exact for the
    saturating map (min(min(a, s) + b, s) == min(a + b, s) for b >= 0, the
    reference's saturating_counting_densehash_map semantics,
    distributed_densehash_map.hpp:2947), and the mechanism that keeps raw
    int32 weight totals bounded on unbounded streams (the host wrapper
    forces a clamped compact when the ingested-weight guard trips).

    Returns (new_store[new_cap], overflow int32 = distinct - new_cap if
    positive)."""
    w, cap = store.keys.shape
    _, is_last, total = run_totals(store)
    if saturate is not None:
        total = jnp.minimum(total, saturate)
    emit = is_last & (total > 0)
    n_emit = jnp.sum(emit.astype(jnp.int32))
    front_key = (~emit).astype(jnp.uint32)
    ops = jax.lax.sort(
        (front_key,) + tuple(store.keys[j] for j in range(w)) + (total,),
        num_keys=1, is_stable=True)
    uniq = jnp.stack(ops[1:1 + w], axis=0)
    totals = ops[1 + w]
    live = jnp.arange(cap) < n_emit
    uniq = jnp.where(live[None, :], uniq, jnp.uint32(_SENTINEL))
    totals = jnp.where(live, totals, 0)
    if new_cap <= cap:
        uniq, totals = uniq[:, :new_cap], totals[:new_cap]
    else:
        uniq = jnp.concatenate([
            uniq, jnp.full((w, new_cap - cap), _SENTINEL, jnp.uint32)],
            axis=1)
        totals = jnp.concatenate([
            totals, jnp.zeros(new_cap - cap, jnp.int32)])
    return run_from_sorted(uniq, totals), jnp.maximum(n_emit - new_cap, 0)


# ---------------------------------------- run-layout Bimolecule store
@dataclasses.dataclass
class RunBimolStore:
    """Bimolecule counting store in RUN layout: canonical keys sorted
    with duplicates, per-row weights, the count prefix sum, and per-row
    representative (first-occurrence id, strand) columns.

    Counts are csum differences exactly like `RunCountStore` (whose
    query/histogram/select steps this store reuses duck-typed — same
    `keys`/`weights`/`csum` fields).  The Bimolecule extra — "remember
    the INPUT-strand orientation of each key's first occurrence"
    (kmer_index.hpp:436-562) — virtualizes into a segmented MIN-by-id
    scan over each run at query/compact time: the row with the smallest
    64-bit occurrence id supplies the stored orientation, matching the
    reference's keep-first-inserted-key hash semantics.

    The compacted `bimol_insert` re-sorts store+batch with four payload
    columns per flush; this layout's flush is one (w + 4)-column bitonic
    merge + a prefix-sum rebuild.  Dead rows (weight 0) never win the min: their id
    candidates are the all-ones sentinel.
    """

    keys: jax.Array        # uint32[w, cap] — canonical, COLUMN-major
    weights: jax.Array     # int32[cap]
    csum: jax.Array        # int32[cap + 1]
    rep_hi: jax.Array      # uint32[cap] — occurrence id high word
    rep_lo: jax.Array      # uint32[cap]
    rep_strand: jax.Array  # uint32[cap] — 0 forward, 1 revcomp

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


jax.tree_util.register_dataclass(
    RunBimolStore,
    data_fields=["keys", "weights", "csum", "rep_hi", "rep_lo",
                 "rep_strand"],
    meta_fields=[])


def empty_run_bimol_store(capacity: int, nwords: int) -> RunBimolStore:
    return RunBimolStore(
        keys=jnp.full((nwords, capacity), _SENTINEL, dtype=jnp.uint32),
        weights=jnp.zeros((capacity,), jnp.int32),
        csum=jnp.zeros((capacity + 1,), jnp.int32),
        rep_hi=jnp.full((capacity,), _SENTINEL, dtype=jnp.uint32),
        rep_lo=jnp.full((capacity,), _SENTINEL, dtype=jnp.uint32),
        rep_strand=jnp.zeros((capacity,), jnp.uint32),
    )


def run_bimol_from_sorted(kcols, weights, rep_hi, rep_lo,
                          rep_strand) -> RunBimolStore:
    wt = weights.astype(jnp.int32)
    return RunBimolStore(
        keys=kcols,
        weights=wt,
        csum=jnp.concatenate([jnp.zeros(1, jnp.int32), _cumsum_i32(wt)]),
        rep_hi=rep_hi.astype(jnp.uint32),
        rep_lo=rep_lo.astype(jnp.uint32),
        rep_strand=rep_strand.astype(jnp.uint32),
    )


@jax.jit
def run_bimol_merge(a: RunBimolStore, b: RunBimolStore) -> RunBimolStore:
    """Merge two sorted Bimolecule runs ((w + 4)-column bitonic merge +
    prefix rebuild); capacity grows to next_pow2(sum)."""
    keys, (wt, hi, lo, stc) = sortops.merge_sorted_runs_cols(
        a.keys, (a.weights, a.rep_hi, a.rep_lo, a.rep_strand),
        b.keys, (b.weights, b.rep_hi, b.rep_lo, b.rep_strand))
    return run_bimol_from_sorted(keys, wt, hi, lo, stc)


def _segmented_min_rep(kcols, weights, rep_hi, rep_lo, rep_strand):
    """Per-row FULL-RUN minimum representative: the (hi, lo)-smallest
    live row of the row's key run, broadcast to every row of the run
    (gather-free: one segmented argmin scan + one reverse select scan
    per column).  Dead rows (weight 0) carry sentinel candidates."""
    live = weights > 0
    hi = jnp.where(live, rep_hi, jnp.uint32(_SENTINEL))
    lo = jnp.where(live, rep_lo, jnp.uint32(_SENTINEL))
    stc = jnp.where(live, rep_strand, 0).astype(jnp.uint32)
    neq_prev, neq_next = _adjacent_neq(kcols)

    def comb(a, b):
        ahi, alo, ast, af = a
        bhi, blo, bst, bf = b
        a_less = (ahi < bhi) | ((ahi == bhi) & (alo <= blo))
        mhi = jnp.where(a_less, ahi, bhi)
        mlo = jnp.where(a_less, alo, blo)
        mst = jnp.where(a_less, ast, bst)
        return (jnp.where(bf, bhi, mhi), jnp.where(bf, blo, mlo),
                jnp.where(bf, bst, mst), af | bf)

    fhi, flo, fst, _ = jax.lax.associative_scan(
        comb, (hi, lo, stc, neq_prev))
    # the forward scan leaves each run's min at its LAST row; spread it
    # back over the run with a reversed last-set-value scan per column
    flags = neq_next[::-1]
    mhi = _broadcast_head(fhi[::-1], flags)[::-1]
    mlo = _broadcast_head(flo[::-1], flags)[::-1]
    mst = _broadcast_head(fst[::-1], flags)[::-1]
    return mhi, mlo, mst


@functools.partial(jax.jit, static_argnames=("saturate",))
def run_bimol_lookup(store: RunBimolStore, queries: jax.Array,
                     saturate: int | None = None):
    """(counts int32[m], strand uint32[m]) per canonical query key —
    count plus the stored-orientation flag of the earliest occurrence
    (the device half of Bimolecule find)."""
    cap = store.capacity
    w = store.keys.shape[0]
    q = queries.astype(jnp.uint32)
    size = store.csum[0] * 0 + cap
    lo = sortops.lower_bound_cols_bucketed(store.keys, size, q)
    _, _, total = run_totals(store)
    _, _, mst = _segmented_min_rep(store.keys, store.weights,
                                   store.rep_hi, store.rep_lo,
                                   store.rep_strand)
    # one fused [w + 2, m] gather: key words + run total + min-rep strand
    ext = jnp.concatenate(
        [store.keys, total.astype(jnp.uint32)[None, :], mst[None, :]],
        axis=0)
    g = ext[:, jnp.clip(lo, 0, cap - 1)]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == q[:, j]
    counts = jnp.where(hit, g[w].astype(jnp.int32), 0)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    strand = jnp.where(hit & (counts > 0), g[w + 1], 0)
    return counts, strand


@jax.jit
def run_bimol_erase(store: RunBimolStore, queries: jax.Array,
                    qvalid: jax.Array):
    """Zero the weights of matching runs; returns (new_store, n_erased)
    with n_erased = distinct keys whose count dropped to 0 (mirrors
    `run_erase`; representatives stay in place — weight-0 rows never
    win the min and dead runs never report)."""
    cap = store.capacity
    q = queries.astype(jnp.uint32)
    lo, hi, _, total = _run_query_bounds(store, q)
    lo = jnp.where(qvalid, lo, 0)
    hi = jnp.where(qvalid, hi, 0)
    had = total > 0
    diff = jnp.zeros((cap + 1,), jnp.int32)
    diff = diff.at[lo].add(jnp.where(qvalid, 1, 0))
    diff = diff.at[hi].add(jnp.where(qvalid, -1, 0))
    covered = jnp.cumsum(diff[:cap]) > 0
    new_w = jnp.where(covered, 0, store.weights)
    new = RunBimolStore(
        keys=store.keys,
        weights=new_w,
        csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                              _cumsum_i32(new_w)]),
        rep_hi=store.rep_hi,
        rep_lo=store.rep_lo,
        rep_strand=store.rep_strand,
    )
    first = jnp.zeros((cap + 1,), jnp.int32).at[
        jnp.where(qvalid & had, lo, cap)].max(
        jnp.arange(q.shape[0], dtype=jnp.int32) + 1)
    m_idx = jnp.arange(q.shape[0], dtype=jnp.int32) + 1
    is_first = qvalid & had & (first[lo] == m_idx)
    return new, jnp.sum(is_first.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("new_cap", "saturate"))
def run_bimol_compact(store: RunBimolStore, new_cap: int,
                      saturate: int | None = None):
    """Collapse every run to one (key, total, min-rep) row and compact
    live rows to the front.  Returns (new_store[new_cap], overflow)."""
    w, cap = store.keys.shape
    _, is_last, total = run_totals(store)
    if saturate is not None:
        total = jnp.minimum(total, saturate)
    mhi, mlo, mst = _segmented_min_rep(store.keys, store.weights,
                                       store.rep_hi, store.rep_lo,
                                       store.rep_strand)
    emit = is_last & (total > 0)
    n_emit = jnp.sum(emit.astype(jnp.int32))
    front_key = (~emit).astype(jnp.uint32)
    ops = jax.lax.sort(
        (front_key,) + tuple(store.keys[j] for j in range(w))
        + (total, mhi, mlo, mst),
        num_keys=1, is_stable=True)
    uniq = jnp.stack(ops[1:1 + w], axis=0)
    totals, hi2, lo2, st2 = ops[1 + w:]
    live = jnp.arange(cap) < n_emit
    uniq = jnp.where(live[None, :], uniq, jnp.uint32(_SENTINEL))
    totals = jnp.where(live, totals, 0)
    hi2 = jnp.where(live, hi2, jnp.uint32(_SENTINEL))
    lo2 = jnp.where(live, lo2, jnp.uint32(_SENTINEL))
    st2 = jnp.where(live, st2, 0)
    if new_cap <= cap:
        uniq, totals = uniq[:, :new_cap], totals[:new_cap]
        hi2, lo2, st2 = hi2[:new_cap], lo2[:new_cap], st2[:new_cap]
    else:
        pad = new_cap - cap
        uniq = jnp.concatenate(
            [uniq, jnp.full((w, pad), _SENTINEL, jnp.uint32)], axis=1)
        totals = jnp.concatenate([totals, jnp.zeros(pad, jnp.int32)])
        hi2 = jnp.concatenate(
            [hi2, jnp.full((pad,), _SENTINEL, jnp.uint32)])
        lo2 = jnp.concatenate(
            [lo2, jnp.full((pad,), _SENTINEL, jnp.uint32)])
        st2 = jnp.concatenate([st2, jnp.zeros(pad, jnp.uint32)])
    return run_bimol_from_sorted(uniq, totals, hi2, lo2, st2), \
        jnp.maximum(n_emit - new_cap, 0)


# ------------------------------------- run-layout de Bruijn node store
@dataclasses.dataclass
class RunVecStore:
    """De Bruijn node store in RUN layout: sorted keys with duplicates
    allowed, per-row (edge byte, weight) payloads, and a [9, cap]
    INCLUSIVE prefix-sum table of counter contributions (one contiguous
    stream per counter).

    Row i contributes ``weights[i] * bit_j(ebytes[i])`` to counter j
    (j < 8: out A,C,G,T, in A,C,G,T — one increment per set DNA16 bit,
    edge_counts::update, de_bruijn_node_trait.hpp:195-245) and
    ``weights[i]`` to the self counter (j = 8).  Node counters of key q
    are ``bsum[:, run_end(q) - 1] - bsum[:, run_start(q) - 1]`` (zero below
    index 0) — the vector reduction
    virtualized into prefix sums, the same discipline that RunCountStore
    applies to counting (distributed_sorted_map.hpp:341,940 lazy-sort
    semantics).  The compacted VecStore flush is a 9-payload sort +
    segment reduce of store+batch; this layout's flush is one
    (w+2)-column bitonic merge plus 9 prefix-sum rebuilds.

    Invariants mirror RunCountStore: keys nondecreasing over ALL cap
    rows, padding rows hold the all-ones sentinel with weight 0 (a real
    k-mer colliding with the sentinel pattern is harmless — weight-0
    rows never change any counter), and `run_vec_compact` reclaims
    duplicate/dead rows by collapsing equal (key, edge-byte) rows into
    one weighted row (<= 256 rows per key, typically ~1-4: distinct
    neighbor-pair patterns per node are few).
    """

    keys: jax.Array     # uint32[w, cap] — per-word COLUMNS, sorted
    ebytes: jax.Array   # int32[cap] DNA16 edge byte (left<<4 | right)
    weights: jax.Array  # int32[cap] occurrences collapsed into the row
    #: int32[9, cap] INCLUSIVE prefix sums per counter — or None on a
    #: LAZY run (intermediate LSM runs are merge fodder; their tables
    #: would be rebuilt and thrown away every level, so the graph defers
    #: them until a query/export needs answers: run_vec_with_table)
    bsum: jax.Array | None

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


jax.tree_util.register_dataclass(
    RunVecStore, data_fields=["keys", "ebytes", "weights", "bsum"],
    meta_fields=[])


def empty_run_vec_store(capacity: int, nwords: int) -> RunVecStore:
    return RunVecStore(
        keys=jnp.full((nwords, capacity), _SENTINEL, dtype=jnp.uint32),
        ebytes=jnp.zeros((capacity,), jnp.int32),
        weights=jnp.zeros((capacity,), jnp.int32),
        bsum=jnp.zeros((9, capacity), jnp.int32),
    )


def _excl_of(incl: jax.Array) -> jax.Array:
    """Exclusive counterpart of an INCLUSIVE prefix-sum column [cap]."""
    i = jnp.arange(incl.shape[0])
    return jnp.where(i > 0, jnp.roll(incl, 1), jnp.zeros_like(incl))


def _vec_bsum(ebytes: jax.Array, weights: jax.Array) -> jax.Array:
    """int32[9, cap] INCLUSIVE prefix sums of per-row counter
    contributions, one contiguous row per counter (the kernel-native
    stream layout — no [cap, 9] interleave pass; bound gathers use the
    fast axis-1 form `bsum[:, idx]`)."""
    cols = []
    for j in range(8):
        cols.append(_cumsum_i32(((ebytes >> j) & 1) * weights))
    cols.append(_cumsum_i32(weights))
    return jnp.stack(cols, axis=0)


def run_vec_from_sorted(kcols: jax.Array, ebytes: jax.Array,
                        weights: jax.Array) -> RunVecStore:
    """Adopt an already-sorted (sentinel-padded) weighted edge run."""
    return RunVecStore(
        keys=kcols,
        ebytes=ebytes.astype(jnp.int32),
        weights=weights.astype(jnp.int32),
        bsum=_vec_bsum(ebytes.astype(jnp.int32), weights.astype(jnp.int32)),
    )


@jax.jit
def run_vec_merge(a: RunVecStore, b: RunVecStore) -> RunVecStore:
    """Merge two sorted edge runs (bitonic merge over w + 2 payload
    columns + prefix-sum rebuild).  Capacity grows to next_pow2(sum) —
    run stores never overflow; `run_vec_compact` reclaims dead rows."""
    keys, (eb, wt) = sortops.merge_sorted_runs_cols(
        a.keys, (a.ebytes, a.weights), b.keys, (b.ebytes, b.weights))
    return run_vec_from_sorted(keys, eb, wt)


def _vec_bsum_unit(eb: jax.Array, n_live: jax.Array) -> jax.Array:
    """[9, n] inclusive counter prefix sums of a UNIT run: weights are 1
    per live row (dead rows carry ebyte 0, so the bit streams need no
    mask) and the self stream is closed-form min(i + 1, n_live)."""
    n = eb.shape[0]
    cols = [_cumsum_i32((eb >> j) & 1) for j in range(8)]
    self_row = jnp.minimum(jnp.arange(1, n + 1, dtype=jnp.int32),
                           n_live)
    # ONE [9, n] stack (a stack + concat pair costs an extra full-table
    # copy)
    return jnp.stack(cols + [self_row], axis=0)


def run_vec_from_sorted_unit(kcols: jax.Array,
                             ebytes: jax.Array,
                             weights: jax.Array,
                             table: bool = True) -> RunVecStore:
    """Adopt a sorted UNIT edge run (file-ingest output: weight 1 per
    live row, sentinel tail, dead ebytes 0) — closed-form self stream,
    8 bit-stream scans with no weight multiply.  table=False defers the
    counter table (LAZY run)."""
    eb = ebytes.astype(jnp.int32)
    n_live = jnp.sum(weights.astype(jnp.int32))
    n = kcols.shape[1]
    live = jnp.arange(n, dtype=jnp.int32) < n_live
    return RunVecStore(
        keys=kcols, ebytes=eb, weights=live.astype(jnp.int32),
        bsum=_vec_bsum_unit(eb, n_live) if table else None)


@functools.partial(jax.jit, static_argnames=("table",))
def run_vec_merge_unit(a: RunVecStore, b: RunVecStore,
                       table: bool = True) -> RunVecStore:
    """Merge two UNIT edge runs: the weight column never rides the merge
    network (w + 1 operands instead of w + 2) — weights and the self
    stream come back in closed form (the count family's
    `run_merge_unit` discipline applied to the de Bruijn store).
    table=False defers the counter table (intermediate LSM runs)."""
    keys, (eb,) = sortops.merge_sorted_runs_cols(
        a.keys, (a.ebytes,), b.keys, (b.ebytes,))
    n = keys.shape[1]
    # live totals from the weight flags, NOT bsum[8, -1]: a one-element
    # read of the stacked table defeats XLA's dead-code elimination of
    # the operands' full [9, n] tables
    n_live = jnp.sum(a.weights) + jnp.sum(b.weights)
    live = jnp.arange(n, dtype=jnp.int32) < n_live
    return RunVecStore(
        keys=keys, ebytes=eb, weights=live.astype(jnp.int32),
        bsum=_vec_bsum_unit(eb, n_live) if table else None)


@jax.jit
def run_vec_with_table(store: RunVecStore) -> RunVecStore:
    """Materialize a LAZY run's counter table (generic weights)."""
    if store.bsum is not None:
        return store
    return RunVecStore(keys=store.keys, ebytes=store.ebytes,
                       weights=store.weights,
                       bsum=_vec_bsum(store.ebytes, store.weights))


@jax.jit
def run_vec_distinct(store: RunVecStore) -> jax.Array:
    """int32 scalar: distinct keys with positive total weight (the graph's
    node count; sentinel padding has weight 0 and never counts)."""
    cap = store.capacity
    neq_prev, neq_next = _adjacent_neq(store.keys)
    csum_incl = store.bsum[8]
    csum_excl = _excl_of(csum_incl)
    start = jax.lax.cummax(
        jnp.where(neq_prev, csum_excl, jnp.int32(-2147483648)), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, csum_incl,
                  jnp.int32(2147483647))[::-1], axis=0)[::-1]
    return jnp.sum((neq_prev & (end - start > 0)).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("saturate",))
def run_vec_lookup(store: RunVecStore, queries: jax.Array,
                   saturate: int | None = None) -> jax.Array:
    """int32[m, 9] node counters per query key (zeros if absent).

    ONE bucketed lower_bound + the run-length scan broadcast (the count
    family's one-search discipline), then counters come from a single
    fused [2m, 9] gather of prefix-sum rows at the run bounds."""
    cap = store.capacity
    w = store.keys.shape[0]
    q = queries.astype(jnp.uint32)
    size = store.bsum[0, 0] * 0 + cap
    lo = sortops.lower_bound_cols_bucketed(store.keys, size, q)
    neq_prev, neq_next = _adjacent_neq(store.keys)
    idx = jnp.arange(cap, dtype=jnp.int32)
    start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, idx + 1, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    runlen = end - start
    ext = jnp.concatenate(
        [store.keys, runlen.astype(jnp.uint32)[None, :]], axis=0)
    lofc = jnp.clip(lo, 0, cap - 1)
    g = ext[:, lofc]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == q[:, j]
    hi = jnp.where(hit, jnp.minimum(lo + g[w].astype(jnp.int32), cap), lo)
    lo_h = jnp.where(hit, lofc, 0)
    hi_h = jnp.where(hit, hi, 0)
    # one fused [9, 2m] axis-1 gather of the inclusive prefix rows at
    # both run bounds; bound i reads incl[:, i-1] (zero at i == 0)
    idx2 = jnp.concatenate([lo_h, hi_h])
    g = store.bsum[:, jnp.clip(idx2 - 1, 0, cap - 1)]
    g = jnp.where(idx2[None, :] > 0, g, 0)
    m = q.shape[0]
    counts = (g[:, m:] - g[:, :m]).T
    counts = jnp.where(hit[:, None], counts, 0)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    return counts


@functools.partial(jax.jit, static_argnames=("new_cap",))
def run_vec_compact(store: RunVecStore, new_cap: int):
    """Collapse equal (key, edge-byte) rows into one weighted row and
    compact live rows to the front — reclaims the memory the merge-only
    flush never frees.  One (w+1)-key sort groups the edge bytes within
    each key run, then the scatter-free stable front sort compacts.

    Returns (new_store[new_cap], overflow int32)."""
    w, cap = store.keys.shape
    # group rows by (key, ebyte): sentinel-safe because no real row has
    # an all-ones EBYTE column (ebytes <= 255)
    eb_u = store.ebytes.astype(jnp.uint32)
    ops = jax.lax.sort(
        tuple(store.keys[j] for j in range(w)) + (eb_u, store.weights),
        num_keys=w + 1, is_stable=False)
    kcols = ops[:w]
    eb, wt = ops[w], ops[w + 1]
    # per-(key, ebyte)-group weight totals, gather-free
    neq_prev = jnp.zeros(cap, bool).at[0].set(True) | (eb != jnp.roll(eb, 1))
    neq_next = jnp.zeros(cap, bool).at[cap - 1].set(True) \
        | (eb != jnp.roll(eb, -1))
    for j in range(w):
        neq_prev = neq_prev | (kcols[j] != jnp.roll(kcols[j], 1))
        neq_next = neq_next | (kcols[j] != jnp.roll(kcols[j], -1))
    neq_prev = neq_prev.at[0].set(True)
    neq_next = neq_next.at[cap - 1].set(True)
    incl = jnp.cumsum(wt)
    excl = incl - wt
    start = jax.lax.cummax(
        jnp.where(neq_prev, excl, jnp.int32(-2147483648)), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, incl, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    total = end - start
    emit = neq_next & (total > 0)
    n_emit = jnp.sum(emit.astype(jnp.int32))
    front_key = (~emit).astype(jnp.uint32)
    ops2 = jax.lax.sort(
        (front_key,) + tuple(kcols) + (eb, total),
        num_keys=1, is_stable=True)
    uniq = jnp.stack(ops2[1:1 + w], axis=0)
    eb2, tot2 = ops2[1 + w], ops2[2 + w]
    live = jnp.arange(cap) < n_emit
    uniq = jnp.where(live[None, :], uniq, jnp.uint32(_SENTINEL))
    eb2 = jnp.where(live, eb2, 0).astype(jnp.int32)
    tot2 = jnp.where(live, tot2, 0)
    if new_cap <= cap:
        uniq, eb2, tot2 = uniq[:, :new_cap], eb2[:new_cap], tot2[:new_cap]
    else:
        uniq = jnp.concatenate([
            uniq, jnp.full((w, new_cap - cap), _SENTINEL, jnp.uint32)],
            axis=1)
        eb2 = jnp.concatenate([eb2, jnp.zeros(new_cap - cap, jnp.int32)])
        tot2 = jnp.concatenate([tot2, jnp.zeros(new_cap - cap, jnp.int32)])
    return run_vec_from_sorted(uniq, eb2, tot2), \
        jnp.maximum(n_emit - new_cap, 0)


# ------------------------------ run-layout QUALITY de Bruijn node store
@dataclasses.dataclass
class RunVecQStore:
    """`RunVecStore` + a per-row windowed-quality sum column and its
    float32 prefix sums — the run-layout quality de Bruijn engine
    (de_bruijn_quality_engine, de_bruijn_construct_engine.hpp:245; the
    alias is declared but never instantiated by the reference, so the
    node reduction is defined here: counter sums + quality-score sum,
    mean quality queryable).  Same merge-instead-of-re-sort flush
    economics as RunVecStore; the window count equals the self counter
    (every window contributes one occurrence)."""

    keys: jax.Array     # uint32[w, cap]
    ebytes: jax.Array   # int32[cap]
    weights: jax.Array  # int32[cap]
    qsums: jax.Array    # float32[cap] — windowed scores collapsed in
    bsum: jax.Array | None   # int32[9, cap] INCLUSIVE per-counter (lazy: None)
    qcsum: jax.Array | None  # float32[cap] INCLUSIVE qsums (lazy: None)

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]


jax.tree_util.register_dataclass(
    RunVecQStore,
    data_fields=["keys", "ebytes", "weights", "qsums", "bsum", "qcsum"],
    meta_fields=[])


def empty_run_vecq_store(capacity: int, nwords: int) -> RunVecQStore:
    return RunVecQStore(
        keys=jnp.full((nwords, capacity), _SENTINEL, dtype=jnp.uint32),
        ebytes=jnp.zeros((capacity,), jnp.int32),
        weights=jnp.zeros((capacity,), jnp.int32),
        qsums=jnp.zeros((capacity,), jnp.float32),
        bsum=jnp.zeros((9, capacity), jnp.int32),
        qcsum=jnp.zeros((capacity,), jnp.float32),
    )


def run_vecq_from_sorted(kcols, ebytes, weights, qsums) -> RunVecQStore:
    eb = ebytes.astype(jnp.int32)
    wt = weights.astype(jnp.int32)
    qs = qsums.astype(jnp.float32)
    return RunVecQStore(
        keys=kcols, ebytes=eb, weights=wt, qsums=qs,
        bsum=_vec_bsum(eb, wt),
        qcsum=jnp.cumsum(qs),
    )


@jax.jit
def run_vecq_merge(a: RunVecQStore, b: RunVecQStore) -> RunVecQStore:
    """Merge two sorted quality edge runs ((w + 3)-column bitonic merge
    + prefix rebuilds)."""
    keys, (eb, wt, qb) = sortops.merge_sorted_runs_cols(
        a.keys,
        (a.ebytes, a.weights,
         jax.lax.bitcast_convert_type(a.qsums, jnp.uint32)),
        b.keys,
        (b.ebytes, b.weights,
         jax.lax.bitcast_convert_type(b.qsums, jnp.uint32)))
    return run_vecq_from_sorted(
        keys, eb, wt, jax.lax.bitcast_convert_type(qb, jnp.float32))


def run_vecq_from_sorted_unit(kcols, ebytes, weights, qsums,
                              table: bool = True) -> RunVecQStore:
    """Adopt a sorted UNIT quality edge run (weight 1 per live row; dead
    rows carry ebyte 0 and qsum 0.0) — closed-form self stream."""
    eb = ebytes.astype(jnp.int32)
    qs = qsums.astype(jnp.float32)
    n_live = jnp.sum(weights.astype(jnp.int32))
    n = kcols.shape[1]
    live = jnp.arange(n, dtype=jnp.int32) < n_live
    return RunVecQStore(
        keys=kcols, ebytes=eb, weights=live.astype(jnp.int32), qsums=qs,
        bsum=_vec_bsum_unit(eb, n_live) if table else None,
        qcsum=jnp.cumsum(qs) if table else None)


@functools.partial(jax.jit, static_argnames=("table",))
def run_vecq_merge_unit(a: RunVecQStore, b: RunVecQStore,
                        table: bool = True) -> RunVecQStore:
    """Merge two UNIT quality edge runs: w + 2 merge operands instead of
    w + 3 (the weight column is closed-form)."""
    keys, (eb, qb) = sortops.merge_sorted_runs_cols(
        a.keys, (a.ebytes, jax.lax.bitcast_convert_type(a.qsums,
                                                        jnp.uint32)),
        b.keys, (b.ebytes, jax.lax.bitcast_convert_type(b.qsums,
                                                        jnp.uint32)))
    qs = jax.lax.bitcast_convert_type(qb, jnp.float32)
    n = keys.shape[1]
    n_live = jnp.sum(a.weights) + jnp.sum(b.weights)  # see run_vec_merge_unit
    live = jnp.arange(n, dtype=jnp.int32) < n_live
    return RunVecQStore(
        keys=keys, ebytes=eb, weights=live.astype(jnp.int32), qsums=qs,
        bsum=_vec_bsum_unit(eb, n_live) if table else None,
        qcsum=jnp.cumsum(qs) if table else None)


@jax.jit
def run_vecq_with_table(store: RunVecQStore) -> RunVecQStore:
    """Materialize a LAZY quality run's tables (generic weights)."""
    if store.bsum is not None:
        return store
    return RunVecQStore(keys=store.keys, ebytes=store.ebytes,
                        weights=store.weights, qsums=store.qsums,
                        bsum=_vec_bsum(store.ebytes, store.weights),
                        qcsum=jnp.cumsum(store.qsums))


@jax.jit
def run_vecq_distinct(store: RunVecQStore) -> jax.Array:
    return run_vec_distinct(store)  # duck-typed on keys/bsum


@functools.partial(jax.jit, static_argnames=("saturate",))
def run_vecq_lookup(store: RunVecQStore, queries: jax.Array,
                    saturate: int | None = None):
    """(counts int32[m, 9], qsum float32[m]) per query key.  One bucketed
    lower_bound + run-length broadcast, then ONE fused [2m, 10] gather of
    the combined prefix table at both run bounds."""
    cap = store.capacity
    w = store.keys.shape[0]
    q = queries.astype(jnp.uint32)
    size = store.bsum[0, 0] * 0 + cap
    lo = sortops.lower_bound_cols_bucketed(store.keys, size, q)
    neq_prev, neq_next = _adjacent_neq(store.keys)
    idx = jnp.arange(cap, dtype=jnp.int32)
    start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, idx + 1, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    runlen = end - start
    ext = jnp.concatenate(
        [store.keys, runlen.astype(jnp.uint32)[None, :]], axis=0)
    lofc = jnp.clip(lo, 0, cap - 1)
    g = ext[:, lofc]
    hit = lo < cap
    for j in range(w):
        hit &= g[j] == q[:, j]
    hi = jnp.where(hit, jnp.minimum(lo + g[w].astype(jnp.int32), cap), lo)
    lo_h = jnp.where(hit, lofc, 0)
    hi_h = jnp.where(hit, hi, 0)
    table = jnp.concatenate(
        [store.bsum,
         jax.lax.bitcast_convert_type(store.qcsum, jnp.int32)[None, :]],
        axis=0)
    idx2 = jnp.concatenate([lo_h, hi_h])
    g = table[:, jnp.clip(idx2 - 1, 0, cap - 1)]
    g = jnp.where(idx2[None, :] > 0, g, 0)
    m = q.shape[0]
    counts = (g[:9, m:] - g[:9, :m]).T
    qdiff = (jax.lax.bitcast_convert_type(g[9, m:], jnp.float32)
             - jax.lax.bitcast_convert_type(g[9, :m], jnp.float32))
    counts = jnp.where(hit[:, None], counts, 0)
    qdiff = jnp.where(hit, qdiff, 0.0)
    if saturate is not None:
        counts = jnp.minimum(counts, saturate)
    return counts, qdiff


def _broadcast_head(vals: jax.Array, is_head: jax.Array) -> jax.Array:
    """vals[group_head(i)] broadcast to every row i of its group,
    gather-free: an associative last-set-value scan (works for
    NON-monotone vals, unlike the cummax trick)."""

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    out, _ = jax.lax.associative_scan(comb, (vals, is_head))
    return out


@functools.partial(jax.jit, static_argnames=("new_cap",))
def run_vecq_compact(store: RunVecQStore, new_cap: int):
    """Collapse equal (key, edge-byte) rows, summing weights AND quality
    scores; float group sums use the last-set-value broadcast (quality
    scores may be negative, so the monotone cummax trick does not
    apply)."""
    w, cap = store.keys.shape
    eb_u = store.ebytes.astype(jnp.uint32)
    ops = jax.lax.sort(
        tuple(store.keys[j] for j in range(w)) + (eb_u,)
        + (store.weights,
           jax.lax.bitcast_convert_type(store.qsums, jnp.uint32)),
        num_keys=w + 1, is_stable=False)
    kcols = ops[:w]
    eb, wt = ops[w], ops[w + 1]
    qs = jax.lax.bitcast_convert_type(ops[w + 2], jnp.float32)
    neq_prev = jnp.zeros(cap, bool) | (eb != jnp.roll(eb, 1))
    neq_next = jnp.zeros(cap, bool) | (eb != jnp.roll(eb, -1))
    for j in range(w):
        neq_prev = neq_prev | (kcols[j] != jnp.roll(kcols[j], 1))
        neq_next = neq_next | (kcols[j] != jnp.roll(kcols[j], -1))
    neq_prev = neq_prev.at[0].set(True)
    neq_next = neq_next.at[cap - 1].set(True)
    incl = jnp.cumsum(wt)
    total = incl - _broadcast_head(incl - wt, neq_prev)
    q_incl = jnp.cumsum(qs)
    q_total = q_incl - _broadcast_head(q_incl - qs, neq_prev)
    emit = neq_next & (total > 0)
    n_emit = jnp.sum(emit.astype(jnp.int32))
    front_key = (~emit).astype(jnp.uint32)
    ops2 = jax.lax.sort(
        (front_key,) + tuple(kcols)
        + (eb, total, jax.lax.bitcast_convert_type(q_total, jnp.uint32)),
        num_keys=1, is_stable=True)
    uniq = jnp.stack(ops2[1:1 + w], axis=0)
    eb2, tot2 = ops2[1 + w], ops2[2 + w]
    qs2 = jax.lax.bitcast_convert_type(ops2[3 + w], jnp.float32)
    live = jnp.arange(cap) < n_emit
    uniq = jnp.where(live[None, :], uniq, jnp.uint32(_SENTINEL))
    eb2 = jnp.where(live, eb2, 0).astype(jnp.int32)
    tot2 = jnp.where(live, tot2, 0)
    qs2 = jnp.where(live, qs2, 0.0)
    if new_cap <= cap:
        uniq, eb2 = uniq[:, :new_cap], eb2[:new_cap]
        tot2, qs2 = tot2[:new_cap], qs2[:new_cap]
    else:
        pad = new_cap - cap
        uniq = jnp.concatenate(
            [uniq, jnp.full((w, pad), _SENTINEL, jnp.uint32)], axis=1)
        eb2 = jnp.concatenate([eb2, jnp.zeros(pad, jnp.int32)])
        tot2 = jnp.concatenate([tot2, jnp.zeros(pad, jnp.int32)])
        qs2 = jnp.concatenate([qs2, jnp.zeros(pad, jnp.float32)])
    return run_vecq_from_sorted(uniq, eb2, tot2, qs2), \
        jnp.maximum(n_emit - new_cap, 0)


# ------------------------------------------------ generic unique-value map
@dataclasses.dataclass
class KVStore:
    """Unique-key k-mer → 64-bit value map — the reference's generic
    `KmerIndex` alias (`Index<densehash_map<Kmer, T>>`,
    /root/reference/src/index/kmer_index.hpp:397-399 over
    densehash_map.hpp:1742 / distributed_sorted_map.hpp:1407).  Values are
    (hi, lo) uint32 pairs; the insert reduction is `first` (keep the
    earliest arrival, the hash map's insert-does-not-overwrite), `min`, or
    `max` over the u64 value."""

    keys: jax.Array    # uint32[cap, w] — sorted unique keys in [0, size)
    val_hi: jax.Array  # uint32[cap]
    val_lo: jax.Array  # uint32[cap]
    size: jax.Array    # int32 scalar

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


jax.tree_util.register_dataclass(
    KVStore, data_fields=["keys", "val_hi", "val_lo", "size"],
    meta_fields=[])


def empty_kv_store(capacity: int, nwords: int) -> KVStore:
    return KVStore(
        keys=jnp.full((capacity, nwords), _SENTINEL, dtype=jnp.uint32),
        val_hi=jnp.zeros((capacity,), jnp.uint32),
        val_lo=jnp.zeros((capacity,), jnp.uint32),
        size=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("reduce",))
def kv_insert(store: KVStore, words, val_hi, val_lo, valid,
              reduce: str = "first"):
    """Merge (key, u64 value) tuples into the unique map.

    reduce="first": existing store entries win over the batch, earlier
    batch rows win over later ones (densehash insert semantics; arrival
    order within a routed batch follows source-shard-major order).
    reduce="min"/"max": the extreme u64 value per key wins —
    order-independent (the reduction map with min/max functor,
    distributed_densehash_map.hpp:2429+).  Returns (new_store, overflow).
    """
    cap = store.capacity
    n = words.shape[0]
    live_store = jnp.arange(cap) < store.size
    all_words = jnp.concatenate([store.keys, words.astype(jnp.uint32)],
                                axis=0)
    all_hi = jnp.concatenate([store.val_hi, val_hi.astype(jnp.uint32)])
    all_lo = jnp.concatenate([store.val_lo, val_lo.astype(jnp.uint32)])
    all_valid = jnp.concatenate([live_store, valid])
    w = all_words.shape[1]
    flag = (~all_valid).astype(jnp.uint32)
    cols = tuple(all_words[:, j] for j in range(w))
    if reduce == "first":
        # priority: store rows 0 (their keys are unique among themselves),
        # batch rows by arrival index
        prio = jnp.concatenate([
            jnp.zeros(cap, jnp.uint32),
            jnp.arange(1, n + 1, dtype=jnp.uint32)])
        ops = jax.lax.sort((flag,) + cols + (prio, all_hi, all_lo),
                           num_keys=1 + w + 1, is_stable=False)
        s_hi, s_lo = ops[2 + w], ops[3 + w]
    elif reduce in ("min", "max"):
        vh = all_hi if reduce == "min" else ~all_hi
        vl = all_lo if reduce == "min" else ~all_lo
        ops = jax.lax.sort((flag,) + cols + (vh, vl),
                           num_keys=1 + w + 2, is_stable=False)
        s_hi, s_lo = ops[1 + w], ops[2 + w]
        if reduce == "max":
            s_hi, s_lo = ~s_hi, ~s_lo
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    s_valid = ops[0] == 0
    s_words = jnp.stack(ops[1:1 + w], axis=1)
    uniq, (hi_f, lo_f), starts, n_unique, total_valid = sortops.compact_runs(
        s_words, s_valid, payloads=(s_hi, s_lo))
    live = jnp.arange(cap + n) < n_unique
    new = KVStore(
        keys=jnp.where(live[:, None], uniq, jnp.uint32(_SENTINEL))[:cap],
        val_hi=jnp.where(live, hi_f, 0)[:cap],
        val_lo=jnp.where(live, lo_f, 0)[:cap],
        size=jnp.minimum(n_unique, cap),
    )
    return new, jnp.maximum(n_unique - cap, 0)


@jax.jit
def kv_lookup(store: KVStore, queries):
    """(val_hi, val_lo, found) per query key.  SMALL batches take the
    gather-free sort-merge join, the inverse of the other families'
    rule: the kv bsearch pays flat per-call O(cap) scans and two-column
    bound work, while the join grows ~linearly in m (rule taken from
    an earlier accelerator; not yet measured on the GPU, ROADMAP S5)."""
    q = queries.astype(jnp.uint32)
    if queries.shape[0] * JOIN_CROSSOVER_FACTOR <= store.capacity:
        (hi, lo), found = sortops.lookup_join_vals(
            store.keys, store.size, (store.val_hi, store.val_lo), q)
        return hi, lo, found
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    cap, w = store.keys.shape
    # fused [m, w+2] row gather: key words + both value halves
    ext = jnp.concatenate(
        [store.keys, store.val_hi[:, None], store.val_lo[:, None]], axis=1)
    g = ext[jnp.clip(idx, 0, cap - 1)]
    hit = (idx < jnp.asarray(store.size, jnp.int32)) & jnp.all(
        g[:, :w] == q, axis=-1)
    return (jnp.where(hit, g[:, w], 0),
            jnp.where(hit, g[:, w + 1], 0), hit)


@jax.jit
def kv_erase(store: KVStore, queries, qvalid):
    """Remove query keys; returns (new_store, n_erased)."""
    q = queries.astype(jnp.uint32)
    idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
    hit = sortops.rows_equal_at(store.keys, idx, q, store.size) & qvalid
    cap = store.capacity
    kill = jnp.zeros((cap + 1,), bool).at[
        jnp.where(hit, idx, cap)].set(True)[:cap]
    keep = (jnp.arange(cap) < store.size) & ~kill
    s_words, (s_hi, s_lo), s_valid = sortops.sort_rows(
        store.keys, (store.val_hi, store.val_lo), keep)
    new_size = jnp.sum(keep.astype(jnp.int32))
    new = KVStore(
        keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(_SENTINEL)),
        val_hi=jnp.where(s_valid, s_hi, 0),
        val_lo=jnp.where(s_valid, s_lo, 0),
        size=new_size,
    )
    return new, store.size - new_size

"""Sort / unique / segmented-reduce / binary-search primitives over
multi-word keys.

This is the accelerator-idiomatic replacement for the reference's pointer-chasing
hash tables: the local store of every distributed container becomes sorted
flat arrays + ``searchsorted``-style batched binary search, the design the
reference itself offers as ``dsc::sorted_map``
(/root/reference/src/containers/distributed_sorted_map.hpp:114-141) and
which maps directly onto XLA's fused sort + segment ops.

Keys are ``uint32[n, nwords]`` rows in big-endian word order (word 0 most
significant), so lexicographic row order == k-mer order.  All functions take
a ``valid`` mask and route invalid rows to the end of the sort with an
explicit flag key, keeping every shape static under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "sort_rows",
    "compact_runs",
    "unique_counts",
    "segment_reduce_sorted",
    "lower_bound",
    "upper_bound",
    "rows_equal_at",
    "bitonic_merge",
    "bitonic_merge_cols",
    "merge_sorted_runs",
    "merge_sorted_runs_cols",
    "lookup_join_runs",
    "lookup_join_runs_cols",
    "lower_bound_cols",
    "upper_bound_cols",
    "lower_bound_cols_bucketed",
    "lower_bound_bucketed",
    "lookup_join",
    "lookup_join_vals",
    "lookup_join_ranges",
]


def _narrow_dtype(bits: int | None):
    """Smallest sortable dtype whose all-ones pattern still exceeds every
    valid `bits`-bit value (strict <, so the sentinel stays distinct)."""
    if bits is None:
        return None
    if bits < 8:
        return jnp.uint8
    if bits < 16:
        return jnp.uint16
    return None


def sort_rows(words: jax.Array, payloads=(), valid: jax.Array | None = None,
              is_stable: bool = True, sentinel_ok: bool = False,
              word_bits: tuple | None = None, as_cols: bool = False):
    """Sort rows of uint32[n, w] lexicographically, carrying payloads.

    Invalid rows sort after all valid rows (regardless of key bits) — via a
    leading invalid-flag key, or, when `sentinel_ok` (no valid key can be
    all-ones, KmerSpec.sentinel_safe), by overwriting invalid rows with the
    all-ones sentinel and dropping the flag operand (one fewer sort column).

    word_bits: optional per-column significant-bit counts
    (KmerSpec.word_char_counts() × bits_per_char).  Columns with < 16
    significant bits sort as uint16 (< 8 as uint8) — a narrower
    comparator moves fewer bytes per sort pass, and narrow columns widen
    back losslessly.

    as_cols: return the sorted keys COLUMN-major (uint32[w, n], word 0
    first) instead of row-major [n, w].  lax.sort operates per column, so
    the column form skips the interleaving [n, w] stack — the layout the
    run store keeps (store.RunCountStore) so merges never de-interleave.

    Returns (sorted_words, sorted_payloads_tuple, sorted_valid).
    """
    n, w = words.shape
    _stack_keys = (lambda cols: jnp.stack(cols, axis=0)) if as_cols \
        else (lambda cols: jnp.stack(cols, axis=1))
    if valid is None:
        valid = jnp.ones((n,), dtype=bool)
    narrow = [None] * w
    if word_bits is not None:
        narrow = [_narrow_dtype(b) for b in word_bits[:w]]
        narrow += [None] * (w - len(narrow))

    def _shrink(col, dt):
        return col if dt is None else col.astype(dt)

    def _widen(col, dt, sorted_valid):
        if dt is None:
            return col
        full = col.astype(jnp.uint32)
        if sentinel_ok:
            full = jnp.where(sorted_valid, full, jnp.uint32(0xFFFFFFFF))
        return full

    if sentinel_ok:
        sent = jnp.uint32(0xFFFFFFFF)
        masked = jnp.where(valid[:, None], words, sent)
        total_valid = jnp.sum(valid.astype(jnp.int32))
        operands = tuple(
            _shrink(masked[:, j], narrow[j]) for j in range(w)
        ) + tuple(payloads)
        out = jax.lax.sort(operands, num_keys=w, is_stable=is_stable)
        sorted_valid = jnp.arange(n) < total_valid
        sorted_words = _stack_keys(
            [_widen(out[j], narrow[j], sorted_valid) for j in range(w)])
        sorted_payloads = tuple(out[w:])
        return sorted_words, sorted_payloads, sorted_valid
    invalid_key = (~valid).astype(jnp.uint32)
    operands = (invalid_key,) + tuple(
        _shrink(words[:, j], narrow[j]) for j in range(w)) + tuple(payloads)
    out = jax.lax.sort(operands, num_keys=1 + w, is_stable=is_stable)
    sorted_valid = out[0] == 0
    sorted_words = _stack_keys(
        [_widen(out[1 + j], narrow[j], sorted_valid) for j in range(w)])
    sorted_payloads = tuple(out[1 + w:])
    return sorted_words, sorted_payloads, sorted_valid


def _row_neq_prev(sorted_words: jax.Array) -> jax.Array:
    """bool[n]: row differs from previous row (row 0 -> True)."""
    prev = jnp.roll(sorted_words, 1, axis=0)
    neq = jnp.any(sorted_words != prev, axis=1)
    return neq.at[0].set(True)


def compact_runs(sorted_words: jax.Array, sorted_valid: jax.Array,
                 payloads=()):
    """Move the first row of every run of equal keys to the front, in order.

    Scatter-free: compaction is ONE more stable
    single-key sort (new-row flag) carrying the row words, each payload
    column, and the source index.  Returns
    (uniq_rows[n, w], payload_firsts, starts[n] int32 — source index of
    each compacted run head, n_unique, total_valid).
    """
    n, w = sorted_words.shape
    is_new = _row_neq_prev(sorted_words) & sorted_valid
    n_unique = jnp.sum(is_new.astype(jnp.int32))
    total_valid = jnp.sum(sorted_valid.astype(jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)
    front_key = (~is_new).astype(jnp.uint32)
    # a stable 1-key sort rather than an unstable (1+w)-key sort: the
    # comparator width costs more than stability
    ops = jax.lax.sort(
        (front_key,) + tuple(sorted_words[:, j] for j in range(w))
        + tuple(payloads) + (idx,),
        num_keys=1, is_stable=True)
    uniq = jnp.stack(ops[1:1 + w], axis=1)
    payload_firsts = tuple(ops[1 + w:-1])
    starts = ops[-1]
    return uniq, payload_firsts, starts, n_unique, total_valid


def run_weight_totals(sorted_words: jax.Array, sorted_valid: jax.Array,
                      weights: jax.Array) -> jax.Array:
    """int32[n]: per-row sum of `weights` over the row's run of equal
    keys (invalid rows contribute 0), GATHER-FREE.

    The masked inclusive prefix is nondecreasing (weights >= 0), so the
    run-start/run-end prefix values broadcast within each run by a
    cummax / reversed-cummin pair — replacing the prefix[ends] -
    prefix[starts] gathers (random gathers are latency-bound, while the
    scans stream)."""
    n = sorted_words.shape[0]
    wmask = jnp.where(sorted_valid, weights.astype(jnp.int32), 0)
    incl = jnp.cumsum(wmask)
    excl = incl - wmask
    neq_prev = _row_neq_prev(sorted_words)
    nxt = jnp.roll(sorted_words, -1, axis=0)
    neq_next = jnp.any(sorted_words != nxt, axis=1).at[n - 1].set(True)
    start = jax.lax.cummax(
        jnp.where(neq_prev, excl, jnp.int32(-2147483648)), axis=0)
    end = jax.lax.cummin(
        jnp.where(neq_next, incl, jnp.int32(2147483647))[::-1],
        axis=0)[::-1]
    return end - start


def unique_counts(sorted_words: jax.Array, sorted_valid: jax.Array,
                  sentinel: int = 0xFFFFFFFF):
    """Deduplicate sorted rows and count multiplicities.

    The tensor analog of "insert into counting hash map": after the global
    sort, each run of equal keys becomes one entry whose count is the run
    length (counting_densehash_map insert semantics,
    distributed_densehash_map.hpp:2669+).  Counts are positional
    differences between consecutive run heads — no scatter, no
    segment_sum.

    Args:
      sorted_words: uint32[n, w], valid rows sorted to the front.
      sorted_valid: bool[n].

    Returns:
      (uniq: uint32[n, w] — first n_unique rows are the distinct keys, rest
       filled with `sentinel`;
       counts: int32[n] — multiplicity per distinct key, 0 past n_unique;
       n_unique: int32 scalar).
    """
    n, w = sorted_words.shape
    uniq, _, starts, n_unique, total_valid = compact_runs(
        sorted_words, sorted_valid)
    j = jnp.arange(n, dtype=jnp.int32)
    next_start = jnp.concatenate([starts[1:], jnp.zeros(1, jnp.int32)])
    counts = jnp.where(
        j + 1 < n_unique, next_start - starts,
        jnp.where(j + 1 == n_unique, total_valid - starts, 0))
    live = j < n_unique
    uniq = jnp.where(live[:, None], uniq, jnp.uint32(sentinel))
    return uniq, counts, n_unique


def run_length_counts(sorted_words: jax.Array, sorted_valid: jax.Array):
    """Run lengths of equal sorted keys WITHOUT compaction — no second
    sort.

    `unique_counts` compacts run heads to the front with one more stable
    sort; on the ingest hot path that compaction is wasted work because the
    pending-merge buffer accepts valid-masked weighted rows in any layout.
    This emits, for the LAST row of every run, the run's length — computed
    with a single cummax scan (each row's run start) instead of a sort:
    O(n) memory traffic vs the sort's O(n · log-ish passes).

    Returns (weights int32[n], emit bool[n]): emit marks one row per
    distinct key (carrying that key in `sorted_words`), weights its
    multiplicity; both 0/False elsewhere.  Feeding (sorted_words, weights,
    emit) to `count_insert` is equivalent to feeding the compacted
    (uniq, counts) of `unique_counts`.
    """
    n, w = sorted_words.shape
    idx = jnp.arange(n, dtype=jnp.int32)
    is_new = _row_neq_prev(sorted_words) & sorted_valid
    # lax.cummax (primitive) — NOT associative_scan, whose trace-level
    # unrolling makes 16M-row compiles pathologically slow
    run_start = jax.lax.cummax(jnp.where(is_new, idx, -1), axis=0)
    next_differs = jnp.concatenate([
        jnp.any(sorted_words[1:] != sorted_words[:-1], axis=1),
        jnp.ones((1,), bool)])
    next_invalid = jnp.concatenate([~sorted_valid[1:], jnp.ones((1,), bool)])
    is_last = sorted_valid & (next_differs | next_invalid)
    weights = jnp.where(is_last, idx - run_start + 1, 0)
    return weights, is_last


def segment_reduce_sorted(sorted_words, sorted_valid, values, reduce: str = "sum"):
    """Reduce `values` over runs of equal sorted keys.

    Generalization of `unique_counts` used by reduction maps
    (reduction_densehash_map, distributed_densehash_map.hpp:2429+): counting
    is reduce="sum" over ones; de Bruijn edge accumulation is reduce="sum"
    over edge-count vectors; saturating counters clip afterwards.

    values: [n] or [n, d] aligned with sorted rows.

    Returns (uniq, reduced, n_unique) with reduced zero (or identity) past
    n_unique.
    """
    n, w = sorted_words.shape
    if reduce != "sum":
        # rare path (min/max): segment ops over cumsum-incompatible monoids
        is_new = _row_neq_prev(sorted_words) & sorted_valid
        seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        seg_c = jnp.maximum(seg, 0)
        vmask = sorted_valid if values.ndim == 1 else sorted_valid[:, None]
        if reduce == "min":
            big = jnp.iinfo(values.dtype).max if jnp.issubdtype(
                values.dtype, jnp.integer) else jnp.inf
            reduced_rows = jax.ops.segment_min(
                jnp.where(vmask, values, big), seg_c, num_segments=n)
        elif reduce == "max":
            small = jnp.iinfo(values.dtype).min if jnp.issubdtype(
                values.dtype, jnp.integer) else -jnp.inf
            reduced_rows = jax.ops.segment_max(
                jnp.where(vmask, values, small), seg_c, num_segments=n)
        else:
            raise ValueError(f"unknown reduce {reduce!r}")
        dest = jnp.where(is_new, seg, n)
        uniq = jnp.full((n + 1, w), 0xFFFFFFFF, dtype=jnp.uint32)
        uniq = uniq.at[dest].set(sorted_words)[:n]
        n_unique = jnp.sum(is_new.astype(jnp.int32))
        live = jnp.arange(n) < n_unique
        reduced = jnp.where(
            live if reduced_rows.ndim == 1 else live[:, None],
            reduced_rows, 0)
        return uniq, reduced, n_unique

    # sum: per-row run totals by gather-free broadcast scans (instead of
    # a random gather of the prefix array), carried to the front as
    # payloads of the scatter-free compaction sort
    if values.ndim == 1:
        total_cols = (run_weight_totals(sorted_words, sorted_valid,
                                        values),)
    else:
        total_cols = tuple(
            run_weight_totals(sorted_words, sorted_valid, values[:, j])
            for j in range(values.shape[1]))
    uniq, reduced_cols, _, n_unique, _ = compact_runs(
        sorted_words, sorted_valid, payloads=total_cols)
    j = jnp.arange(n, dtype=jnp.int32)
    live = j < n_unique
    uniq = jnp.where(live[:, None], uniq, jnp.uint32(0xFFFFFFFF))
    if values.ndim == 1:
        reduced = jnp.where(live, reduced_cols[0], 0).astype(values.dtype)
    else:
        reduced = jnp.where(
            live[:, None],
            jnp.stack(reduced_cols, axis=1), 0).astype(values.dtype)
    return uniq, reduced, n_unique


def _lex_less_rows(a: jax.Array, b: jax.Array) -> jax.Array:
    """Row-wise a < b for uint32[..., w] (shared elementwise fold)."""
    from .packing import lex_less
    return lex_less(a, b)


# ------------------------------------------------------------------ merging
# The deferred-merge flush of the count index works on data that is ALREADY
# sorted (each ingest chunk leaves the sorter sorted; the store is sorted by
# invariant).  Re-sorting store+batch from scratch costs O(log^2 n) HBM
# passes; a bitonic MERGE of
# two sorted runs needs only log2(n) compare-exchange stages of elementwise
# work — the "cheaper network" replacing mxx-style merge loops
# (distributed_sorted_map.hpp:2061 merges rank-sorted runs the same way).

def bitonic_merge(keys: jax.Array, payloads=()):
    """Sort a BITONIC sequence of rows (ascending prefix + descending
    suffix) with log2(n) half-cleaner stages.

    keys: uint32[n, w] with n a power of two; payloads: tuple of [n]
    arrays carried through the exchanges.  Not stable (ties may reorder) —
    callers that need stability must extend the key.

    Returns (sorted_keys, payloads_tuple).
    """
    n, w = keys.shape
    assert n & (n - 1) == 0, "bitonic_merge needs power-of-two length"
    # flat 1-D columns with XOR-partner indexing: at distance d the partner
    # of i is i ^ d, fetched with two rolls + a lane select.  (The naive
    # [g, 2, d, w] reshape gives tiny trailing dims that XLA may pad to
    # its tile width.)
    cols = tuple(keys[:, j] for j in range(w)) + tuple(payloads)
    idx = jnp.arange(n, dtype=jnp.int32)
    nstages = n.bit_length() - 1  # log2(n)

    # one stage per fori_loop iteration (dynamic distance d) so XLA reuses
    # the stage buffers — a fully unrolled network keeps every stage's
    # temporaries live simultaneously
    def stage(s, cols):
        d = jnp.int32(n) >> (s + 1)
        is_lo = (idx & d) == 0
        partner = tuple(jnp.where(is_lo, jnp.roll(c, -d), jnp.roll(c, d))
                        for c in cols)
        # lex compare of (this row) vs (partner row) on the key columns
        less = jnp.zeros(n, bool)
        gt = jnp.zeros(n, bool)
        for j in reversed(range(w)):
            a, b = cols[j], partner[j]
            less = jnp.where(a != b, a < b, less)
            gt = jnp.where(a != b, a > b, gt)
        # lo keeps min, hi keeps max; ties keep own value on both sides
        take_partner = jnp.where(is_lo, gt, less)
        return tuple(jnp.where(take_partner, p, c)
                     for c, p in zip(cols, partner))

    cols = jax.lax.fori_loop(0, nstages, stage, cols)
    keys = jnp.stack(cols[:w], axis=1)
    return keys, tuple(cols[w:])


def merge_sorted_runs(a_keys: jax.Array, a_payloads, b_keys: jax.Array,
                      b_payloads, sentinel: int = 0xFFFFFFFF):
    """Merge two ASCENDING sorted runs into one ascending run.

    Each run is uint32[n_i, w] rows (duplicates fine, sentinel-padded tails
    fine — sentinels keep sorting to the tail) with aligned payload columns.
    The total is padded to the next power of two with sentinel rows
    (payloads 0) — harmless under the run-store convention that padding
    rows carry weight 0.

    Returns (keys [n, w], payloads) with n = next_pow2(n_a + n_b).
    """
    w = a_keys.shape[1]
    na, nb = a_keys.shape[0], b_keys.shape[0]
    total = na + nb
    n = 1 << max(1, (total - 1).bit_length())
    pad = n - total
    if pad:
        b_keys = jnp.concatenate(
            [b_keys, jnp.full((pad, w), sentinel, jnp.uint32)], axis=0)
        b_payloads = tuple(
            jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
            for p in b_payloads)
    keys = jnp.concatenate([a_keys, b_keys[::-1]], axis=0)
    payloads = tuple(jnp.concatenate([pa, pb[::-1]])
                     for pa, pb in zip(a_payloads, b_payloads))
    return bitonic_merge(keys, payloads)


def bitonic_merge_cols(kcols: jax.Array, payloads=()):
    """`bitonic_merge` over COLUMN-major keys: kcols uint32[w, n] (word 0
    most significant), n a power of two.  Returns ([w, n], payloads)."""
    w, n = kcols.shape
    assert n & (n - 1) == 0, "bitonic_merge needs power-of-two length"
    cols = tuple(kcols[j] for j in range(w)) + tuple(payloads)
    idx = jnp.arange(n, dtype=jnp.int32)
    nstages = n.bit_length() - 1

    def stage(s, cols):
        d = jnp.int32(n) >> (s + 1)
        is_lo = (idx & d) == 0
        partner = tuple(jnp.where(is_lo, jnp.roll(c, -d), jnp.roll(c, d))
                        for c in cols)
        less = jnp.zeros(n, bool)
        gt = jnp.zeros(n, bool)
        for j in reversed(range(w)):
            a, b = cols[j], partner[j]
            less = jnp.where(a != b, a < b, less)
            gt = jnp.where(a != b, a > b, gt)
        take_partner = jnp.where(is_lo, gt, less)
        return tuple(jnp.where(take_partner, p, c)
                     for c, p in zip(cols, partner))

    cols = jax.lax.fori_loop(0, nstages, stage, cols)
    return jnp.stack(cols[:w], axis=0), tuple(cols[w:])


def merge_sorted_runs_cols(a_kcols: jax.Array, a_payloads,
                           b_kcols: jax.Array, b_payloads,
                           sentinel: int = 0xFFFFFFFF):
    """`merge_sorted_runs` over COLUMN-major runs (the run store's native
    layout): each run is uint32[w, n_i] key columns plus aligned [n_i]
    payloads.  Column layout keeps every merge operand a long contiguous
    [n] vector — no interleaved [n, w] extract/stack around the merge
    network.

    Returns (kcols [w, n], payloads) with n = next_pow2(n_a + n_b).
    """
    w, na = a_kcols.shape
    nb = b_kcols.shape[1]
    total = na + nb
    n = 1 << max(1, (total - 1).bit_length())
    pad = n - total
    if pad:
        b_kcols = jnp.concatenate(
            [b_kcols, jnp.full((w, pad), sentinel, jnp.uint32)], axis=1)
        b_payloads = tuple(
            jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
            for p in b_payloads)
    # reversed b makes a+b bitonic; XLA fuses the flip into the concat copy
    kcols = jnp.concatenate([a_kcols, b_kcols[:, ::-1]], axis=1)
    payloads = tuple(jnp.concatenate([pa, pb[::-1]])
                     for pa, pb in zip(a_payloads, b_payloads))
    return bitonic_merge_cols(kcols, payloads)


def lookup_join_runs(keys: jax.Array, csum: jax.Array,
                     queries: jax.Array) -> jax.Array:
    """Batched count lookup over a RUN store (sorted keys with duplicates,
    exclusive prefix-sum `csum` of the per-row weights): count(q) = total
    weight of q's key run.  Gather-free sort-merge join, the run-store
    analog of `lookup_join` — store rows enter with their csum values and
    each query reads (csum at its position) - (csum at its run start) via
    two cumulative-max scans.

    keys: uint32[cap, w] sorted over ALL rows; csum: int32[cap + 1] with
    csum[i] = sum(weights[:i]).  queries: uint32[m, w].  Returns int32[m].
    """
    cap, w = keys.shape
    m = queries.shape[0]
    total = cap + m
    q = queries.astype(jnp.uint32)

    all_words = jnp.concatenate([keys, q], axis=0)
    # store rows flag 0 (sort before queries of the same key), queries 1
    flag = jnp.concatenate([jnp.zeros(cap, jnp.uint32),
                            jnp.ones(m, jnp.uint32)])
    # store row i contributes weight csum[i+1]-csum[i]; queries 0
    wts = jnp.concatenate([csum[1:] - csum[:-1], jnp.zeros(m, jnp.int32)])
    qidx = jnp.concatenate([
        jnp.zeros(cap, jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    ops = jax.lax.sort(
        tuple(all_words[:, j] for j in range(w)) + (flag, wts, qidx),
        num_keys=w + 1, is_stable=True)
    s_cols = ops[:w]
    s_wts, s_qidx = ops[w + 1], ops[w + 2]
    s_flag = ops[w]

    idx = jnp.arange(total, dtype=jnp.int32)
    neq_prev = jnp.zeros(total, bool).at[0].set(True)
    for j in range(w):
        neq_prev = neq_prev | (s_cols[j] != jnp.roll(s_cols[j], 1))
    psum_incl = jnp.cumsum(s_wts)
    psum_excl = psum_incl - s_wts
    # csum value at each row's run start (psum_excl is nondecreasing in
    # total-weight terms only when weights >= 0; erased rows are 0 and
    # explicit negative counts are excluded from the join path by api)
    start_excl = jax.lax.cummax(
        jnp.where(neq_prev, psum_excl, jnp.int32(-2147483648)), axis=0)
    counts = jnp.where(s_flag == 1, psum_incl - start_excl, 0)

    back = jax.lax.sort((jnp.uint32(1) - s_flag, s_qidx.astype(jnp.uint32),
                         counts), num_keys=2, is_stable=True)
    return back[2][:m]


def lookup_join_runs_cols(kcols: jax.Array, csum: jax.Array,
                          queries: jax.Array) -> jax.Array:
    """`lookup_join_runs` over COLUMN-major store keys (uint32[w, cap]);
    queries stay row-major [m, w].  The store-side operands feed the sort
    as the contiguous columns they already are."""
    w, cap = kcols.shape
    m = queries.shape[0]
    total = cap + m
    q = queries.astype(jnp.uint32)

    all_cols = tuple(jnp.concatenate([kcols[j], q[:, j]]) for j in range(w))
    flag = jnp.concatenate([jnp.zeros(cap, jnp.uint32),
                            jnp.ones(m, jnp.uint32)])
    wts = jnp.concatenate([csum[1:] - csum[:-1], jnp.zeros(m, jnp.int32)])
    qidx = jnp.concatenate([
        jnp.zeros(cap, jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    ops = jax.lax.sort(all_cols + (flag, wts, qidx),
                       num_keys=w + 1, is_stable=True)
    s_cols, s_flag = ops[:w], ops[w]
    s_wts, s_qidx = ops[w + 1], ops[w + 2]

    neq_prev = jnp.zeros(total, bool).at[0].set(True)
    for j in range(w):
        neq_prev = neq_prev | (s_cols[j] != jnp.roll(s_cols[j], 1))
    psum_incl = jnp.cumsum(s_wts)
    psum_excl = psum_incl - s_wts
    start_excl = jax.lax.cummax(
        jnp.where(neq_prev, psum_excl, jnp.int32(-2147483648)), axis=0)
    counts = jnp.where(s_flag == 1, psum_incl - start_excl, 0)

    back = jax.lax.sort((jnp.uint32(1) - s_flag, s_qidx.astype(jnp.uint32),
                         counts), num_keys=2, is_stable=True)
    return back[2][:m]


def _bsearch(keys: jax.Array, size: jax.Array, queries: jax.Array, side: str):
    """Batched binary search over sorted rows.

    keys: uint32[cap, w] sorted ascending in the first `size` rows.
    queries: uint32[m, w].
    Returns int32[m] insertion indices (lower or upper bound).

    Vectorized manual binary search (jnp.searchsorted has no multiword
    keys): ceil(log2(cap))+1 rounds, each a gather of m rows + row
    compare — all elementwise work, the batched analog of sorted_map's splitter/binary-search
    queries (distributed_sorted_map.hpp:1568-1600).
    """
    cap = keys.shape[0]
    m = queries.shape[0]
    # derive the zero from `size` so the carry has the same varying-axis
    # type as the data when running inside shard_map (see shard-map vma docs)
    zero = jnp.asarray(size, jnp.int32) * 0
    lo = jnp.zeros((m,), jnp.int32) + zero
    hi = jnp.broadcast_to(jnp.asarray(size, jnp.int32), (m,)) + zero
    steps = max(1, cap.bit_length())

    def body(_, lohi):
        lo, hi = lohi
        active = lo < hi
        mid = (lo + hi) >> 1
        kmid = keys[jnp.clip(mid, 0, cap - 1)]
        if side == "left":
            go_right = _lex_less_rows(kmid, queries)
        else:
            go_right = ~_lex_less_rows(queries, kmid)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps + 1, body, (lo, hi))
    return lo


def lower_bound(keys, size, queries):
    return _bsearch(keys, size, queries, side="left")


def upper_bound(keys, size, queries):
    return _bsearch(keys, size, queries, side="right")


def _bsearch_cols(kcols: jax.Array, size, queries: jax.Array, side: str):
    """`_bsearch` over COLUMN-major store keys (uint32[w, cap]); queries
    stay row-major [m, w] (the API shape).  The per-round gather fetches
    one [m] slice per word column — long-vector gathers instead of [m, w]
    row gathers."""
    w, cap = kcols.shape
    m = queries.shape[0]
    q_cols = tuple(queries[:, j].astype(jnp.uint32) for j in range(w))
    zero = jnp.asarray(size, jnp.int32) * 0
    lo = jnp.zeros((m,), jnp.int32) + zero
    hi = jnp.broadcast_to(jnp.asarray(size, jnp.int32), (m,)) + zero
    steps = max(1, cap.bit_length())

    def body(_, lohi):
        lo, hi = lohi
        active = lo < hi
        mid = (lo + hi) >> 1
        midc = jnp.clip(mid, 0, cap - 1)
        # ONE [w, m] gather for all word columns instead of separate
        # per-column 1-D gathers of the same indices
        kmid = kcols[:, midc]
        less = jnp.zeros(m, bool)   # kmid < q
        gt = jnp.zeros(m, bool)     # kmid > q
        for j in reversed(range(w)):
            kj = kmid[j]
            less = jnp.where(kj != q_cols[j], kj < q_cols[j], less)
            gt = jnp.where(kj != q_cols[j], kj > q_cols[j], gt)
        go_right = less if side == "left" else ~gt
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps + 1, body, (lo, hi))
    return lo


def lower_bound_cols(kcols, size, queries):
    return _bsearch_cols(kcols, size, queries, side="left")


def upper_bound_cols(kcols, size, queries):
    return _bsearch_cols(kcols, size, queries, side="right")


def _bsearch_rounds(kcols_or_rows, queries, lo, hi, side, cols: bool):
    """Shared bsearch refinement: run compare-exchange rounds from the
    given (lo, hi) until EVERY query converges (while_loop — the round
    count adapts to the actual range widths, so a bucketed start pays
    only ~log2(bucket) gather rounds instead of log2(cap))."""
    if cols:
        w, cap = kcols_or_rows.shape
    else:
        cap, w = kcols_or_rows.shape
    m = queries.shape[0]
    q_cols = tuple(queries[:, j].astype(jnp.uint32) for j in range(w))

    def round_(lo, hi):
        active = lo < hi
        mid = (lo + hi) >> 1
        midc = jnp.clip(mid, 0, cap - 1)
        kmid = kcols_or_rows[:, midc] if cols else kcols_or_rows[midc].T
        less = jnp.zeros(m, bool)
        gt = jnp.zeros(m, bool)
        for j in reversed(range(w)):
            kj = kmid[j]
            less = jnp.where(kj != q_cols[j], kj < q_cols[j], less)
            gt = jnp.where(kj != q_cols[j], kj > q_cols[j], gt)
        go_right = less if side == "left" else ~gt
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    return jax.lax.while_loop(
        lambda s: jnp.any(s[0] < s[1]),
        lambda s: round_(*s), (lo, hi))[0]


def _prefix_starts(hi_word: jax.Array, tbits: int) -> jax.Array:
    """int32[2^tbits + 1] bucket table over a SORTED most-significant
    word column: starts[b] = first row whose top tbits >= b."""
    buck = (hi_word >> jnp.uint32(32 - tbits)).astype(jnp.int32)
    probes = jnp.arange((1 << tbits) + 1, dtype=jnp.int32)
    return jnp.searchsorted(buck, probes, side="left").astype(jnp.int32)


def lower_bound_cols_bucketed(kcols: jax.Array, size, queries: jax.Array,
                              tbits: int = 16):
    """`lower_bound_cols` seeded by a 2^tbits-entry prefix-bucket table
    (the reference's splitter idea applied locally): the search starts at
    the query's top-tbits bucket bounds, so the expected gather rounds
    drop from log2(cap) to ~log2(cap / 2^tbits); a while_loop keeps it
    correct for arbitrarily skewed buckets.  Searches the FULL cap rows
    like lower_bound_cols with size == cap (the run store's invariant:
    the sentinel tail is sorted too)."""
    w, cap = kcols.shape
    m = queries.shape[0]
    starts = _prefix_starts(kcols[0], tbits)
    b = (queries[:, 0].astype(jnp.uint32)
         >> jnp.uint32(32 - tbits)).astype(jnp.int32)
    # one fused [2, m] gather of (bucket start, bucket end)
    t2 = jnp.stack([starts[:-1], starts[1:]], axis=0)
    g = t2[:, b]
    zero = jnp.asarray(size, jnp.int32) * 0
    lo = g[0] + zero
    hi = g[1] + zero
    return _bsearch_rounds(kcols, queries, lo, hi, "left", cols=True)


def lower_bound_cols_prebuilt(ext: jax.Array, w: int, bstart: jax.Array,
                              queries: jax.Array):
    """`lower_bound_cols_bucketed` with PREBUILT per-store metadata (the
    round-5 query-aux cache): `ext` is uint32[w + extra, cap] whose first
    w rows are the sorted key columns (extra rows ride along for the
    caller's fused bound gather), `bstart` the int32[2^16 + 1] prefix
    starts.  The per-call O(cap) table build disappears — queries pay
    only the seeded refinement rounds."""
    tbits = 16
    b = (queries[:, 0].astype(jnp.uint32)
         >> jnp.uint32(32 - tbits)).astype(jnp.int32)
    t2 = jnp.stack([bstart[:-1], bstart[1:]], axis=0)
    g = t2[:, b]
    zero = jnp.asarray(bstart[-1], jnp.int32) * 0
    lo = g[0] + zero
    hi = g[1] + zero
    return _bsearch_rounds(ext[:w], queries, lo, hi, "left", cols=True)


def lower_bound_bucketed(keys: jax.Array, size, queries: jax.Array,
                         tbits: int = 16):
    """Row-major twin of `lower_bound_cols_bucketed` — searches the live
    [0, size) rows with a bucket-seeded start.  Rows >= size must hold
    the all-ones sentinel (every store's invariant), so clipping the
    bucket bounds to `size` preserves the lower_bound result."""
    cap, w = keys.shape
    starts = _prefix_starts(keys[:, 0], tbits)
    b = (queries[:, 0].astype(jnp.uint32)
         >> jnp.uint32(32 - tbits)).astype(jnp.int32)
    t2 = jnp.stack([starts[:-1], starts[1:]], axis=0)
    g = t2[:, b]
    size_i = jnp.asarray(size, jnp.int32)
    lo = jnp.minimum(g[0], size_i)
    hi = jnp.minimum(g[1], size_i)
    return _bsearch_rounds(keys, queries, lo, hi, "left", cols=False)


def rows_equal_at(keys: jax.Array, idx: jax.Array, queries: jax.Array,
                  size: jax.Array) -> jax.Array:
    """bool[m]: keys[idx] == queries and idx < size (i.e. query present)."""
    cap = keys.shape[0]
    rows = keys[jnp.clip(idx, 0, cap - 1)]
    return (idx < size) & jnp.all(rows == queries, axis=-1)


def lookup_join_vals(keys: jax.Array, size: jax.Array, vals: tuple,
                     queries: jax.Array):
    """Generalized `lookup_join`: gather-free batched lookup over a
    unique-key store carrying ANY number of 32-bit value columns
    (the kv map's (hi, lo), the vec map's d counters).

    vals: tuple of [cap] arrays (uint32/int32; float32 callers bitcast).
    Returns (matched: tuple of [m] columns, 0 where missing;
    found bool[m]) in original query order.  Same crossover rationale as
    `lookup_join` (the m*8 >= cap rule): two sorts + scans + ONE fused row
    gather replace log2(cap) gather rounds.
    """
    cap, w = keys.shape
    m = queries.shape[0]
    total = cap + m
    q = queries.astype(jnp.uint32)

    all_words = jnp.concatenate([keys, q], axis=0)
    store_flag = jnp.where(jnp.arange(cap) < jnp.asarray(size, jnp.int32),
                           jnp.uint32(0), jnp.uint32(2))
    flag = jnp.concatenate([store_flag, jnp.ones(m, jnp.uint32)])
    vcols = tuple(
        jnp.concatenate([jax.lax.bitcast_convert_type(v, jnp.uint32),
                         jnp.zeros(m, jnp.uint32)]) for v in vals)
    qidx = jnp.concatenate([
        jnp.zeros(cap, jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    ops = jax.lax.sort(
        tuple(all_words[:, j] for j in range(w)) + (flag,) + vcols + (qidx,),
        num_keys=w + 1, is_stable=True)
    s_cols = ops[:w]
    s_flag = ops[w]
    s_vals = ops[w + 1:w + 1 + len(vals)]
    s_qidx = ops[-1]
    is_store = s_flag == 0

    idx = jnp.arange(total, dtype=jnp.int32)
    neq_prev = jnp.zeros(total, bool).at[0].set(True)
    for j in range(w):
        neq_prev = neq_prev | (s_cols[j] != jnp.roll(s_cols[j], 1))
    run_start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    last_store = jax.lax.cummax(jnp.where(is_store, idx, -1), axis=0)
    match = (s_flag == 1) & (last_store >= run_start)
    # ONE fused row gather of every value column (instead of separate
    # 1-D gathers of the same indices)
    ext = jnp.stack(s_vals, axis=1)
    g = ext[jnp.clip(last_store, 0, total - 1)]
    matched = tuple(jnp.where(match, g[:, c], 0)
                    for c in range(len(vals)))

    back = jax.lax.sort(
        (jnp.uint32(1) - s_flag, s_qidx.astype(jnp.uint32))
        + matched + (match.astype(jnp.uint32),),
        num_keys=2, is_stable=True)
    out = tuple(jax.lax.bitcast_convert_type(back[2 + c][:m], v.dtype)
                for c, v in enumerate(vals))
    return out, back[-1][:m] != 0


def lookup_join_ranges(keys: jax.Array, size: jax.Array,
                       queries: jax.Array):
    """Gather-free (lo, hi) run ranges per query over a sorted MULTIMAP
    store (duplicates allowed) — the large-batch twin of
    `store.multi_lookup_ranges`.

    Because the store's live rows are globally sorted and the join sort is
    stable, the i-th live store row in the joined order is store row i; a
    cumulative count of live store rows therefore yields store INDICES
    directly: lo = count of live rows before the query's key run,
    hi = count up to the query's position (store rows of the run sort
    before the query by flag).  Returns (lo int32[m], hi int32[m]) with
    hi == lo for absent keys — valid inputs for `store.multi_gather`.
    """
    cap, w = keys.shape
    m = queries.shape[0]
    total = cap + m
    q = queries.astype(jnp.uint32)

    all_words = jnp.concatenate([keys, q], axis=0)
    store_flag = jnp.where(jnp.arange(cap) < jnp.asarray(size, jnp.int32),
                           jnp.uint32(0), jnp.uint32(2))
    flag = jnp.concatenate([store_flag, jnp.ones(m, jnp.uint32)])
    qidx = jnp.concatenate([
        jnp.zeros(cap, jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    ops = jax.lax.sort(
        tuple(all_words[:, j] for j in range(w)) + (flag, qidx),
        num_keys=w + 1, is_stable=True)
    s_cols, s_flag, s_qidx = ops[:w], ops[w], ops[w + 1]
    is_store = (s_flag == 0).astype(jnp.int32)
    csum_incl = jnp.cumsum(is_store)
    csum_excl = csum_incl - is_store
    neq_prev = jnp.zeros(total, bool).at[0].set(True)
    for j in range(w):
        neq_prev = neq_prev | (s_cols[j] != jnp.roll(s_cols[j], 1))
    # live-store-row count at each run's start (nondecreasing -> cummax)
    start_c = jax.lax.cummax(
        jnp.where(neq_prev, csum_excl, jnp.int32(-2147483648)), axis=0)
    lo = start_c
    hi = csum_incl  # at a query position: all live rows of its run counted

    back = jax.lax.sort((jnp.uint32(1) - s_flag, s_qidx.astype(jnp.uint32),
                         lo, hi), num_keys=2, is_stable=True)
    return back[2][:m], back[3][:m]


def lookup_join(keys: jax.Array, size: jax.Array, vals: jax.Array,
                queries: jax.Array) -> jax.Array:
    """Gather-free batched lookup: value per query key (0 if absent).

    For large query batches the log2(cap) gather rounds of `lower_bound`
    dominate (each round is a dependent random gather); this sort-merge
    join answers ALL
    queries with two sorts, two cumulative-max scans and a single gather —
    the accelerator form of the reference's fused scatter_compute_gather
    query pattern (incremental_mxx.hpp:1376-1806):

      1. concatenate store rows (flag 0), query rows (flag 1), and store
         PADDING rows (rows >= size, flag 2), sort by (key words, flag) —
         equal keys group, live store row first;
      2. cummax of "last key-run start" and "last store-row position": a
         query matches iff a store row exists inside its own key run;
      3. one gather fetches the matched store values; a second sort by
         (flag, original index) restores query order.

    Padding rows get flag 2 (not 0) so that when the store's sentinel key
    pattern is also a REAL k-mer (``KmerSpec.sentinel_safe`` False, e.g.
    k=16 DNA poly-T), the zero-valued padding rows can never shadow the
    live row of the same key — they sort after the queries in the run and
    are excluded from `is_store`.

    keys/vals: store arrays ([cap, w], [cap]) with live rows in [0, size).
    queries: [m, w].  Returns int32[m].
    """
    cap, w = keys.shape
    m = queries.shape[0]
    total = cap + m
    q = queries.astype(jnp.uint32)

    all_words = jnp.concatenate([keys, q], axis=0)
    store_flag = jnp.where(jnp.arange(cap) < jnp.asarray(size, jnp.int32),
                           jnp.uint32(0), jnp.uint32(2))
    flag = jnp.concatenate([store_flag, jnp.ones(m, jnp.uint32)])
    vcol = jnp.concatenate([vals.astype(jnp.int32), jnp.zeros(m, jnp.int32)])
    qidx = jnp.concatenate([
        jnp.zeros(cap, jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    ops = jax.lax.sort(
        tuple(all_words[:, j] for j in range(w)) + (flag, vcol, qidx),
        num_keys=w + 1, is_stable=True)
    s_cols = ops[:w]
    s_flag, s_val, s_qidx = ops[w], ops[w + 1], ops[w + 2]
    is_store = s_flag == 0

    idx = jnp.arange(total, dtype=jnp.int32)
    neq_prev = jnp.zeros(total, bool).at[0].set(True)
    for j in range(w):
        neq_prev = neq_prev | (s_cols[j] != jnp.roll(s_cols[j], 1))
    run_start = jax.lax.cummax(jnp.where(neq_prev, idx, -1), axis=0)
    last_store = jax.lax.cummax(jnp.where(is_store, idx, -1), axis=0)
    match = (~is_store) & (last_store >= run_start)
    matched_val = s_val[jnp.clip(last_store, 0, total - 1)]
    result = jnp.where(match, matched_val, 0)

    back = jax.lax.sort((jnp.uint32(1) - s_flag, s_qidx.astype(jnp.uint32),
                         result), num_keys=2, is_stable=True)
    return back[2][:m]

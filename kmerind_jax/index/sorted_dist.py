"""Range-partitioned (sorted) distributed index: samplesort flush +
splitter-routed queries.

Sharded rebuild of the reference's SECOND distribution strategy — the
sorted distributed maps (/root/reference/src/containers/
distributed_sorted_map.hpp: `sorted_map` :1407, `sorted_multimap` :2333,
`counting_sorted_map` :2825).  Where the hash strategy owns keys by
``hash(key) % p``, here shard i owns the contiguous key range
[splitter[i-1], splitter[i]):

* **flush** (the reference's lazy global sort on first query,
  distributed_sorted_map.hpp:341,940,2061): local sort → p-quantile
  samples → all_gather → global splitters → route rows by splitter →
  local sort + merge of received runs.  The result is *globally* sorted:
  every key on shard i precedes every key on shard i+1.
* **query routing** (splitter binary search,
  distributed_sorted_map.hpp:1568-1600): owner(q) = number of splitters
  <= q, then the same dense-bucket all_to_all as the hash strategy.

Splitters are computed identically on every shard (post-allgather), so the
step outputs them stacked [p, p-1, w]; the host keeps them for query
routing.  All steps are pure jitted `shard_map` programs mirroring
`distributed.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import sortops
from ..parallel import distribute as dist
from ..parallel.mesh import axes_of
from . import store as st

__all__ = [
    "owners_from_splitters",
    "make_count_flush_step",
    "make_count_query_step",
    "make_count_erase_step",
    "make_multi_flush_step",
    "make_multi_count_step",
    "make_multi_find_step",
    "make_multi_erase_step",
]

_SENT = jnp.uint32(0xFFFFFFFF)


def _unstack(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _stack(tree):
    return jax.tree.map(lambda a: a[None], tree)


def owners_from_splitters(words: jax.Array, splitters: jax.Array,
                          nparts: int) -> jax.Array:
    """Destination shard per key row: #splitters <= key — the batched form
    of the reference's splitter binary search
    (distributed_sorted_map.hpp:1568-1600)."""
    from ..ops.packing import lex_less
    owner = jnp.zeros(words.shape[:-1], jnp.int32)
    for si in range(nparts - 1):
        sp = jnp.broadcast_to(splitters[si], words.shape)
        owner = owner + jnp.where(lex_less(words, sp), 0, 1)
    return owner


def _global_splitters(s_words, s_valid, nparts: int, oversample: int,
                      axes="shards"):
    """Evenly-spaced local samples → allgather → p-1 global splitters.

    Shards with fewer valid rows than samples contribute sentinel rows
    (sort last) instead of garbage, so splitters stay unbiased."""
    n = s_words.shape[0]
    total_valid = jnp.sum(s_valid.astype(jnp.int32))
    j = jnp.arange(oversample, dtype=jnp.int32)
    pos = jnp.clip(((j + 1) * total_valid) // (oversample + 1), 0, n - 1)
    samples = jnp.where((pos < total_valid)[:, None], s_words[pos], _SENT)
    all_samples = jax.lax.all_gather(
        samples, axes, axis=0, tiled=True)  # [p*oversample, w]
    g_sorted, _, _ = sortops.sort_rows(all_samples, ())
    m = nparts * oversample
    if nparts > 1:
        spos = jnp.clip(((jnp.arange(nparts - 1) + 1) * m) // nparts,
                        0, m - 1)
    else:
        spos = jnp.zeros((0,), jnp.int32)
    return g_sorted[spos]  # [p-1, w]


def make_count_flush_step(mesh: Mesh, nparts: int, capacity: int,
                          saturate: int | None = None,
                          sentinel_ok: bool = False, oversample: int = 64):
    """Jitted: (words[p,n,w], weights[p,n], valid[p,n]) ->
    (new_stores [p, p*capacity ...], splitters[p, p-1, w], overflow[p]).

    The whole-index rebuild of counting_sorted_map's lazy sort
    (distributed_sorted_map.hpp:2061 global mxx::sort + local merge): the
    inputs are ALL live rows (store contents as weighted rows + pending
    inserts); the output store is globally range-partitioned and locally
    compacted."""

    def body(words_blk, weights_blk, valid_blk):
        words, weights, valid = words_blk[0], weights_blk[0], valid_blk[0]
        s_words, _, s_valid = sortops.sort_rows(
            words, (), valid, is_stable=False, sentinel_ok=sentinel_ok)
        splitters = _global_splitters(s_words, s_valid, nparts, oversample,
                                      axes_of(mesh))
        owner = owners_from_splitters(words, splitters, nparts)
        (rw, rwts), rvalid, route = dist.distribute(
            (words, weights), owner, valid, nparts, capacity, axes_of(mesh))
        s2, (v2,), sv2 = sortops.sort_rows(
            rw, (rwts,), rvalid, is_stable=False, sentinel_ok=sentinel_ok)
        uniq, red, n_unique = sortops.segment_reduce_sorted(s2, sv2, v2)
        if saturate is not None:
            red = jnp.minimum(red, saturate)
        store = st.CountStore(keys=uniq, counts=red, size=n_unique)
        return _stack(store), splitters[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_count_query_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted: (stores, splitters[p, p-1, w], queries[p,m,w], qvalid[p,m])
    -> (counts[p,m], overflow[p]) — splitter-routed count
    (the sorted-map query path, distributed_sorted_map.hpp:1568-1600)."""

    def body(stores_blk, split_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_from_splitters(queries, splitters, nparts)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        local = jnp.where(rvalid, st.count_lookup(store, rq), 0)
        (back,) = dist.undistribute(
            (local,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_count_erase_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted splitter-routed erase: (stores, splitters, keys, valid) ->
    (new_stores, n_erased[p], overflow[p]).  Erasing never moves keys
    between shards, so splitters stay valid."""

    def body(stores_blk, split_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_from_splitters(keys, splitters, nparts)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.count_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_multi_flush_step(mesh: Mesh, nparts: int, capacity: int,
                          oversample: int = 64):
    """Jitted sorted-multimap rebuild: (words, hi, lo, qbits, valid) ->
    (new_stores, splitters, overflow) — sorted_multimap's global sort
    (distributed_sorted_map.hpp:2333+); duplicates kept."""

    def body(words_blk, hi_blk, lo_blk, q_blk, valid_blk):
        words, vhi, vlo, vq, valid = (
            words_blk[0], hi_blk[0], lo_blk[0], q_blk[0], valid_blk[0])
        s_words, _, s_valid = sortops.sort_rows(words, (), valid,
                                                is_stable=False)
        splitters = _global_splitters(s_words, s_valid, nparts, oversample,
                                      axes_of(mesh))
        owner = owners_from_splitters(words, splitters, nparts)
        qbits = jax.lax.bitcast_convert_type(vq, jnp.uint32)
        (rw, rhi, rlo, rqb), rvalid, route = dist.distribute(
            (words, vhi, vlo, qbits), owner, valid, nparts, capacity,
            axes_of(mesh))
        s2, (shi, slo, sqb), sv2 = sortops.sort_rows(
            rw, (rhi, rlo, rqb), rvalid)
        total = jnp.sum(sv2.astype(jnp.int32))
        store = st.MultiStore(
            keys=jnp.where(sv2[:, None], s2, _SENT),
            val_hi=shi,
            val_lo=slo,
            val_q=jax.lax.bitcast_convert_type(sqb, jnp.float32),
            size=total,
        )
        return _stack(store), splitters[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 5,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_multi_count_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted splitter-routed multimap multiplicity query."""

    def body(stores_blk, split_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_from_splitters(queries, splitters, nparts)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        local = jnp.where(rvalid, st.multi_count(store, rq), 0)
        (back,) = dist.undistribute(
            (local,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_multi_find_step(mesh: Mesh, nparts: int, capacity: int,
                         max_per_query: int):
    """Jitted splitter-routed multimap find (same reply contract as the
    hash strategy's find step, incl. true multiplicity counts)."""

    def body(stores_blk, split_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_from_splitters(queries, splitters, nparts)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        lo, hi = st.multi_lookup_ranges(store, rq)
        hi = jnp.where(rvalid, hi, lo)
        vhi, vlo, vq, mask = st.multi_gather(store, lo, hi, max_per_query)
        qbits = jax.lax.bitcast_convert_type(vq, jnp.uint32)
        back_hi, back_lo, back_q, back_mask, back_n = dist.undistribute(
            (vhi, vlo, qbits, mask.astype(jnp.int8), hi - lo), route, nparts,
            capacity, axes_of(mesh))
        return (back_hi[None], back_lo[None],
                jax.lax.bitcast_convert_type(back_q, jnp.float32)[None],
                back_mask.astype(bool)[None], back_n[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_multi_erase_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted splitter-routed multimap erase-by-key."""

    def body(stores_blk, split_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_from_splitters(keys, splitters, nparts)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.multi_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_local_ingest_step(mesh: Mesh, spec, canonical: bool):
    """Jitted shard-LOCAL extraction + pre-reduction (NO exchange): the
    sorted strategy's insert is append-local, sort-on-flush
    (distributed_sorted_map.hpp:341 inserts append + mark unsorted).
    Returns (words[p,n,w], weights[p,n], emit[p,n])."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples

    def body(codes_blk, valid_blk, owned_blk, seg_blk):
        codes, valid, owned, seg = (
            codes_blk[0], valid_blk[0], owned_blk[0], seg_blk[0])
        bases = DeviceBases(
            codes=codes, valid=valid, owned=owned, seg_id=seg,
            id_hi=jnp.zeros_like(codes, jnp.uint32),
            id_lo=jnp.zeros_like(codes, jnp.uint32),
            qual=jnp.zeros_like(codes),
        )
        tup = extract_tuples(bases, spec, canonical=canonical)
        s_words, _, s_valid = sortops.sort_rows(
            tup.words, (), tup.valid, is_stable=False,
            sentinel_ok=spec.sentinel_safe)
        weights, emit = sortops.run_length_counts(s_words, s_valid)
        return s_words[None], weights[None], emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_multi_local_ingest_step(mesh: Mesh, spec, canonical: bool,
                                 with_quality: bool = False, codec=None):
    """Jitted shard-local multimap extraction (no exchange, no reduction):
    returns (words, hi, lo, q, valid) stacked [p, n, ...]."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples
    from ..quality import ILLUMINA18

    codec = codec if codec is not None else ILLUMINA18

    def body(codes_blk, valid_blk, owned_blk, seg_blk, hi_blk, lo_blk,
             qual_blk):
        bases = DeviceBases(
            codes=codes_blk[0], valid=valid_blk[0], owned=owned_blk[0],
            seg_id=seg_blk[0], id_hi=hi_blk[0], id_lo=lo_blk[0],
            qual=qual_blk[0],
        )
        tup = extract_tuples(bases, spec, canonical=canonical,
                             with_quality=with_quality, codec=codec)
        return (tup.words[None], tup.id_hi[None], tup.id_lo[None],
                tup.qual[None], tup.valid[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 7,
        out_specs=(P(axes_of(mesh)),) * 5,
    ))


def make_kv_flush_step(mesh: Mesh, nparts: int, capacity: int,
                       reduce: str = "first", oversample: int = 64):
    """Jitted sorted-map rebuild for the generic unique-value map
    (sorted_map, distributed_sorted_map.hpp:1407): global samplesort of
    (key, u64 value, priority) rows + per-key reduction.

    reduce="first": smallest `prio` wins (store rows re-enter with prio 0,
    pending batches with ascending arrival priorities).  "min"/"max":
    extreme u64 value wins; prio ignored.  Returns
    (new_stores, splitters, overflow)."""

    def body(words_blk, hi_blk, lo_blk, prio_blk, valid_blk):
        words, vhi, vlo, prio, valid = (
            words_blk[0], hi_blk[0], lo_blk[0], prio_blk[0], valid_blk[0])
        s_words, _, s_valid = sortops.sort_rows(words, (), valid,
                                                is_stable=False)
        splitters = _global_splitters(s_words, s_valid, nparts, oversample,
                                      axes_of(mesh))
        owner = owners_from_splitters(words, splitters, nparts)
        (rw, rhi, rlo, rp), rvalid, route = dist.distribute(
            (words, vhi, vlo, prio), owner, valid, nparts, capacity,
            axes_of(mesh))
        n, w = rw.shape
        flag = (~rvalid).astype(jnp.uint32)
        cols = tuple(rw[:, j] for j in range(w))
        if reduce == "first":
            ops = jax.lax.sort((flag,) + cols + (rp, rhi, rlo),
                               num_keys=1 + w + 1, is_stable=False)
            s_hi, s_lo = ops[2 + w], ops[3 + w]
        elif reduce in ("min", "max"):
            vh = rhi if reduce == "min" else ~rhi
            vl = rlo if reduce == "min" else ~rlo
            ops = jax.lax.sort((flag,) + cols + (vh, vl),
                               num_keys=1 + w + 2, is_stable=False)
            s_hi, s_lo = ops[1 + w], ops[2 + w]
            if reduce == "max":
                s_hi, s_lo = ~s_hi, ~s_lo
        else:
            raise ValueError(reduce)
        sv = ops[0] == 0
        sw = jnp.stack(ops[1:1 + w], axis=1)
        uniq, (hi_f, lo_f), starts, n_unique, _tv = sortops.compact_runs(
            sw, sv, payloads=(s_hi, s_lo))
        live = jnp.arange(n) < n_unique
        store = st.KVStore(
            keys=jnp.where(live[:, None], uniq, _SENT),
            val_hi=jnp.where(live, hi_f, 0),
            val_lo=jnp.where(live, lo_f, 0),
            size=n_unique,
        )
        return _stack(store), splitters[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 5,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_query_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted splitter-routed unique-map lookup."""

    def body(stores_blk, split_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_from_splitters(queries, splitters, nparts)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        hi, lo, found = st.kv_lookup(store, rq)
        found = found & rvalid
        back_hi, back_lo, back_f = dist.undistribute(
            (hi, lo, found.astype(jnp.int8)), route, nparts, capacity,
            axes_of(mesh))
        return (back_hi[None], back_lo[None], back_f.astype(bool)[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_kv_erase_step(mesh: Mesh, nparts: int, capacity: int):
    """Jitted splitter-routed unique-map erase."""

    def body(stores_blk, split_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_from_splitters(keys, splitters, nparts)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.kv_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_local_ingest_step(mesh: Mesh, spec, canonical: bool):
    """Jitted shard-local (kmer, position-id) extraction for the sorted
    unique-value map (no exchange — the flush samplesort routes).
    Returns (words, hi, lo, valid) stacked [p, n, ...]."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples

    def body(codes_blk, valid_blk, owned_blk, seg_blk, hi_blk, lo_blk):
        bases = DeviceBases(
            codes=codes_blk[0], valid=valid_blk[0], owned=owned_blk[0],
            seg_id=seg_blk[0], id_hi=hi_blk[0], id_lo=lo_blk[0],
            qual=jnp.zeros_like(codes_blk[0]),
        )
        tup = extract_tuples(bases, spec, canonical=canonical)
        return (tup.words[None], tup.id_hi[None], tup.id_lo[None],
                tup.valid[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_multi_erase_if_keys_step(mesh: Mesh, nparts: int, capacity: int,
                                  pred):
    """Jitted splitter-routed keyed erase_if: pairs whose key matches a
    routed query key AND satisfies pred are removed (the device-side
    replacement of per-query predicate unrolling)."""

    def body(stores_blk, split_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        splitters = split_blk[0]
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_from_splitters(keys, splitters, nparts)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        q = rk.astype(jnp.uint32)
        cap = store.capacity
        lo, hi = st.multi_lookup_ranges(store, q)
        lo = jnp.where(rvalid, lo, 0)
        hi = jnp.where(rvalid, hi, 0)
        diff = jnp.zeros((cap + 1,), jnp.int32)
        diff = diff.at[lo].add(jnp.where(rvalid, 1, 0))
        diff = diff.at[hi].add(jnp.where(rvalid, -1, 0))
        member = jnp.cumsum(diff[:cap]) > 0
        live = jnp.arange(cap) < store.size
        keep = live & ~(member & pred(store.keys, store.val_hi,
                                      store.val_lo, store.val_q))
        s_words, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
            store.keys,
            (store.val_hi, store.val_lo,
             jax.lax.bitcast_convert_type(store.val_q, jnp.uint32)),
            keep)
        new_size = jnp.sum(keep.astype(jnp.int32))
        new = st.MultiStore(
            keys=jnp.where(s_valid[:, None], s_words, _SENT),
            val_hi=jnp.where(s_valid, s_hi, 0),
            val_lo=jnp.where(s_valid, s_lo, 0),
            val_q=jax.lax.bitcast_convert_type(
                jnp.where(s_valid, s_q, 0), jnp.float32),
            size=new_size,
        )
        return (_stack(new), (store.size - new_size)[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))

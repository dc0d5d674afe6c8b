"""Sharded distributed index: per-device stores + all_to_all routing.

Sharded rebuild of the reference's distributed containers
(/root/reference/src/containers/distributed_densehash_map.hpp,
distributed_sorted_map.hpp): every k-mer is owned by shard
``owner_from_hash(hash(transform(kmer)), p)`` (KeyToRank,
distributed_densehash_map.hpp:148-171); insert and every query ship tuples
to owners via the dense-bucket all_to_all (`parallel.distribute`), run the
local sorted-store op, and (for queries) route replies back to the
requesting shard in the original element order.

Everything here is a *pure jitted step* built with `jax.shard_map` over a
1-D mesh; the `DistributedIndex` classes in `api.py` hold the store pytree
(arrays with a leading [p] axis, sharded over the mesh) and orchestrate
capacity growth on overflow (check-and-retry replaces the reference's
per-bucket size estimation, distributed_densehash_map.hpp:328-420).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import hashing
from ..parallel import distribute as dist
from ..parallel.mesh import axes_of
from . import store as st

__all__ = [
    "owners_for",
    "make_insert_step",
    "make_count_query_step",
    "make_erase_step",
    "make_multi_insert_step",
    "make_multi_count_step",
]


def owners_for(words: jax.Array, nparts: int, hash_name: str = "murmur",
               seed: int = 42) -> jax.Array:
    """Destination shard per key row (KeyToRank)."""
    if nparts == 1:
        return jnp.zeros(words.shape[:-1], jnp.int32)
    h = hashing.HASHES[hash_name](words, seed)
    return hashing.owner_from_hash(h, nparts)


def _unstack(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _stack(tree):
    return jax.tree.map(lambda a: a[None], tree)


def make_insert_step(mesh: Mesh, nparts: int, capacity: int, hash_name: str,
                     saturate: int | None = None):
    """Jitted: (stores[p,...], words[p,n,w], valid[p,n], weights[p,n]) ->
    (new_stores, route_overflow[p], store_overflow[p]).

    The stack-3.1 insert half: transform already applied by extraction;
    here = hash → distribute → local merge (SURVEY §3.1 hot loops 3-4).
    """

    def body(stores_blk, words_blk, valid_blk, weights_blk):
        store = _unstack(stores_blk)
        words, valid, weights = words_blk[0], valid_blk[0], weights_blk[0]
        owner = owners_for(words, nparts, hash_name)
        (rwords, rweights), rvalid, route = dist.distribute(
            (words, weights), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, ovf = st.count_insert(
            store, rwords, rvalid, weights=rweights, saturate=saturate)
        return _stack(new_store), route.overflow[None], ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_count_query_step(mesh: Mesh, nparts: int, capacity: int, hash_name: str):
    """Jitted: (stores, queries[p,m,w], qvalid[p,m]) ->
    (counts[p,m], overflow[p]) — counts aligned with the original query
    order per shard (the find/count round trip of
    distributed_densehash_map.hpp:1123-1199 + unpermute :1563-1577)."""

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        local_counts = st.count_lookup(store, rq)
        local_counts = jnp.where(rvalid, local_counts, 0)
        (back,) = dist.undistribute(
            (local_counts,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_erase_step(mesh: Mesh, nparts: int, capacity: int, hash_name: str):
    """Jitted: (stores, keys[p,m,w], valid[p,m]) ->
    (new_stores, n_erased[p], overflow[p])."""

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.count_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_multi_insert_step(mesh: Mesh, nparts: int, capacity: int, hash_name: str):
    """Jitted multimap insert: routes (key, 64-bit id [+ quality]) tuples."""

    def body(stores_blk, words_blk, hi_blk, lo_blk, q_blk, valid_blk):
        store = _unstack(stores_blk)
        words, vhi, vlo, vq, valid = (
            words_blk[0], hi_blk[0], lo_blk[0], q_blk[0], valid_blk[0])
        owner = owners_for(words, nparts, hash_name)
        qbits = jax.lax.bitcast_convert_type(vq, jnp.uint32)
        (rw, rhi, rlo, rqb), rvalid, route = dist.distribute(
            (words, vhi, vlo, qbits), owner, valid, nparts, capacity,
            axes_of(mesh))
        rq = jax.lax.bitcast_convert_type(rqb, jnp.float32)
        new_store, ovf = st.multi_insert(store, rw, rhi, rlo, rvalid, val_q=rq)
        return _stack(new_store), route.overflow[None], ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_multi_count_step(mesh: Mesh, nparts: int, capacity: int, hash_name: str):
    """Jitted multimap multiplicity query (get_multiplicity / count)."""

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        local = jnp.where(rvalid, st.multi_count(store, rq), 0)
        (back,) = dist.undistribute(
            (local,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_multi_aux_step(mesh: Mesh):
    """Jitted: build the multimap's query-aux metadata
    (st.multi_query_aux), cached by the index per store version."""

    def body(stores_blk):
        ext, bstart = st.multi_query_aux(_unstack(stores_blk))
        return ext[None], bstart[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_multi_find_step(mesh: Mesh, nparts: int, capacity: int,
                         hash_name: str, max_per_query: int,
                         cached: bool = False):
    """Jitted multimap find: returns per-query payload lists
    (hi[p,m,max], lo[p,m,max], q[p,m,max], mask[p,m,max], counts[p,m],
    overflow[p]) in original query order — the find path of
    distributed_densehash_map.hpp:1509-1577.

    counts is the TRUE multiplicity per query (the reference's two-pass
    size estimation, :328-420); callers compare it against max_per_query to
    detect truncation and retry with a larger gather width.  cached=True:
    the store's query-aux metadata (make_multi_aux_step) rides as extra
    operands and the per-call scans disappear."""

    def body(stores_blk, queries_blk, qvalid_blk, *aux_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        if cached:
            (ext_blk, bstart_blk), = aux_blk
            lo, hi = st.multi_lookup_ranges_aux(
                store, ext_blk[0], bstart_blk[0], rq)
        else:
            lo, hi = st.multi_lookup_ranges(store, rq)
        hi = jnp.where(rvalid, hi, lo)  # empty range for padding slots
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
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh)))
        + ((P(axes_of(mesh)),) if cached else ()),
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_multi_erase_step(mesh: Mesh, nparts: int, capacity: int,
                          hash_name: str):
    """Jitted multimap erase: removes ALL pairs whose key matches a query
    key (densehash_multimap::erase, distributed_densehash_map.hpp:1603+).
    Returns (new_stores, n_erased[p], overflow[p])."""

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.multi_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_multi_filter_step(mesh: Mesh, pred):
    """Jitted predicate filter over every local (key, id, quality) pair of
    a MultiStore — the multimap erase_if/filter(pred) path
    (distributed_densehash_map.hpp:1603+ erase_if on densehash_multimap).

    pred: traceable (keys uint32[n, w], id_hi uint32[n], id_lo uint32[n],
    qual float32[n]) -> keep bool[n].  Returns (new_stores, n_erased[p]).
    """
    from ..ops import sortops

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap = store.capacity
        live = jnp.arange(cap) < store.size
        keep = pred(store.keys, store.val_hi, store.val_lo,
                    store.val_q) & live
        s_words, (s_hi, s_lo, s_q), s_valid = sortops.sort_rows(
            store.keys,
            (store.val_hi, store.val_lo,
             jax.lax.bitcast_convert_type(store.val_q, jnp.uint32)),
            keep)
        new_size = jnp.sum(keep.astype(jnp.int32))
        new = st.MultiStore(
            keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(0xFFFFFFFF)),
            val_hi=jnp.where(s_valid, s_hi, 0),
            val_lo=jnp.where(s_valid, s_lo, 0),
            val_q=jax.lax.bitcast_convert_type(
                jnp.where(s_valid, s_q, 0), jnp.float32),
            size=new_size,
        )
        return _stack(new), (store.size - new_size)[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_count_filter_step(mesh: Mesh, pred):
    """Jitted predicate filter over every local entry of a CountStore —
    the erase_if/filter(pred) path (kmer_index.hpp:192, densehash filter).

    pred: traceable (keys uint32[n, w], counts int32[n]) -> keep bool[n];
    entries where keep is False are removed.  Returns (new_stores,
    n_erased[p]).
    """
    from ..ops import sortops

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap = store.capacity
        live = jnp.arange(cap) < store.size
        keep = pred(store.keys, store.counts) & live
        s_words, (s_vals,), s_valid = sortops.sort_rows(
            store.keys, (store.counts,), keep)
        new_size = jnp.sum(keep.astype(jnp.int32))
        new = st.CountStore(
            keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(0xFFFFFFFF)),
            counts=jnp.where(s_valid, s_vals, 0),
            size=new_size,
        )
        return _stack(new), (store.size - new_size)[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_histogram_step(mesh: Mesh, nbins: int):
    """Jitted k-mer frequency spectrum: hist[c] = number of distinct
    stored keys whose count is c, with counts >= nbins-1 accumulated in
    the last bin.  Device-side analog of the reference's frequency
    histogram tooling (utils/kmer_distribution.R over index dumps) — one
    bincount per shard, psum across the mesh, no host gather of the
    store.  Works on any store with `counts`/`size` leaves (CountStore,
    BimolStore).  Returns int32[nbins], replicated."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        live = jnp.arange(store.capacity) < store.size
        bins = jnp.clip(store.counts, 0, nbins - 1)
        local = jnp.zeros((nbins,), jnp.int32).at[bins].add(
            live.astype(jnp.int32))
        return jax.lax.psum(local, axes_of(mesh))

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),), out_specs=P(),
    ))


def make_ingest_step(mesh: Mesh, nparts: int, spec, canonical: bool,
                     capacity: int, hash_name: str):
    """Jitted: per-base columns -> (uniq_words[p, m, w], counts[p, m],
    valid[p, m], route_overflow[p]) — extraction + owner exchange +
    chunk-local pre-reduction, WITHOUT the store merge.

    The pre-reduction (sort + run-length per chunk) is the reference's
    local bucket_reduce (fsc_container_utils.hpp:306-507): duplicates
    inside a chunk collapse to weighted rows before they ever hit the
    pending buffer, which shrinks deferred merges dramatically on real
    (repetitive) genomic data.  Pairs with `make_merge_step` for the
    deferred merge (sorted_map lazy semantics,
    distributed_sorted_map.hpp:341,940)."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples
    from ..ops import sortops

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
        owner = owners_for(tup.words, nparts, hash_name)
        (rw,), rvalid, route = dist.distribute(
            (tup.words,), owner, tup.valid, nparts, capacity, axes_of(mesh))
        s_words, _, s_valid = sortops.sort_rows(
            rw, (), rvalid, is_stable=False, sentinel_ok=spec.sentinel_safe,
            word_bits=spec.word_bits())
        # run-length weights in place (one cummax scan) — skips the
        # compaction sort; the pending buffer takes valid-masked rows
        weights, emit = sortops.run_length_counts(s_words, s_valid)
        return (s_words[None], weights[None], emit[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_merge_step(mesh: Mesh, saturate: int | None = None,
                    sentinel_ok: bool = False,
                    word_bits: tuple | None = None):
    """Jitted: (stores, words[p, m, w], weights[p, m], valid[p, m]) ->
    (new_stores, store_overflow[p]) — local weighted merge of
    already-owner-resident rows (the deferred sort of the lazy-insert
    path)."""

    def body(stores_blk, words_blk, weights_blk, valid_blk):
        store = _unstack(stores_blk)
        new_store, ovf = st.count_insert(
            store, words_blk[0], valid_blk[0], weights=weights_blk[0],
            saturate=saturate, sentinel_ok=sentinel_ok, word_bits=word_bits)
        return _stack(new_store), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_multi_ingest_step(mesh: Mesh, nparts: int, spec, canonical: bool,
                           capacity: int, hash_name: str,
                           with_quality: bool = False, codec=None):
    """Jitted multimap ingest: extraction + owner exchange of
    (kmer, id, quality) tuples WITHOUT the store merge — the lazy half of
    the position-index insert."""
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
        owner = owners_for(tup.words, nparts, hash_name)
        qbits = jax.lax.bitcast_convert_type(tup.qual, jnp.uint32)
        (rw, rhi, rlo, rqb), rvalid, route = dist.distribute(
            (tup.words, tup.id_hi, tup.id_lo, qbits), owner, tup.valid,
            nparts, capacity, axes_of(mesh))
        rq = jax.lax.bitcast_convert_type(rqb, jnp.float32)
        return (rw[None], rhi[None], rlo[None], rq[None], rvalid[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 7,
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_multi_merge_step(mesh: Mesh, sentinel_ok: bool = False,
                          with_q: bool = True):
    """Jitted: deferred multimap merge of owner-resident tuples.

    sentinel_ok (KmerSpec.sentinel_safe): flush by sorting ONLY the batch
    and bitonic-MERGING it with the already-sorted store (instead of a
    monolithic stable re-sort of both); otherwise the
    liveness-FLAG merge (one extra key column) does the same for
    full-word specs.  with_q=False (PositionIndex without quality): the
    all-zero val_q column never rides the sort or merge."""

    def body(stores_blk, words_blk, hi_blk, lo_blk, q_blk, valid_blk):
        store = _unstack(stores_blk)
        if sentinel_ok:
            new_store, ovf = st.multi_merge_flush(
                store, words_blk[0], hi_blk[0], lo_blk[0], valid_blk[0],
                val_q=q_blk[0] if with_q else None)
        else:
            # sentinel-unsafe specs (k=16/32/64 DNA): liveness-flag
            # merge — still no monolithic re-sort (st.multi_merge_flush_flagged)
            new_store, ovf = st.multi_merge_flush_flagged(
                store, words_blk[0], hi_blk[0], lo_blk[0], valid_blk[0],
                val_q=q_blk[0] if with_q else None)
        return _stack(new_store), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_bimol_ingest_step(mesh: Mesh, nparts: int, spec, capacity: int,
                           hash_name: str):
    """Jitted Bimolecule ingest: extraction (canonical words + strand flag)
    + owner exchange of (canonical kmer, occurrence id, strand) tuples
    WITHOUT the store merge — the Bimolecule map preset stores input-strand
    keys while hashing/comparing canonically (kmer_index.hpp:436-562)."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples

    def body(codes_blk, valid_blk, owned_blk, seg_blk, hi_blk, lo_blk):
        bases = DeviceBases(
            codes=codes_blk[0], valid=valid_blk[0], owned=owned_blk[0],
            seg_id=seg_blk[0], id_hi=hi_blk[0], id_lo=lo_blk[0],
            qual=jnp.zeros_like(codes_blk[0]),
        )
        tup = extract_tuples(bases, spec, canonical=True)
        owner = owners_for(tup.words, nparts, hash_name)
        (rw, rhi, rlo, rs), rvalid, route = dist.distribute(
            (tup.words, tup.id_hi, tup.id_lo, tup.strand), owner, tup.valid,
            nparts, capacity, axes_of(mesh))
        return (rw[None], rhi[None], rlo[None], rs[None], rvalid[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_bimol_merge_step(mesh: Mesh, saturate: int | None = None):
    """Jitted deferred Bimolecule merge: weighted count sum + earliest-
    occurrence representative per canonical key."""

    def body(stores_blk, words_blk, w_blk, hi_blk, lo_blk, s_blk, valid_blk):
        store = _unstack(stores_blk)
        new_store, ovf = st.bimol_insert(
            store, words_blk[0], w_blk[0], hi_blk[0], lo_blk[0], s_blk[0],
            valid_blk[0], saturate=saturate)
        return _stack(new_store), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 7,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_bimol_insert_step(mesh: Mesh, nparts: int, capacity: int,
                           hash_name: str, saturate: int | None = None):
    """Jitted direct Bimolecule insert of explicit (canonical key, weight,
    occurrence id, strand) tuples: route to owners + merge."""

    def body(stores_blk, words_blk, w_blk, hi_blk, lo_blk, s_blk, valid_blk):
        store = _unstack(stores_blk)
        words = words_blk[0]
        owner = owners_for(words, nparts, hash_name)
        (rw, rwt, rhi, rlo, rs), rvalid, route = dist.distribute(
            (words, w_blk[0], hi_blk[0], lo_blk[0], s_blk[0]), owner,
            valid_blk[0], nparts, capacity, axes_of(mesh))
        new_store, ovf = st.bimol_insert(
            store, rw, rwt, rhi, rlo, rs, rvalid, saturate=saturate)
        return _stack(new_store), route.overflow[None], ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 7,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_bimol_erase_step(mesh: Mesh, nparts: int, capacity: int,
                          hash_name: str):
    """Jitted Bimolecule erase: route canonical query keys to owners and
    remove them, preserving representative columns."""

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.bimol_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_bimol_filter_step(mesh: Mesh, pred):
    """Jitted predicate filter over local Bimolecule entries (erase_if /
    filter; pred sees canonical keys and counts).  Returns
    (new_stores, n_erased[p])."""
    from ..ops import sortops

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap = store.capacity
        live = jnp.arange(cap) < store.size
        keep = pred(store.keys, store.counts) & live
        s_words, (s_c, s_hi, s_lo, s_s), s_valid = sortops.sort_rows(
            store.keys,
            (store.counts, store.rep_hi, store.rep_lo, store.rep_strand),
            keep)
        new_size = jnp.sum(keep.astype(jnp.int32))
        new = st.BimolStore(
            keys=jnp.where(s_valid[:, None], s_words, jnp.uint32(0xFFFFFFFF)),
            counts=jnp.where(s_valid, s_c, 0),
            rep_hi=jnp.where(s_valid, s_hi, jnp.uint32(0xFFFFFFFF)),
            rep_lo=jnp.where(s_valid, s_lo, jnp.uint32(0xFFFFFFFF)),
            rep_strand=jnp.where(s_valid, s_s, 0),
            size=new_size,
        )
        return _stack(new), (store.size - new_size)[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


# ------------------------------------------------------- run-layout count map
# The hash-partitioned count family runs on the RUN store layout
# (store.RunCountStore): the flush merges already-sorted runs with a
# bitonic merge network (log2 n elementwise stages) instead of re-sorting
# store+batch (log^2 n sorting-network passes + a stable compaction sort).

def make_run_ingest_step(mesh: Mesh, nparts: int, spec, canonical: bool,
                         capacity: int, hash_name: str):
    """Jitted: per-base columns -> (sorted_words[p, m, w], weights[p, m],
    route_overflow[p]) — extraction + owner exchange + local sort.  The
    output is a sorted weighted RUN (weight 1 per live row, sentinel keys
    with weight 0 elsewhere), the unit the deferred bitonic-merge flush
    consumes."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples
    from ..ops import sortops

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
        owner = owners_for(tup.words, nparts, hash_name)
        (rw,), rvalid, route = dist.distribute(
            (tup.words,), owner, tup.valid, nparts, capacity, axes_of(mesh))
        s_words, _, s_valid = sortops.sort_rows(
            rw, (), rvalid, is_stable=False, sentinel_ok=spec.sentinel_safe,
            word_bits=spec.word_bits(), as_cols=True)
        # weights are positional (valid rows sort to the front in both
        # sort modes).  Flag-mode tails keep their key bits — force the
        # sentinel so the run invariant (sorted incl. padding) holds;
        # sentinel mode already substituted it pre-sort, so the extra
        # elementwise pass is skipped.
        if not spec.sentinel_safe:
            s_words = jnp.where(s_valid[None, :], s_words,
                                jnp.uint32(0xFFFFFFFF))
        weights = s_valid.astype(jnp.int32)
        return s_words[None], weights[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_adopt_step(mesh: Mesh, unit: bool = False):
    """Jitted: adopt a sorted weighted run as the whole store (first
    flush into an empty index — skips the merge).  unit=True: the run
    is file-ingest output (weight 1 per live row) — closed-form csum,
    no prefix-sum dispatch."""

    def body(words_blk, weights_blk):
        if unit:
            return _stack(st.run_from_sorted_unit(words_blk[0],
                                                  weights_blk[0]))
        return _stack(st.run_from_sorted(words_blk[0], weights_blk[0]))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 2,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_stats_step(mesh: Mesh):
    """Jitted: distinct live keys per shard (int32[p]) — the collective
    size/unique_size surface (dsc::map_base::size allreduce)."""

    def body(stores_blk):
        return st.run_distinct(_unstack(stores_blk))[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=P(axes_of(mesh)),
    ))


def make_run_count_query_step(mesh: Mesh, nparts: int, capacity: int,
                              hash_name: str, saturate: int | None = None):
    """Jitted count query over the run store: route -> csum-difference
    lookup -> reply routing (distributed_densehash_map.hpp:1123-1199)."""

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        local = jnp.where(rvalid, st.run_lookup(store, rq, saturate), 0)
        (back,) = dist.undistribute(
            (local,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_run_erase_step(mesh: Mesh, nparts: int, capacity: int,
                        hash_name: str):
    """Jitted erase over the run store: weights zeroed in place."""

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.run_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_insert_step(mesh: Mesh, nparts: int, capacity: int,
                         hash_name: str):
    """Jitted explicit insert: route (key, weight) tuples to owners and
    sort them into a pending run (weights carried as a sort payload —
    explicit counts vary per row)."""
    from ..ops import sortops

    def body(words_blk, weights_blk, valid_blk):
        words, weights, valid = words_blk[0], weights_blk[0], valid_blk[0]
        owner = owners_for(words, nparts, hash_name)
        (rw, rwt), rvalid, route = dist.distribute(
            (words, weights), owner, valid, nparts, capacity, axes_of(mesh))
        rwt = jnp.where(rvalid, rwt, 0)
        s_words, (s_wt,), s_valid = sortops.sort_rows(
            rw, (rwt,), rvalid, is_stable=False, as_cols=True)
        s_words = jnp.where(s_valid[None, :], s_words,
                            jnp.uint32(0xFFFFFFFF))
        s_wt = jnp.where(s_valid, s_wt, 0)
        return s_words[None], s_wt[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_filter_step(mesh: Mesh, pred, saturate: int | None = None):
    """Jitted predicate filter over the run store: rows whose run fails
    pred(keys, counts) get weight 0 (erase_if/filter,
    kmer_index.hpp:192).  pred = KEEP predicate, evaluated per row with
    the run's total as the count.  Returns (new_stores, n_erased[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        _, is_last, total = st.run_totals(store)
        counts = total if saturate is None else jnp.minimum(total, saturate)
        # user predicates see row-major keys [cap, w]; XLA drops the
        # transpose when the predicate ignores the keys
        keep = pred(jnp.swapaxes(store.keys, 0, 1), counts)
        live = total > 0
        kill = live & ~keep
        new_w = jnp.where(kill, 0, store.weights)
        new = st.RunCountStore(
            keys=store.keys,
            weights=new_w,
            csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                                  st._cumsum_i32(new_w)]),
        )
        nerased = jnp.sum((is_last & kill).astype(jnp.int32))
        return _stack(new), nerased[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_run_histogram_step(mesh: Mesh, nbins: int,
                            saturate: int | None = None):
    """Jitted frequency spectrum over the run store (one bincount per
    shard + psum; counts >= nbins-1 accumulate in the last bin)."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        _, is_last, total = st.run_totals(store)
        counts = total if saturate is None else jnp.minimum(total, saturate)
        live = is_last & (total > 0)
        bins = jnp.clip(counts, 0, nbins - 1)
        local = jnp.zeros((nbins,), jnp.int32).at[bins].add(
            live.astype(jnp.int32))
        return jax.lax.psum(local, axes_of(mesh))

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),), out_specs=P(),
    ))


def make_run_compact_step(mesh: Mesh, new_cap: int,
                          saturate: int | None = None):
    """Jitted store compaction: collapse runs to (key, total) rows at a
    new capacity (memory reclamation for the merge-only flush; clamped
    when `saturate` — see store.run_compact).  Returns
    (new_stores, overflow[p])."""

    def body(stores_blk):
        new, ovf = st.run_compact(_unstack(stores_blk), new_cap, saturate)
        return _stack(new), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


# ------------------------------------------------- multi-run (LSM) count map
# The count index keeps its shard-local data as a SMALL LIST of sorted
# runs (log-structured merge discipline): each ingest chunk lands as one
# run; runs merge pairwise only when the list exceeds max_runs, so the
# amortized per-row merge work is O(log(total/chunk)) and a build is
# queryable the moment its last chunk lands — the reference's own lazy
# sorted map defers its sort to first query the same way
# (distributed_sorted_map.hpp:341,940).  Queries visit every run and sum.

def make_run_aux_step(mesh: Mesh):
    """Jitted: build one run's query-aux metadata (st.run_query_aux —
    run totals + fused-gather operand + prefix-bucket table), cached by
    the index per run VERSION so queries stop paying the per-call
    O(cap) scans (flat in m)."""

    def body(stores_blk):
        ext, bstart = st.run_query_aux(_unstack(stores_blk))
        return ext[None], bstart[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_runs_count_query_step(mesh: Mesh, nparts: int, capacity: int,
                               hash_name: str, saturate: int | None,
                               nruns: int, cached: bool = False):
    """Jitted count query over a list of runs: route once, csum-difference
    lookup in each run, sum, reply.  cached=True: per-run aux metadata
    (make_run_aux_step) rides as extra operands and the per-call scans
    disappear (st.run_lookup_aux)."""

    def body(stores_blk, queries_blk, qvalid_blk, *aux_blks):
        stores = [_unstack(s) for s in stores_blk]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        if cached:
            total = None
            for ext_blk, bstart_blk in aux_blks:
                part = st.run_lookup_aux(ext_blk[0], bstart_blk[0], rq,
                                         None)
                total = part if total is None else total + part
        else:
            total = st.run_lookup(stores[0], rq, None)
            for s in stores[1:]:
                total = total + st.run_lookup(s, rq, None)
        if saturate is not None:
            total = jnp.minimum(total, saturate)
        local = jnp.where(rvalid, total, 0)
        (back,) = dist.undistribute(
            (local,), route, nparts, capacity, axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh)))
        + ((P(axes_of(mesh)),) * nruns if cached else ()),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_runs_erase_step(mesh: Mesh, nparts: int, capacity: int,
                         hash_name: str, nruns: int):
    """Jitted erase over a list of runs.  Returns (new_stores, n_erased[p],
    overflow[p]) — n_erased counts DISTINCT erased keys across runs
    (each key owned by one shard, so per-shard counts sum globally)."""

    def body(stores_blk, keys_blk, valid_blk):
        stores = [_unstack(s) for s in stores_blk]
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        total = st.run_lookup(stores[0], rk, None)
        for s in stores[1:]:
            total = total + st.run_lookup(s, rk, None)
        had = rvalid & (total > 0)
        new_stores = tuple(st.run_erase_cover(s, rk, rvalid)
                           for s in stores)
        # distinct erased keys: sort the marked query rows, count run heads
        w = rk.shape[1]
        qk = jnp.where(had[:, None], rk, jnp.uint32(0xFFFFFFFF))
        ops = jax.lax.sort(
            tuple(qk[:, j] for j in range(w))
            + (jnp.uint32(1) - had.astype(jnp.uint32),),
            num_keys=w + 1, is_stable=False)
        s_had = ops[w] == 0
        n = rk.shape[0]
        neq_prev = jnp.zeros(n, bool).at[0].set(True)
        for j in range(w):
            neq_prev = neq_prev | (ops[j] != jnp.roll(ops[j], 1))
        nerased = jnp.sum((neq_prev & s_had).astype(jnp.int32))
        return (tuple(_stack(s) for s in new_stores), nerased[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_run_merge_pair_step(mesh: Mesh, unit: bool = False):
    """Jitted: merge two run stores into one (bitonic merge + prefix-sum
    rebuild) — the LSM level-merge.  With unit=True both operands are
    UNIT runs (weight 1 per live row; file-ingest output) and the merge
    runs keys-only with closed-form weights/csum (st.run_merge_unit)."""

    def body(a_blk, b_blk):
        a, b = _unstack(a_blk), _unstack(b_blk)
        if unit:
            return _stack(st.run_merge_unit(a, b))
        return _stack(st.run_merge(a, b.keys, b.weights))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
        out_specs=P(axes_of(mesh)),
    ))


# ---------------------------------------------- generic unique-value map
def make_kv_insert_step(mesh: Mesh, nparts: int, capacity: int,
                        hash_name: str, reduce: str):
    """Jitted unique-map insert: route (key, u64 value) tuples to owners
    and merge with the configured reduction (the generic KmerIndex alias,
    kmer_index.hpp:397-399)."""

    def body(stores_blk, words_blk, hi_blk, lo_blk, valid_blk):
        store = _unstack(stores_blk)
        words, vhi, vlo, valid = (words_blk[0], hi_blk[0], lo_blk[0],
                                  valid_blk[0])
        owner = owners_for(words, nparts, hash_name)
        (rw, rhi, rlo), rvalid, route = dist.distribute(
            (words, vhi, vlo), owner, valid, nparts, capacity,
            axes_of(mesh))
        new_store, ovf = st.kv_insert(store, rw, rhi, rlo, rvalid,
                                      reduce=reduce)
        return _stack(new_store), route.overflow[None], ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 5,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_ingest_step(mesh: Mesh, nparts: int, spec, canonical: bool,
                        capacity: int, hash_name: str, reduce: str):
    """Jitted file-build ingest for the unique-value map: extraction +
    owner exchange of (kmer, position-id) tuples + local reduction merge
    (Index<densehash_map<Kmer, IdType>, KmerPositionTupleParser>)."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples

    def body(stores_blk, codes_blk, valid_blk, owned_blk, seg_blk, hi_blk,
             lo_blk):
        store = _unstack(stores_blk)
        bases = DeviceBases(
            codes=codes_blk[0], valid=valid_blk[0], owned=owned_blk[0],
            seg_id=seg_blk[0], id_hi=hi_blk[0], id_lo=lo_blk[0],
            qual=jnp.zeros_like(codes_blk[0]),
        )
        tup = extract_tuples(bases, spec, canonical=canonical)
        owner = owners_for(tup.words, nparts, hash_name)
        (rw, rhi, rlo), rvalid, route = dist.distribute(
            (tup.words, tup.id_hi, tup.id_lo), owner, tup.valid, nparts,
            capacity, axes_of(mesh))
        new_store, ovf = st.kv_insert(store, rw, rhi, rlo, rvalid,
                                      reduce=reduce)
        return _stack(new_store), route.overflow[None], ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 7,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_find_step(mesh: Mesh, nparts: int, capacity: int,
                      hash_name: str):
    """Jitted unique-map lookup: (hi[p,m], lo[p,m], found[p,m],
    overflow[p]) in original query order."""

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        hi, lo, found = st.kv_lookup(store, rq)
        found = found & rvalid
        back_hi, back_lo, back_f = dist.undistribute(
            (hi, lo, found.astype(jnp.int8)), route, nparts, capacity,
            axes_of(mesh))
        return (back_hi[None], back_lo[None],
                back_f.astype(bool)[None], route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_kv_erase_step(mesh: Mesh, nparts: int, capacity: int,
                       hash_name: str):
    """Jitted unique-map erase."""

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.kv_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_filter_step(mesh: Mesh, pred):
    """Jitted predicate filter over local (key, u64 value) entries —
    pred: (keys uint32[n, w], val_hi uint32[n], val_lo uint32[n]) ->
    keep bool[n].  Returns (new_stores, n_erased[p])."""
    from ..ops import sortops

    def body(stores_blk):
        store = _unstack(stores_blk)
        live = jnp.arange(store.capacity) < store.size
        keep = pred(store.keys, store.val_hi, store.val_lo) & live
        s_words, (s_hi, s_lo), s_valid = sortops.sort_rows(
            store.keys, (store.val_hi, store.val_lo), keep)
        new_size = jnp.sum(keep.astype(jnp.int32))
        new = st.KVStore(
            keys=jnp.where(s_valid[:, None], s_words,
                           jnp.uint32(0xFFFFFFFF)),
            val_hi=jnp.where(s_valid, s_hi, 0),
            val_lo=jnp.where(s_valid, s_lo, 0),
            size=new_size,
        )
        return _stack(new), (store.size - new_size)[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_bimol_find_step(mesh: Mesh, nparts: int, capacity: int,
                         hash_name: str):
    """Jitted Bimolecule lookup: (counts[p,m], strand[p,m], overflow[p]) in
    original query order — count + stored-orientation flag per canonical
    query key, WITHOUT a host store gather (the device-side replacement of
    the old O(store) dict reconstruction; fused query pattern analog,
    incremental_mxx.hpp:1376-1806)."""
    from ..ops import sortops

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        q = rq.astype(jnp.uint32)
        idx = sortops.lower_bound_bucketed(store.keys, store.size, q)
        cap, w = store.keys.shape
        # fused [m, w+2] row gather: key words + count + strand
        ext = jnp.concatenate(
            [store.keys, store.counts.astype(jnp.uint32)[:, None],
             store.rep_strand.astype(jnp.uint32)[:, None]], axis=1)
        g = ext[jnp.clip(idx, 0, cap - 1)]
        hit = rvalid & (idx < jnp.asarray(store.size, jnp.int32)) & jnp.all(
            g[:, :w] == q, axis=-1)
        counts = jnp.where(hit, g[:, w].astype(jnp.int32), 0)
        strand = jnp.where(hit, g[:, w + 1].astype(store.rep_strand.dtype),
                           0)
        back_c, back_s = dist.undistribute(
            (counts, strand), route, nparts, capacity, axes_of(mesh))
        return back_c[None], back_s[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_multi_erase_if_keys_step(mesh: Mesh, nparts: int, capacity: int,
                                  hash_name: str, pred):
    """Jitted multimap erase_if restricted to a query key set: pairs whose
    key matches a (routed) query key AND satisfies pred are removed —
    replaces the old per-query-row predicate unrolling (compile time and
    program size were linear in the query count).

    pred: traceable (keys, id_hi, id_lo, qual) -> bool[n].
    Returns (new_stores, n_erased[p], overflow[p])."""
    from ..ops import sortops

    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
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
            keys=jnp.where(s_valid[:, None], s_words,
                           jnp.uint32(0xFFFFFFFF)),
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
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_count_select_step(mesh: Mesh, pred):
    """Jitted device-side selection over a compacted (unique-key) counting
    store: entries satisfying pred(keys, counts) are COMPACTED to the
    front per shard with one stable sort, so the host slices n rows
    instead of scanning cap-sized masks in Python (owner-side predicate
    evaluation, distributed_densehash_map.hpp:1603+).  Works on any store
    with `keys[cap, w]`/`counts`/`size` leaves (CountStore, BimolStore).
    Returns (keys_out[p, cap, w], counts_out[p, cap], n[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap, w = store.keys.shape
        live = jnp.arange(cap) < store.size
        emit = pred(store.keys, store.counts) & live
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[:, j] for j in range(w))
            + (store.counts,), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        return keys_out[None], ops[1 + w][None], n_emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_kv_select_step(mesh: Mesh, pred):
    """Jitted device-side selection over a KVStore: entries satisfying
    pred(keys, val_hi, val_lo) compact to the front per shard.
    Returns (keys_out[p, cap, w], hi_out[p, cap], lo_out[p, cap], n[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap, w = store.keys.shape
        live = jnp.arange(cap) < store.size
        emit = pred(store.keys, store.val_hi, store.val_lo) & live
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[:, j] for j in range(w))
            + (store.val_hi, store.val_lo), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        return (keys_out[None], ops[1 + w][None], ops[2 + w][None],
                n_emit[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_multi_select_step(mesh: Mesh, pred):
    """Jitted device-side count_if over a MultiStore: per DISTINCT key, the
    number of its (key, id, quality) pairs satisfying pred — one output row
    per key with >= 1 match, compacted to the front per shard (replaces the
    host np.unique over a fetched cap-sized mask).  The per-run match count
    is computed gather-free with the same cummax/cummin scans as
    store.run_totals (the match-prefix-sum is nondecreasing).
    Returns (keys_out[p, cap, w], match_counts[p, cap], n[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap, w = store.keys.shape
        live = jnp.arange(cap) < store.size
        match = pred(store.keys, store.val_hi, store.val_lo,
                     store.val_q) & live
        mi = match.astype(jnp.int32)
        csum_incl = jnp.cumsum(mi)
        csum_excl = csum_incl - mi
        prev = jnp.roll(store.keys, 1, axis=0)
        neq_prev = jnp.any(store.keys != prev, axis=1).at[0].set(True)
        nxt = jnp.roll(store.keys, -1, axis=0)
        neq_next = jnp.any(store.keys != nxt, axis=1).at[cap - 1].set(True)
        start_c = jax.lax.cummax(
            jnp.where(neq_prev, csum_excl, jnp.int32(-2147483648)), axis=0)
        end_c = jax.lax.cummin(
            jnp.where(neq_next, csum_incl,
                      jnp.int32(2147483647))[::-1], axis=0)[::-1]
        runcount = end_c - start_c
        # a key run may straddle the live/dead boundary only via sentinel
        # collision; dead rows contribute 0 matches so runcount is exact,
        # but the emit row must then be the last LIVE row of the run (the
        # run's neq_next row would be dead and never emit)
        next_live = jnp.roll(live, -1).at[cap - 1].set(False)
        emit = live & (neq_next | ~next_live) & (runcount > 0)
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[:, j] for j in range(w))
            + (runcount,), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        return keys_out[None], ops[1 + w][None], n_emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_unique_size_step(mesh: Mesh):
    """Jitted distinct-key count over any store with sorted
    `keys[cap, w]` + `size` leaves (map_base::unique_size,
    distributed_map_base.hpp:149-302): per shard, key-change boundaries
    within the live prefix, psum'd across the mesh — no host gather of
    the store.  Returns a replicated int32 scalar."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        cap = store.keys.shape[0]
        live = jnp.arange(cap) < store.size
        prev = jnp.roll(store.keys, 1, axis=0)
        neq_prev = jnp.any(store.keys != prev, axis=1).at[0].set(True)
        local = jnp.sum((neq_prev & live).astype(jnp.int32))
        return jax.lax.psum(local, axes_of(mesh))

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),), out_specs=P(),
    ))


def make_run_select_step(mesh: Mesh, pred, saturate: int | None = None):
    """Jitted device-side selection over the run store: entries satisfying
    pred(keys, counts) are COMPACTED to the front per shard (one stable
    sort), so the host slices n rows instead of scanning cap-sized masks.
    Returns (keys_out[p, cap, w], totals_out[p, cap], n[p])."""
    from ..ops import sortops

    def body(stores_blk):
        store = _unstack(stores_blk)
        w, cap = store.keys.shape
        _, is_last, total = st.run_totals(store)
        counts = total if saturate is None else jnp.minimum(total, saturate)
        emit = is_last & (total > 0) & pred(
            jnp.swapaxes(store.keys, 0, 1), counts)
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[j] for j in range(w))
            + (counts,), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        return keys_out[None], ops[1 + w][None], n_emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


# ------------------------------------------- run-layout de Bruijn store
# The de Bruijn node family runs on the RUN store layout
# (store.RunVecStore): flushes are (w + 2)-column bitonic merges + nine
# prefix-sum rebuilds instead of the compacted VecStore's 9-payload
# re-sort of store+batch (the same merge discipline as the count
# family).

def make_debruijn_run_ingest_step(mesh: Mesh, nparts: int, spec,
                                  canonical: bool, capacity: int,
                                  hash_name: str, raw: bool = False):
    """Jitted de Bruijn run ingest: per-base columns -> (sorted kcols
    [p, w, m], ebytes[p, m], weights[p, m], route_overflow[p]) —
    extraction + strand-corrected edge bytes + owner exchange + ONE local
    sort carrying the edge byte as its single payload.  No per-chunk
    vector expansion or segment reduction: the run flush virtualizes the
    9-counter reduction into prefix sums (de_bruijn_construct_engine.hpp
    :91-131 zips kmer and edge iterators the same way).

    raw=True reproduces the reference's dual-LUT semantics exactly
    (kmer sees 'N'->0 under DNA, edge nibble sees 'N'->0xF;
    de_bruijn_construct_engine.hpp:109-158)."""
    from ..debruijn.edges import (edge_bytes_for_windows,
                                  revcomp_edge_byte)
    from ..ops import packing, sortops

    def body(codes_blk, valid_blk, owned_blk, seg_blk):
        codes, valid, owned, seg = (
            codes_blk[0], valid_blk[0], owned_blk[0], seg_blk[0])
        if raw:
            kcodes = jnp.take(jnp.asarray(spec.alphabet.from_ascii),
                              codes.astype(jnp.int32))
        else:
            kcodes = codes
        if canonical:
            words, was_rc = packing.extract_canonical(kcodes, spec)
        else:
            words = packing.extract_kmers(kcodes, spec)
            was_rc = jnp.zeros(codes.shape[0], bool)
        wvalid = packing.window_valid(valid, seg, spec.k) & owned
        edges = edge_bytes_for_windows(codes, valid, seg, spec.k,
                                       spec.alphabet, raw=raw)
        edges = jnp.where(was_rc, revcomp_edge_byte(edges), edges)
        owner = owners_for(words, nparts, hash_name)
        (rw, re), rvalid, route = dist.distribute(
            (words, edges.astype(jnp.uint32)), owner, wvalid, nparts,
            capacity, axes_of(mesh))
        s_words, (s_eb,), s_valid = sortops.sort_rows(
            rw, (re,), rvalid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, word_bits=spec.word_bits(),
            as_cols=True)
        if not spec.sentinel_safe:
            s_words = jnp.where(s_valid[None, :], s_words,
                                jnp.uint32(0xFFFFFFFF))
        ebytes = jnp.where(s_valid, s_eb, 0).astype(jnp.int32)
        weights = s_valid.astype(jnp.int32)
        return (s_words[None], ebytes[None], weights[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_run_vec_adopt_step(mesh: Mesh, unit: bool = False,
                            table: bool = True):
    """Jitted: adopt a sorted edge run as the whole store.  unit=True:
    file-ingest output (weight 1 per live row) — closed-form self
    stream, no weight-masked bit streams.  table=False: LAZY run (the
    counter table is deferred until a query/export needs it)."""

    def body(words_blk, ebytes_blk, weights_blk):
        if unit:
            out = st.run_vec_from_sorted_unit(
                words_blk[0], ebytes_blk[0], weights_blk[0], table=table)
        else:
            out = st.run_vec_from_sorted(
                words_blk[0], ebytes_blk[0], weights_blk[0])
            if not table:
                out = st.RunVecStore(keys=out.keys, ebytes=out.ebytes,
                                     weights=out.weights, bsum=None)
        return _stack(out)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vec_merge_pair_step(mesh: Mesh, unit: bool = False,
                                 table: bool = True):
    """Jitted: merge two edge runs (bitonic merge + prefix rebuild).
    unit=True: both operands are unit runs — the weight column never
    rides the merge (st.run_vec_merge_unit).  table=False: the output
    is a LAZY run (no counter table — intermediate LSM level)."""

    def body(a_blk, b_blk):
        a, b = _unstack(a_blk), _unstack(b_blk)
        if unit:
            out = st.run_vec_merge_unit(a, b, table=table)
        else:
            out = st.run_vec_merge(a, b)
            if not table:
                out = st.RunVecStore(keys=out.keys, ebytes=out.ebytes,
                                     weights=out.weights, bsum=None)
        return _stack(out)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 2,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vec_table_step(mesh: Mesh):
    """Jitted: materialize a LAZY run's counter table."""

    def body(stores_blk):
        return _stack(st.run_vec_with_table(_unstack(stores_blk)))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),),
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vec_stats_step(mesh: Mesh):
    """Jitted: distinct live nodes per shard (int32[p])."""

    def body(stores_blk):
        return st.run_vec_distinct(_unstack(stores_blk))[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vec_compact_step(mesh: Mesh, new_cap: int):
    """Jitted: collapse equal (key, edge-byte) rows and shrink to
    new_cap.  Returns (new_stores, overflow[p])."""

    def body(stores_blk):
        new, ovf = st.run_vec_compact(_unstack(stores_blk), new_cap)
        return _stack(new), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_runs_vec_query_step(mesh: Mesh, nparts: int, capacity: int,
                             hash_name: str, saturate: int | None,
                             nruns: int):
    """Jitted node-counter query over a list of edge runs: route once,
    prefix-difference lookup in each run, sum, reply (the node_counts
    surface, de_bruijn_node_trait.hpp:186-280)."""

    def body(stores_blk, queries_blk, qvalid_blk):
        stores = [_unstack(s) for s in stores_blk]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        total = st.run_vec_lookup(stores[0], rq, None)
        for s in stores[1:]:
            total = total + st.run_vec_lookup(s, rq, None)
        if saturate is not None:
            total = jnp.minimum(total, saturate)
        local = jnp.where(rvalid[:, None], total, 0)
        (back,) = dist.undistribute((local,), route, nparts, capacity,
                                    axes_of(mesh))
        return back[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_run_vec_export_step(mesh: Mesh, saturate: int | None = None):
    """Jitted device-side node export: one row per distinct live key with
    its 9 summed counters, COMPACTED to the front per shard (one stable
    sort) — the to_dict / save surface.  Returns
    (keys_out[p, cap, w], vecs_out[p, cap, 9], n[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        w, cap = store.keys.shape
        neq_prev, neq_next = st._adjacent_neq(store.keys)
        # per-run totals per counter column, gather-free: bsum columns
        # are nondecreasing, so head/last scans broadcast within runs
        totals = []
        for j in range(9):
            incl = store.bsum[j]
            excl = st._excl_of(incl)
            start = jax.lax.cummax(
                jnp.where(neq_prev, excl, jnp.int32(-2147483648)), axis=0)
            end = jax.lax.cummin(
                jnp.where(neq_next, incl,
                          jnp.int32(2147483647))[::-1], axis=0)[::-1]
            totals.append(end - start)
        if saturate is not None:
            totals = [jnp.minimum(t, saturate) for t in totals]
        emit = neq_next & (totals[8] > 0)
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[j] for j in range(w))
            + tuple(totals), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        vecs_out = jnp.stack(ops[1 + w:], axis=1)
        return keys_out[None], vecs_out[None], n_emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_debruijn_quality_run_ingest_step(mesh: Mesh, nparts: int, spec,
                                          canonical: bool, capacity: int,
                                          hash_name: str, codec,
                                          raw: bool = False):
    """Jitted QUALITY de Bruijn run ingest: like
    make_debruijn_run_ingest_step with each window's phred score riding
    as one extra bitcast payload column (QualityScoreGenerationIterator
    zip, de_bruijn_construct_engine.hpp:160-230).  Returns (sorted kcols
    [p, w, m], ebytes[p, m], weights[p, m], qsums[p, m], overflow[p])."""
    from ..debruijn.edges import (edge_bytes_for_windows,
                                  revcomp_edge_byte)
    from ..ops import packing, sortops
    from ..quality import window_quality

    def body(codes_blk, valid_blk, owned_blk, seg_blk, qual_blk):
        codes, valid, owned, seg, qual = (
            codes_blk[0], valid_blk[0], owned_blk[0], seg_blk[0],
            qual_blk[0])
        if raw:
            kcodes = jnp.take(jnp.asarray(spec.alphabet.from_ascii),
                              codes.astype(jnp.int32))
        else:
            kcodes = codes
        if canonical:
            words, was_rc = packing.extract_canonical(kcodes, spec)
        else:
            words = packing.extract_kmers(kcodes, spec)
            was_rc = jnp.zeros(codes.shape[0], bool)
        wvalid = packing.window_valid(valid, seg, spec.k) & owned
        edges = edge_bytes_for_windows(codes, valid, seg, spec.k,
                                       spec.alphabet, raw=raw)
        edges = jnp.where(was_rc, revcomp_edge_byte(edges), edges)
        wq = window_quality(qual, spec.k, codec)
        owner = owners_for(words, nparts, hash_name)
        qbits = jax.lax.bitcast_convert_type(wq, jnp.uint32)
        (rw, re, rqb), rvalid, route = dist.distribute(
            (words, edges.astype(jnp.uint32), qbits), owner, wvalid,
            nparts, capacity, axes_of(mesh))
        s_words, (s_eb, s_qb), s_valid = sortops.sort_rows(
            rw, (re, rqb), rvalid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, word_bits=spec.word_bits(),
            as_cols=True)
        if not spec.sentinel_safe:
            s_words = jnp.where(s_valid[None, :], s_words,
                                jnp.uint32(0xFFFFFFFF))
        ebytes = jnp.where(s_valid, s_eb, 0).astype(jnp.int32)
        weights = s_valid.astype(jnp.int32)
        qsums = jnp.where(
            s_valid, jax.lax.bitcast_convert_type(s_qb, jnp.float32), 0.0)
        return (s_words[None], ebytes[None], weights[None], qsums[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 5,
        out_specs=(P(axes_of(mesh)),) * 5,
    ))


def make_run_vecq_adopt_step(mesh: Mesh, unit: bool = False,
                             table: bool = True):
    """Jitted: adopt a sorted quality edge run as the whole store."""

    def body(words_blk, ebytes_blk, weights_blk, qsums_blk):
        if unit:
            out = st.run_vecq_from_sorted_unit(
                words_blk[0], ebytes_blk[0], weights_blk[0],
                qsums_blk[0], table=table)
        else:
            out = st.run_vecq_from_sorted(
                words_blk[0], ebytes_blk[0], weights_blk[0],
                qsums_blk[0])
        return _stack(out)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 4,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vecq_merge_pair_step(mesh: Mesh, unit: bool = False,
                                  table: bool = True):
    def body(a_blk, b_blk):
        a, b = _unstack(a_blk), _unstack(b_blk)
        if unit:
            out = st.run_vecq_merge_unit(a, b, table=table)
        else:
            out = st.run_vecq_merge(a, b)
            if not table:
                out = st.RunVecQStore(keys=out.keys, ebytes=out.ebytes,
                                      weights=out.weights,
                                      qsums=out.qsums, bsum=None,
                                      qcsum=None)
        return _stack(out)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 2,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vecq_table_step(mesh: Mesh):
    """Jitted: materialize a LAZY quality run's tables."""

    def body(stores_blk):
        return _stack(st.run_vecq_with_table(_unstack(stores_blk)))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),),
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vecq_stats_step(mesh: Mesh):
    def body(stores_blk):
        return st.run_vecq_distinct(_unstack(stores_blk))[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=P(axes_of(mesh)),
    ))


def make_run_vecq_compact_step(mesh: Mesh, new_cap: int):
    def body(stores_blk):
        new, ovf = st.run_vecq_compact(_unstack(stores_blk), new_cap)
        return _stack(new), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 2,
    ))


def make_runs_vecq_query_step(mesh: Mesh, nparts: int, capacity: int,
                              hash_name: str, saturate: int | None,
                              nruns: int):
    """Jitted node-counter + quality-sum query over a list of quality
    edge runs: route once, prefix-difference lookups, sum, reply."""

    def body(stores_blk, queries_blk, qvalid_blk):
        stores = [_unstack(s) for s in stores_blk]
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        total, qtotal = st.run_vecq_lookup(stores[0], rq, None)
        for s in stores[1:]:
            t, qt = st.run_vecq_lookup(s, rq, None)
            total = total + t
            qtotal = qtotal + qt
        if saturate is not None:
            total = jnp.minimum(total, saturate)
        local = jnp.where(rvalid[:, None], total, 0)
        localq = jnp.where(
            rvalid, jax.lax.bitcast_convert_type(qtotal, jnp.uint32), 0)
        back, backq = dist.undistribute(
            (local, localq), route, nparts, capacity, axes_of(mesh))
        return (back[None],
                jax.lax.bitcast_convert_type(backq, jnp.float32)[None],
                route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_vecq_export_step(mesh: Mesh, saturate: int | None = None):
    """Jitted device-side quality node export: one row per distinct live
    key with 9 summed counters + window count + quality sum, compacted
    to the front.  Returns (keys_out[p, cap, w], vecs_out[p, cap, 10],
    qsum_out[p, cap], n[p]) — vecs_out's last column is the window
    count (== the self counter)."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        w, cap = store.keys.shape
        neq_prev, neq_next = st._adjacent_neq(store.keys)
        totals = []
        for j in range(9):
            incl = store.bsum[j]
            excl = st._excl_of(incl)
            start = jax.lax.cummax(
                jnp.where(neq_prev, excl, jnp.int32(-2147483648)), axis=0)
            end = jax.lax.cummin(
                jnp.where(neq_next, incl,
                          jnp.int32(2147483647))[::-1], axis=0)[::-1]
            totals.append(end - start)
        q_incl = store.qcsum
        q_total = q_incl - st._broadcast_head(st._excl_of(q_incl), neq_prev)
        if saturate is not None:
            totals = [jnp.minimum(t, saturate) for t in totals]
        emit = neq_next & (totals[8] > 0)
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[j] for j in range(w))
            + tuple(totals)
            + (totals[8],
               jax.lax.bitcast_convert_type(q_total, jnp.uint32)),
            num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        vecs_out = jnp.stack(ops[1 + w:1 + w + 10], axis=1)
        qsum_out = jax.lax.bitcast_convert_type(ops[11 + w], jnp.float32)
        return keys_out[None], vecs_out[None], qsum_out[None], n_emit[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


# ---------------------------------------- run-layout Bimolecule store
# The Bimolecule preset runs on the RUN layout (store.RunBimolStore):
# flushes are (w + 4)-column bitonic merges + a prefix rebuild instead of
# the compacted bimol_insert's store+batch re-sort.  Count queries,
# histogram, predicate selects and stats reuse the count family's
# run-store steps duck-typed (same keys/weights/csum fields); only the
# representative (first-occurrence orientation) surface is new.

def make_bimol_run_ingest_step(mesh: Mesh, nparts: int, spec,
                               capacity: int, hash_name: str):
    """Jitted Bimolecule run ingest: canonical extraction (+ strand flag)
    + owner exchange + ONE local sort carrying (id_hi, id_lo, strand)
    payloads.  Returns (kcols[p, w, m], weights[p, m], hi[p, m],
    lo[p, m], strand[p, m], route_overflow[p]) — an adoptable run."""
    from ..io.kmer_parsers import DeviceBases, extract_tuples
    from ..ops import sortops

    def body(codes_blk, valid_blk, owned_blk, seg_blk, hi_blk, lo_blk):
        bases = DeviceBases(
            codes=codes_blk[0], valid=valid_blk[0], owned=owned_blk[0],
            seg_id=seg_blk[0], id_hi=hi_blk[0], id_lo=lo_blk[0],
            qual=jnp.zeros_like(codes_blk[0]),
        )
        tup = extract_tuples(bases, spec, canonical=True)
        owner = owners_for(tup.words, nparts, hash_name)
        (rw, rhi, rlo, rs), rvalid, route = dist.distribute(
            (tup.words, tup.id_hi, tup.id_lo,
             tup.strand.astype(jnp.uint32)),
            owner, tup.valid, nparts, capacity, axes_of(mesh))
        s_words, (s_hi, s_lo, s_s), s_valid = sortops.sort_rows(
            rw, (rhi, rlo, rs), rvalid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, word_bits=spec.word_bits(),
            as_cols=True)
        s_words = jnp.where(s_valid[None, :], s_words,
                            jnp.uint32(0xFFFFFFFF))
        weights = s_valid.astype(jnp.int32)
        s_hi = jnp.where(s_valid, s_hi, jnp.uint32(0xFFFFFFFF))
        s_lo = jnp.where(s_valid, s_lo, jnp.uint32(0xFFFFFFFF))
        s_s = jnp.where(s_valid, s_s, 0)
        return (s_words[None], weights[None], s_hi[None], s_lo[None],
                s_s[None], route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_run_bimol_tuples_step(mesh: Mesh, nparts: int, capacity: int,
                               hash_name: str):
    """Jitted: route explicit (canonical key, weight, id, strand) tuples
    to owners and sort them into an adoptable run (the insert /
    insert_counts / load path)."""
    from ..ops import sortops

    def body(words_blk, w_blk, hi_blk, lo_blk, s_blk, valid_blk):
        words, wt, hi, lo, stc, valid = (
            words_blk[0], w_blk[0], hi_blk[0], lo_blk[0], s_blk[0],
            valid_blk[0])
        owner = owners_for(words, nparts, hash_name)
        (rw, rwt, rhi, rlo, rs), rvalid, route = dist.distribute(
            (words, wt.astype(jnp.uint32), hi, lo,
             stc.astype(jnp.uint32)),
            owner, valid, nparts, capacity, axes_of(mesh))
        s_words, (s_wt, s_hi, s_lo, s_s), s_valid = sortops.sort_rows(
            rw, (rwt, rhi, rlo, rs), rvalid, is_stable=False)
        s_words = jnp.where(s_valid[:, None], s_words,
                            jnp.uint32(0xFFFFFFFF))
        kcols = jnp.stack([s_words[:, j]
                           for j in range(s_words.shape[1])], axis=0)
        weights = jnp.where(s_valid, s_wt, 0).astype(jnp.int32)
        s_hi = jnp.where(s_valid, s_hi, jnp.uint32(0xFFFFFFFF))
        s_lo = jnp.where(s_valid, s_lo, jnp.uint32(0xFFFFFFFF))
        s_s = jnp.where(s_valid, s_s, 0)
        return (kcols[None], weights[None], s_hi[None], s_lo[None],
                s_s[None], route.overflow[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 6,
        out_specs=(P(axes_of(mesh)),) * 6,
    ))


def make_run_bimol_adopt_step(mesh: Mesh):
    def body(words_blk, w_blk, hi_blk, lo_blk, s_blk):
        return _stack(st.run_bimol_from_sorted(
            words_blk[0], w_blk[0], hi_blk[0], lo_blk[0], s_blk[0]))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 5,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_bimol_merge_pair_step(mesh: Mesh):
    def body(a_blk, b_blk):
        return _stack(st.run_bimol_merge(_unstack(a_blk),
                                         _unstack(b_blk)))

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 2,
        out_specs=P(axes_of(mesh)),
    ))


def make_run_bimol_find_step(mesh: Mesh, nparts: int, capacity: int,
                             hash_name: str,
                             saturate: int | None = None):
    """Jitted Bimolecule lookup over the run store: route -> count +
    min-rep strand -> reply (the device half of find;
    kmer_index.hpp:436-562 keep-first-inserted-key semantics)."""

    def body(stores_blk, queries_blk, qvalid_blk):
        store = _unstack(stores_blk)
        queries, qvalid = queries_blk[0], qvalid_blk[0]
        owner = owners_for(queries, nparts, hash_name)
        (rq,), rvalid, route = dist.distribute(
            (queries,), owner, qvalid, nparts, capacity, axes_of(mesh))
        counts, strand = st.run_bimol_lookup(store, rq, saturate)
        counts = jnp.where(rvalid, counts, 0)
        strand = jnp.where(rvalid, strand, 0)
        back_c, back_s = dist.undistribute(
            (counts, strand), route, nparts, capacity, axes_of(mesh))
        return back_c[None], back_s[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_bimol_erase_step(mesh: Mesh, nparts: int, capacity: int,
                              hash_name: str):
    def body(stores_blk, keys_blk, valid_blk):
        store = _unstack(stores_blk)
        keys, valid = keys_blk[0], valid_blk[0]
        owner = owners_for(keys, nparts, hash_name)
        (rk,), rvalid, route = dist.distribute(
            (keys,), owner, valid, nparts, capacity, axes_of(mesh))
        new_store, nerased = st.run_bimol_erase(store, rk, rvalid)
        return _stack(new_store), nerased[None], route.overflow[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes_of(mesh)),) * 3,
        out_specs=(P(axes_of(mesh)),) * 3,
    ))


def make_run_bimol_filter_step(mesh: Mesh, pred,
                               saturate: int | None = None):
    """Jitted predicate filter over the run store: runs whose
    (canonical key, count) fail `pred` get their weights zeroed.
    Returns (new_stores, n_erased[p] — distinct keys dropped)."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        w, cap = store.keys.shape
        is_head, _, total = st.run_totals(store)
        counts = total if saturate is None else jnp.minimum(total,
                                                            saturate)
        keep_head = pred(jnp.swapaxes(store.keys, 0, 1), counts)
        # broadcast each run head's verdict over the run (last-set scan)
        keep = st._broadcast_head(keep_head, is_head)
        live = total > 0
        new_w = jnp.where(keep, store.weights, 0)
        nerased = jnp.sum((is_head & live & ~keep).astype(jnp.int32))
        new = st.RunBimolStore(
            keys=store.keys,
            weights=new_w,
            csum=jnp.concatenate([jnp.zeros(1, jnp.int32),
                                  st._cumsum_i32(new_w)]),
            rep_hi=store.rep_hi,
            rep_lo=store.rep_lo,
            rep_strand=store.rep_strand,
        )
        return _stack(new), nerased[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)), P(axes_of(mesh))),
    ))


def make_run_bimol_export_step(mesh: Mesh, saturate: int | None = None):
    """Jitted device-side export: one (canonical key, count, min-rep
    strand) row per distinct live key, compacted to the front.
    Returns (keys_out[p, cap, w], counts_out[p, cap],
    strand_out[p, cap], n[p])."""

    def body(stores_blk):
        store = _unstack(stores_blk)
        w, cap = store.keys.shape
        _, is_last, total = st.run_totals(store)
        counts = total if saturate is None else jnp.minimum(total,
                                                            saturate)
        _, _, mst = st._segmented_min_rep(
            store.keys, store.weights, store.rep_hi, store.rep_lo,
            store.rep_strand)
        emit = is_last & (total > 0)
        n_emit = jnp.sum(emit.astype(jnp.int32))
        front_key = (~emit).astype(jnp.uint32)
        ops = jax.lax.sort(
            (front_key,) + tuple(store.keys[j] for j in range(w))
            + (counts, mst), num_keys=1, is_stable=True)
        keys_out = jnp.stack(ops[1:1 + w], axis=1)
        return (keys_out[None], ops[1 + w][None], ops[2 + w][None],
                n_emit[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 4,
    ))


def make_run_bimol_compact_step(mesh: Mesh, new_cap: int,
                                saturate: int | None = None):
    def body(stores_blk):
        new, ovf = st.run_bimol_compact(_unstack(stores_blk), new_cap,
                                        saturate)
        return _stack(new), ovf[None]

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(axes_of(mesh)),),
        out_specs=(P(axes_of(mesh)),) * 2,
    ))

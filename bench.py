"""Throughput benchmark of the canonical count-index build (and, by
--mode, of the other index families and query paths) on the default
device.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "kmers/s", "device": {...}, ...}

The timed program is the FULL build of a multi-chunk corpus into a
queryable index state — per chunk: extract + canonicalize + sort
(ingest), plus every LSM run-merge the index's default policy triggers
(bitonic-merge network, `ops/sortops.merge_sorted_runs_cols`), plus the
per-run prefix sums that make counts answerable.  Nothing is deferred
past the timer: when it stops, `count()` on the result is pure lookup
work.

``vs_baseline`` divides by a single-thread vectorized-numpy rate for the
same pipeline, measured live with --measure-baseline (the query modes
always measure their own); without it the field is null.

Usage: python bench.py [--bases N] [--k K] [--chunks C] [--max-runs R]
                       [--iters I] [--mode e2e|ingest|debruijn|...]
                       [--json-only]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _log(msg, quiet):
    if not quiet:
        print(msg, file=sys.stderr, flush=True)


def make_batch(n_bases: int, read_len: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    valid = np.ones(n_bases, dtype=bool)
    seg_id = (np.arange(n_bases) // read_len).astype(np.int32)
    return codes, valid, seg_id


def numpy_baseline(codes: np.ndarray, seg_id: np.ndarray, k: int) -> float:
    """Single-thread numpy canonical count build; returns kmers/s."""
    t0 = time.perf_counter()
    n = codes.shape[0]
    c = codes.astype(np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1)
    acc = np.zeros(n, dtype=np.uint64)
    acc[:] = c
    span = 1
    while span < k:
        step = min(span, k - span)
        shifted = np.zeros_like(acc)
        shifted[:-step] = acc[step:]
        acc = (acc << np.uint64(2 * step)) | shifted
        span += step
    packed = acc[: n - k + 1] & mask
    comp = np.uint64(3) - c
    racc = comp[::-1].copy()
    span = 1
    while span < k:
        step = min(span, k - span)
        shifted = np.zeros_like(racc)
        shifted[:-step] = racc[step:]
        racc = (racc << np.uint64(2 * step)) | shifted
        span += step
    rc = racc[::-1][k - 1:] & mask
    canon = np.minimum(packed, rc)
    valid_w = seg_id[: n - k + 1] == seg_id[k - 1:]
    vals = canon[valid_w]
    uniq, counts = np.unique(vals, return_counts=True)
    dt = time.perf_counter() - t0
    return vals.shape[0] / dt, (uniq, counts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=1 << 24,
                    help="bases per chunk")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--chunks", type=int, default=8,
                    help="chunks in the end-to-end build")
    ap.add_argument("--max-runs", type=int, default=4,
                    help="LSM run bound (merges trigger above it)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--inner", type=int, default=40,
                    help="builds per dispatch in --mode ingest")
    ap.add_argument("--mode", default="e2e",
                    choices=("e2e", "ingest", "count_query",
                             "multimap_find", "erase", "debruijn",
                             "debruijn_quality", "position",
                             "position_quality"))
    ap.add_argument("--queries", type=int, default=1 << 20,
                    help="query rows in the query-rate modes")
    ap.add_argument("--max-per-query", type=int, default=16,
                    help="multimap find gather width")
    ap.add_argument("--baseline-bases", type=int, default=1 << 21)
    ap.add_argument("--measure-baseline", action="store_true")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args()
    quiet = args.json_only

    import jax
    import jax.numpy as jnp

    # persistent-compile-cache effectiveness counters (ask: a warm start
    # must be attributable — trace vs cache-deserialize vs first run)
    cache_stats = {"hits": 0, "misses": 0}
    import jax.monitoring as _jm

    def _on_event(event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            cache_stats["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache_stats["misses"] += 1
    _jm.register_event_listener(_on_event)

    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.index import store as st
    from kmerind_jax.io.kmer_parsers import DeviceBases, extract_tuples
    from kmerind_jax.ops import sortops

    dev = jax.devices()[0]
    _log(f"device: {dev}", quiet)
    spec = KmerSpec(args.k, DNA)

    codes, valid, seg = make_batch(args.bases, args.read_len)

    def ingest(codes, valid, seg_id, salt):
        # salt perturbs the input so repeated on-device builds cannot be
        # collapsed by the compiler (flips the low bit of one base code)
        c = codes.at[0].set(codes[0] ^ (salt & jnp.uint8(1)))
        bases = DeviceBases(
            codes=c, valid=valid, owned=jnp.ones_like(valid),
            seg_id=seg_id,
            id_hi=jnp.zeros_like(codes, jnp.uint32),
            id_lo=jnp.zeros_like(codes, jnp.uint32),
            qual=jnp.zeros_like(codes),
        )
        tup = extract_tuples(bases, spec, canonical=True)
        s_words, _, s_valid = sortops.sort_rows(
            tup.words, (), tup.valid, is_stable=False,
            sentinel_ok=spec.sentinel_safe, word_bits=spec.word_bits(),
            as_cols=True)
        if not spec.sentinel_safe:
            s_words = jnp.where(s_valid[None, :], s_words,
                                jnp.uint32(0xFFFFFFFF))
        return s_words, s_valid.astype(jnp.int32)

    unit_runs = spec.sentinel_safe  # the UNIT-run path CountIndex takes

    dcodes = jax.device_put(codes, dev)
    dvalid = jax.device_put(valid, dev)
    dseg = jax.device_put(seg, dev)

    compile_s = [0.0]  # wall time to first result (compile or cache load)
    breakdown: dict = {}  # e2e: trace_s / backend_s / first_run_s

    base_rate = None  # query modes compute their own numpy baseline

    def synth_read_batch():
        """The bench corpus as a host ReadBatch (for index.build paths)."""
        from kmerind_jax.io.batch import ReadBatch
        n, rl = args.bases, args.read_len
        r = (n + rl - 1) // rl
        return ReadBatch(
            codes=codes, valid=valid, owned=np.ones(n, bool), seg_id=seg,
            offset_in_record=(np.arange(n) % rl).astype(np.uint32),
            global_pos=np.arange(n, dtype=np.uint64),
            qual=np.zeros(n, np.uint8),
            record_start=np.arange(r, dtype=np.uint64) * rl,
            seq_index=np.arange(r, dtype=np.uint32),
            file_id=np.zeros(r, np.uint16), alphabet=DNA)

    def sample_query_words():
        """args.queries in-read windows of the corpus, as host word rows."""
        from kmerind_jax.ops import packing
        w_all = np.asarray(jax.jit(
            packing.extract_kmers, static_argnames=("spec",))(dcodes, spec))
        starts = np.random.default_rng(1).integers(
            0, args.bases - args.k + 1, args.queries)
        in_read = seg[starts] == seg[starts + args.k - 1]
        # replace boundary-crossing picks with aligned ones (guaranteed
        # hits, matching the reference's query-from-same-file setup)
        starts = np.where(in_read, starts,
                          (starts // args.read_len) * args.read_len)
        return w_all[starts]

    def timed_step(run, force):
        """min-of-iters wall time of run(), ended by block_until_ready."""
        run()  # warm (compile already done by the caller loop)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(force(run()))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    if args.mode == "count_query":
        # Distributed count-query rate at a 16.7M-row store / 1M queries
        # (BenchmarkKmerIndex count phase, :524-535).  Queries are staged
        # to the device once; the timed program is the full routed query
        # step (hash -> all_to_all -> per-run csum lookups -> reply).
        from kmerind_jax.index import distributed as dxm
        from kmerind_jax.index.api import CountIndex
        idx = CountIndex(spec)
        _log(f"building {args.bases >> 20}M-base store…", quiet)
        idx.insert_batch(synth_read_batch())
        idx._flush()
        qw = idx._maybe_canonicalize_queries(sample_query_words())
        _log(f"store: {idx.size()} kmers over {len(idx.runs)} runs; "
             f"{len(qw)} queries", quiet)
        (wsh,), vsh, m = idx._shard_rows(qw)
        mq = wsh.shape[1]
        bucket_cap = idx._bucket_capacity(mq)
        t0 = time.perf_counter()
        # per-run query-aux metadata (round 5): run totals + gather
        # operand + bucket table built ONCE per store version — exactly
        # what CountIndex.count() now does
        aux = idx._ensure_aux()
        while True:
            step = dxm.make_runs_count_query_step(
                idx.mesh, idx.nparts, bucket_cap, idx.hash_name,
                idx.saturate, len(idx.runs), cached=True)
            counts, ovf = step(tuple(idx.runs), wsh, vsh, *aux)
            if int(np.asarray(ovf).max()) == 0:
                break
            bucket_cap *= 2
        compile_s[0] = time.perf_counter() - t0
        assert int(np.asarray(counts).sum()) >= m  # all sampled hits hit
        best = timed_step(lambda: step(tuple(idx.runs), wsh, vsh, *aux),
                          lambda out: out[0].sum())
        n_windows = m
        rate = m / best
        metric = ("queries/s/device (distributed count query, %dM-row "
                  "store, %dk queries, k=%d)"
                  % (idx.size() >> 20, m >> 10, args.k))
        # numpy baseline: binary search of the same queries over the
        # same-size sorted u64 key set (single thread)
        skeys = np.sort(np.random.default_rng(2).integers(
            0, 1 << 42, idx.size(), dtype=np.uint64))
        bq = skeys[np.random.default_rng(3).integers(0, len(skeys), m)]
        t0 = time.perf_counter()
        pos = np.searchsorted(skeys, bq)
        hit = skeys[np.minimum(pos, len(skeys) - 1)] == bq
        bt = time.perf_counter() - t0
        assert hit.all()
        base_rate = m / bt
        _log(f"numpy searchsorted baseline: {base_rate/1e6:.2f} Mq/s",
             quiet)
    elif args.mode == "erase":
        # Distributed erase rate at a 16.7M-row store / 1M keys
        # (BenchmarkKmerIndex erase phase, :549-560).  The erase step is
        # functional (returns new stores), so repeated timing runs hit
        # the same store snapshot.
        from kmerind_jax.index import distributed as dxm
        from kmerind_jax.index.api import CountIndex
        idx = CountIndex(spec)
        _log(f"building {args.bases >> 20}M-base store…", quiet)
        idx.insert_batch(synth_read_batch())
        idx._flush()
        qw = idx._maybe_canonicalize_queries(sample_query_words())
        (wsh,), vsh, m = idx._shard_rows(qw)
        mq = wsh.shape[1]
        bucket_cap = idx._bucket_capacity(mq)
        t0 = time.perf_counter()
        while True:
            step = dxm.make_runs_erase_step(
                idx.mesh, idx.nparts, bucket_cap, idx.hash_name,
                len(idx.runs))
            _, nerased, ovf = step(tuple(idx.runs), wsh, vsh)
            if int(np.asarray(ovf).max()) == 0:
                break
            bucket_cap *= 2
        compile_s[0] = time.perf_counter() - t0
        assert int(np.asarray(nerased).sum()) > 0
        best = timed_step(lambda: step(tuple(idx.runs), wsh, vsh),
                          lambda out: out[1].sum())
        n_windows = m
        rate = m / best
        metric = ("keys/s/device (distributed erase, %dM-row store, %dk "
                  "keys, k=%d)" % (idx.size() >> 20, m >> 10, args.k))
        # numpy baseline: searchsorted + boolean-mask compaction
        skeys = np.sort(np.random.default_rng(2).integers(
            0, 1 << 42, idx.size(), dtype=np.uint64))
        bq = skeys[np.random.default_rng(3).integers(0, len(skeys), m)]
        t0 = time.perf_counter()
        pos = np.searchsorted(skeys, bq)
        kill = np.zeros(len(skeys) + 1, bool)
        kill[np.minimum(pos, len(skeys) - 1)] = True
        _ = skeys[~kill[:-1]]
        bt = time.perf_counter() - t0
        base_rate = m / bt
        _log(f"numpy erase baseline: {base_rate/1e6:.2f} Mkeys/s", quiet)
    elif args.mode == "multimap_find":
        # Multimap find rate (position lists) at a 16.7M-pair store / 1M
        # queries (BenchmarkKmerIndex find phase, :536-548).
        from kmerind_jax.index import distributed as dxm
        from kmerind_jax.index.api import PositionIndex
        idx = PositionIndex(spec)
        _log(f"building {args.bases >> 20}M-base position store…", quiet)
        idx.insert_batch(synth_read_batch())
        idx._flush()
        qw = idx._maybe_canonicalize_queries(sample_query_words())
        _log(f"store: {idx.size()} pairs; {len(qw)} queries", quiet)
        (wsh,), vsh, m = idx._shard_rows(qw)
        mq = wsh.shape[1]
        bucket_cap = idx._bucket_capacity(mq)
        mpq = args.max_per_query
        t0 = time.perf_counter()
        # per-store query-aux metadata (round 5), as PositionIndex.find
        aux = idx._ensure_aux()
        while True:
            step = dxm.make_multi_find_step(
                idx.mesh, idx.nparts, bucket_cap, idx.hash_name, mpq,
                cached=True)
            hi, lo, q, mask, nfound, ovf = step(idx.store, wsh, vsh, aux)
            if int(np.asarray(ovf).max()) != 0:
                bucket_cap *= 2
                continue
            worst = int(np.asarray(nfound).max())
            if worst > mpq:
                mpq = 1 << (worst - 1).bit_length()
                continue
            break
        compile_s[0] = time.perf_counter() - t0
        pairs = int(np.asarray(nfound).sum())
        assert pairs >= m
        best = timed_step(lambda: step(idx.store, wsh, vsh, aux),
                          lambda out: out[4].sum())
        n_windows = m
        rate = m / best
        metric = ("queries/s/device (multimap find, %dM-pair store, %dk "
                  "queries, max_per_query=%d, k=%d)"
                  % (idx.size() >> 20, m >> 10, mpq, args.k))
        # numpy baseline: searchsorted range + bounded gather of the
        # payload lists over same-size sorted u64 keys
        skeys = np.sort(np.random.default_rng(2).integers(
            0, 1 << 42, idx.size(), dtype=np.uint64))
        vals = np.arange(len(skeys), dtype=np.uint64)
        bq = skeys[np.random.default_rng(3).integers(0, len(skeys), m)]
        t0 = time.perf_counter()
        lo_ = np.searchsorted(skeys, bq, side="left")
        hi_ = np.searchsorted(skeys, bq, side="right")
        take = np.minimum(hi_ - lo_, mpq)
        out = vals[np.minimum(lo_[:, None] + np.arange(mpq), len(vals) - 1)]
        _ = out * (np.arange(mpq) < take[:, None])
        bt = time.perf_counter() - t0
        base_rate = m / bt
        _log(f"numpy find baseline: {base_rate/1e6:.2f} Mq/s", quiet)
    elif args.mode == "debruijn":
        # END-TO-END de Bruijn graph build: extraction + strand-corrected
        # edge bytes + per-chunk sort (ONE edge-byte payload) + the run
        # store's LSM merge policy with per-merge prefix-table rebuilds —
        # the exact device schedule DeBruijnGraph runs for this corpus
        # (the reference's de_bruijn_construct_engine + node reduction,
        # test/test/debruijn/de_bruijn_construct_engine.hpp:91-131)
        from kmerind_jax.debruijn.edges import (edge_bytes_for_windows,
                                                revcomp_edge_byte)
        from kmerind_jax.ops import packing
        C, MAX_RUNS = args.chunks, args.max_runs

        def dbg_ingest(codes, valid, seg_id, salt):
            c = codes.at[0].set(codes[0] ^ (salt & jnp.uint8(1)))
            words, was_rc = packing.extract_canonical(c, spec)
            wvalid = packing.window_valid(valid, seg_id, spec.k)
            edges = edge_bytes_for_windows(c, valid, seg_id, spec.k,
                                           spec.alphabet)
            edges = jnp.where(was_rc, revcomp_edge_byte(edges), edges)
            s_words, (s_eb,), s_valid = sortops.sort_rows(
                words, (edges.astype(jnp.uint32),), wvalid,
                is_stable=False, sentinel_ok=spec.sentinel_safe,
                word_bits=spec.word_bits(), as_cols=True)
            if not spec.sentinel_safe:
                s_words = jnp.where(s_valid[None, :], s_words,
                                    jnp.uint32(0xFFFFFFFF))
            # LAZY runs: counter tables are deferred to the end of the
            # build (intermediate LSM runs never need them) — exactly
            # what DeBruijnGraph does
            if spec.sentinel_safe:
                return st.run_vec_from_sorted_unit(
                    s_words,
                    jnp.where(s_valid, s_eb, 0).astype(jnp.int32),
                    s_valid.astype(jnp.int32), table=False)
            return st.run_vec_from_sorted(
                s_words, jnp.where(s_valid, s_eb, 0).astype(jnp.int32),
                s_valid.astype(jnp.int32))

        if spec.sentinel_safe:
            mg = lambda a, b: st.run_vec_merge_unit(a, b, table=False)
        else:
            mg = st.run_vec_merge

        @jax.jit
        def build(codes, valid, seg_id, salt0):
            runs = []
            for i in range(C):
                runs.append(dbg_ingest(codes, valid, seg_id,
                                       salt0 + jnp.uint8(i)))
                while len(runs) > MAX_RUNS:
                    runs.sort(key=lambda r: r.keys.shape[-1],
                              reverse=True)
                    b = runs.pop()
                    a = runs.pop()
                    runs.append(mg(a, b))
            acc = jnp.uint32(0)
            total = jnp.int32(0)
            for r in runs:
                r = st.run_vec_with_table(r)
                acc = acc + r.keys[0, 0] + r.bsum[0, -1].astype(
                    jnp.uint32)
                total = total + r.bsum[8, -1]
            return acc, total

        _log(f"compiling de Bruijn build ({C} chunks, "
             f"max_runs={MAX_RUNS})…", quiet)
        t0 = time.perf_counter()
        r = build(dcodes, dvalid, dseg, jnp.uint8(0))
        total = int(np.asarray(r[1]))
        compile_s[0] = time.perf_counter() - t0
        _log(f"compile+first run: {compile_s[0]:.1f}s "
             f"(total windows in store: {total})", quiet)
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = build(dcodes, dvalid, dseg, jnp.uint8(i))
            jax.block_until_ready(r)
            times.append(time.perf_counter() - t0)
            _log(f"iter {i}: {times[-1]*1e3:.0f} ms/build", quiet)
        n_windows = total
        best = min(times)
        rate = n_windows / best
        metric = ("kmers/s/device (de Bruijn graph build END-TO-END: "
                  "%d chunks, k=%d, edge bytes + LSM merges + prefix "
                  "tables included)" % (C, args.k))
    elif args.mode == "debruijn_quality":
        # END-TO-END quality de Bruijn build: the debruijn mode plus each
        # window's phred score riding the sorts/merges as one bitcast
        # float column and the float quality prefix sums rebuilt per
        # merge (de_bruijn_quality_engine,
        # test/test/debruijn/de_bruijn_construct_engine.hpp:245 — the
        # reference declares but never measures it; this is its first
        # number).
        from kmerind_jax.debruijn.edges import (edge_bytes_for_windows,
                                                revcomp_edge_byte)
        from kmerind_jax.ops import packing
        from kmerind_jax.quality import ILLUMINA18, window_quality
        C, MAX_RUNS = args.chunks, args.max_runs
        qual_np = np.random.default_rng(5).integers(
            33, 75, args.bases).astype(np.uint8)
        dqual = jax.device_put(qual_np, dev)

        def dbq_ingest(codes, valid, seg_id, qual, salt):
            c = codes.at[0].set(codes[0] ^ (salt & jnp.uint8(1)))
            words, was_rc = packing.extract_canonical(c, spec)
            wvalid = packing.window_valid(valid, seg_id, spec.k)
            edges = edge_bytes_for_windows(c, valid, seg_id, spec.k,
                                           spec.alphabet)
            edges = jnp.where(was_rc, revcomp_edge_byte(edges), edges)
            wq = window_quality(qual, spec.k, ILLUMINA18)
            qbits = jax.lax.bitcast_convert_type(wq, jnp.uint32)
            s_words, (s_eb, s_qb), s_valid = sortops.sort_rows(
                words, (edges.astype(jnp.uint32), qbits), wvalid,
                is_stable=False, sentinel_ok=spec.sentinel_safe,
                word_bits=spec.word_bits(), as_cols=True)
            if not spec.sentinel_safe:
                s_words = jnp.where(s_valid[None, :], s_words,
                                    jnp.uint32(0xFFFFFFFF))
            qs = jnp.where(
                s_valid,
                jax.lax.bitcast_convert_type(s_qb, jnp.float32), 0.0)
            if spec.sentinel_safe:
                return st.run_vecq_from_sorted_unit(
                    s_words,
                    jnp.where(s_valid, s_eb, 0).astype(jnp.int32),
                    s_valid.astype(jnp.int32), qs, table=False)
            return st.run_vecq_from_sorted(
                s_words, jnp.where(s_valid, s_eb, 0).astype(jnp.int32),
                s_valid.astype(jnp.int32), qs)

        if spec.sentinel_safe:
            mgq = lambda a, b: st.run_vecq_merge_unit(a, b, table=False)
        else:
            mgq = st.run_vecq_merge

        @jax.jit
        def build(codes, valid, seg_id, qual, salt0):
            runs = []
            for i in range(C):
                runs.append(dbq_ingest(codes, valid, seg_id, qual,
                                       salt0 + jnp.uint8(i)))
                while len(runs) > MAX_RUNS:
                    runs.sort(key=lambda r: r.keys.shape[-1],
                              reverse=True)
                    b = runs.pop()
                    a = runs.pop()
                    runs.append(mgq(a, b))
            acc = jnp.float32(0)
            total = jnp.int32(0)
            for r in runs:
                r = st.run_vecq_with_table(r)
                acc = acc + r.qcsum[-1] + r.keys[0, 0].astype(jnp.float32)
                total = total + r.bsum[8, -1]
            return acc, total

        _log(f"compiling QUALITY de Bruijn build ({C} chunks, "
             f"max_runs={MAX_RUNS})…", quiet)
        t0 = time.perf_counter()
        r = build(dcodes, dvalid, dseg, dqual, jnp.uint8(0))
        total = int(np.asarray(r[1]))
        compile_s[0] = time.perf_counter() - t0
        _log(f"compile+first run: {compile_s[0]:.1f}s "
             f"(total windows in store: {total})", quiet)
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = build(dcodes, dvalid, dseg, dqual, jnp.uint8(i))
            jax.block_until_ready(r)
            times.append(time.perf_counter() - t0)
            _log(f"iter {i}: {times[-1]*1e3:.0f} ms/build", quiet)
        n_windows = total
        best = min(times)
        rate = n_windows / best
        metric = ("kmers/s/device (QUALITY de Bruijn build END-TO-END: "
                  "%d chunks, k=%d, edge bytes + phred scores + LSM "
                  "merges + int and float prefix tables included)"
                  % (C, args.k))
    elif args.mode in ("position", "position_quality"):
        # END-TO-END position(-quality) multimap build: per chunk,
        # extract + canonicalize + synthesize the 64-bit ShortSequence
        # ids + the multimap's merge-based flush (sort ONLY the batch +
        # two-operand bitonic merge with the sorted store,
        # store.multi_merge_flush), with capacity growth on the index's
        # schedule.  The reference times insert on its position flavors
        # (pINDEX=2/3, test/benchmark/BenchmarkKmerIndex.cpp:45-120,
        # 480-523); this is its analog, reported as pairs/s/device.
        from kmerind_jax.ops import packing
        with_q = args.mode == "position_quality"
        C = args.chunks
        _next_pow2 = lambda v: 1 << max(1, (int(v) - 1).bit_length())
        nwin = args.bases
        if with_q:
            from kmerind_jax.quality import ILLUMINA18, window_quality
            qual_np = np.random.default_rng(5).integers(
                33, 75, args.bases).astype(np.uint8)
            dqual = jax.device_put(qual_np, dev)
        else:
            dqual = jnp.zeros((1,), jnp.uint8)

        def pos_ingest(codes, valid, seg_id, qual, salt):
            c = codes.at[0].set(codes[0] ^ (salt & jnp.uint8(1)))
            words, _ = packing.extract_canonical(c, spec)
            wvalid = packing.window_valid(valid, seg_id, spec.k)
            # ShortSequenceKmerId-shaped 64-bit ids: sequence index in
            # the high word, in-read offset in the low word
            n = c.shape[0]
            hi = seg_id.astype(jnp.uint32)
            lo = (jnp.arange(n, dtype=jnp.uint32)
                  % jnp.uint32(args.read_len))
            if with_q:
                wq = window_quality(qual, spec.k, ILLUMINA18)
            else:
                wq = None
            return words, hi, lo, wq, wvalid

        @jax.jit
        def build(codes, valid, seg_id, qual, salt0):
            cap = _next_pow2(nwin)
            store = st.empty_multi_store(cap, spec.nwords)
            total_ovf = jnp.int32(0)
            for i in range(C):
                words, hi, lo, wq, wvalid = pos_ingest(
                    codes, valid, seg_id, qual, salt0 + jnp.uint8(i))
                need = _next_pow2((i + 1) * nwin)
                if need > cap:
                    pad = need - cap
                    store = st.MultiStore(
                        keys=jnp.pad(store.keys, ((0, pad), (0, 0)),
                                     constant_values=np.uint32(
                                         0xFFFFFFFF)),
                        val_hi=jnp.pad(store.val_hi, (0, pad)),
                        val_lo=jnp.pad(store.val_lo, (0, pad)),
                        val_q=jnp.pad(store.val_q, (0, pad)),
                        size=store.size)
                    cap = need
                store, ovf = st.multi_merge_flush(
                    store, words, hi, lo, wvalid, val_q=wq)
                total_ovf = total_ovf + ovf
            return store.size, total_ovf, store.keys[0, 0], \
                store.val_q.sum()

        _log(f"compiling {args.mode} build ({C} chunks)…", quiet)
        t0 = time.perf_counter()
        r = build(dcodes, dvalid, dseg, dqual, jnp.uint8(0))
        total = int(np.asarray(r[0]))
        assert int(np.asarray(r[1])) == 0
        compile_s[0] = time.perf_counter() - t0
        _log(f"compile+first run: {compile_s[0]:.1f}s "
             f"(total pairs in store: {total})", quiet)
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = build(dcodes, dvalid, dseg, dqual, jnp.uint8(i))
            jax.block_until_ready(r)
            times.append(time.perf_counter() - t0)
            _log(f"iter {i}: {times[-1]*1e3:.0f} ms/build", quiet)
        n_windows = total
        best = min(times)
        rate = n_windows / best
        metric = ("pairs/s/device (%s multimap build END-TO-END: %d "
                  "chunks, k=%d, 64-bit ids%s, merge-based flushes + "
                  "capacity growth included)"
                  % ("position-quality" if with_q else "position", C,
                     args.k, " + phred scores" if with_q else ""))
    elif args.mode == "e2e":
        C, MAX_RUNS = args.chunks, args.max_runs

        @jax.jit
        def build(codes, valid, seg_id, salt0):
            """Full C-chunk build: every chunk ingested + the index's LSM
            merge policy applied + per-run prefix sums — the exact device
            schedule CountIndex (max_runs=MAX_RUNS) runs for this corpus.
            Sentinel-safe specs take the index's UNIT-run path
            (store.run_merge_unit): merges are keys-only and csum is
            closed-form; other specs carry the weight column."""
            runs = []
            for i in range(C):
                w, t = ingest(codes, valid, seg_id,
                              salt0 + jnp.uint8(i))
                runs.append((w, t))
                while len(runs) > MAX_RUNS:
                    runs.sort(key=lambda r: r[0].shape[-1], reverse=True)
                    b = runs.pop()
                    a = runs.pop()
                    if unit_runs:
                        k2, _ = sortops.merge_sorted_runs_cols(
                            a[0], (), b[0], ())
                        wt = (~jnp.all(
                            k2 == jnp.uint32(0xFFFFFFFF),
                            axis=0)).astype(jnp.int32)
                    else:
                        k2, (wt,) = sortops.merge_sorted_runs_cols(
                            a[0], (a[1],), b[0], (b[1],))
                    runs.append((k2, wt))
            acc = jnp.uint32(0)
            total = jnp.int32(0)
            for w, t in runs:
                s = (st.run_from_sorted_unit(w, t) if unit_runs
                     else st.run_from_sorted(w, t))
                acc = acc + s.keys[0, 0]
                total = total + s.csum[-1]
            return acc, total

        _log(f"compiling e2e build ({C} chunks, max_runs={MAX_RUNS})…",
             quiet)
        # staged cold-start breakdown: trace+lower / backend compile (or
        # persistent-cache deserialize) / first dispatch+execute
        t0 = time.perf_counter()
        lowered = build.lower(dcodes, dvalid, dseg, jnp.uint8(0))
        t_trace = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        t_backend = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = compiled(dcodes, dvalid, dseg, jnp.uint8(0))
        total = int(np.asarray(r[1]))
        t_first = time.perf_counter() - t0
        compile_s[0] = t_trace + t_backend + t_first
        breakdown.update(
            trace_s=round(t_trace, 1), backend_s=round(t_backend, 1),
            first_run_s=round(t_first, 1))
        _log(f"compile+first run: {compile_s[0]:.1f}s "
             f"(trace {t_trace:.1f} + backend {t_backend:.1f} + first "
             f"run {t_first:.1f}; cache hits {cache_stats['hits']} / "
             f"misses {cache_stats['misses']}; total kmers in store: "
             f"{total})", quiet)
        build = compiled
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = build(dcodes, dvalid, dseg, jnp.uint8(i))
            jax.block_until_ready(r)
            times.append(time.perf_counter() - t0)
            _log(f"iter {i}: {times[-1]*1e3:.0f} ms/build", quiet)
        n_windows = total
        best = min(times)
        rate = n_windows / best
        metric = ("kmers/s/device (canonical count-index build END-TO-END: "
                  "%d chunks, k=%d, LSM merges + prefix sums included)"
                  % (C, args.k))
    else:
        INNER = args.inner

        @jax.jit
        def build_i(codes, valid, seg_id):
            def it(i, acc):
                w, t = ingest(codes, valid, seg_id, i.astype(jnp.uint8))
                return (acc[0] + w[0, 0], acc[1] + jnp.sum(t))
            return jax.lax.fori_loop(
                0, INNER, it, (jnp.uint32(0), jnp.int32(0)))

        _log("compiling ingest loop…", quiet)
        t0 = time.perf_counter()
        r = jax.block_until_ready(build_i(dcodes, dvalid, dseg))
        total = int(np.asarray(r[1])) // INNER
        compile_s[0] = time.perf_counter() - t0
        _log(f"compile+first run: {compile_s[0]:.1f}s", quiet)
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = build_i(dcodes, dvalid, dseg)
            jax.block_until_ready(r)
            times.append((time.perf_counter() - t0) / INNER)
            _log(f"iter {i}: {times[-1]*1e3:.1f} ms/chunk (x{INNER})", quiet)
        n_windows = total
        best = min(times)
        rate = n_windows / best
        metric = ("kmers/s/device (canonical count ingest only, k=%d)"
                  % args.k)

    if base_rate is not None:
        pass  # query modes measured their own numpy baseline above
    elif args.measure_baseline:
        _log("running numpy baseline…", quiet)
        bcodes, _, bseg = make_batch(args.baseline_bases, args.read_len)
        rates = []
        for _ in range(3):
            rr, _res = numpy_baseline(bcodes, bseg, args.k)
            rates.append(rr)
        base_rate = sorted(rates)[1]  # median
        _log(f"numpy baseline (measured): {base_rate/1e6:.2f} Mkmers/s",
             quiet)

    extra = dict(breakdown)
    extra["cache_hits"] = cache_stats["hits"]
    extra["cache_misses"] = cache_stats["misses"]
    print(json.dumps({
        "metric": metric,
        "value": round(rate, 1),
        "unit": ("queries/s" if args.mode in ("count_query",
                                              "multimap_find")
                 else "keys/s" if args.mode == "erase"
                 else "pairs/s" if args.mode in ("position",
                                                 "position_quality")
                 else "kmers/s"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
        "vs_baseline": (round(rate / base_rate, 3) if base_rate
                        else None),
        "compile_s": round(compile_s[0], 1),
        **extra,
    }), flush=True)


if __name__ == "__main__":
    main()

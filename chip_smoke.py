#!/usr/bin/env python3
"""Smoke test of the k-mer index on NVIDIA GPUs.

Drives the main path through the public API on one GPU and checks every
answer against a plain numpy reference on data made from --seed:

* layers   — the plain jnp/lax scans, merge and extraction of the build,
             timed at the sizes of a real build and compared exactly
             (integers) or to a stated tolerance (float32 sums);
* count    — CountIndex.build() of a whole-genome short-read FASTQ
             (default: 5 Mbp genome, 150 bp reads at 30x, 1% errors, a
             ~330 MB file that takes the streaming path), then size(),
             histogram(), count(), erase_if(count < 2) and count() again;
* families — the other index families at a modest size.

    python chip_smoke.py               # one GPU, all phases
    python chip_smoke.py --cards 4     # count phase only, over 4 GPUs

Timings are first readings, printed beside the card's name and power
limit.  Any failed check raises, and the process exits non-zero.  The
last line of stdout is one JSON object naming the devices used.
There are no matrix products here, so TF32 never arises.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory bandwidth (data sheet)
READ_LEN = 150     # Illumina short reads
ERROR_RATE = 0.01  # per-base substitution rate


def card_line() -> str:
    """`nvidia-smi` name and power limit, read by a child process that
    does not open the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Raise unless JAX sees at least one GPU (no CPU fallback)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX reports platform {found!r}")


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def median_time(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of fn(*args) after one warm-up call, each
    ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def report(name: str, seconds: float, nbytes: int) -> None:
    gbs = nbytes / seconds / 1e9
    print(f"layer {name}: median {seconds * 1e3:.3f} ms, {gbs:.1f} GB/s "
          f"from shapes, {gbs * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s",
          flush=True)


class CompileClock:
    """Seconds XLA spends compiling, or loading cached executables
    (jax.monitoring duration events)."""

    # tracing is left out: nested jits report overlapping trace spans
    EVENTS = ("/jax/core/compile/backend_compile_duration",
              "/jax/compilation_cache/cache_retrieval_time_sec")

    def __init__(self):
        import jax.monitoring as jm
        self.seconds = 0.0
        jm.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


# --------------------------------------------------------------- layers
def quality_reference(qual: np.ndarray, k: int, codec) -> np.ndarray:
    """float64 windowed phred score per window start (the reference's
    QualityScoreSlidingWindow): exp2(sum log2 P(correct)), 0 when any
    base of the window decodes as incorrect."""
    logp = codec.decode_lut[np.clip(qual.astype(np.int64) - codec.min_input,
                                    0, 95)]
    bad = (logp == np.finfo(np.float64).min) | (logp >= 0)
    contrib = np.where(bad, 0.0, logp)
    cs = np.concatenate([[0.0], np.cumsum(contrib)])
    cb = np.concatenate([[0], np.cumsum(bad)])
    nwin = qual.shape[0] - k + 1
    wsum = cs[k:k + nwin] - cs[:nwin]
    wbad = cb[k:k + nwin] - cb[:nwin]
    return np.where(wbad > 0, 0.0, np.exp2(wsum))


def _sorted_keys(rng, n, distinct, sentinel_tail):
    """uint32[2, n] sorted (hi 32, lo 10 bits) key columns drawn from
    `distinct` values, the last `sentinel_tail` rows all-ones."""
    pool = rng.integers(0, 1 << 42, distinct, dtype=np.uint64)
    v = np.sort(pool[rng.integers(0, distinct, n - sentinel_tail)])
    cols = np.stack([(v >> np.uint64(10)).astype(np.uint32),
                     (v & np.uint64(0x3FF)).astype(np.uint32)])
    return np.concatenate(
        [cols, np.full((2, sentinel_tail), 0xFFFFFFFF, np.uint32)], axis=1)


def phase_layers(rng, n: int = 1 << 24, n_oracle: int = 100_000) -> None:
    import jax
    import jax.numpy as jnp

    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.bench import synth
    from kmerind_jax.index import store as st
    from kmerind_jax.ops import packing, sortops
    from kmerind_jax.quality import ILLUMINA18, window_quality
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    print("phase layers", flush=True)

    # extraction + canonicalisation, k=21: every window exact
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    dcodes = jnp.asarray(codes)
    spec = KmerSpec(21, DNA)
    ext21 = jax.jit(lambda c: packing.extract_canonical(c, spec))
    t = median_time(ext21, dcodes)
    words, was_rc = (np.asarray(a) for a in ext21(dcodes))
    ref, ref_rc = synth.canonical_kmers(codes[None, :], 21)
    nwin = n - 21 + 1
    got = ((words[:nwin, 0].astype(np.uint64) << np.uint64(10))
           | words[:nwin, 1].astype(np.uint64))
    check(np.array_equal(got, ref[0]) and np.array_equal(was_rc[:nwin],
                                                         ref_rc[0]),
          f"extract k=21: {nwin} canonical windows and strand flags equal "
          "numpy")
    report(f"extract_canonical k=21 ({n} windows)", t, n + n * 2 * 4 + n)

    # k=63: 4 words per window; a sample checked against tests/oracle.py
    spec63 = KmerSpec(63, DNA)
    ext63 = jax.jit(lambda c: packing.extract_canonical(c, spec63))
    t = median_time(ext63, dcodes)
    words63 = np.asarray(ext63(dcodes)[0])
    sample = rng.choice(n - 63 + 1, n_oracle, replace=False)
    wbits = (32, 32, 32, 30)
    bad = 0
    for i in sample:
        v = oracle.kmer_int(codes[i:i + 63].tolist(), 2)
        want = min(v, oracle.revcomp_int(v, 63, DNA))
        have = 0
        for w, b in zip(words63[i], wbits):
            have = (have << b) | int(w)
        bad += have != want
    check(bad == 0, f"extract k=63: {n_oracle} sampled canonical windows "
          "equal tests/oracle.py")
    report(f"extract_canonical k=63 ({n} windows)", t, n + n * 4 * 4 + n)
    del dcodes, words, was_rc, words63, ref, ref_rc, got

    # run-length counts over sorted 2-word rows with an invalid tail
    tv = n - 333
    swords = _sorted_keys(rng, n, n // 4, 0).T.copy()
    swords[tv:] = rng.integers(0, 2**32, (n - tv, 2), dtype=np.uint32)
    svalid = np.arange(n) < tv
    rl = jax.jit(sortops.run_length_counts)
    args = (jnp.asarray(swords), jnp.asarray(svalid))
    t = median_time(rl, *args)
    weights, emit = (np.asarray(a) for a in rl(*args))
    idx = np.arange(n)
    neq = np.any(swords[1:] != swords[:-1], axis=1)
    isnew = np.concatenate([[True], neq]) & svalid
    start = np.maximum.accumulate(np.where(isnew, idx, -1))
    islast = svalid & (np.concatenate([neq, [True]]) | (idx == tv - 1))
    want = np.where(islast, idx - start + 1, 0)
    check(np.array_equal(weights, want) and np.array_equal(emit, islast),
          f"run_length_counts: {n} x 2-word weights equal numpy")
    report(f"run_length_counts ({n} rows x 2 words)", t, n * 14)
    del args, swords, svalid

    # LSM merge of two 16.7M-row runs with sentinel tails
    a = _sorted_keys(rng, n, n // 2, n // 20)
    b = _sorted_keys(rng, n, n // 2, n // 16)
    wa = np.where(a[0] == 0xFFFFFFFF, 0, rng.integers(1, 4, n)).astype(
        np.int32)
    wb = np.where(b[0] == 0xFFFFFFFF, 0, rng.integers(1, 4, n)).astype(
        np.int32)
    allk = np.concatenate([a, b], axis=1)
    allw = np.concatenate([wa, wb])
    order = np.lexsort((allw, allk[1], allk[0]))
    want_k, want_w = allk[:, order], allw[order]
    da, db = jnp.asarray(a), jnp.asarray(b)
    dwa, dwb = jnp.asarray(wa), jnp.asarray(wb)
    mk = jax.jit(lambda x, y: sortops.merge_sorted_runs_cols(x, (), y, ())[0])
    t = median_time(mk, da, db)
    check(np.array_equal(np.asarray(mk(da, db)), want_k),
          f"merge_sorted_runs_cols keys-only: 2 x {n} rows equal numpy")
    report(f"merge_sorted_runs_cols keys-only (2 x {n} rows)", t,
           2 * (2 * n * 2 * 4))
    mw = jax.jit(lambda x, y, p, q: sortops.merge_sorted_runs_cols(
        x, (p,), y, (q,)))
    t = median_time(mw, da, db, dwa, dwb)
    gk, (gw,) = mw(da, db, dwa, dwb)
    gk, gw = np.asarray(gk), np.asarray(gw)
    # ties may leave the network in any order: compare as sorted triples
    o = np.lexsort((gw, gk[1], gk[0]))
    check(np.array_equal(gk, want_k) and np.array_equal(gw[o], want_w),
          f"merge_sorted_runs_cols with weights: 2 x {n} rows equal numpy")
    report(f"merge_sorted_runs_cols + 1 payload (2 x {n} rows)", t,
           2 * (2 * n * 3 * 4))
    del da, db, dwa, dwb, gk, gw, allk, allw, want_k, want_w

    # int32 prefix sum of the run store
    x = rng.integers(0, 4, 2 * n).astype(np.int32)
    dx = jnp.asarray(x)
    cs = jax.jit(st._cumsum_i32)
    t = median_time(cs, dx)
    check(np.array_equal(np.asarray(cs(dx)), np.cumsum(x, dtype=np.int64)),
          f"_cumsum_i32: {2 * n} rows equal numpy")
    report(f"_cumsum_i32 ({2 * n} rows)", t, 2 * n * 8)
    del dx

    # float32 quality prefix sums (window_quality -> run_vecq qcsum).
    # XLA's scan adds in another order than numpy, and float32 rounding
    # accumulates over n terms: compare with float64 at rtol 1e-4.
    qual = rng.integers(33 + 2, 33 + 41, n, dtype=np.uint8)
    nwin = n - 21 + 1

    def qcsum(q):
        wq = window_quality(q, 21, ILLUMINA18)
        live = jnp.arange(n) < nwin
        run = st.run_vecq_from_sorted(
            jnp.zeros((1, n), jnp.uint32), jnp.zeros(n, jnp.int32),
            live.astype(jnp.int32), jnp.where(live, wq, 0.0))
        return run.qcsum

    got = np.asarray(jax.jit(qcsum)(jnp.asarray(qual)))
    want = np.cumsum(quality_reference(qual, 21, ILLUMINA18))
    want = np.concatenate([want, np.full(n - nwin, want[-1])])
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    check(np.allclose(got, want, rtol=1e-4, atol=0),
          f"quality qcsum: {n} float32 prefix sums within rtol 1e-4 of "
          f"float64 numpy (max rel err {rel:.2e})")


# ---------------------------------------------------------------- count
def phase_count(mesh, rng, genome_mbp: float, coverage: float) -> None:
    import jax

    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.bench import synth
    from kmerind_jax.index.api import CountIndex
    from kmerind_jax.io import native

    k = 21
    print("phase count", flush=True)
    genome = synth.make_genome(rng, int(genome_mbp * 1e6))
    n_reads = int(genome_mbp * 1e6 * coverage / READ_LEN)
    reads, quals = synth.sample_reads(rng, genome, n_reads, READ_LEN,
                                      ERROR_RATE)
    uniq, ucount = synth.count_canonical(reads, k)
    n_kmers = reads.shape[0] * (READ_LEN - k + 1)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        path = os.path.join(tmp, "reads.fastq")
        nbytes = synth.write_fastq(path, reads, quals)
        print(f"corpus: {genome_mbp} Mbp genome, {n_reads} reads x "
              f"{READ_LEN} bp ({reads.size} bases, {nbytes} FASTQ "
              f"bytes), {n_kmers} k-mers, {uniq.size} distinct canonical "
              f"{k}-mers", flush=True)
        print("parser: " + ("native scanner" if native.available()
                            else "numpy (native scanner unavailable)"),
              flush=True)
        spec = KmerSpec(k, DNA)
        clock = CompileClock()
        t0 = time.perf_counter()
        idx = CountIndex(spec, mesh=mesh).build(path)
        jax.block_until_ready(idx.runs)
        cold, cold_compile = time.perf_counter() - t0, clock.seconds
        # second build, fresh index: its steps are traced again and their
        # executables reloaded, so some compile time remains
        c0 = clock.seconds
        t0 = time.perf_counter()
        idx = CountIndex(spec, mesh=mesh).build(path)
        jax.block_until_ready(idx.runs)
        warm, warm_compile = time.perf_counter() - t0, clock.seconds - c0
    print(f"build cold: {cold:.3f} s wall, of which {cold_compile:.3f} s "
          f"compile", flush=True)
    print(f"build warm: {warm:.3f} s wall, of which {warm_compile:.3f} s "
          f"compile; {n_kmers / warm:.4g} k-mers/s "
          f"({n_kmers / (warm - warm_compile):.4g} without compile)",
          flush=True)

    check(idx.size() == uniq.size, f"size() == {uniq.size} distinct k-mers")
    if mesh.devices.size > 1:
        devs = idx.runs[0].keys.sharding.device_set
        check(len(devs) == mesh.devices.size,
              f"store shards on {len(devs)} distinct devices")
        # a uniform owner hash leaves each shard within a few binomial
        # standard deviations of the mean
        sizes = idx.local_sizes()
        mean = sum(sizes) / len(sizes)
        check(max(abs(x - mean) for x in sizes) <= 5 * mean ** 0.5,
              f"shard sizes {sizes} within 5 sigma of their mean")
    hist = idx.histogram(max_count=255)
    want = np.bincount(np.minimum(ucount, 255), minlength=256)
    check(np.array_equal(hist, want), "histogram(255) equals numpy")

    # 4096 k-mers sampled from the reads (present), 4096 random ones
    canon, _ = synth.canonical_kmers(reads[rng.integers(0, n_reads, 4096)],
                                     k)
    from_reads = canon[np.arange(4096), rng.integers(0, canon.shape[1], 4096)]
    random_q = rng.integers(0, 1 << (2 * k), 4096, dtype=np.uint64)
    q = np.concatenate([from_reads, random_q])
    qcanon = np.minimum(q, synth.revcomp_u64(q, k))
    pos = np.minimum(np.searchsorted(uniq, qcanon), uniq.size - 1)
    want = np.where(uniq[pos] == qcanon, ucount[pos], 0)
    qwords = synth.u64_to_words(q, k)
    got = idx.count(qwords)
    check(np.array_equal(got, want), "count() of 8192 queries equals numpy")
    tq = median_time(idx.count, qwords)
    print(f"count: {q.size} queries in {tq * 1e3:.3f} ms median, "
          f"{q.size / tq:.4g} queries/s", flush=True)

    n_erased = idx.erase_if(lambda keys, counts: counts < 2)
    check(n_erased == int((ucount < 2).sum()),
          f"erase_if(count < 2) erased {n_erased} k-mers")
    want = np.where(want >= 2, want, 0)
    check(np.array_equal(idx.count(qwords), want),
          "count() after the solid-k-mer filter equals numpy")
    check(idx.size() == int((ucount >= 2).sum()), "size() after the filter")

    stats = [d.memory_stats() or {} for d in mesh.devices.flat]
    peak = max(s.get("peak_bytes_in_use", 0) for s in stats)
    print(f"peak device memory: {peak} bytes (max over "
          f"{mesh.devices.size} devices)", flush=True)


# ------------------------------------------------------------- families
def phase_families(mesh, rng, genome_bases: int = 50_000,
                   n_reads: int = 3000, n_reads63: int = 300) -> None:
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.bench import synth
    from kmerind_jax.debruijn import DeBruijnGraph, QualityDeBruijnGraph
    from kmerind_jax.index.api import (BimoleculeCountIndex, CountIndex,
                                       PositionIndex)
    from kmerind_jax.index.sorted_api import SortedCountIndex
    from kmerind_jax.index.value_api import KmerValueIndex
    from kmerind_jax.quality import ILLUMINA18
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle

    print("phase families", flush=True)
    k = 21
    spec = KmerSpec(k, DNA)
    genome = synth.make_genome(rng, genome_bases, n_families=4,
                               repeat_len=(500, 2000))
    reads, quals = synth.sample_reads(rng, genome, n_reads, READ_LEN,
                                      ERROR_RATE)
    uniq, ucount = synth.count_canonical(reads, k)
    canon, _ = synth.canonical_kmers(reads, k)
    q = uniq[rng.choice(uniq.size, min(256, uniq.size), replace=False)]
    pos = np.searchsorted(uniq, q)
    qwords = synth.u64_to_words(q, k)

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        path = os.path.join(tmp, "reads.fastq")
        synth.write_fastq(path, reads, quals)

        sidx = SortedCountIndex(spec, mesh=mesh).build(path)
        check(sidx.size() == uniq.size
              and np.array_equal(sidx.count(qwords), ucount[pos]),
              f"SortedCountIndex: size and {q.size} counts equal numpy")

        pidx = PositionIndex(spec, mesh=mesh, canonical=True).build(path)
        ids, mask = pidx.find(qwords, max_per_query=4)
        check(pidx.size() == canon.size
              and np.array_equal(mask.sum(axis=1), ucount[pos]),
              "PositionIndex.find: one position per occurrence")

        bidx = BimoleculeCountIndex(spec, mesh=mesh).build(path)
        out_w, out_c = bidx.find(qwords)
        ow = (out_w[:, 0].astype(np.uint64) << np.uint64(10)) \
            | out_w[:, 1].astype(np.uint64)
        oc = np.minimum(ow, synth.revcomp_u64(ow, k))
        check(out_c.shape[0] == q.size
              and np.array_equal(out_c, ucount[np.searchsorted(uniq, oc)]),
              "BimoleculeCountIndex.find: counts of stored keys equal numpy")

        g = DeBruijnGraph(spec, mesh=mesh).build(path)
        vals, found = g.node_counts(qwords)
        check(g.size() == uniq.size and found.all()
              and np.array_equal(vals[:, 8], ucount[pos]),
              "DeBruijnGraph: node count and self counters equal numpy")

        qg = QualityDeBruijnGraph(spec, mesh=mesh).build(path)
        meanq, nq, foundq = qg.node_quality(qwords)
        wq = np.stack([quality_reference(r, k, ILLUMINA18) for r in quals])
        inv = np.searchsorted(uniq, canon.reshape(-1))
        qsum = np.bincount(inv, wq.reshape(-1), uniq.size)[pos]
        # a node's quality sum is a difference of two float32 prefix
        # sums over the whole run, so its error scales with the run's
        # total, not with the node's own sum
        tol = 1e-5 * wq.sum() + 1e-4 * qsum
        check(qg.size() == uniq.size and foundq.all()
              and np.array_equal(nq, ucount[pos])
              and np.all(np.abs(meanq * nq - qsum) <= tol),
              "QualityDeBruijnGraph: node windows equal numpy, quality "
              "sums within 1e-5 of the run total")

    vidx = KmerValueIndex(spec, mesh=mesh, reduce="min")
    vals = np.arange(q.size, dtype=np.uint64) * 7 + 3
    vidx.insert(qwords, vals)
    got_v, got_f = vidx.find(qwords)
    check(got_f.all() and np.array_equal(got_v, vals),
          "KmerValueIndex: insert then find returns the values")

    # k=63: 4-word keys, checked against tests/oracle.py
    spec63 = KmerSpec(63, DNA)
    sub = reads[:n_reads63]
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        path = os.path.join(tmp, "reads63.fastq")
        synth.write_fastq(path, sub, quals[:n_reads63])
        idx63 = CountIndex(spec63, mesh=mesh).build(path)
    seqs = [synth.ACGT[r].tobytes().decode() for r in sub]
    want63 = oracle.count_index(seqs, 63, DNA)
    check(idx63.to_dict() == dict(want63),
          f"CountIndex k=63: {len(want63)} k-mers equal tests/oracle.py")
    keys = sorted(want63)[:64]
    got = idx63.count(np.stack([spec63.from_int(v) for v in keys]))
    check([int(c) for c in got] == [want63[v] for v in keys],
          "CountIndex k=63: 64 counts equal tests/oracle.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mbp", type=float, default=5.0)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--cards", type=int, default=1,
                    help="GPUs to use; above 1 only the count phase runs")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices)
    if len(devices) < args.cards:
        raise RuntimeError(f"--cards {args.cards}: only {len(devices)} "
                           "GPUs visible")
    from kmerind_jax.parallel.mesh import make_mesh
    mesh = make_mesh(args.cards)
    print(f"devices: {args.cards} x {devices[0].device_kind}", flush=True)
    print(card_line(), flush=True)
    if args.cards == 1:
        phase_layers(np.random.default_rng([args.seed, 0]))
    # each phase draws from its own stream of the seed, so the count
    # corpus is the same with one card or four
    phase_count(mesh, np.random.default_rng([args.seed, 1]),
                args.genome_mbp, args.coverage)
    if args.cards == 1:
        phase_families(mesh, np.random.default_rng([args.seed, 2]))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": args.cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

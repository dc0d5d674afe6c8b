"""Micro-benchmarks — the analog of the reference's perf binaries
(benchmark_kmer_ops/benchmark_bit_reverse/hash_vs_sort/BenchmarkHashTables,
SURVEY §6): per-op throughput on the current default device, one JSON line
per op.

Usage: python -m kmerind_jax.bench.micro [--n 4194304] [--k 21]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from .. import DNA, KmerSpec
    from ..ops import bitops, hashing, packing, sortops

    n, k = args.n, args.k
    spec = KmerSpec(k, DNA)
    rng = np.random.default_rng(0)
    codes = jax.device_put(rng.integers(0, 4, size=n).astype(np.uint8))
    valid = jax.device_put(np.ones(n, bool))

    results = []

    def bench(name, f, *a, items=None):
        g = jax.jit(f)
        out = g(*a)
        jax.tree.map(lambda x: x.block_until_ready(), out)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(g(*a))
            ts.append(time.perf_counter() - t0)
        rate = (n if items is None else items) / min(ts)
        results.append({"op": name, "ms": round(min(ts) * 1e3, 2),
                        "items_per_s": round(rate, 0)})
        print(json.dumps(results[-1]), flush=True)

    bench("extract_canonical",
          lambda c: packing.extract_canonical(c, spec)[0], codes)
    words = jax.jit(lambda c: packing.extract_kmers(c, spec))(codes)
    words.block_until_ready()
    bench("murmur3_32", hashing.murmur3_32, words)
    bench("sort_rows", lambda w, v: sortops.sort_rows(
        w, (), v, sentinel_ok=spec.sentinel_safe)[0], words, valid)
    bench("sort+unique_counts", lambda w, v: sortops.unique_counts(
        *(lambda s, _, sv: (s, sv))(*sortops.sort_rows(
            w, (), v, sentinel_ok=spec.sentinel_safe)))[2], words, valid)
    bench("revcomp_packed", lambda w: bitops.revcomp(w, spec), words)
    bench("reverse_packed", lambda w: bitops.reverse(w, spec), words)

    # local store point lookups — the BenchmarkHashTables / hash_vs_sort
    # analog: binary search vs the gather-free sort-merge join over the
    # same sorted store (the two auto-selected local-lookup strategies)
    from ..index import store as st
    from ..ops import sortops as so
    s_words, _, s_valid = jax.jit(
        lambda w, v: so.sort_rows(w, (), v,
                                  sentinel_ok=spec.sentinel_safe))(
        words, valid)
    uniq, cnts, nuniq = jax.jit(so.unique_counts)(s_words, s_valid)
    cstore = st.CountStore(keys=uniq, counts=cnts.astype(jnp.int32),
                           size=nuniq)
    q = words[: max(1, n // 4)]
    bench("count_lookup_bsearch",
          lambda k, s_, q_: jnp.where(
              so.rows_equal_at(k, so.lower_bound(k, s_, q_), q_, s_), 1, 0),
          cstore.keys, cstore.size, q, items=q.shape[0])
    bench("count_lookup_join",
          lambda k, s_, c_, q_: so.lookup_join(k, s_, c_, q_),
          cstore.keys, cstore.size, cstore.counts, q, items=q.shape[0])

    # host parse rate — the BenchmarkFileLoader analog (native scanner on
    # synthesized FASTQ bytes, multi-threaded ring path)
    from ..io import native as _nat
    if _nat.available():
        rng = np.random.default_rng(7)
        recs = []
        for i in range(max(1, n // 250)):
            seq = "".join(rng.choice(list("ACGT"), size=250))
            qual = "".join(chr(33 + int(x)) for x in
                           rng.integers(0, 40, 250))
            recs.append(f"@r{i}\n{seq}\n+\n{qual}\n")
        data = np.frombuffer("".join(recs).encode(), np.uint8)
        from ..alphabets import DNA as _DNA
        _nat.fastq_parse(data, _DNA, reuse=True)  # warm ring
        _nat.fastq_parse(data, _DNA, reuse=True)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            _nat.fastq_parse(data, _DNA, reuse=True)
            ts.append(time.perf_counter() - t0)
        results.append({"op": "fastq_parse_native",
                        "ms": round(min(ts) * 1e3, 2),
                        "bytes_per_s": round(data.shape[0] / min(ts), 0)})
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()

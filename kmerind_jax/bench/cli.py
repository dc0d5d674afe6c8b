"""Benchmark CLI — the BenchmarkKmerIndex equivalent.

Rebuild of the reference's de-facto application driver
(/root/reference/test/benchmark/BenchmarkKmerIndex.cpp): read a query
sample, build the configured index from a FASTQ/FASTA file, then run
count / find / erase over the queries, reporting per-phase timings in the
``[TIME]`` format.  Where the reference bakes the configuration matrix into
one binary per combination via -Dp* macros (:45-260), every knob here is a
runtime flag; where it parses TCLAP flags (:441-476), argparse.

Usage:
  python -m kmerind_jax.bench.cli -F file.fastq [-Q query.fastq]
      [--index count|position|posqual|debruijn] [-k 21] [--alphabet DNA]
      [--single-strand] [--hash murmur] [-S 0.1] [--devices N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kmerind_jax.bench.cli",
        description="Build and query a distributed k-mer index "
                    "(BenchmarkKmerIndex equivalent)")
    ap.add_argument("-F", "--file", default=None, help="input FASTQ/FASTA "
                    "(required unless --load restores a built index)")
    ap.add_argument("-Q", "--query", default=None,
                    help="query file (defaults to input file)")
    ap.add_argument("--index", default="count",
                    choices=["count", "position", "posqual", "debruijn"])
    ap.add_argument("-k", type=int, default=21)
    ap.add_argument("--alphabet", default="DNA")
    ap.add_argument("--single-strand", action="store_true",
                    help="disable canonicalization (SingleStrand preset)")
    ap.add_argument("--bimolecule", action="store_true",
                    help="Bimolecule preset: store input-strand keys, "
                         "hash/compare canonically (count index only)")
    ap.add_argument("--map", default="hash", choices=["hash", "sorted"],
                    help="distribution strategy: hash-partitioned "
                         "(densehash analog) or range-partitioned "
                         "(sorted_map analog, the reference's pMAP=SORTED)")
    ap.add_argument("--hash", default="murmur",
                    choices=["murmur", "farm", "fmix32", "std", "identity"])
    ap.add_argument("-S", "--sample", "--query-sample", type=float,
                    default=1.0,
                    help="query sampling: values >= 2 are the reference's "
                         "'one in N' ratio (BenchmarkKmerIndex.cpp:454-457 "
                         "keeps size/N shuffled kmers; its default is 100), "
                         "values in (0,1) a fraction; 1 keeps all queries")
    ap.add_argument("-A", "--algo", type=int, default=7,
                    help="reader algorithm id, accepted for drop-in "
                         "compatibility (reference: 2=loader, 5=mmap, "
                         "7=posix, 10=mpiio); one memory-mapped reader "
                         "serves all here")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all devices)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual devices)")
    ap.add_argument("--format", default=None, choices=["fastq", "fasta"])
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="after building, write a sharded Orbax checkpoint "
                         "of the index under DIR (utils.checkpoint)")
    ap.add_argument("--load", default=None, metavar="DIR",
                    help="restore the index from a --save checkpoint "
                         "instead of building; index-config flags are taken "
                         "from the checkpoint, -F becomes optional")
    ap.add_argument("--no-erase", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="emit a summary JSON line")
    return ap


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.file is None and args.load is None:
        ap.error("-F/--file is required unless --load is given")
    if args.file is None and args.query is None:
        ap.error("--load without -F needs -Q/--query for the query kmers")

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from .. import alphabets
    from ..config import IndexConfig
    from ..kmer import KmerSpec
    from ..io import batch_to_arrays, extract_tuples, read_file
    from ..parallel.mesh import make_mesh
    from ..utils.timers import MemUsage, PhaseTimer

    alpha = alphabets.by_name(args.alphabet)
    spec = KmerSpec(args.k, alpha)
    mesh = make_mesh(args.devices)
    timer = PhaseTimer()
    mem = MemUsage()
    mem.mark("start")

    id_kind = "short"
    if args.format == "fasta" or str(args.file).endswith(
            (".fasta", ".fa", ".fna")):
        id_kind = "long"

    strands = ("bimolecule" if args.bimolecule
               else "single" if args.single_strand else "canonical")
    cfg = IndexConfig(
        k=args.k, alphabet=args.alphabet, index=args.index,
        strands=strands,
        distribution="range" if args.map == "sorted" else "hash",
        hash_name=args.hash, id_kind=id_kind, fmt=args.format)
    idx = None if args.load is not None else cfg.make_index(mesh=mesh,
                                                            timer=timer)

    # ---- build (or restore a checkpoint, --load)
    if args.load is not None:
        from ..utils.checkpoint import load_index
        t0 = time.perf_counter()
        idx = load_index(args.load, mesh=mesh)
        build_s = time.perf_counter() - t0
        # queries and reporting follow the CHECKPOINT's configuration,
        # not the CLI flags
        spec, alpha = idx.spec, idx.spec.alphabet
        args.index = {"CountIndex": "count", "BimoleculeCountIndex": "count",
                      "SortedCountIndex": "count",
                      "PositionIndex": "position",
                      "SortedPositionIndex": "position",
                      "PositionQualityIndex": "posqual",
                      "SortedPositionQualityIndex": "posqual",
                      "KmerValueIndex": "value",
                      "SortedKmerValueIndex": "value",
                      "DeBruijnGraph": "debruijn"}[type(idx).__name__]
        mem.mark("after_build")
        size = idx.size()
        print(f"index restored: {size} entries in {build_s:.3f}s",
              file=sys.stderr)
    else:
        t0 = time.perf_counter()
        idx.build(args.file, fmt=args.format)
        build_s = time.perf_counter() - t0
        mem.mark("after_build")
        size = idx.size()
        print(f"index built: {size} entries in {build_s:.3f}s",
              file=sys.stderr)
    if args.save is not None:
        from ..utils.checkpoint import save_index
        with timer.phase("save"):
            save_index(idx, args.save)
        print(f"checkpoint saved to {args.save}", file=sys.stderr)

    # ---- read query sample (readForQuery + sample, BenchmarkKmerIndex
    # :486-497): extract all kmers of the query file, then sample
    qpath = args.query or args.file
    with timer.phase("read_query"):
        qbatch = read_file(qpath, alpha, args.format)
        tup = extract_tuples(batch_to_arrays(qbatch), spec, canonical=False)
        qwords = np.asarray(tup.words)[np.asarray(tup.valid)]
    if args.sample >= 2:
        # the reference's -S: shuffle, keep size/N (sample(),
        # BenchmarkKmerIndex.cpp:373-392 via :497)
        take = max(1, len(qwords) // int(args.sample))
        rng = np.random.default_rng(0)
        qwords = qwords[rng.permutation(len(qwords))[:take]]
    elif args.sample < 1.0:
        rng = np.random.default_rng(0)
        take = max(1, int(len(qwords) * args.sample))
        qwords = qwords[rng.choice(len(qwords), size=take, replace=False)]
    print(f"queries: {len(qwords)} kmers", file=sys.stderr)

    # ---- queries
    results = {"size": size, "build_s": round(build_s, 4)}
    if args.index in ("count", "position", "posqual"):
        with timer.phase("query_count"):
            counts = idx.count(qwords)
        results["count_hits"] = int((counts > 0).sum())
        results["count_total"] = int(counts.sum())
    if args.index in ("position", "posqual"):
        with timer.phase("query_find"):
            found = idx.find(qwords[: min(len(qwords), 4096)],
                             max_per_query=64)
        results["find_pairs"] = int(found[-1].sum())
    if args.index == "debruijn":
        with timer.phase("query_nodes"):
            vals, found = idx.node_counts(qwords)
        results["nodes_found"] = int(found.sum())
    if args.index == "count" and not args.no_erase:
        with timer.phase("erase"):
            nerased = idx.erase(qwords)
        results["erased"] = nerased

    mem.mark("end")
    print(timer.report(f"{args.index}_k{args.k}"), file=sys.stderr)
    print(mem.report(f"{args.index}_k{args.k}"), file=sys.stderr)
    if args.json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

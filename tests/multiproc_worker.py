"""Worker process for the multi-process integration test — the analog of
one MPI rank in the reference's `mpirun -np N` test discipline
(/root/reference/CMakeLists.txt:851-910).

Each worker: joins the jax.distributed CPU cluster, reads ITS OWN byte
block of the input (parallel.multihost.host_block_batch — the
BlockPartitioner + record-repair contract of partitioned_file,
file.hpp:1216-1432), builds the distributed index over the GLOBAL mesh,
then dumps the (replicated) index contents + collective stats as JSON so
the parent test can compare against a single-process build.

Usage: python multiproc_worker.py <pid> <nproc> <devices_per_proc> \
           <coordinator_port> <fastq_path> <out_json> <index_kind>
"""

import json
import os
import pathlib
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
dpp = int(sys.argv[3])
port = int(sys.argv[4])
path = sys.argv[5]
out_json = sys.argv[6]
kind = sys.argv[7]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={dpp}")

import jax  # noqa: E402

# keep the config in step with the variable (as tests/conftest.py does)
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc, process_id=pid)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from kmerind_jax import DNA, KmerSpec  # noqa: E402
from kmerind_jax.index.api import CountIndex, PositionIndex  # noqa: E402
from kmerind_jax.parallel.multihost import (  # noqa: E402
    global_mesh, host_block_batch)
from kmerind_jax.utils.timers import PhaseTimer  # noqa: E402

assert jax.process_count() == nproc
assert len(jax.devices()) == nproc * dpp

spec = KmerSpec(21, DNA)
if kind == "count2d":
    # hosts x chips (dcn, ici) mesh: ownership = (process, local chip),
    # the reference's two-level hashing (kmer_hash.hpp:24-54) under REAL
    # multi-process execution
    from kmerind_jax.parallel.mesh import make_mesh_2d
    mesh = make_mesh_2d()
else:
    mesh = global_mesh()
timer = PhaseTimer()

if kind in ("count", "count2d", "fasta_count",
            "stream_count", "fasta_stream_count"):
    idx = CountIndex(spec, mesh=mesh, canonical=True, timer=timer)
elif kind == "sorted_count":
    from kmerind_jax.index.sorted_api import SortedCountIndex
    idx = SortedCountIndex(spec, mesh=mesh, canonical=True, timer=timer)
elif kind == "debruijn":
    from kmerind_jax.debruijn import DeBruijnGraph
    idx = DeBruijnGraph(spec, mesh=mesh, canonical=True, timer=timer)
elif kind == "debruijn_quality":
    from kmerind_jax.debruijn import QualityDeBruijnGraph
    idx = QualityDeBruijnGraph(spec, mesh=mesh, canonical=True,
                               timer=timer)
elif kind == "bimol":
    from kmerind_jax.index.api import BimoleculeCountIndex
    idx = BimoleculeCountIndex(spec, mesh=mesh, timer=timer)
elif kind == "value_min":
    # the generic unique-key value map; reduce="min" is order-independent
    # so contents are comparable across process counts (the reference's
    # "first" is arrival-order-dependent under different np too)
    from kmerind_jax.index.value_api import KmerValueIndex
    idx = KmerValueIndex(spec, mesh=mesh, canonical=True, reduce="min",
                         id_kind="short", timer=timer)
else:
    idx = PositionIndex(spec, mesh=mesh, id_kind="short", timer=timer)

# each process parses only its own byte block (record-boundary repaired;
# FASTA: O(block) header scan + distributed context exchange, plus a k-1
# halo so boundary-crossing windows are emitted exactly once).  The
# de Bruijn graph needs raw bytes (dual-LUT edge semantics) and an extra
# base of edge context on each side.
if kind in ("stream_count", "fasta_stream_count"):
    # streamed multi-process build: each host streams ITS byte range in
    # tiny sub-blocks (block_bytes=128 forces several blocks per host and
    # divergent chunk counts, exercising the lockstep equalization)
    idx.build_stream(path, block_bytes=128)
    num_bases = -1
elif kind in ("debruijn", "debruijn_quality"):
    # raw bytes for the dual-LUT edge semantics; FASTQ records are whole
    # per block, so no cross-block base halo is needed
    batch = host_block_batch(path, idx.parse_alphabet)
    idx.insert_batch(batch)
    num_bases = batch.num_bases
else:
    batch = host_block_batch(path, DNA, halo=spec.k - 1)
    idx.insert_batch(batch)
    num_bases = batch.num_bases

size = idx.size()
contents = idx.to_dict()
if kind in ("debruijn", "debruijn_quality"):
    # node-counter tuples serialize as lists; normalize for comparison
    contents = {k: list(v) for k, v in contents.items()}

# a query round-trip through the owner routing + reply exchange
some = sorted(contents)[:16]


def _pack_int(v: int) -> np.ndarray:
    codes = []
    for i in range(spec.k - 1, -1, -1):
        codes.append((v >> (2 * i)) & 3)
    return spec.pack_codes(codes)


qwords = np.stack([_pack_int(v) for v in some])
if kind in ("debruijn", "debruijn_quality"):
    # the graph's query surface is node_counts (self-counter = count)
    vals, found = idx.node_counts(qwords)
    counts = np.where(found, vals[:, 8], 0)
else:
    counts = idx.count(qwords)

# cross-process timer reduction must include every process's phases
stats = timer.cross_host_stats()

if pid == 0:
    json.dump({
        "size": size,
        "contents": {str(k): v for k, v in contents.items()},
        "counts": [int(c) for c in counts],
        "queried": [str(v) for v in some],
        "timer_phases": sorted(stats),
        "timer_count_ok": all(s["count"] == nproc for s in stats.values()),
        "per_process_bases": num_bases,
    }, open(out_json, "w"))
print(f"proc {pid}: ok (bases={num_bases}, size={size})", flush=True)

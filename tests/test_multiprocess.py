"""Real multi-process (jax.distributed) integration — the analog of the
reference's mpirun -np N ctest sweeps (CMakeLists.txt:851-910): N separate
OS processes with their own JAX runtimes, a TCP coordinator, per-process
file-block reads with record repair, and a global-mesh index whose contents
must equal the single-process build."""

import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import oracle
from test_io import py_parse_fastq

HERE = pathlib.Path(__file__).resolve().parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nproc, dpp, path, kind, tmp_path):
    port = _free_port()
    out_json = tmp_path / f"mp_{kind}_{nproc}x{dpp}.json"
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            ["timeout", "-s", "KILL", "300", sys.executable,
             str(HERE / "multiproc_worker.py"), str(pid), str(nproc),
             str(dpp), str(port), str(path), str(out_json), kind],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=320)
        outs.append(out)
        assert pr.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert out_json.exists(), outs[0][-2000:]
    return json.load(open(out_json))


@pytest.mark.parametrize("nproc,dpp", [(2, 1), (4, 2)])
def test_multiprocess_count_index(ref_data_dir, tmp_path, nproc, dpp):
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(nproc, dpp, path, "count", tmp_path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    assert res["size"] == len(expect)
    # the query round trip answered from the distributed store
    want_counts = [expect[int(v)] for v in res["queried"]]
    assert res["counts"] == want_counts
    # cross-process timer reduction saw one total per process
    assert res["timer_count_ok"]
    assert "insert" in res["timer_phases"]


def test_multiprocess_count_index_2d_mesh(ref_data_dir, tmp_path):
    """2 processes x 2 local devices on the 2-D (dcn, ici) mesh — the
    two-level hashing layout under real multi-process execution; index
    contents must be placement-independent."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "count2d", tmp_path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    want_counts = [expect[int(v)] for v in res["queried"]]
    assert res["counts"] == want_counts


def test_multiprocess_fasta_count_index(ref_data_dir, tmp_path):
    """FASTA per-process block reads: each worker scans only ITS block for
    record starts (O(block)), learns its leading-record context from the
    distributed exchange (multihost.distributed_fasta_context), and the
    global index must equal the whole-file oracle — on a fixture with
    ';' header lines, multi-line header runs, and multi-line sequences."""
    from test_io import py_parse_fasta

    path = ref_data_dir / "test2.fasta"
    res = _run_workers(3, 1, path, "fasta_count", tmp_path)
    seqs = ["".join(r["seq"]) for r in py_parse_fasta(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    assert res["size"] == len(expect)


def test_multiprocess_position_index(ref_data_dir, tmp_path):
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "position", tmp_path)
    k = 21
    from kmerind_jax import DNA
    recs = py_parse_fastq(path.read_text())
    seqs_ids = []
    for hdr, seq, qual, rstart, sstart in recs:
        ids = [(rstart << 16) | (sstart - rstart + i)
               for i in range(len(seq) - k + 1)]
        seqs_ids.append((seq, ids))
    expect = oracle.position_index(seqs_ids, k, DNA, canonical=False)
    got = {int(kk): v for kk, v in res["contents"].items()}
    assert got == expect


def test_multiprocess_sorted_count_index(ref_data_dir, tmp_path):
    """Range-partitioned family under REAL jax.distributed processes: the
    global samplesort flush (all_gather of splitter samples + routed
    exchange) and splitter-routed queries must produce contents equal to
    the whole-file oracle (distributed_sorted_map.hpp:2061 at any np)."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "sorted_count", tmp_path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    assert res["size"] == len(expect)
    want_counts = [expect[int(v)] for v in res["queried"]]
    assert res["counts"] == want_counts


def test_multiprocess_value_index(ref_data_dir, tmp_path):
    """Generic unique-key value map under real jax.distributed processes:
    kmer -> min 64-bit position id must equal the single-process build
    (min is order-independent, so contents are np-invariant)."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "value_min", tmp_path)
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.index.value_api import KmerValueIndex
    idx = KmerValueIndex(KmerSpec(21, DNA), reduce="min", id_kind="short")
    idx.build(str(path))
    expect = {str(k): v for k, v in idx.to_dict().items()}
    assert res["contents"] == expect
    assert res["size"] == len(expect)
    # count() on a value map answers membership (0/1)
    assert res["counts"] == [1] * len(res["queried"])


def test_multiprocess_streamed_build(ref_data_dir, tmp_path):
    """Streamed build under REAL jax.distributed processes: each host
    streams ITS byte range in sub-blocks through the parser ring
    (O(block) host memory at any corpus size), the lockstep driver
    equalizing divergent per-host chunk counts with all-invalid chunks.
    Contents must equal the whole-file oracle."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "stream_count", tmp_path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    assert res["size"] == len(expect)
    want_counts = [expect[int(v)] for v in res["queried"]]
    assert res["counts"] == want_counts


def test_multiprocess_streamed_fasta_build(ref_data_dir, tmp_path):
    """Streamed FASTA build under real multi-process execution: the
    per-sub-block record contexts come from ONE distributed header-scan
    exchange (distributed_fasta_grid_context) — on a fixture with ';'
    header lines, multi-line header runs, and multi-line sequences, at a
    3-process count that doesn't divide the block grid evenly."""
    from test_io import py_parse_fasta

    path = ref_data_dir / "test2.fasta"
    res = _run_workers(3, 1, path, "fasta_stream_count", tmp_path)
    seqs = ["".join(r["seq"]) for r in py_parse_fasta(path.read_text())]
    from kmerind_jax import DNA
    expect = oracle.count_index(seqs, 21, DNA, canonical=True)
    got = {int(k): v for k, v in res["contents"].items()}
    assert got == dict(expect)
    assert res["size"] == len(expect)


def test_multiprocess_debruijn(ref_data_dir, tmp_path):
    """De Bruijn node counters under real multi-process execution must
    equal the single-process build of the same file."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "debruijn", tmp_path)
    # single-process reference build (virtual 8-device mesh of this proc)
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.debruijn import DeBruijnGraph
    g = DeBruijnGraph(KmerSpec(21, DNA), canonical=True)
    g.build(str(path))
    expect = {str(k): list(v) for k, v in g.to_dict().items()}
    assert res["contents"] == expect
    assert res["size"] == len(expect)


def test_multiprocess_debruijn_quality(ref_data_dir, tmp_path):
    """Quality de Bruijn engine under real multi-process execution: the
    integer counters must equal the single-process build exactly; the
    float quality sums to float32-reorder tolerance (the run merges sum
    them in routing order — ROADMAP, round 4).  The reference runs every
    map flavor under mpirun np=1..4 (CMakeLists.txt:851-910)."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "debruijn_quality", tmp_path)
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.debruijn import QualityDeBruijnGraph
    g = QualityDeBruijnGraph(KmerSpec(21, DNA), canonical=True)
    g.build(str(path))
    expect = g.to_dict()
    got = {int(k): v for k, v in res["contents"].items()}
    assert sorted(got) == sorted(expect)
    for k, want in expect.items():
        have = got[k]
        assert have[:10] == list(want[:10]), k
        np.testing.assert_allclose(have[10], want[10], rtol=1e-3,
                                   atol=1e-6)
    assert res["size"] == len(expect)


def test_multiprocess_bimolecule(ref_data_dir, tmp_path):
    """Bimolecule preset under real multi-process execution: stored
    orientations are the earliest 64-bit occurrence id — global record
    order, so contents are process-count-independent and must equal the
    single-process build."""
    path = ref_data_dir / "test.small.fastq"
    res = _run_workers(2, 2, path, "bimol", tmp_path)
    from kmerind_jax import DNA, KmerSpec
    from kmerind_jax.index.api import BimoleculeCountIndex
    idx = BimoleculeCountIndex(KmerSpec(21, DNA))
    idx.build(str(path))
    expect = {str(k): v for k, v in idx.to_dict().items()}
    assert res["contents"] == expect
    assert res["size"] == len(expect)
    assert res["timer_count_ok"]

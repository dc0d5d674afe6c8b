"""CLI driver + predicate-variant API tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.bench.cli import main as cli_main
from kmerind_jax.index.api import CountIndex
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq


def test_cli_count_index(ref_data_dir, capsys):
    res = cli_main([
        "-F", str(ref_data_dir / "test.small.fastq"),
        "--index", "count", "-k", "15", "--json",
    ])
    assert res["size"] > 0
    assert res["count_hits"] > 0
    assert res["erased"] == res["size"]  # queries cover all index kmers


def test_cli_position_index(ref_data_dir):
    res = cli_main([
        "-F", str(ref_data_dir / "test.small.fastq"),
        "--index", "position", "-k", "21", "-S", "0.5",
    ])
    assert res["size"] == 280
    assert res["find_pairs"] > 0


def test_cli_debruijn(ref_data_dir):
    res = cli_main([
        "-F", str(ref_data_dir / "test.debruijn.small.fastq"),
        "--index", "debruijn", "-k", "21",
    ])
    assert res["size"] == 124
    assert res["nodes_found"] > 0


def test_cli_sample_one_in_n(ref_data_dir, capsys):
    """-S >= 2 is the reference's 'one in N' query-sample ratio
    (BenchmarkKmerIndex.cpp:454-457, sample() at :373-392)."""
    res_all = cli_main([
        "-F", str(ref_data_dir / "test.small.fastq"),
        "--index", "count", "-k", "15", "--no-erase",
    ])
    res = cli_main([
        "-F", str(ref_data_dir / "test.small.fastq"),
        "--index", "count", "-k", "15", "-S", "100", "--no-erase",
    ])
    # count_total counts hits over the sampled queries only
    assert res["size"] == res_all["size"]
    assert 0 < res["count_total"] < res_all["count_total"]
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("queries:")]
    n_all = int(lines[0].split()[1])
    n_sampled = int(lines[-1].split()[1])
    assert n_sampled == max(1, n_all // 100)


def test_cli_save_load_roundtrip(ref_data_dir, tmp_path):
    """--save then --load reach the sharded checkpoint path from the app
    layer; the restored index answers queries identically with no -F."""
    ckpt = str(tmp_path / "ckpt")
    res_build = cli_main([
        "-F", str(ref_data_dir / "test.small.fastq"),
        "--index", "count", "-k", "15", "--no-erase", "--save", ckpt,
    ])
    res_load = cli_main([
        "--load", ckpt, "-Q", str(ref_data_dir / "test.small.fastq"),
        "--no-erase",
    ])
    assert res_load["size"] == res_build["size"]
    assert res_load["count_hits"] == res_build["count_hits"]
    assert res_load["count_total"] == res_build["count_total"]


def test_cli_load_requires_query():
    with pytest.raises(SystemExit):
        cli_main(["--load", "/nonexistent"])


def test_cli_fasta(ref_data_dir):
    res = cli_main([
        "-F", str(ref_data_dir / "test.fasta"), "--index", "count",
        "-k", "15",
    ])
    assert res["size"] > 0


def _build_small(ref_data_dir, k=15):
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(k, DNA)
    idx = CountIndex(spec, mesh=make_mesh(4))
    idx.build(path)
    seqs = [r[1] for r in py_parse_fastq(path.read_text())]
    expect = oracle.count_index(seqs, k, DNA, canonical=True)
    return idx, expect


def test_erase_if_predicate_only(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    lo_count = {v for v, c in expect.items() if c < 7}
    n = idx.erase_if(lambda k, c: c < 7)
    assert n == len(lo_count)
    assert idx.size() == len(expect) - len(lo_count)
    left = idx.to_dict()
    assert set(left) == {v for v, c in expect.items() if c >= 7}


def test_count_if_scan(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    got = dict(idx.count_if(lambda k, c: c >= 7))
    assert got == {v: c for v, c in expect.items() if c >= 7}


def test_count_if_with_queries(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    items = list(expect.items())[:20]
    qwords = np.stack([
        idx.spec.pack_codes(oracle.int_to_codes(v, idx.spec.k, 2))
        for v, _ in items])
    got = idx.count_if(lambda k, c: c >= 7, qwords)
    want = [c if c >= 7 else 0 for _, c in items]
    np.testing.assert_array_equal(got, want)


def test_filter(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    idx.filter(lambda k, c: c == 7)
    assert set(idx.to_dict()) == {v for v, c in expect.items() if c == 7}


def test_erase_if_with_queries(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    items = list(expect.items())[:10]
    qwords = np.stack([
        idx.spec.pack_codes(oracle.int_to_codes(v, idx.spec.k, 2))
        for v, _ in items])
    n = idx.erase_if(lambda k, c: c >= 7, qwords)
    want_erased = [v for v, c in items if c >= 7]
    assert n == len(want_erased)
    for v, c in items:
        still = idx.count(np.stack([idx.spec.pack_codes(
            oracle.int_to_codes(v, idx.spec.k, 2))]))[0]
        assert still == (0 if c >= 7 else c)


def test_capacity_grow_paths(ref_data_dir):
    """Tiny initial capacity forces the grow/retry path (regression: the
    sentinel pad constant used to overflow int32 parsing)."""
    idx = CountIndex(KmerSpec(21, DNA), mesh=make_mesh(2),
                     initial_capacity=16)
    idx.build(ref_data_dir / "test.medium.fastq")
    assert idx.size() == 40
    assert idx.capacity > 16


def test_container_base_surface(ref_data_dir):
    idx, expect = _build_small(ref_data_dir)
    assert not idx.empty()
    assert idx.unique_size() == len(expect)
    assert sum(idx.local_sizes()) == len(expect)
    idx.reserve(100_000)
    assert idx.capacity * idx.num_shards >= 100_000
    # contents unchanged by reserve
    assert idx.to_dict() == dict(expect)
    idx.clear()
    assert idx.empty() and idx.size() == 0


def test_insert_counts_pairs():
    idx = CountIndex(KmerSpec(9, DNA), mesh=make_mesh(4), canonical=False)
    idx.insert_counts(["ACGTACGTA", "CCCCCCCCC"], [5, 7])
    idx.insert_counts(["ACGTACGTA"], [2])
    got = idx.count(["ACGTACGTA", "CCCCCCCCC"])
    np.testing.assert_array_equal(got, [7, 7])


def test_build_files_multi(ref_data_dir):
    idx = CountIndex(KmerSpec(15, DNA), mesh=make_mesh(2))
    idx.build_files([ref_data_dir / "test.small.fastq",
                     ref_data_dir / "test.small.fastq"])
    seqs = [r[1] for r in py_parse_fastq(
        (ref_data_dir / "test.small.fastq").read_text())]
    expect = {k: 2 * v for k, v in
              oracle.count_index(seqs, 15, DNA, canonical=True).items()}
    assert idx.to_dict() == expect


def test_save_load_roundtrip(ref_data_dir, tmp_path):
    idx, expect = _build_small(ref_data_dir)
    f = tmp_path / "idx.npz"
    idx.save(f)
    # restore onto a different mesh size
    idx2 = CountIndex.load(f, mesh=make_mesh(8))
    assert idx2.to_dict() == dict(expect)
    assert idx2.spec == idx.spec and idx2.canonical == idx.canonical


def test_index_config_factory(ref_data_dir):
    from kmerind_jax.config import IndexConfig
    cfg = IndexConfig(k=15, index="count", devices=4)
    idx = cfg.make_index(mesh=make_mesh(4))
    idx.build(ref_data_dir / "test.small.fastq")
    assert idx.size() > 0
    cfg2 = IndexConfig(k=21, index="debruijn")
    g = cfg2.make_index(mesh=make_mesh(2))
    g.build(ref_data_dir / "test.debruijn.small.fastq")
    assert g.size() == 124


def test_packed_string_roundtrip():
    from kmerind_jax.utils.packed_string import (
        pack_string, packed_nbytes, unpack_string)
    rng = np.random.default_rng(0)
    for bits in (2, 3, 4, 8):
        for n in (1, 5, 16, 17, 100):
            codes = rng.integers(0, 1 << bits, size=n).astype(np.uint8)
            words = pack_string(codes, bits)
            assert words.nbytes == packed_nbytes(n, bits)
            back = unpack_string(words, n, bits)
            np.testing.assert_array_equal(back, codes)


def test_logging_levels(capsys):
    from kmerind_jax.utils import logging as klog
    klog.set_level("info")
    klog.log.info("hello-info")
    klog.log.debug("hidden-debug")
    err = capsys.readouterr().err
    assert "hello-info" in err and "hidden-debug" not in err
    klog.set_level("warning")


def test_multihost_single_process(ref_data_dir):
    from kmerind_jax.parallel import multihost
    assert multihost.initialize() is False  # no coordinator configured
    mesh = multihost.global_mesh()
    assert mesh.devices.size >= 1
    b = multihost.host_block_batch(
        ref_data_dir / "test.small.fastq", DNA)
    assert b.num_records == 7  # single process owns the whole file


def test_micro_bench_runs():
    from kmerind_jax.bench.micro import main as micro_main
    res = micro_main(["--n", "65536", "--iters", "1"])
    assert any(r["op"] == "sort_rows" for r in res)


def test_profiler_trace(tmp_path):
    from kmerind_jax.utils.profiling import annotate, trace
    import jax.numpy as jnp
    import jax as _jax
    with trace(str(tmp_path / "tr")) as d:
        with annotate("unit"):
            _jax.jit(lambda a: (a + 1).sum())(jnp.arange(64.0)).block_until_ready()
    import glob
    assert glob.glob(str(tmp_path / "tr") + "/**/*", recursive=True)


def test_chunked_insert_matches_whole(ref_data_dir):
    """Streaming chunked ingestion produces the identical index."""
    from kmerind_jax.io import read_file
    path = ref_data_dir / "test.medium.fastq"
    spec = KmerSpec(21, DNA)
    whole = CountIndex(spec, mesh=make_mesh(4)).build(path)
    batch = read_file(path, DNA)
    chunked = CountIndex(spec, mesh=make_mesh(4))
    chunked.insert_batch(batch, chunk_bases=1000)  # ~9 chunks
    assert chunked.to_dict() == whole.to_dict()


def test_chunk_boundary_no_recursion(ref_data_dir):
    """Regression: num_bases in (chunk, chunk + k - 2) used to recurse
    forever (padded chunks exceeded the re-chunk guard)."""
    from kmerind_jax.io import read_file
    batch = read_file(ref_data_dir / "test.medium.fastq", DNA)  # 8400 bases
    spec = KmerSpec(21, DNA)
    idx = CountIndex(spec, mesh=make_mesh(2))
    idx.insert_batch(batch, chunk_bases=batch.num_bases - 5)  # boundary window
    whole = CountIndex(spec, mesh=make_mesh(2))
    whole.insert_batch(batch)
    assert idx.to_dict() == whole.to_dict()


def test_empty_batch_position_insert():
    """Regression: a partition with zero records must be a clean no-op."""
    from kmerind_jax.index.api import PositionIndex
    from kmerind_jax.io import parse_fastq
    empty = parse_fastq(np.zeros(0, np.uint8), DNA)
    idx = PositionIndex(KmerSpec(21, DNA), mesh=make_mesh(2), id_kind="short")
    idx.insert_batch(empty)
    assert idx.size() == 0


def test_file_id_in_position_ids(ref_data_dir):
    """Multi-file position builds carry the file id in bits 56-63 of every
    stored id (ShortSequenceKmerId file field)."""
    from kmerind_jax.index.api import PositionIndex
    idx = PositionIndex(KmerSpec(21, DNA), mesh=make_mesh(2), id_kind="short")
    idx.build_files([ref_data_dir / "test.small.fastq",
                     ref_data_dir / "test.small.fastq"])
    fids = set()
    for v, ids in idx.to_dict().items():
        for pid in ids:
            fids.add(pid >> 56)
    assert fids == {0, 1}


def test_position_quality_save_load(ref_data_dir, tmp_path):
    from kmerind_jax.index.api import PositionQualityIndex
    idx = PositionQualityIndex(KmerSpec(21, DNA), mesh=make_mesh(4),
                               id_kind="short")
    idx.build(ref_data_dir / "test.small.fastq")
    want = idx.to_dict()
    f = tmp_path / "pq.npz"
    idx.save(f)
    idx2 = PositionQualityIndex.load(f, mesh=make_mesh(8))
    assert idx2.to_dict() == want


def test_debruijn_save_load(ref_data_dir, tmp_path):
    from kmerind_jax.debruijn import DeBruijnGraph
    g = DeBruijnGraph(KmerSpec(21, DNA), mesh=make_mesh(4))
    g.build(ref_data_dir / "test.debruijn.small.fastq")
    want = g.to_dict()
    f = tmp_path / "g.npz"
    g.save(f)
    g2 = DeBruijnGraph.load(f, mesh=make_mesh(2))
    assert g2.to_dict() == want

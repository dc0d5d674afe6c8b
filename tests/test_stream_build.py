"""Streaming block builds (`build_stream`): block-by-block parse+ingest
must produce an index identical to the whole-file build, for FASTQ and
FASTA, across index families and block sizes (including blocks that split
records and FASTA sequences spanning many blocks).

The reference's analog contract is partitioned_file's "union of per-rank
blocks == whole file" (file.hpp:1216-1432) composed with the read_block
ingest loop (kmer_file_helper.hpp:293-331); here the blocks additionally
stream through the zero-copy parser ring while the device consumes."""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.debruijn import DeBruijnGraph
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.index.sorted_api import SortedCountIndex

def _write_corpus(tmp_path, fmt, n_records=300, seed=7):
    """Synthetic corpus big enough for several blocks at tiny block_bytes."""
    rng = np.random.default_rng(seed)
    path = tmp_path / f"corpus.{fmt}"
    with open(path, "w") as f:
        for i in range(n_records):
            ln = int(rng.integers(30, 120))
            seq = "".join(rng.choice(list("ACGT"), size=ln))
            if fmt == "fastq":
                qual = "".join(chr(33 + int(q)) for q in
                               rng.integers(0, 42, ln))
                f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
            else:
                # multi-line sequences: 50-char lines
                lines = "\n".join(seq[j:j + 50] for j in range(0, ln, 50))
                f.write(f">r{i}\n{lines}\n")
    return str(path)


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
@pytest.mark.parametrize("block_bytes", [512, 4096])
def test_stream_equals_whole_file_count(tmp_path, fmt, block_bytes):
    path = _write_corpus(tmp_path, fmt)
    spec = KmerSpec(21, DNA)
    whole = CountIndex(spec).build(path)
    streamed = CountIndex(spec).build_stream(path, block_bytes=block_bytes)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_position_index(tmp_path):
    path = _write_corpus(tmp_path, "fastq", n_records=120)
    spec = KmerSpec(15, DNA)
    whole = PositionIndex(spec).build(path)
    streamed = PositionIndex(spec).build_stream(path, block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_sorted_index(tmp_path):
    path = _write_corpus(tmp_path, "fastq", n_records=120)
    spec = KmerSpec(21, DNA)
    whole = SortedCountIndex(spec).build(path)
    streamed = SortedCountIndex(spec).build_stream(path, block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_sorted_position_index(tmp_path):
    from kmerind_jax.index.sorted_api import SortedPositionIndex
    path = _write_corpus(tmp_path, "fastq", n_records=120)
    spec = KmerSpec(15, DNA)
    whole = SortedPositionIndex(spec).build(path)
    streamed = SortedPositionIndex(spec).build_stream(path,
                                                      block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_bimolecule(tmp_path):
    from kmerind_jax.index.api import BimoleculeCountIndex
    path = _write_corpus(tmp_path, "fastq", n_records=120)
    spec = KmerSpec(21, DNA)
    whole = BimoleculeCountIndex(spec).build(path)
    streamed = BimoleculeCountIndex(spec).build_stream(path, block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_position_quality(tmp_path):
    from kmerind_jax.index.api import PositionQualityIndex
    path = _write_corpus(tmp_path, "fastq", n_records=120)
    spec = KmerSpec(15, DNA)
    whole = PositionQualityIndex(spec).build(path)
    streamed = PositionQualityIndex(spec).build_stream(path,
                                                       block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_debruijn_fastq(tmp_path):
    path = _write_corpus(tmp_path, "fastq", n_records=80)
    spec = KmerSpec(21, DNA)
    whole = DeBruijnGraph(spec).build(path)
    streamed = DeBruijnGraph(spec).build_stream(path, block_bytes=1024)
    assert streamed.to_dict() == whole.to_dict()


@pytest.mark.parametrize("block_bytes", [512, 4096])
def test_stream_debruijn_fasta(tmp_path, block_bytes):
    """FASTA block reads now supply the 1-base LEFT edge context across
    block boundaries (file.hpp:1436+ partitioned FASTA reads + the edge
    halo, edge_iterator.hpp:56) — whole-genome graph builds stream with
    O(block) host memory and node counters equal to the whole-file build,
    at block sizes that split sequences mid-line and mid-record."""
    path = _write_corpus(tmp_path, "fasta", n_records=60)
    spec = KmerSpec(21, DNA)
    whole = DeBruijnGraph(spec).build(path)
    streamed = DeBruijnGraph(spec).build_stream(path,
                                                block_bytes=block_bytes)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_debruijn_fasta_long_genome(tmp_path):
    """One long multi-block sequence: every interior block starts
    mid-sequence and needs both edge halos."""
    rng = np.random.default_rng(11)
    seq = "".join(rng.choice(list("ACGT"), size=30_000))
    path = tmp_path / "genome.fasta"
    path.write_text(">chr1\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    spec = KmerSpec(21, DNA)
    whole = DeBruijnGraph(spec).build(str(path))
    streamed = DeBruijnGraph(spec).build_stream(str(path), block_bytes=2048)
    assert streamed.to_dict() == whole.to_dict()


def test_stream_on_reference_fixture(seeded_corpus):
    """The seeded 300 kbp three-record FASTA, streamed in 100 kB blocks:
    equal to the whole-file build and to the numpy count."""
    from kmerind_jax.bench import synth
    spec = KmerSpec(21, DNA)
    path = seeded_corpus.fasta
    whole = CountIndex(spec).build(path)
    streamed = CountIndex(spec).build_stream(path, block_bytes=100_000)
    assert streamed.to_dict() == whole.to_dict()
    uniq, counts = np.unique(np.concatenate([
        synth.canonical_kmers(c[None, :], spec.k)[0][0]
        for c in seeded_corpus.fasta_codes]), return_counts=True)
    assert whole.to_dict() == dict(zip(uniq.tolist(), counts.tolist()))

"""Randomized end-to-end hardening: messy synthetic corpora (mixed read
lengths, N bases, CRLF, tiny reads, adversarial quality lines) through the
full distributed pipeline vs the oracle — the belt-and-suspenders layer on
top of the per-component suites."""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.io import parse_fastq, read_file
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq


def _random_fastq(rng, n_reads, min_len=1, max_len=120, with_n=False,
                  crlf=False, tricky_quals=False):
    letters = "ACGTN" if with_n else "ACGT"
    out = []
    for i in range(n_reads):
        L = int(rng.integers(min_len, max_len + 1))
        seq = "".join(rng.choice(list(letters), size=L))
        if tricky_quals:
            # quality lines starting with '@' or '+' — the boundary
            # heuristic's adversarial case
            qual = rng.choice(["@", "+", "I"]) + "".join(
                rng.choice(list("!@+IJK"), size=L - 1)) if L > 1 else "I"
        else:
            qual = "".join(chr(c) for c in rng.integers(33, 74, size=L))
        hdr = f"@r{i} x" + ("@+" if tricky_quals else "")
        out.append(f"{hdr}\n{seq}\n+\n{qual}\n")
    text = "".join(out)
    if crlf:
        text = text.replace("\n", "\r\n")
    return text


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("opts", [
    dict(),
    dict(with_n=True),
    dict(crlf=True),
    dict(tricky_quals=True),
    dict(min_len=1, max_len=30),  # many reads shorter than k
])
def test_fuzz_count_index(tmp_path, seed, opts):
    rng = np.random.default_rng(seed)
    k = 13
    text = _random_fastq(rng, 60, **opts)
    path = tmp_path / "fuzz.fastq"
    path.write_text(text, newline="")

    idx = CountIndex(KmerSpec(k, DNA), mesh=make_mesh(4))
    idx.build(path)

    seqs = [r[1] for r in py_parse_fastq(text.replace("\r\n", "\n"))]
    expect = oracle.count_index(seqs, k, DNA, canonical=True)
    assert idx.to_dict() == dict(expect), f"seed={seed} opts={opts}"


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_block_reads(tmp_path, seed):
    """Block-partitioned reads of a messy corpus agree with the whole-file
    parse for every partition count."""
    from kmerind_jax.io import read_fastq_block

    rng = np.random.default_rng(seed + 100)
    text = _random_fastq(rng, 40, tricky_quals=True)
    path = tmp_path / "fuzz.fastq"
    path.write_text(text)
    whole = read_file(path, DNA)
    for nparts in (2, 3, 5):
        starts = []
        for part in range(nparts):
            starts.extend(
                read_fastq_block(path, DNA, part, nparts).record_start.tolist())
        assert sorted(starts) == whole.record_start.tolist(), nparts


def test_fuzz_chunked_equals_whole(tmp_path):
    rng = np.random.default_rng(7)
    text = _random_fastq(rng, 80, max_len=90)
    path = tmp_path / "fuzz.fastq"
    path.write_text(text)
    batch = read_file(path, DNA)
    spec = KmerSpec(17, DNA)
    a = CountIndex(spec, mesh=make_mesh(4))
    a.insert_batch(batch)
    b = CountIndex(spec, mesh=make_mesh(4))
    b.insert_batch(batch, chunk_bases=257)
    assert a.to_dict() == b.to_dict()


def test_fuzz_position_roundtrip(tmp_path):
    """Every stored position id decodes back to the k-mer it claims."""
    rng = np.random.default_rng(11)
    text = _random_fastq(rng, 30, max_len=60)
    path = tmp_path / "fuzz.fastq"
    path.write_text(text)
    k = 13
    spec = KmerSpec(k, DNA)
    idx = PositionIndex(spec, mesh=make_mesh(4), id_kind="short")
    idx.build(path)
    raw = path.read_bytes()
    for v, ids in list(idx.to_dict().items())[:200]:
        for pid in ids:
            rec_start = (pid >> 16) & ((1 << 40) - 1)
            off = pid & 0xFFFF
            got = raw[rec_start + off : rec_start + off + k].decode()
            want = DNA.decode(np.array(oracle.int_to_codes(v, k, 2), np.uint8))
            assert got == want

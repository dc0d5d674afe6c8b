"""Property-based fuzzing of the FASTQ block-boundary heuristic against
adversarial inputs — quality lines that BEGIN with '@' or '+' (legal
Phred+33: '@'=31, '+'=10), variable read lengths, CRLF mixes, and
multi-line-free pathological records.

The reference's own hardest case (fastq_loader.hpp:199-358, decision table
:338-342) is exactly this: from an arbitrary byte offset, the 4-line
first-char pattern must still find the true record start, because '@' and
'+' are valid quality characters.  The invariant fuzzed here is the one
the partitioned loader depends on: for ANY block split, the union of
per-block parses equals the whole-file parse."""

import numpy as np
import pytest

from kmerind_jax import DNA
from kmerind_jax.io.fastq import find_record_start
from kmerind_jax.io.files import read_file, read_fastq_block

QUAL_ADVERSARIAL = "@+"  # legal Phred chars that collide with markers


def _gen_fastq(rng, n_records, adversarial_frac=0.6, crlf=False,
               min_len=4, max_len=40):
    """Random FASTQ text whose quality lines often start with '@' or '+'."""
    recs = []
    for i in range(n_records):
        ln = int(rng.integers(min_len, max_len + 1))
        seq = "".join(rng.choice(list("ACGT"), size=ln))
        qual = list(rng.choice(list("!#5I~@+"), size=ln))
        if rng.random() < adversarial_frac:
            qual[0] = QUAL_ADVERSARIAL[int(rng.integers(2))]
        name = f"r{i}"
        plus = "+" if rng.random() < 0.5 else f"+{name}"
        recs.append((name, seq, "".join(qual), plus))
    eol = "\r\n" if crlf else "\n"
    text = "".join(f"@{n}{eol}{s}{eol}{p}{eol}{q}{eol}"
                   for n, s, q, p in recs)
    return text, recs


def _true_starts(text, recs):
    """Byte offset of each record's '@' header."""
    starts, pos = [], 0
    for n, s, q, p in recs:
        starts.append(pos)
        pos = text.index(f"@{n}", pos) if False else pos
        # recompute directly: header + seq + plus + qual + 4 EOLs
        eol = "\r\n" if "\r" in text else "\n"
        pos += sum(len(x) + len(eol) for x in (f"@{n}", s, p, q))
    return starts


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("crlf", [False, True])
def test_find_record_start_adversarial_quality(seed, crlf):
    rng = np.random.default_rng(seed)
    text, recs = _gen_fastq(rng, 24, crlf=crlf)
    data = np.frombuffer(text.encode(), np.uint8)
    starts = _true_starts(text, recs)
    # from every byte offset the heuristic must find the next true start
    for off in range(1, len(data) - 1):
        got = find_record_start(data[off:], at_parent_start=False)
        nxt = [s for s in starts if s > off]
        if got < len(data) - off:
            assert nxt and got + off == nxt[0], \
                f"seed={seed} off={off}: got {got + off}, want {nxt[:1]}"
        else:
            assert not nxt or nxt[0] >= starts[-1], f"seed={seed} off={off}"


@pytest.mark.parametrize("seed", range(6))
def test_block_union_invariance_adversarial(seed, tmp_path):
    rng = np.random.default_rng(100 + seed)
    text, recs = _gen_fastq(rng, 40, crlf=bool(seed % 2))
    p = tmp_path / "adv.fastq"
    p.write_text(text, newline="")
    whole = read_file(p, DNA)
    assert whole.num_records == len(recs)
    for nparts in (2, 3, 5, 7):
        starts, bases = [], 0
        for part in range(nparts):
            blk = read_fastq_block(p, DNA, part, nparts)
            starts.extend(blk.record_start.tolist())
            bases += blk.num_bases
        assert sorted(starts) == whole.record_start.tolist(), \
            f"seed={seed} np={nparts}"
        assert bases == whole.num_bases, f"seed={seed} np={nparts}"


def test_all_at_plus_quality_block_union(tmp_path):
    """Worst case: EVERY quality line is pure '@'/'+' characters."""
    rng = np.random.default_rng(7)
    recs = []
    for i in range(30):
        ln = int(rng.integers(4, 30))
        seq = "".join(rng.choice(list("ACGT"), size=ln))
        qual = "".join(rng.choice(list("@+"), size=ln))
        recs.append((f"x{i}", seq, qual))
    text = "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in recs)
    p = tmp_path / "worst.fastq"
    p.write_text(text)
    whole = read_file(p, DNA)
    assert whole.num_records == 30
    for nparts in (2, 4, 6):
        starts = []
        for part in range(nparts):
            starts.extend(
                read_fastq_block(p, DNA, part, nparts).record_start.tolist())
        assert sorted(starts) == whole.record_start.tolist(), f"np={nparts}"


def test_record_start_exactly_on_block_boundary(tmp_path):
    """A record starting precisely AT a block boundary must be owned by
    exactly one block: the boundary finder scans from pos-1 so the
    preceding newline proves the line start (regression: records landing
    on boundaries were skipped by BOTH neighbors)."""
    from kmerind_jax.io.files import read_file, read_fastq_block

    # fixed-size records (26 bytes each: 6+9+2+9) so block boundaries
    # land exactly on record starts whenever nblocks divides total evenly
    recs = []
    for i in range(64):
        seq = "ACGTACGT"          # 8 bases
        qual = "@+II#!I~"         # adversarial first chars
        recs.append(f"@r{i:03d}\n{seq}\n+\n{qual}\n")
    text = "".join(recs)
    path = tmp_path / "aligned.fastq"
    path.write_text(text)
    total = len(text)
    rec_len = len(recs[0])
    whole = read_file(str(path), DNA, engine="numpy")
    # sweep block counts so boundaries land on many byte offsets,
    # including exact record starts (total % rec_len == 0 cases)
    for nblocks in (2, 4, 8, 16, total // rec_len, 64, 99):
        got = []
        for p in range(nblocks):
            got.extend(read_fastq_block(
                str(path), DNA, p, nblocks).record_start.tolist())
        assert sorted(got) == sorted(whole.record_start.tolist()), nblocks


def test_fuzz_streaming_tiny_blocks(tmp_path):
    """Randomized streamed-vs-whole equality at block sizes SMALLER than
    a record (regression: the boundary off-by-one surfaced only when many
    boundaries fell inside/at records)."""
    from kmerind_jax.index.api import CountIndex, PositionIndex
    from kmerind_jax.parallel.mesh import make_mesh
    from kmerind_jax import KmerSpec

    rng = np.random.default_rng(7474)
    path = tmp_path / "tiny.fastq"
    with open(path, "w") as f:
        for i in range(80):
            L = int(rng.integers(1, 300))
            seq = "".join(rng.choice(list("ACGT"), size=L))
            qual = "".join(rng.choice(list("!@+I#"), size=L))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    for cls, k in ((CountIndex, 21), (PositionIndex, 15)):
        spec = KmerSpec(k, DNA)
        whole = cls(spec, mesh=make_mesh(2)).build(str(path))
        streamed = cls(spec, mesh=make_mesh(2)).build_stream(
            str(path), block_bytes=256)
        assert streamed.to_dict() == whole.to_dict(), cls.__name__

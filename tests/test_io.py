"""FASTQ/FASTA parsing vs Python-oracle parsing of the reference fixture
files, plus block-partition invariance (the np=1..4 sweep analog of
mpi_test_file_load / mpi_test_fastq_seq_parse)."""

import numpy as np
import pytest

from kmerind_jax import DNA, DNA16
from kmerind_jax.io import (
    block_partition,
    find_record_start,
    parse_fastq,
    parse_fasta,
    read_fasta_block,
    read_fastq_block,
    read_file,
    sniff_format,
)


# ---------------------------------------------------------------- oracles
def py_parse_fastq(text: str):
    """(header, seq, qual, record_byte_offset, seq_byte_offset) per record."""
    out = []
    pos = 0
    lines = text.split("\n")
    offsets = []
    for ln in lines:
        offsets.append(pos)
        pos += len(ln) + 1
    i = 0
    while i + 3 < len(lines) or (i + 3 == len(lines) - 1 + 1 and lines[i]):
        if not lines[i]:
            break
        out.append(
            (lines[i], lines[i + 1], lines[i + 3], offsets[i], offsets[i + 1])
        )
        i += 4
    return out


def py_parse_fasta(text: str):
    """(header_offset, seq_string, [abs pos per base]) per record.

    Reference semantics (fasta_loader.hpp:295-325): '>' and ';' both start
    header lines; a run of consecutive header lines is ONE record header;
    blank lines are invisible (neither header nor sequence)."""
    recs = []
    pos = 0
    cur = None
    prev_hdr = False
    for ln in text.split("\n"):
        body = ln.rstrip("\r")
        if not body:
            pass  # blank line: invisible, does not break a header run
        elif body.startswith(">") or body.startswith(";"):
            if not prev_hdr:
                cur = {"hdr": pos, "seq": [], "pos": []}
                recs.append(cur)
            prev_hdr = True
        else:
            prev_hdr = False
            if cur is not None:
                for j, ch in enumerate(body):
                    cur["seq"].append(ch)
                    cur["pos"].append(pos + j)
        pos += len(ln) + 1
    return recs


# ---------------------------------------------------------------- fixtures
FASTQ_TEXT = (
    "@read1 some description\n"
    "ACGTACGTACGTTGCA\n"
    "+\n"
    "IIIIIIIIIIIHHHHH\n"
    "@read2\n"
    "GGGGCCCCAAAATTTT\n"
    "+read2\n"
    "!!!!IIIIJJJJKKKK\n"
    "@read3\n"
    "ACGT\n"
    "+\n"
    "ABCD\n"
)


def _bytes(s):
    return np.frombuffer(s.encode(), dtype=np.uint8)


def test_parse_fastq_synthetic():
    b = parse_fastq(_bytes(FASTQ_TEXT), DNA)
    assert b.num_records == 3
    assert b.num_bases == 16 + 16 + 4
    exp = py_parse_fastq(FASTQ_TEXT)
    # record starts
    np.testing.assert_array_equal(b.record_start, [e[3] for e in exp])
    # sequence reconstruction
    seqs = "".join(e[1] for e in exp)
    assert DNA.decode(b.codes) == seqs
    # quality bytes align with bases
    quals = "".join(e[2] for e in exp)
    assert b.qual.tobytes().decode() == quals
    # offset_in_record counts raw bytes from record start
    r0 = exp[0]
    np.testing.assert_array_equal(
        b.offset_in_record[:16], np.arange(16) + (r0[4] - r0[3]))
    # ShortSequenceKmerId encoding (sequence.hpp:152-156)
    ids = b.short_ids()
    assert ids[0] == (r0[3] << 16) | (r0[4] - r0[3])


def test_parse_fastq_crlf_and_no_trailing_newline():
    text = FASTQ_TEXT.replace("\n", "\r\n").rstrip("\r\n")
    b = parse_fastq(_bytes(text), DNA)
    assert b.num_records == 3
    assert b.num_bases == 36


def test_parse_fastq_malformed():
    # truncated after the '+' line: the quality line is empty, which the
    # exact 4-line walk reports as a length mismatch (like the native
    # scanner's FS_ERR_LEN_MISMATCH for the same bytes)
    with pytest.raises(ValueError, match="quality"):
        parse_fastq(_bytes("@r\nACGT\n+\n"), DNA)
    with pytest.raises(ValueError, match="'@'"):
        parse_fastq(_bytes("r\nACGT\n+\nIIII\n"), DNA)
    with pytest.raises(ValueError, match="quality"):
        parse_fastq(_bytes("@r\nACGT\n+\nIII\n"), DNA)


def test_find_record_start_all_offsets():
    """From any byte offset, the 4-line heuristic must locate the next true
    record start (fastq_loader.hpp:199-358)."""
    data = _bytes(FASTQ_TEXT)
    true_starts = [r[3] for r in py_parse_fastq(FASTQ_TEXT)]
    for off in range(1, len(data) - 1):
        got = find_record_start(data[off:], at_parent_start=False)
        # a mid-block search cannot see a record start at its own first byte
        # (the preceding '\n' was cut off) — that record belongs to the left
        # block, exactly as in the reference (fastq_loader.hpp:302-315).
        nxt = [s for s in true_starts if s > off]
        if got < len(data) - off:
            assert nxt and got + off == nxt[0], f"offset {off}"
        else:
            # not found: acceptable only when the next start is too close to
            # EOF for the 4-line pattern to be visible
            assert not nxt or nxt[0] >= true_starts[-1], f"offset {off}"


def test_fastq_block_partition_invariance(tmp_path):
    p = tmp_path / "t.fastq"
    p.write_text(FASTQ_TEXT)
    whole = read_file(p, DNA)
    for nparts in range(1, 6):
        recs = []
        bases = 0
        for part in range(nparts):
            blk = read_fastq_block(p, DNA, part, nparts)
            recs.extend(blk.record_start.tolist())
            bases += blk.num_bases
        assert sorted(recs) == whole.record_start.tolist(), f"np={nparts}"
        assert bases == whole.num_bases


FASTA_TEXT = (
    ">seq1 first\n"
    "ACGTACGTAC\n"
    "GTTGCAGGGG\n"
    "TT\n"
    ";comment line\n"
    ">seq2\n"
    "CCCCAAAATT\n"
)


def test_parse_fasta_synthetic():
    b = parse_fasta(_bytes(FASTA_TEXT), DNA)
    exp = py_parse_fasta(FASTA_TEXT)
    assert b.num_records == 2
    assert b.num_bases == 22 + 10
    seqs = "".join("".join(e["seq"]) for e in exp)
    assert DNA.decode(b.codes) == seqs
    allpos = [p for e in exp for p in e["pos"]]
    np.testing.assert_array_equal(b.global_pos, allpos)
    # LongSequenceKmerId: file 0, seq idx in bits 40-55, pos low 40
    ids = b.long_ids()
    assert ids[0] == exp[0]["pos"][0]
    first2 = 22  # first base of seq2
    assert ids[first2] == (1 << 40) | exp[1]["pos"][0]


def test_fasta_block_partition_invariance(tmp_path):
    p = tmp_path / "t.fasta"
    p.write_text(FASTA_TEXT)
    whole = read_file(p, DNA)
    k = 4
    for nparts in range(1, 6):
        owned_pos = []
        for part in range(nparts):
            blk = read_fasta_block(p, DNA, part, nparts, halo=k - 1)
            owned_pos.extend(blk.global_pos[blk.owned].tolist())
        assert sorted(owned_pos) == whole.global_pos.tolist(), f"np={nparts}"


# ------------------------------------------------------- reference fixtures
def test_reference_small_fastq(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    b = read_file(path, DNA)
    text = path.read_text()
    exp = py_parse_fastq(text)
    assert b.num_records == len(exp)
    assert DNA.decode(b.codes) == "".join(e[1] for e in exp)
    assert b.qual.tobytes().decode() == "".join(e[2] for e in exp)
    np.testing.assert_array_equal(b.record_start, [e[3] for e in exp])


def test_reference_medium_fasta(ref_data_dir):
    path = ref_data_dir / "test.medium.fasta"
    b = read_file(path, DNA16)
    exp = py_parse_fasta(path.read_text())
    assert b.num_records == len(exp)
    assert b.num_bases == sum(len(e["seq"]) for e in exp)
    assert DNA16.decode(b.codes[:50]) == "".join(exp[0]["seq"][:50]).upper().replace("U", "T")


def test_reference_fastq_blocks(ref_data_dir):
    path = ref_data_dir / "test.small.fastq"
    whole = read_file(path, DNA)
    for nparts in (2, 3, 7):
        starts = []
        for part in range(nparts):
            starts.extend(read_fastq_block(path, DNA, part, nparts).record_start.tolist())
        assert sorted(starts) == whole.record_start.tolist()


def test_sniff(ref_data_dir):
    assert sniff_format(ref_data_dir / "test.small.fastq") == "fastq"
    assert sniff_format(ref_data_dir / "test.medium.fasta") == "fasta"


def test_block_partition_properties():
    for total in (0, 1, 10, 97):
        for nparts in (1, 2, 3, 8):
            spans = [block_partition(total, nparts, p) for p in range(nparts)]
            assert spans[0][0] == 0 and spans[-1][1] == total
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c
            sizes = [b - a for a, b in spans]
            assert max(sizes) - min(sizes) <= 1


def test_cyclic_partition():
    from kmerind_jax.io.files import cyclic_partition
    spans = {p: cyclic_partition(100, 3, p, 10) for p in range(3)}
    allspans = sorted(sp for l in spans.values() for sp in l)
    assert allspans[0][0] == 0 and allspans[-1][1] == 100
    for (a, b), (c, d) in zip(allspans, allspans[1:]):
        assert b == c
    assert spans[1][0] == (10, 20) and spans[1][1] == (40, 50)


def test_drop_records_with_invalid(ref_data_dir):
    """SequenceNPredicate: reads containing N are dropped under strict DNA
    (filtered_sequence_iterator.hpp:151)."""
    from kmerind_jax.io.filters import (
        drop_records_with_invalid, records_with_invalid)
    path = ref_data_dir / "natural.withN.fastq"
    data = np.fromfile(path, np.uint8)
    b = read_file(path, DNA)
    bad = records_with_invalid(b, data, DNA)
    text = path.read_text()
    want_bad = ["N" in r[1] for r in py_parse_fastq(text)]
    np.testing.assert_array_equal(bad, want_bad)
    assert bad.any() and not bad.all()
    fb = drop_records_with_invalid(b, data, DNA)
    assert fb.num_bases == sum(
        len(r[1]) for r, w in zip(py_parse_fastq(text), want_bad) if not w)
    # kmers from the filtered batch contain no read with N
    kept_segs = set(fb.seg_id.tolist())
    assert all(not want_bad[s] for s in kept_segs)


def test_fasta_block_long_ids_invariance(ref_data_dir):
    """Block reads must produce the same LongSequenceKmerIds (absolute
    positions AND sequence ordinals) as the whole-file parse, for every
    partition count — including blocks starting exactly at a header."""
    path = ref_data_dir / "test.medium.fasta"
    whole = read_file(path, DNA16)
    want = {int(p): int(i) for p, i in
            zip(whole.global_pos, whole.long_ids())}
    for nparts in (2, 3, 7, 16):
        got = {}
        for part in range(nparts):
            blk = read_fasta_block(path, DNA16, part, nparts, halo=20)
            ids = blk.long_ids()
            for p, i, o in zip(blk.global_pos, ids, blk.owned):
                if o:
                    got[int(p)] = int(i)
        assert got == want, f"np={nparts}"


def test_fasta_block_record_starts_union(ref_data_dir):
    """Per-block O(block) record-start scans must union to the whole-file
    header table for every partition count (the per-rank half of the
    reference's distributed header scan, fasta_loader.hpp:202-360)."""
    from kmerind_jax.io.files import (
        block_partition as bp, fasta_block_record_starts, fasta_header_table,
        file_size)

    for name in ("test.fasta", "test2.fasta", "test.medium.fasta"):
        path = ref_data_dir / name
        full = fasta_header_table(path).tolist()
        total = file_size(path)
        for nparts in (1, 2, 3, 5, 11):
            got = []
            for part in range(nparts):
                bs, be = bp(total, nparts, part)
                got.extend(fasta_block_record_starts(path, bs, be).tolist())
            assert got == full, f"{name} np={nparts}"


def test_fasta_block_with_explicit_context(ref_data_dir):
    """read_fasta_block(context=...) — the multi-host path where leading
    record context comes from the distributed exchange instead of the
    whole-file header table — must match the default path exactly."""
    from kmerind_jax.io.files import (
        block_partition as bp, fasta_block_record_starts, fasta_header_table,
        file_size)

    path = ref_data_dir / "test2.fasta"
    total = file_size(path)
    full = fasta_header_table(path)
    for nparts in (2, 3, 5):
        for part in range(nparts):
            bs, be = bp(total, nparts, part)
            # recompute the context the way the distributed exchange does:
            # only per-block scans, no whole-file information
            starts_per = [fasta_block_record_starts(path, *bp(total, nparts, j))
                          for j in range(nparts)]
            local = starts_per[part]
            before = sum(s.size for s in starts_per[:part])
            if local.size and int(local[0]) == bs:
                ctx = (before, bs)
            else:
                prev = [int(s[-1]) for s in starts_per[:part] if s.size]
                ctx = (before - 1, prev[-1]) if prev else (-1, -1)
            a = read_fasta_block(path, DNA, part, nparts, halo=10)
            b = read_fasta_block(path, DNA, part, nparts, halo=10, context=ctx)
            np.testing.assert_array_equal(a.global_pos, b.global_pos)
            np.testing.assert_array_equal(a.codes, b.codes)
            np.testing.assert_array_equal(a.seq_index, b.seq_index)
            np.testing.assert_array_equal(a.record_start, b.record_start)
            np.testing.assert_array_equal(a.owned, b.owned)
            # context sanity vs the whole-file table
            hidx = int(np.searchsorted(full, bs, side="right")) - 1
            want = (hidx, int(full[hidx])) if hidx >= 0 else (-1, -1)
            assert ctx == want, f"np={nparts} part={part}"


def test_split_records_at_invalid(ref_data_dir):
    """SplitSequencesIterator semantics: reads containing N split into
    parts at each N; k-mers never span an N and parts shorter than k
    contribute nothing (filtered_sequence_iterator.hpp:168-247)."""
    from kmerind_jax.io.filters import split_records_at_invalid
    from kmerind_jax.index.api import CountIndex
    from kmerind_jax import KmerSpec
    import oracle

    path = ref_data_dir / "natural.withN.fastq"
    data = np.fromfile(path, np.uint8)
    b = read_file(path, DNA)
    sb = split_records_at_invalid(b, data, DNA)
    k = 21
    idx = CountIndex(KmerSpec(k, DNA)).insert_batch(sb)
    # oracle: every N-free piece of every read, counted separately
    pieces = []
    for rec in py_parse_fastq(path.read_text()):
        pieces.extend(p for p in rec[1].split("N") if len(p) >= k)
    expect = oracle.count_index(pieces, k, DNA, canonical=True)
    got = idx.to_dict()
    assert got == {kk: int(v) for kk, v in expect.items()}
    assert len(got) > 0

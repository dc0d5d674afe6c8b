"""Native C++ scanner vs the numpy reference parsers — byte-identical
outputs on all fixtures (the native path is an accelerator, not a fork)."""

import numpy as np
import pytest

from kmerind_jax import DNA, DNA16
from kmerind_jax.io import native, parse_fasta, parse_fastq
from kmerind_jax.io.fastq import find_record_start as np_find

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable")

COLUMNS = ["codes", "seg_id", "offset_in_record", "global_pos", "qual",
           "record_start", "seq_index", "file_id"]


@pytest.mark.parametrize("fixture,kind,alpha", [
    ("test.small.fastq", "fastq", DNA),
    ("test.medium.fastq", "fastq", DNA),
    ("natural.fastq", "fastq", DNA),
    ("natural.withN.fastq", "fastq", DNA),
    ("test.medium.fasta", "fasta", DNA16),
    ("natural.withN.fasta", "fasta", DNA16),
    ("test.unitiqs.fasta", "fasta", DNA),
])
def test_native_equals_numpy(ref_data_dir, fixture, kind, alpha):
    data = np.fromfile(ref_data_dir / fixture, np.uint8)
    nat = (native.fastq_parse if kind == "fastq" else native.fasta_parse)(
        data, alpha, file_offset=7, file_id=3, seq_index_base=11)
    ref = (parse_fastq if kind == "fastq" else parse_fasta)(
        data, alpha, file_offset=7, file_id=3, seq_index_base=11)
    for col in COLUMNS:
        np.testing.assert_array_equal(
            getattr(nat, col), getattr(ref, col), err_msg=f"{fixture}:{col}")


def test_native_crlf():
    # CRLF line endings plus a pathological double-\r: the reference's
    # NotEOL drops every \r, so both must be trimmed
    text = "@r\r\nACGT\r\r\n+\r\nIIII\r\r\n"
    data = np.frombuffer(text.encode(), np.uint8)
    nat = native.fastq_parse(data, DNA)
    ref = parse_fastq(data, DNA)
    np.testing.assert_array_equal(nat.codes, ref.codes)
    np.testing.assert_array_equal(nat.qual, ref.qual)


def test_native_errors():
    with pytest.raises(ValueError, match="'@'"):
        native.fastq_parse(np.frombuffer(b"r\nACGT\n+\nIIII\n", np.uint8), DNA)
    with pytest.raises(ValueError, match="mismatch"):
        native.fastq_parse(np.frombuffer(b"@r\nACGT\n+\nIII\n", np.uint8), DNA)
    with pytest.raises(ValueError, match="'\\+'"):
        native.fastq_parse(np.frombuffer(b"@r\nACGT\nX\nIIII\n", np.uint8), DNA)


def test_native_find_record_start_parity(ref_data_dir):
    data = np.fromfile(ref_data_dir / "test.small.fastq", np.uint8)
    for off in range(0, data.shape[0] - 8, 7):
        got = native.find_record_start(data[off:], off == 0)
        want = np_find(data[off:], off == 0)
        assert got == want, off


def test_native_reuse_ring(ref_data_dir):
    """reuse=True returns ring views: contents match copy mode, memory is
    recycled after _RING_SIZE parses, and the live double-buffer pair is
    never aliased."""
    data = np.fromfile(ref_data_dir / "test.medium.fastq", np.uint8)
    safe = native.fastq_parse(data, DNA)
    a = native.fastq_parse(data, DNA, reuse=True)
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(a, col), getattr(safe, col))
    b = native.fastq_parse(data, DNA, reuse=True)  # other ring slot
    assert a.codes.ctypes.data != b.codes.ctypes.data  # double-buffer live
    np.testing.assert_array_equal(a.codes, b.codes)   # a still intact
    c = native.fastq_parse(data, DNA, reuse=True)     # wraps: reuses a's slot
    assert c.codes.ctypes.data == a.codes.ctypes.data
    # valid/owned alias a read-only pooled ones buffer
    assert not c.valid.flags.writeable
    assert c.valid.all() and c.owned.all()
    # copy mode still returns independent writable arrays
    d = native.fastq_parse(data, DNA)
    assert d.codes.flags.writeable
    assert d.codes.ctypes.data not in (a.codes.ctypes.data,
                                       b.codes.ctypes.data)


def test_native_fastq_base_capacity():
    """FASTQ output capacity n//2+16 always suffices (quality line mirrors
    the sequence line), even for degenerate tiny records."""
    text = "".join(f"@{i}\nA\n+\nI\n" for i in range(500))
    data = np.frombuffer(text.encode(), np.uint8)
    nat = native.fastq_parse(data, DNA, reuse=True)
    ref = parse_fastq(data, DNA)
    np.testing.assert_array_equal(nat.codes, ref.codes)
    np.testing.assert_array_equal(nat.seg_id, ref.seg_id)


def test_native_fasta_ctx_matches_numpy(ref_data_dir):
    """fasta_parse_ctx (mid-record block context) == numpy parse_fasta for
    every slice start/leading/prev-header combination the block reader
    produces."""
    data = np.fromfile(ref_data_dir / "test.medium.fasta", np.uint8)
    # slice at line boundaries inside the file, with true leading context
    nl = np.flatnonzero(data == 10)
    rng = np.random.default_rng(3)
    hdr_starts = np.flatnonzero(
        ((data == ord(">")) | (data == ord(";")))
        & np.concatenate([[True], data[:-1] == 10]))
    for cut in rng.choice(nl[:-2], size=12, replace=False):
        ps = int(cut) + 1  # line start
        hidx = int(np.searchsorted(hdr_starts, ps, side="right")) - 1
        lead = int(hdr_starts[hidx])
        leading = None if lead >= ps else lead
        prev_hdr = data[int(nl[np.searchsorted(nl, ps - 1) - 1]) + 1] in (
            ord(">"), ord(";")) if ps > 0 else False
        blk = data[ps:ps + 4096]
        nat = native.fasta_parse(blk, DNA, file_offset=ps,
                                 seq_index_base=max(hidx, 0),
                                 leading_record_start=leading,
                                 prev_line_is_header=bool(prev_hdr))
        ref = parse_fasta(blk, DNA, file_offset=ps,
                          seq_index_base=max(hidx, 0),
                          leading_record_start=leading,
                          prev_line_is_header=bool(prev_hdr))
        for col in COLUMNS:
            np.testing.assert_array_equal(
                getattr(nat, col), getattr(ref, col),
                err_msg=f"cut={ps}:{col}")


@pytest.mark.parametrize("kind", ["fastq", "fasta"])
def test_native_mt_matches_numpy_adversarial(kind):
    """The multi-threaded parse (>4MB triggers range splitting at record
    boundaries) must equal the numpy parser bit-for-bit on adversarial
    corpora: quality lines starting with '@'/'+', header runs, CRLF,
    blank lines, tiny and huge records straddling the cut points."""
    rng = np.random.default_rng(11)
    parts = []
    total = 0
    while total < (5 << 20):  # past the 4MB MT gate
        ln = int(rng.choice([1, 3, 17, 80, 250, 5000, 200_000]))
        seq = "".join(rng.choice(list("ACGT"), size=ln))
        if kind == "fastq":
            qual = "".join(rng.choice(list("!#5I~@+"), size=ln))
            rec = f"@r{total}\n{seq}\n+\n{qual}\n"
        else:
            nl = "\r\n" if rng.random() < 0.2 else "\n"
            lines = nl.join(seq[j:j + 70] for j in range(0, ln, 70))
            hdr = f">r{total}\n" + (f";comment\n" if rng.random() < 0.3
                                    else "")
            rec = hdr + lines + nl + ("\n" if rng.random() < 0.2 else "")
        parts.append(rec)
        total += len(rec)
    data = np.frombuffer("".join(parts).encode(), np.uint8)
    nat = (native.fastq_parse if kind == "fastq" else native.fasta_parse)(
        data, DNA, file_offset=13, file_id=2)
    ref = (parse_fastq if kind == "fastq" else parse_fasta)(
        data, DNA, file_offset=13, file_id=2)
    for col in COLUMNS:
        np.testing.assert_array_equal(
            getattr(nat, col), getattr(ref, col), err_msg=f"{kind}:{col}")


def test_native_mt_empty_sequence_records_fallback():
    """Empty-sequence records ('@r\\n\\n+\\n\\n') collapse the 4-line cycle
    and can defeat the MT boundary heuristic; the parser must fall back to
    the serial walk rather than reject input whose validity would depend
    on the thread count (>4MB triggers MT)."""
    rng = np.random.default_rng(5)
    recs = []
    total = 0
    i = 0
    while total < (5 << 20):
        if i % 3 == 0:
            rec = f"@e{i}\n\n+\n\n"  # empty sequence + empty quality
        else:
            ln = int(rng.integers(1, 120))
            seq = "".join(rng.choice(list("ACGT"), size=ln))
            qual = "".join(rng.choice(list("@+I#!"), size=ln))
            rec = f"@r{i}\n{seq}\n+\n{qual}\n"
        recs.append(rec)
        total += len(rec)
        i += 1
    data = np.frombuffer("".join(recs).encode(), np.uint8)
    nat = native.fastq_parse(data, DNA)
    ref = parse_fastq(data, DNA)
    for col in COLUMNS:
        np.testing.assert_array_equal(
            getattr(nat, col), getattr(ref, col), err_msg=col)

"""Seeded synthetic sequencing data and a plain numpy k-mer count.

A whole-genome short-read run made from a seed: a random genome with
planted repeat families (the rRNA operons and insertion elements of a
bacterial genome), reads sampled uniformly from both strands with
substitution errors and phred qualities, written as FASTQ or FASTA.

`canonical_kmers` / `count_canonical` state the canonical count index in
plain numpy (2-bit DNA, k <= 32, one uint64 per k-mer).  They share no
code with the package's device paths, so they serve as the reference the
index is checked against.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_genome", "sample_reads", "write_fastq", "write_fasta",
           "canonical_kmers", "count_canonical", "revcomp_u64",
           "u64_to_words"]

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_genome(rng: np.random.Generator, n_bases: int,
                n_families: int = 20, repeat_len=(1000, 5000),
                copies=(2, 8)) -> np.ndarray:
    """uint8[n_bases] codes 0..3: uniform random bases, then `n_families`
    segments copied to 2..8 other places each (exact repeats)."""
    g = rng.integers(0, 4, n_bases, dtype=np.uint8)
    for _ in range(n_families):
        ln = int(rng.integers(*repeat_len))
        if ln >= n_bases // 4:
            continue
        src = int(rng.integers(0, n_bases - ln))
        seg = g[src:src + ln].copy()
        for dst in rng.integers(0, n_bases - ln, int(rng.integers(*copies))):
            g[dst:dst + ln] = seg
    return g


def sample_reads(rng: np.random.Generator, genome: np.ndarray,
                 n_reads: int, read_len: int, error_rate: float):
    """(codes uint8[n_reads, read_len], quals uint8[n_reads, read_len]).

    Starts are uniform; half the reads come from the reverse strand;
    each base is substituted with probability `error_rate`.  Qualities
    are Illumina 1.8 phred+33 bytes in [2, 40]."""
    windows = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    reads = windows[rng.integers(0, windows.shape[0], n_reads)]
    rev = rng.random(n_reads) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    flat = reads.reshape(-1)
    n_err = int(rng.binomial(flat.size, error_rate))
    at = rng.integers(0, flat.size, n_err)
    flat[at] = (flat[at] + rng.integers(1, 4, n_err, dtype=np.uint8)) % 4
    quals = rng.integers(33 + 2, 33 + 41, reads.shape, dtype=np.uint8)
    return reads, quals


def write_fastq(path, reads: np.ndarray, quals: np.ndarray) -> int:
    """Write fixed-width FASTQ records ``@r<index>``; returns bytes."""
    n, ln = reads.shape
    digits = max(1, len(str(max(n - 1, 0))))
    width = 1 + digits + 1 + ln + 3 + ln + 1
    buf = np.empty((n, width), np.uint8)
    buf[:, 0] = ord("@")
    idx = np.arange(n)
    for d in range(digits):
        buf[:, digits - d] = ord("0") + (idx // 10 ** d) % 10
    c = 1 + digits
    buf[:, c] = ord("\n")
    buf[:, c + 1:c + 1 + ln] = ACGT[reads]
    c += 1 + ln
    buf[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    buf[:, c + 3:c + 3 + ln] = quals
    buf[:, -1] = ord("\n")
    buf.tofile(path)
    return buf.size


def write_fasta(path, seqs, line_len: int = 60) -> None:
    """Write code arrays as FASTA records ``>s<index>`` wrapped at
    `line_len` characters."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            text = ACGT[s].tobytes()
            f.write(b">s%d\n" % i)
            for j in range(0, len(text), line_len):
                f.write(text[j:j + line_len] + b"\n")


def _windows(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64[n, L-k+1]: 2-bit pack of every length-k window of each row
    of codes[n, L], first base most significant (power-of-two doubling)."""
    pw = {1: codes.astype(np.uint64)}
    s = 1
    while 2 * s <= k:
        prev = pw[s]
        pw[2 * s] = (prev[:, :-s] << np.uint64(2 * s)) | prev[:, s:]
        s *= 2
    nwin = codes.shape[1] - k + 1
    acc, off = None, 0
    for s in sorted(pw, reverse=True):
        if k & s:
            part = pw[s][:, off:off + nwin]
            acc = part if acc is None else (acc << np.uint64(2 * s)) | part
            off += s
    return acc


def canonical_kmers(codes: np.ndarray, k: int):
    """(canonical uint64[n, W], was_rc bool[n, W]) for reads codes[n, L]:
    min of each window and its reverse complement (W = L - k + 1)."""
    assert 1 <= k <= 32
    fwd = _windows(codes, k)
    rc = _windows(3 - codes[:, ::-1], k)[:, ::-1]
    was_rc = rc < fwd
    return np.where(was_rc, rc, fwd), was_rc


def count_canonical(codes: np.ndarray, k: int):
    """(sorted distinct canonical k-mers uint64, counts int64)."""
    canon, _ = canonical_kmers(codes, k)
    return np.unique(canon.reshape(-1), return_counts=True)


def revcomp_u64(vals: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit packed k-mers."""
    v = np.asarray(vals, np.uint64)
    out = np.zeros_like(v)
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (v & np.uint64(3)))
        v = v >> np.uint64(2)
    return out


def u64_to_words(vals: np.ndarray, k: int) -> np.ndarray:
    """uint32[n, nwords] rows in the index's char-aligned big-endian word
    layout (16 bases per word, the last word right-aligned)."""
    counts = [16] * (k // 16) + ([k % 16] if k % 16 else [])
    v = np.asarray(vals, np.uint64)
    cols, shift = [], 2 * k
    for c in counts:
        shift -= 2 * c
        cols.append(((v >> np.uint64(shift))
                     & np.uint64((1 << (2 * c)) - 1)).astype(np.uint32))
    return np.stack(cols, axis=1)

"""Large synthetic corpus: chunked ingestion + capacity growth at scale.

The reference benchmarks on multi-GB FASTQ (BenchmarkKmerIndex,
test/benchmark_kmerindex.cpp); the analog invariant here is that a corpus
larger than one device chunk (default_chunk_bases = 8.4M bases) streams
through the SAME jitted executables chunk by chunk (double-buffered
host→device feeding), the store grows capacity on overflow retries, and
the final index matches a vectorized numpy oracle exactly — full key AND
count multisets, not samples.

Sized to ~12M bases (2 device chunks, one capacity growth) so the CPU
suite stays fast; 100M+-scale runs are the bench/CLI path on hardware."""

import numpy as np

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex
from kmerind_jax.io.batch import ReadBatch
from kmerind_jax.parallel.mesh import make_mesh

K = 21
N_BASES = 12_000_000
READ_LEN = 1000


def _batch_from_codes(codes: np.ndarray) -> ReadBatch:
    n = codes.shape[0]
    seg = (np.arange(n) // READ_LEN).astype(np.int32)
    nrec = int(seg[-1]) + 1
    return ReadBatch(
        codes=codes,
        valid=np.ones(n, bool),
        owned=np.ones(n, bool),
        seg_id=seg,
        offset_in_record=(np.arange(n) % READ_LEN).astype(np.uint32),
        global_pos=np.arange(n, dtype=np.uint64),
        qual=np.zeros(n, np.uint8),
        record_start=(np.arange(nrec, dtype=np.uint64) * READ_LEN),
        seq_index=np.arange(nrec, dtype=np.uint32),
        file_id=np.zeros(nrec, np.uint16),
        alphabet=DNA,
    )


def _pack_ints(codes: np.ndarray) -> np.ndarray:
    """Canonical uint64 ints of every valid K-window (numpy oracle)."""
    n = codes.shape[0]
    c = codes.astype(np.uint64)
    acc = c.copy()
    span = 1
    while span < K:
        step = min(span, K - span)
        shifted = np.zeros_like(acc)
        shifted[:-step] = acc[step:]
        acc = (acc << np.uint64(2 * step)) | shifted
        span += step
    mask = np.uint64((1 << (2 * K)) - 1)
    fwd = acc[: n - K + 1] & mask
    comp = np.uint64(3) - c
    racc = comp[::-1].copy()
    span = 1
    while span < K:
        step = min(span, K - span)
        shifted = np.zeros_like(racc)
        shifted[:-step] = racc[step:]
        racc = (racc << np.uint64(2 * step)) | shifted
        span += step
    rc = racc[::-1][K - 1:] & mask
    canon = np.minimum(fwd, rc)
    w_idx = np.arange(n - K + 1)
    valid = (w_idx // READ_LEN) == ((w_idx + K - 1) // READ_LEN)
    return canon[valid]


def _stored_ints(idx: CountIndex) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized (sorted_keys_u64, counts) across all shards."""
    kw, cn = idx.items()  # [t, 2] uint32 rows, int64 counts
    spec = idx.spec
    # words are char-aligned big-endian with the last word right-aligned:
    # to_int == (w0 << bits_in_last_word) | w1.
    bits_last = spec.last_word_chars * spec.bits_per_char
    ints = (kw[:, 0].astype(np.uint64) << np.uint64(bits_last)) \
        | kw[:, 1].astype(np.uint64)
    # sanity: vectorized conversion must agree with spec.to_int
    for i in range(0, min(50, ints.shape[0])):
        assert int(ints[i]) == spec.to_int(kw[i])
    order = np.argsort(ints, kind="stable")
    return ints[order], cn[order]


def test_chunked_ingestion_large_corpus():
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=N_BASES).astype(np.uint8)
    # plant a heavy repeat: one 21-mer stamped every ~10k bases
    motif = rng.integers(0, 4, size=K).astype(np.uint8)
    for s in range(0, N_BASES - K, 9973):
        codes[s:s + K] = motif
    batch = _batch_from_codes(codes)

    # capacity sized to force at least one growth retry mid-stream
    idx = CountIndex(KmerSpec(K, DNA), mesh=make_mesh(8),
                     initial_capacity=1 << 20)
    idx.insert_batch(batch)

    vals = _pack_ints(codes)
    uniq, counts = np.unique(vals, return_counts=True)

    assert idx.size() == uniq.shape[0]
    got_keys, got_counts = _stored_ints(idx)
    np.testing.assert_array_equal(got_keys, uniq)
    np.testing.assert_array_equal(got_counts, counts)

    # the planted repeat is the heaviest key and matches exactly
    motif_int = 0
    for b in motif:
        motif_int = (motif_int << 2) | int(b)
    rc_int = 0
    for b in (3 - motif)[::-1]:
        rc_int = (rc_int << 2) | int(b)
    canon_int = min(motif_int, rc_int)
    pos = np.searchsorted(uniq, canon_int)
    assert counts[pos] == counts.max() > 1000
    assert got_counts[np.searchsorted(got_keys, canon_int)] == counts[pos]

"""Record→tuple extraction pipelines: ReadBatch → device k-mer tensors.

Vectorized counterpart of the reference's kmer parsers
(/root/reference/src/io/kmer_parser.hpp): where the reference builds a lazy
iterator chain per record (NonEOL filter → ASCII2 transform →
KmerGenerationIterator [→ zip with id / quality iterators]), we run one
vectorized extraction over the whole base tensor and mask invalid windows.

Flavors (kmer_parser.hpp):
* kmers only            — KmerParser (:86)
* (kmer, position id)   — KmerPositionTupleParser (:304)
* (kmer, pos, quality)  — KmerPositionQualityTupleParser (:578)
* (kmer, count=1)       — KmerCountTupleParser (:910); counts are implicit
  here (each valid window contributes 1).

Canonicalization on ingest (``lex_less`` InputTransform of the Canonical map
presets, kmer_index.hpp:436-562) is fused into extraction.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..kmer import KmerSpec
from ..ops import packing
from ..quality import ILLUMINA18, QualityCodec, window_quality
from .batch import ReadBatch

__all__ = ["DeviceBases", "KmerTuples", "batch_to_arrays", "extract_tuples"]


@dataclasses.dataclass
class DeviceBases:
    """Per-base device tensors (one shard). All shapes [n]."""

    codes: jax.Array      # uint8
    valid: jax.Array      # bool
    owned: jax.Array      # bool
    seg_id: jax.Array     # int32
    id_hi: jax.Array      # uint32 — high word of the 64-bit position id
    id_lo: jax.Array      # uint32
    qual: jax.Array       # uint8 phred byte


jax.tree_util.register_dataclass(
    DeviceBases,
    data_fields=["codes", "valid", "owned", "seg_id", "id_hi", "id_lo", "qual"],
    meta_fields=[],
)


@dataclasses.dataclass
class KmerTuples:
    """Extracted k-mer tuples (one shard).  Rows align with window starts."""

    words: jax.Array    # uint32[n, nwords]
    valid: jax.Array    # bool[n] — real, owned windows
    id_hi: jax.Array    # uint32[n] position id of the window's first base
    id_lo: jax.Array    # uint32[n]
    qual: jax.Array     # float32[n] windowed quality score (0 if unused)
    strand: jax.Array   # uint32[n] — 1 when the stored word is the reverse
                        # complement of the input window (canonical modes;
                        # 0 otherwise).  Consumed by the Bimolecule preset.


jax.tree_util.register_dataclass(
    KmerTuples,
    data_fields=["words", "valid", "id_hi", "id_lo", "qual", "strand"],
    meta_fields=[],
)


def batch_to_arrays(batch: ReadBatch, id_kind: str | None = None) -> DeviceBases:
    """Host ReadBatch → DeviceBases (numpy→jnp; ids precomputed host-side)."""
    if id_kind is None:
        ids = np.zeros(batch.num_bases, dtype=np.uint64)
    else:
        ids = batch.ids(id_kind)
    return DeviceBases(
        codes=jnp.asarray(batch.codes),
        valid=jnp.asarray(batch.valid),
        owned=jnp.asarray(batch.owned),
        seg_id=jnp.asarray(batch.seg_id),
        id_hi=jnp.asarray((ids >> np.uint64(32)).astype(np.uint32)),
        id_lo=jnp.asarray(ids.astype(np.uint32)),
        qual=jnp.asarray(batch.qual),
    )


@functools.partial(jax.jit,
                   static_argnames=("spec", "canonical", "with_quality",
                                    "codec"))
def extract_tuples(bases: DeviceBases, spec: KmerSpec, canonical: bool = True,
                   with_quality: bool = False,
                   codec: QualityCodec = ILLUMINA18) -> KmerTuples:
    """All k-mer tuples of one shard.

    Hot path: fused window-pack + revcomp + canonicalize + validity mask —
    replaces hot loops 1-2 of the reference build stack (SURVEY §3.1).
    With `with_quality`, the windowed phred score is computed alongside
    (KmerPositionQualityTupleParser, kmer_parser.hpp:578+).

    canonical also accepts a transform NAME — the full MapParams
    InputTransform matrix (kmer_transform.hpp:90-145): "single" (False),
    "lex_less" (True, the Canonical preset), "lex_greater" (max of the two
    strands), "xor_rev_comp" (strand-neutral XOR key; keys are stored in
    transformed form, as the reference's InputTransform does).
    """
    transform = {False: "single", True: "lex_less"}.get(canonical, canonical)
    if transform == "lex_less":
        words, was_rc = packing.extract_canonical(bases.codes, spec)
        strand = was_rc.astype(jnp.uint32)
    elif transform == "lex_greater":
        words, was_rc = packing.extract_canonical_greater(bases.codes, spec)
        strand = was_rc.astype(jnp.uint32)
    elif transform == "xor_rev_comp":
        words = packing.extract_xor_rev_comp(bases.codes, spec)
        strand = jnp.zeros(bases.codes.shape[0], jnp.uint32)
    elif transform == "single":
        words = packing.extract_kmers(bases.codes, spec)
        strand = jnp.zeros(bases.codes.shape[0], jnp.uint32)
    else:
        raise ValueError(f"unknown transform {transform!r}")
    wvalid = packing.window_valid(bases.valid, bases.seg_id, spec.k) & bases.owned
    if with_quality:
        qual = window_quality(bases.qual, spec.k, codec)
    else:
        qual = jnp.zeros(bases.codes.shape[0], jnp.float32)
    return KmerTuples(
        words=words,
        valid=wvalid,
        id_hi=bases.id_hi,
        id_lo=bases.id_lo,
        qual=qual,
        strand=strand,
    )

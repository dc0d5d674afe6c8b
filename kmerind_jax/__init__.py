"""kmerind_jax — a distributed k-mer indexing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ParBLiSS/kmerind (header-only C++11 + MPI): building and querying
distributed k-mer indices (count, position, position+quality) from
FASTQ/FASTA files, plus a de Bruijn graph application.

Layering (mirrors SURVEY.md §7):

* ``alphabets`` / ``kmer`` / ``ops``  — k-mer data model & vectorized kernels
  (replaces src/common + src/utils/bitgroup_ops).
* ``io``        — host-side FASTQ/FASTA parsing into device tensors
  (replaces src/io file/parser stack).
* ``parallel``  — mesh + all_to_all distribute/undistribute
  (replaces mxx/imxx MPI collectives).
* ``index``     — sharded sorted-array containers + top-level Index API
  (replaces src/containers + src/index).
* ``debruijn``  — de Bruijn graph engine on top of the index.
* ``utils``     — phase timers, memory marks, logging, config.
"""

from . import alphabets
from .alphabets import ASCII, DNA, DNA5, DNA6, DNA16, DNA_IUPAC, RNA, RNA5, RNA6
from .config import IndexConfig
from .kmer import KmerSpec
from .utils import compile_cache as _compile_cache

# compile-once-per-config economics (the reference pre-compiles its type
# matrix offline)
_compile_cache.enable()

__version__ = "0.1.0"

__all__ = [
    "alphabets",
    "KmerSpec",
    "IndexConfig",
    "DNA",
    "DNA5",
    "DNA6",
    "DNA16",
    "DNA_IUPAC",
    "RNA",
    "RNA5",
    "RNA6",
    "ASCII",
]

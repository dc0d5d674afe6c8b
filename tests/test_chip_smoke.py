"""chip_smoke.py's helpers on the CPU, and its phases rehearsed at small
sizes on the virtual CPU mesh (the script itself refuses to run off-GPU).
"""

import pathlib
import sys

import jax
import numpy as np
import oracle
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.bench import synth
from kmerind_jax.index.api import CountIndex
from kmerind_jax.parallel.mesh import make_mesh
from kmerind_jax.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_require_gpu_raises_off_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([])


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/xla"}, "/elsewhere/xla"),
    ({}, str(ROOT / ".jax_cache")),
])
def test_compile_cache_dir_choice(env, want):
    assert compile_cache.cache_dir(env) == want


def test_numpy_reference_matches_oracle_and_count_index(tmp_path):
    """synth.count_canonical equals tests/oracle.py and a CountIndex built
    from the FASTQ that synth writes."""
    rng = np.random.default_rng(3)
    genome = synth.make_genome(rng, 2000, n_families=2,
                               repeat_len=(100, 300))
    reads, quals = synth.sample_reads(rng, genome, 60, 50, 0.02)
    uniq, counts = synth.count_canonical(reads, 21)
    seqs = [synth.ACGT[r].tobytes().decode() for r in reads]
    assert dict(zip(uniq.tolist(), counts.tolist())) == \
        dict(oracle.count_index(seqs, 21, DNA))
    path = tmp_path / "reads.fastq"
    synth.write_fastq(path, reads, quals)
    idx = CountIndex(KmerSpec(21, DNA), mesh=make_mesh(1)).build(str(path))
    assert idx.to_dict() == dict(zip(uniq.tolist(), counts.tolist()))


def test_numpy_reference_word_helpers():
    spec = KmerSpec(21, DNA)
    rng = np.random.default_rng(4)
    v = rng.integers(0, 1 << 42, 100, dtype=np.uint64)
    np.testing.assert_array_equal(spec.to_ints(synth.u64_to_words(v, 21)),
                                  v)
    assert [int(x) for x in synth.revcomp_u64(v, 21)] == \
        [oracle.revcomp_int(int(x), 21, DNA) for x in v]


def test_layers_rehearsal():
    chip_smoke.phase_layers(np.random.default_rng(0), n=1 << 13,
                            n_oracle=200)


@pytest.mark.parametrize("cards", [1, 4])
def test_count_rehearsal(cards):
    """The count phase at 20 kbp x 5: build, size, histogram, queries,
    erase_if and, on four devices, the shard placement and balance."""
    chip_smoke.phase_count(make_mesh(cards), np.random.default_rng(cards),
                           genome_mbp=0.02, coverage=5)


def test_families_rehearsal():
    chip_smoke.phase_families(make_mesh(1), np.random.default_rng(1),
                              genome_bases=5000, n_reads=200, n_reads63=30)

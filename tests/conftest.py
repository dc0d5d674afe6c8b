"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's test strategy of exercising all collective paths
with mpirun -np 1..4 on one box (/root/reference/CMakeLists.txt:851-910):
correctness must hold for any device count, and 8 virtual CPU devices
exercise every sharded path without GPUs.  Tests that need a GPU carry
the `gpu` marker and skip here.
"""

import os

# Force the CPU backend before JAX initializes, and keep the config in
# step with the variable for code that reads either.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DATA = pathlib.Path("/root/reference/test/data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs on an NVIDIA GPU (in a child process; skips when JAX "
        "finds none)")


@pytest.fixture(scope="session")
def ref_data_dir():
    if not REFERENCE_DATA.is_dir():
        pytest.skip("reference test data not available")
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def seeded_corpus(tmp_path_factory):
    """Seeded in-repo inputs: a short-read FASTQ (150 reads x 60 bp at
    ~3x over a 3 kbp genome with repeats, 1% errors: k-mer counts from 1
    to well above 3) and a 300 kbp three-record FASTA."""
    from kmerind_jax.bench import synth

    rng = np.random.default_rng(2024)
    d = tmp_path_factory.mktemp("corpus")
    genome = synth.make_genome(rng, 3000, n_families=2,
                               repeat_len=(100, 300))
    reads, quals = synth.sample_reads(rng, genome, 150, 60, 0.01)
    synth.write_fastq(d / "reads.fastq", reads, quals)
    big = synth.make_genome(rng, 300_000)
    seqs = [big[:120_000], big[120_000:250_000], big[250_000:]]
    synth.write_fasta(d / "genome.fasta", seqs)
    return types.SimpleNamespace(
        fastq=str(d / "reads.fastq"), reads=reads,
        seqs=[synth.ACGT[r].tobytes().decode() for r in reads],
        fasta=str(d / "genome.fasta"), fasta_codes=seqs)

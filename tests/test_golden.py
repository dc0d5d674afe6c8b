"""Bit-exact parity against the pinned golden index dumps
(tests/golden/*.json.gz, generated by tests/make_golden.py).

These stand in for diffing against the actual kmerind binaries, which
cannot be built in this sandbox (PARITY.md documents why: empty mxx /
sparsehash-c11 / gtest submodules, no MPI toolchain, no network).  Every
golden file is the oracle's dump for a (fixture, k, flavor) config from
BASELINE.md's matrix; the framework indexes must reproduce them exactly,
on both distribution strategies."""

import gzip
import json
import pathlib

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.api import CountIndex, PositionIndex
from kmerind_jax.index.sorted_api import SortedCountIndex
from kmerind_jax.parallel.mesh import make_mesh

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _load(fn):
    with gzip.open(GOLDEN / fn, "rt") as f:
        return json.load(f)


def _manifest():
    return json.load(open(GOLDEN / "MANIFEST.json"))


@pytest.mark.parametrize("fn", sorted(
    fn for fn, meta in _manifest().items() if meta["kind"] == "count"))
def test_count_matches_golden(ref_data_dir, fn):
    meta = _manifest()[fn]
    spec = KmerSpec(meta["k"], DNA)
    idx = CountIndex(spec, mesh=make_mesh(8), canonical=meta["canonical"])
    idx.build(ref_data_dir / meta["fixture"])
    want = {int(k): v for k, v in _load(fn).items()}
    assert idx.to_dict() == want, fn
    assert idx.size() == meta["distinct"]


@pytest.mark.parametrize("fn", sorted(
    fn for fn, meta in _manifest().items() if meta["kind"] == "position"))
def test_position_matches_golden(ref_data_dir, fn):
    meta = _manifest()[fn]
    spec = KmerSpec(meta["k"], DNA)
    idx = PositionIndex(spec, mesh=make_mesh(8), id_kind="short")
    idx.build(ref_data_dir / meta["fixture"])
    want = {int(k): v for k, v in _load(fn).items()}
    assert idx.to_dict() == want, fn


def test_sorted_strategy_matches_golden(ref_data_dir):
    """The range-partitioned strategy must hit the same golden dump."""
    fn = "count_test.unitiq1.fastq_k21_canon.json.gz"
    meta = _manifest()[fn]
    spec = KmerSpec(meta["k"], DNA)
    idx = SortedCountIndex(spec, mesh=make_mesh(8))
    idx.build(ref_data_dir / meta["fixture"])
    want = {int(k): v for k, v in _load(fn).items()}
    assert idx.to_dict() == want

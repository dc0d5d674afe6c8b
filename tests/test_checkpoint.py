"""Sharded (Orbax) checkpoint/resume — utils/checkpoint.py.

The npz save/load (tested per-index elsewhere) gathers to one host; this
is the scalable path: the store pytree streams out shard-by-shard and
restores directly into the live mesh's shardings.  The reference has no
checkpointing (SURVEY §5) — this is new capability, pinned here across
every index family.
"""

import pathlib

import pytest

from kmerind_jax.config import IndexConfig
from kmerind_jax.utils.checkpoint import load_index, save_index

CONFIGS = [
    dict(index="count"),
    dict(index="count", strands="single"),
    dict(index="count", strands="bimolecule"),
    dict(index="position"),
    dict(index="posqual"),
    dict(index="count", distribution="range"),
    dict(index="position", distribution="range"),
    dict(index="debruijn"),
]


@pytest.mark.parametrize("kwargs", CONFIGS,
                         ids=[("-".join(f"{v}" for v in c.values()))
                              for c in CONFIGS])
def test_roundtrip(kwargs, ref_data_dir, tmp_path):
    cfg = IndexConfig(k=21, alphabet="DNA", **kwargs)
    idx = cfg.make_index()
    idx.build(str(ref_data_dir / "test.small.fastq"))
    ref = idx.to_dict()
    assert ref
    save_index(idx, tmp_path / "ck")
    idx2 = load_index(tmp_path / "ck")
    assert idx2.to_dict() == ref
    # the restored index keeps working: grow past saved capacity
    if kwargs.get("index") == "count" and "strands" not in kwargs:
        idx2.insert(["A" * 21] * 3)
        assert idx2.count(["A" * 21])[0] == ref.get(0, 0) + 3


def test_mesh_mismatch_rejected(ref_data_dir, tmp_path):
    import jax
    from jax.sharding import Mesh

    idx = IndexConfig(k=21, alphabet="DNA").make_index()
    idx.build(str(ref_data_dir / "test.small.fastq"))
    save_index(idx, tmp_path / "ck")
    small = Mesh(jax.devices()[:4], ("shards",))
    with pytest.raises(ValueError, match="shards"):
        load_index(tmp_path / "ck", mesh=small)


def test_meta_is_json(ref_data_dir, tmp_path):
    import json
    idx = IndexConfig(k=21, alphabet="DNA").make_index()
    idx.build(str(ref_data_dir / "test.small.fastq"))
    save_index(idx, tmp_path / "ck")
    meta = json.loads(
        (pathlib.Path(tmp_path) / "ck" / "kmerind_meta.json").read_text())
    assert meta["config"]["k"] == 21
    assert meta["nparts"] == idx.nparts

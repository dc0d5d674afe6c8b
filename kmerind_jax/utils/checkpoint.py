"""Sharded (Orbax) checkpoint/resume for distributed indexes.

The `.save(path)` / `.load(path)` npz methods on every index gather the
whole store to one host — portable across mesh sizes (entries re-insert
through the distributed path) but bounded by one host's memory.  This
module adds the scalable variant: `save_index` writes the sharded store
pytree with Orbax (each host/device shard streams out without a global
gather — OCDBT format), plus a JSON config; `load_index` rebuilds the
index from the config and restores the store in place with the live
mesh's shardings.

Contract: the restoring mesh must have the same shard count as the saving
mesh (the store's leading [p] axis).  Cross-topology restores go through
the npz path, which re-inserts and therefore re-shards.  The reference has
no checkpointing at all (SURVEY §5: index lives in memory only); this is
the standard JAX/Orbax equivalent of what a production deployment needs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import numpy as np

__all__ = ["save_index", "load_index"]

_META = "kmerind_meta.json"
_STORE = "store"


def _orbax():
    """orbax.checkpoint, imported on use: it is an optional dependency,
    and the npz `.save()` / `.load()` methods need nothing beyond numpy."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "sharded checkpoints need orbax-checkpoint; without it, use the "
            "index's npz .save(path) / .load(path) instead") from e
    return ocp


def _value_types():
    from ..index.value_api import KmerValueIndex, SortedKmerValueIndex
    return KmerValueIndex, SortedKmerValueIndex


def _config_of(idx) -> dict:
    """IndexConfig-compatible kwargs reconstructing `idx` empty."""
    from ..config import IndexConfig
    from ..debruijn import DeBruijnGraph
    from ..index import api as hx
    from ..index import sorted_api as sx

    cfg: dict = {"k": idx.spec.k, "alphabet": idx.spec.alphabet.name}
    if isinstance(idx, hx.BimoleculeCountIndex):
        cfg.update(index="count", strands="bimolecule",
                   hash_name=idx.hash_name,
                   saturate=idx.saturate if idx.saturate is not None else 0)
    elif isinstance(idx, hx.CountIndex):
        cfg.update(index="count", canonical=idx.canonical,
                   hash_name=idx.hash_name,
                   saturate=idx.saturate if idx.saturate is not None else 0)
    elif isinstance(idx, hx.PositionQualityIndex):
        cfg.update(index="posqual", canonical=idx.canonical,
                   hash_name=idx.hash_name, id_kind=idx.id_kind,
                   quality_codec=idx.codec.name)
    elif isinstance(idx, hx.PositionIndex):
        cfg.update(index="position", canonical=idx.canonical,
                   hash_name=idx.hash_name, id_kind=idx.id_kind)
    elif isinstance(idx, _value_types()[0]):
        cfg.update(index="value", canonical=idx.canonical,
                   hash_name=idx.hash_name, reduce=idx.reduce,
                   id_kind=idx.id_kind)
    elif isinstance(idx, _value_types()[1]):
        cfg.update(index="value", distribution="range",
                   canonical=idx.canonical, reduce=idx.reduce,
                   id_kind=idx.id_kind)
    elif isinstance(idx, sx.SortedCountIndex):
        cfg.update(index="count", distribution="range",
                   canonical=idx.canonical,
                   saturate=idx.saturate if idx.saturate is not None else 0)
    elif isinstance(idx, sx.SortedPositionQualityIndex):
        cfg.update(index="posqual", distribution="range",
                   canonical=idx.canonical, id_kind=idx.id_kind,
                   quality_codec=idx.codec.name)
    elif isinstance(idx, sx.SortedPositionIndex):
        cfg.update(index="position", distribution="range",
                   canonical=idx.canonical, id_kind=idx.id_kind)
    elif isinstance(idx, DeBruijnGraph):
        cfg.update(index="debruijn", canonical=idx.canonical,
                   hash_name=idx.hash_name)
    else:
        raise TypeError(f"unsupported index type {type(idx).__name__}")
    # normalize saturate=0 -> None on load (IndexConfig uses None)
    valid = {f.name for f in dataclasses.fields(IndexConfig)}
    assert set(cfg) <= valid, sorted(set(cfg) - valid)
    return cfg


def save_index(idx, path) -> None:
    """Write a sharded checkpoint of `idx` under directory `path`.

    No host gather: each store shard streams to disk via Orbax/OCDBT,
    so indexes larger than one host's memory checkpoint fine (and under
    multi-process JAX every process writes only its own shards).
    """
    ocp = _orbax()
    if hasattr(idx, "_checkpoint_prepare"):
        # indexes with variable store structure (the LSM run list)
        # consolidate to the fresh-index structure first
        idx._checkpoint_prepare()
    elif hasattr(idx, "_flush"):
        idx._flush()
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "config": _config_of(idx),
        "nparts": idx.nparts,
        # 2: run-store keys are column-major [p, w, cap] (format-1
        # checkpoints stored [p, cap, w] and cannot restore silently)
        "format": 2,
    }
    # the store is saved as a flat LIST of leaves: restore then targets
    # the live (possibly different-capacity) index's treedef without
    # depending on how Orbax serializes registered-dataclass nodes
    leaves = jax.tree_util.tree_leaves(idx.store)
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ckptr:
        ckptr.save(path / _STORE, {"leaves": leaves}, force=True)
    # metadata written after the store so a complete meta implies a
    # complete checkpoint
    (path / _META).write_text(json.dumps(meta))


def load_index(path, mesh=None):
    """Rebuild an index from `save_index` output.

    The live mesh must provide the same shard count the checkpoint was
    written with; the store restores directly into the index's shardings
    (no host-side round trip).
    """
    ocp = _orbax()
    from ..config import IndexConfig
    from ..parallel.mesh import make_mesh

    path = pathlib.Path(path).absolute()
    meta = json.loads((path / _META).read_text())
    if meta.get("format", 1) != 2:
        raise ValueError(
            f"checkpoint format {meta.get('format', 1)} predates the "
            "column-major run-store layout; rebuild or convert via the "
            "npz save/load path")
    cfgd = dict(meta["config"])
    if cfgd.get("saturate", 0) == 0:
        cfgd.pop("saturate", None)
    idx = IndexConfig(**cfgd).make_index(mesh=mesh if mesh is not None
                                         else make_mesh())
    if idx.nparts != meta["nparts"]:
        raise ValueError(
            f"checkpoint has {meta['nparts']} shards but the mesh provides "
            f"{idx.nparts}; use the npz save/load for cross-topology "
            "restores (it re-inserts and re-shards)")
    # abstract restore targets: SAVED shapes/dtypes (capacity may differ
    # from the fresh index's), live mesh shardings (leading [p] axis)
    live_leaves, treedef = jax.tree_util.tree_flatten(idx.store)
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ckptr:
        md = ckptr.metadata(path / _STORE)
    md_tree = md.item_metadata if hasattr(md, "item_metadata") else md
    saved = jax.tree_util.tree_leaves(md_tree)
    if len(saved) != len(live_leaves):
        raise ValueError(
            f"checkpoint has {len(saved)} store leaves, index has "
            f"{len(live_leaves)} — incompatible versions")
    abstract = {"leaves": [
        jax.ShapeDtypeStruct(tuple(s.shape), live.dtype,
                             sharding=live.sharding)
        for s, live in zip(saved, live_leaves)]}
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ckptr:
        restored = ckptr.restore(path / _STORE, abstract)
    idx.store = jax.tree_util.tree_unflatten(treedef, restored["leaves"])
    return idx

"""Device mesh helpers.

The reference's process model is a flat MPI communicator (``mxx::comm``);
ours is a `jax.sharding.Mesh`.  The default single-axis mesh ("shards") is
the analog of COMM_WORLD; a 2-level (host × GPU) mesh maps the reference's
two-level hashing design (kmer_hash.hpp:24-54: hash prefix → process) onto
an across-hosts axis and a within-host axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "make_mesh_2d", "axes_of", "shard_axis_sharding",
           "SHARD_AXIS", "DCN_AXIS", "ICI_AXIS"]

SHARD_AXIS = "shards"
DCN_AXIS = "dcn"    # across hosts (the data-center network)
ICI_AXIS = "ici"    # the GPUs of one host (joined all to all by NVLink)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (SHARD_AXIS,))


def make_mesh_2d(n_hosts: int | None = None, devices=None) -> Mesh:
    """2-D (hosts × GPUs per host) mesh — the reference's two-level
    hashing layout (kmer_hash.hpp:24-54: hash prefix → process, suffix →
    local bucket) mapped onto an across-hosts axis and a within-host axis.

    Every index step shards its leading axis over BOTH axes (host-major
    device order), so k-mer ownership = (host, GPU): the cards of one
    host are joined all to all by NVLink, and only the across-hosts
    portion of the bucket exchange leaves the host.  `n_hosts` defaults to
    `jax.process_count()`; on a single host it builds (1, n_devices) —
    semantically identical to the 1-D mesh (tested equal).
    """
    if devices is None:
        devices = jax.devices()
    if n_hosts is None:
        n_hosts = jax.process_count()
    n = len(devices)
    if n % n_hosts:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    return Mesh(np.array(devices).reshape(n_hosts, n // n_hosts),
                (DCN_AXIS, ICI_AXIS))


def axes_of(mesh: Mesh):
    """The axis-name spec that shards an array's leading dim over the
    WHOLE mesh: the bare name for 1-D meshes, the name tuple for the 2-D
    (dcn, ici) mesh.  Valid anywhere an axis name is accepted
    (PartitionSpec entries, collective axis_name arguments)."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else tuple(names)


def shard_axis_sharding(mesh: Mesh, *rest_axes) -> NamedSharding:
    """Sharding that splits axis 0 across the shard axis."""
    return NamedSharding(mesh, P(SHARD_AXIS, *rest_axes))

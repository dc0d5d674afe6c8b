"""Owner-routed data exchange: the framework's core collective.

Collective-based replacement for the reference's ``imxx`` incremental-MPI layer
(/root/reference/src/io/incremental_mxx.hpp): where the reference buckets
tuples per destination rank, permutes them into rank order and calls
``mxx::all2allv`` (imxx::distribute, :1040-1109), we bucket-sort on device
and exchange fixed-capacity bucket tensors with ``jax.lax.all_to_all`` over
the mesh axis — the ragged alltoallv becomes a dense [p, C, ...] exchange
with a per-bucket validity count (capacity + overflow-check-and-retry
handles raggedness under static shapes).

The i2o routing contract of the reference (each input element's destination
slot is returned so query replies can be routed back and un-permuted,
imxx::distribute i2o / undistribute :1040-1223) is kept: `distribute`
returns a `Route` whose (owner, slot) pair addresses every input element's
position in the exchanged tensor; `undistribute` uses it to return
per-element replies to the original order.

All functions are written to run inside `shard_map` with a named mesh axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["Route", "bucket_by_owner", "distribute", "undistribute"]


@dataclasses.dataclass
class Route:
    """Routing info for one shard's input elements (shape [n] each)."""

    owner: jax.Array      # int32 — destination shard of element i
    slot: jax.Array       # int32 — position within its destination bucket
    valid: jax.Array      # bool — element participated
    overflow: jax.Array   # int32 scalar — max bucket excess over capacity


jax.tree_util.register_dataclass(
    Route, data_fields=["owner", "slot", "valid", "overflow"], meta_fields=[])


def bucket_by_owner(owner: jax.Array, valid: jax.Array, nparts: int, capacity: int):
    """Assign each element a (bucket, slot) position.

    The local-kernel half of imxx::distribute (assign_to_buckets +
    bucket_to_permutation, incremental_mxx.hpp:273-470) — computed with a
    stable sort over owners instead of counting buckets serially.

    Returns (slot[n] int32, counts[nparts] int32, overflow scalar).
    Elements beyond `capacity` in their bucket get slot >= capacity
    (dropped by the scatter; overflow reports how many).
    """
    n = owner.shape[0]
    key = jnp.where(valid, owner, nparts)  # invalid sorts last
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    # position within run of equal keys
    idx = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.where(
        jnp.concatenate([jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]]),
        idx, 0)
    # lax.cummax primitive, not associative_scan (trace-level unrolling
    # makes 16M-row compiles pathologically slow)
    run_start = jax.lax.cummax(run_start, axis=0)
    slot_sorted = idx - run_start
    # scatter back to original order
    slot = jnp.zeros(n, jnp.int32).at[order].set(slot_sorted)
    counts = jnp.bincount(
        jnp.where(valid, owner, 0), weights=valid.astype(jnp.int32),
        length=nparts).astype(jnp.int32)
    overflow = jnp.maximum(jnp.max(counts) - capacity, 0)
    return slot, counts, overflow


def _scatter_to_buckets(x: jax.Array, owner, slot, valid, nparts, capacity, fill=0):
    """[n, ...] -> [nparts, capacity, ...] dense bucket tensor."""
    dest = jnp.where(valid & (slot < capacity), owner * capacity + slot,
                     nparts * capacity)
    buf_shape = (nparts * capacity + 1,) + x.shape[1:]
    buf = jnp.full(buf_shape, fill, dtype=x.dtype)
    buf = buf.at[dest].set(x)
    return buf[:-1].reshape((nparts, capacity) + x.shape[1:])


def distribute(arrays, owner, valid, nparts: int, capacity: int, axis_name: str):
    """Ship each element to its owner shard.

    All routed arrays plus the validity flag are packed into ONE
    [p, C, D] uint32 tensor and exchanged with a single all_to_all (the
    reference performs one alltoallv per tuple stream; fusing them halves
    the collective count per step and amortizes ICI latency).

    Args:
      arrays: tuple of [n] or [n, d] arrays (same leading dim) to route
        together.  32-bit dtypes (uint32/int32/float32 via bitcast).
      owner: int32[n] destination shard ids in [0, nparts).
      valid: bool[n].
      nparts: number of shards (static, == axis size).
      capacity: per-destination bucket capacity (static).
      axis_name: mesh axis to exchange over.

    Returns:
      (recv_arrays, recv_valid, route) where each recv array is
      [nparts * capacity, ...] — the concatenation of one capacity-sized
      bucket from every source shard — and recv_valid marks live entries.
    """
    n = owner.shape[0]
    if nparts == 1:
        # single-shard fast path: no bucketing, no collective — the whole
        # batch is already owner-resident (and the driver's single-chip
        # bench goes through here)
        route = Route(owner=jnp.zeros(n, jnp.int32),
                      slot=jnp.arange(n, dtype=jnp.int32),
                      valid=valid,
                      overflow=jnp.zeros((), jnp.int32))
        return tuple(arrays), valid, route

    slot, _, overflow = bucket_by_owner(owner, valid, nparts, capacity)
    live = valid & (slot < capacity)

    # pack [valid, col0, col1, …] into one [n, D] uint32 matrix
    cols = [live.astype(jnp.uint32)]
    layout = []  # (ncols, shape_tail, dtype) per array
    for x in arrays:
        if x.ndim == 1:
            cols.append(_as_u32(x))
            layout.append((1, (), x.dtype))
        else:
            for j in range(x.shape[1]):
                cols.append(_as_u32(x[:, j]))
            layout.append((x.shape[1], (x.shape[1],), x.dtype))
    packed = jnp.stack(cols, axis=1)  # [n, D]

    send = _scatter_to_buckets(packed, owner, slot, live, nparts, capacity)
    recv = jax.lax.all_to_all(
        send, axis_name, split_axis=0, concat_axis=0, tiled=True)
    recv = recv.reshape((nparts * capacity, packed.shape[1]))

    recv_valid = recv[:, 0] != 0
    recv_arrays = []
    c = 1
    for ncols, tail, dtype in layout:
        if tail == ():
            recv_arrays.append(_from_u32(recv[:, c], dtype))
        else:
            recv_arrays.append(jnp.stack(
                [_from_u32(recv[:, c + j], dtype) for j in range(ncols)],
                axis=1))
        c += ncols

    route = Route(owner=owner, slot=slot, valid=live, overflow=overflow)
    return tuple(recv_arrays), recv_valid, route


def _as_u32(x: jax.Array) -> jax.Array:
    if x.dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(x, jnp.uint32)
    if x.dtype in (jnp.int8, jnp.uint8, jnp.int16, jnp.uint16, jnp.bool_):
        return x.astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32) \
        if x.dtype == jnp.int32 else x.astype(jnp.uint32)


def _from_u32(x: jax.Array, dtype) -> jax.Array:
    if dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(x, jnp.float32)
    if dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(x, jnp.int32)
    return x.astype(dtype)


def undistribute(reply_arrays, route: Route, nparts: int, capacity: int,
                 axis_name: str, fill=0):
    """Route per-element replies back to the original requesters.

    `reply_arrays` are [nparts * capacity] or [nparts * capacity, d]
    tensors aligned with the recv layout of `distribute` (reply for
    received element r in row r).  All replies are packed into one
    all_to_all (mirroring `distribute`).  Returns a tuple of [n, ...]
    arrays aligned with the original inputs (imxx::undistribute +
    unpermute, incremental_mxx.hpp:1176-1223).
    """
    if nparts == 1:
        out = []
        for x in reply_arrays:
            if x.ndim == 1:
                out.append(jnp.where(route.valid, x, fill))
            else:
                out.append(jnp.where(route.valid[:, None], x, fill))
        return tuple(out)

    cols = []
    layout = []
    for x in reply_arrays:
        if x.ndim == 1:
            cols.append(_as_u32(x))
            layout.append((1, (), x.dtype))
        else:
            for j in range(x.shape[1]):
                cols.append(_as_u32(x[:, j]))
            layout.append((x.shape[1], (x.shape[1],), x.dtype))
    packed = jnp.stack(cols, axis=1)  # [p*C, D]
    buf = packed.reshape((nparts, capacity, packed.shape[1]))
    back = jax.lax.all_to_all(
        buf, axis_name, split_axis=0, concat_axis=0, tiled=True)
    flat = back.reshape((nparts * capacity, packed.shape[1]))
    idx = jnp.where(route.valid, route.owner * capacity + route.slot, 0)
    vals = flat[idx]  # [n, D]
    out = []
    c = 0
    for ncols, tail, dtype in layout:
        if tail == ():
            v = _from_u32(vals[:, c], dtype)
            out.append(jnp.where(route.valid, v, fill))
        else:
            v = jnp.stack([_from_u32(vals[:, c + j], dtype)
                           for j in range(ncols)], axis=1)
            out.append(jnp.where(route.valid[:, None], v, fill))
        c += ncols
    return tuple(out)

"""Prefix-bucketed binary search vs numpy searchsorted oracles.

The bucketed search (sortops.lower_bound_bucketed / _cols_bucketed) seeds
each query's (lo, hi) from a 2^16-entry top-word bucket table and refines
with a while_loop until EVERY query converges — these tests pin its
correctness under the distributions that break fixed-round schemes:
uniform keys, one giant run (all keys equal), everything crammed into a
single bucket, sentinel-equal keys, and empty stores.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmerind_jax.ops import sortops


def _rows_of(u64s):
    return np.stack([(u64s >> np.uint64(32)).astype(np.uint32),
                     (u64s & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1)


def _mk(case, cap=1 << 14, size=None, m=997, seed=0):
    rng = np.random.default_rng(seed)
    size = cap - 37 if size is None else size
    if case == "uniform":
        live = np.sort(rng.integers(0, 1 << 48, size, dtype=np.uint64))
    elif case == "all_equal":
        live = np.full(size, 0x1234_5678_9ABC, np.uint64)
    elif case == "one_bucket":
        # every key shares the top-16 bits of word 0: the bucket table
        # degenerates and the while_loop must do the full log2 rounds
        live = np.sort((np.uint64(0xABCD) << np.uint64(48))
                       | rng.integers(0, 1 << 30, size, dtype=np.uint64))
    elif case == "sentinel_like":
        live = np.sort(np.concatenate([
            rng.integers(0, 1 << 48, size - 5, dtype=np.uint64),
            np.full(5, (1 << 64) - 1, np.uint64)]))
    elif case == "empty":
        size = 0
        live = np.zeros(0, np.uint64)
    u = np.full(cap, (1 << 64) - 1, np.uint64)
    u[:size] = live
    qs = np.concatenate([
        live[rng.integers(0, max(size, 1), m // 2)] if size else
        np.zeros(0, np.uint64),
        rng.integers(0, 1 << 49, m - (m // 2 if size else 0),
                     dtype=np.uint64)])
    return u, size, qs


@pytest.mark.parametrize("case", ["uniform", "all_equal", "one_bucket",
                                  "sentinel_like", "empty"])
def test_lower_bound_bucketed_rows(case):
    u, size, qs = _mk(case)
    keys = jnp.asarray(_rows_of(u))
    got = np.asarray(jax.jit(sortops.lower_bound_bucketed)(
        keys, jnp.int32(size), jnp.asarray(_rows_of(qs))))
    want = np.searchsorted(u[:size], qs, side="left")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["uniform", "all_equal", "one_bucket",
                                  "sentinel_like"])
def test_lower_bound_cols_bucketed(case):
    # the run-store variant searches ALL cap rows (sentinel tail sorted)
    u, size, qs = _mk(case)
    cap = u.shape[0]
    kcols = jnp.asarray(_rows_of(u).T.copy())
    got = np.asarray(jax.jit(sortops.lower_bound_cols_bucketed)(
        kcols, jnp.int32(cap), jnp.asarray(_rows_of(qs))))
    want = np.searchsorted(u, qs, side="left")
    np.testing.assert_array_equal(got, want)

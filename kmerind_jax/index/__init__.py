"""Distributed containers + top-level index API (replaces src/containers,
src/index).

Two distribution strategies, mirroring the reference's container families:

* hash-partitioned (`api`: CountIndex/PositionIndex/PositionQualityIndex —
  densehash/unordered maps, distributed_densehash_map.hpp)
* range-partitioned (`sorted_api`: SortedCountIndex/SortedPositionIndex/
  SortedPositionQualityIndex — sorted maps, distributed_sorted_map.hpp)

Index classes resolve lazily so `import kmerind_jax.index` (e.g. for
`store` dataclasses in checkpoint tooling) does not initialize the JAX
device backend at import time.
"""

from . import store

_LAZY = {
    "CountIndex": ".api",
    "BimoleculeCountIndex": ".api",
    "PositionIndex": ".api",
    "PositionQualityIndex": ".api",
    "SortedCountIndex": ".sorted_api",
    "SortedPositionIndex": ".sorted_api",
    "SortedPositionQualityIndex": ".sorted_api",
    "KmerValueIndex": ".value_api",
    "SortedKmerValueIndex": ".value_api",
}

__all__ = ["store", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Randomized op-sequence state fuzzing: interleaved insert /
insert_counts / erase / erase_if / count / clear sequences against a
dict oracle, across both distribution strategies, canonical on/off, and
mesh sizes — catches state-transition bugs (grow-after-erase,
clear-then-reuse, pending-vs-flushed interactions) that per-op tests
cannot.  Seeded and bounded so the suite stays fast; the long-running
unseeded sweeps are run out-of-band (round logs record 140+ clean
trials)."""

import numpy as np
import pytest

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index import CountIndex, SortedCountIndex
from kmerind_jax.parallel.mesh import make_mesh


def _canon_int(v: int, k: int, canonical: bool) -> int:
    if not canonical:
        return v
    rc = 0
    x = v
    for _ in range(k):
        rc = (rc << 2) | (3 - (x & 3))
        x >>= 2
    return min(v, rc)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("cls", [CountIndex, SortedCountIndex])
def test_op_sequences_match_oracle(seed, cls):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([5, 9, 16]))
    spec = KmerSpec(k, DNA)
    canonical = bool(rng.integers(0, 2))
    idx = cls(spec, mesh=make_mesh(int(rng.choice([1, 4, 8]))),
              canonical=canonical)
    model: dict = {}
    universe = rng.integers(0, 4 ** k, 400, dtype=np.uint64)

    def words_of(ints):
        return np.stack([spec.pack_codes(np.array(
            [(int(v) >> (2 * (k - 1 - i))) & 3 for i in range(k)],
            np.uint8)) for v in ints])

    for step in range(6):
        op = rng.choice(
            ["insert", "insert_counts", "erase", "count", "erase_if",
             "clear"], p=[0.3, 0.15, 0.2, 0.25, 0.05, 0.05])
        sel = universe[rng.integers(0, 400, int(rng.integers(1, 120)))]
        if op == "insert":
            idx.insert(words_of(sel))
            for v in sel:
                c = _canon_int(int(v), k, canonical)
                model[c] = model.get(c, 0) + 1
        elif op == "insert_counts":
            cts = rng.integers(1, 5, sel.shape[0]).astype(np.int32)
            idx.insert_counts(words_of(sel), cts)
            for v, ci in zip(sel, cts):
                c = _canon_int(int(v), k, canonical)
                model[c] = model.get(c, 0) + int(ci)
        elif op == "erase":
            n = idx.erase(words_of(sel))
            keys = {_canon_int(int(v), k, canonical) for v in sel}
            assert n == len(keys & set(model)), (op, step)
            for v in keys:
                model.pop(v, None)
        elif op == "count":
            got = idx.count(words_of(sel))
            want = [model.get(_canon_int(int(v), k, canonical), 0)
                    for v in sel]
            assert got.tolist() == want, (op, step)
        elif op == "erase_if":
            n = idx.erase_if(lambda w, c: c >= 3)
            dead = [v for v, c in model.items() if c >= 3]
            assert n == len(dead), (op, step)
            for v in dead:
                model.pop(v)
        elif op == "clear":
            idx.clear()
            model = {}
    assert idx.to_dict() == model


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("mcls", ["hash", "range"])
def test_multimap_op_sequences_match_oracle(seed, mcls):
    """Interleaved explicit-pair insert / erase / count / find / filter on
    the multimaps vs a dict-of-lists oracle (216 unseeded trials also ran
    clean out-of-band)."""
    from kmerind_jax.index import PositionIndex, SortedPositionIndex
    cls = PositionIndex if mcls == "hash" else SortedPositionIndex
    rng = np.random.default_rng(seed)
    k = int(rng.choice([5, 9, 16]))
    spec = KmerSpec(k, DNA)
    idx = cls(spec, mesh=make_mesh(int(rng.choice([1, 4, 8]))))
    model: dict = {}
    universe = rng.integers(0, 4 ** k, 200, dtype=np.uint64)

    def words_of(ints):
        return np.stack([spec.pack_codes(np.array(
            [(int(v) >> (2 * (k - 1 - i))) & 3 for i in range(k)],
            np.uint8)) for v in ints])

    next_id = 1
    for step in range(5):
        op = rng.choice(["insert", "erase", "count", "find", "filter"],
                        p=[0.4, 0.2, 0.15, 0.15, 0.1])
        sel = universe[rng.integers(0, 200, int(rng.integers(1, 80)))]
        if op == "insert":
            ids = np.arange(next_id, next_id + sel.shape[0],
                            dtype=np.uint64)
            next_id += sel.shape[0]
            idx.insert(words_of(sel), ids)
            for v, i in zip(sel, ids):
                model.setdefault(int(v), []).append(int(i))
        elif op == "erase":
            n = idx.erase(words_of(sel))
            keys = {int(v) for v in sel}
            assert n == sum(len(model.get(v, [])) for v in keys), (op, step)
            for v in keys:
                model.pop(v, None)
        elif op == "count":
            got = idx.count(words_of(sel))
            assert got.tolist() == [len(model.get(int(v), []))
                                    for v in sel], (op, step)
        elif op == "find":
            ids_out, mask = idx.find(words_of(sel), max_per_query=4)
            for j, v in enumerate(sel):
                assert sorted(ids_out[j][mask[j]].tolist()) == \
                    sorted(model.get(int(v), [])), (op, step, int(v))
        elif op == "filter":
            n = idx.filter(lambda kk, hi, lo, q: (lo & 1) == 0)
            removed = sum(sum(1 for i in vs if i % 2 == 1)
                          for vs in model.values())
            assert n == removed, (op, step)
            model = {v: [i for i in vs if i % 2 == 0]
                     for v, vs in model.items()}
            model = {v: vs for v, vs in model.items() if vs}
    got = {kk: sorted(vv) for kk, vv in idx.to_dict().items()}
    assert got == {kk: sorted(vv) for kk, vv in model.items()}

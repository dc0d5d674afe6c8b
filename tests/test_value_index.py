"""Generic unique-key k-mer -> uint64 value map vs an oracle — the
reference's `KmerIndex = Index<densehash_map<Kmer, T>>` alias family
(/root/reference/src/index/kmer_index.hpp:397-399 over
densehash_map.hpp:1742 and distributed_sorted_map.hpp:1407): first-wins /
min / max insert reductions, full Index surface, both distributions,
contents invariant to shard count."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import DNA, KmerSpec
from kmerind_jax.index.value_api import KmerValueIndex, SortedKmerValueIndex
from kmerind_jax.parallel.mesh import make_mesh

import oracle
from test_io import py_parse_fastq

K = 15
SPEC = KmerSpec(K, DNA)


def _words(ints):
    return np.stack(
        [SPEC.pack_codes([(v >> (2 * i)) & 3
                          for i in range(K - 1, -1, -1)]) for v in ints])


def _oracle_reduce(pairs, reduce):
    out = {}
    for k, v in pairs:
        if k not in out:
            out[k] = v
        elif reduce == "min":
            out[k] = min(out[k], v)
        elif reduce == "max":
            out[k] = max(out[k], v)
        # "first": keep existing
    return out


@pytest.mark.parametrize("cls", [KmerValueIndex, SortedKmerValueIndex])
@pytest.mark.parametrize("reduce", ["first", "min", "max"])
def test_insert_reductions_vs_oracle(cls, reduce):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 20, size=300).tolist()
    vals = rng.integers(0, 1 << 60, size=300, dtype=np.uint64)
    idx = cls(SPEC, canonical=False, reduce=reduce)
    # three insert calls (first-wins must respect call order)
    idx.insert(_words(keys[:100]), vals[:100])
    idx.insert(_words(keys[100:200]), vals[100:200])
    idx.insert(_words(keys[200:]), vals[200:])
    expect = _oracle_reduce(zip(keys, (int(v) for v in vals)), reduce)
    assert idx.to_dict() == expect
    assert idx.size() == len(expect)
    # find in query order, absent keys flagged
    qk = sorted(set(keys))[:50] + [(1 << 30) + 5]  # last key absent
    got_vals, found = idx.find(_words(qk))
    assert not found[-1] and got_vals[-1] == 0
    for i, kk in enumerate(qk[:-1]):
        assert found[i] and int(got_vals[i]) == expect[kk]
    # count == 0/1 membership
    np.testing.assert_array_equal(idx.count(_words(qk)),
                                  [1] * 50 + [0])


@pytest.mark.parametrize("cls", [KmerValueIndex, SortedKmerValueIndex])
def test_erase_and_predicates(cls):
    rng = np.random.default_rng(3)
    keys = list(dict.fromkeys(rng.integers(0, 1 << 20, size=200).tolist()))
    vals = np.arange(len(keys), dtype=np.uint64) * 7
    idx = cls(SPEC, canonical=False)
    idx.insert(_words(keys), vals)
    n = idx.erase(_words(keys[:10]))
    assert n == 10
    assert idx.size() == len(keys) - 10
    _, found = idx.find(_words(keys[:10]))
    assert not found.any()
    # erase_if over values: remove entries with value >= 700 (lo half)
    n2 = idx.erase_if(lambda k, h, l: l >= 700)
    expect = {k: int(v) for k, v in zip(keys[10:], vals[10:]) if v < 700}
    assert idx.to_dict() == expect
    assert n2 == len(keys) - 10 - len(expect)
    # count_if scan
    entries = idx.count_if(lambda k, h, l: l >= 350)
    assert sorted(entries) == sorted(
        (k, v) for k, v in expect.items() if v >= 350)
    # filter keeps the complement
    idx.filter(lambda k, h, l: l < 350)
    assert all(v < 350 for v in idx.to_dict().values())


@pytest.mark.parametrize("cls", [KmerValueIndex, SortedKmerValueIndex])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_file_build_min_position(ref_data_dir, cls, p):
    """build(path) = Index<map, KmerPositionTupleParser>: value = 64-bit
    ShortSequenceKmerId, reduced to the earliest position per k-mer —
    contents invariant to shard count."""
    path = ref_data_dir / "test.small.fastq"
    spec = KmerSpec(21, DNA)
    idx = cls(spec, mesh=make_mesh(p), canonical=False, reduce="min",
              id_kind="short")
    idx.build(str(path))
    k = 21
    recs = py_parse_fastq(path.read_text())
    seqs_ids = []
    for hdr, seq, qual, rstart, sstart in recs:
        ids = [(rstart << 16) | (sstart - rstart + i)
               for i in range(len(seq) - k + 1)]
        seqs_ids.append((seq, ids))
    pos = oracle.position_index(seqs_ids, k, DNA, canonical=False)
    expect = {kk: min(v) for kk, v in pos.items()}
    assert idx.to_dict() == expect, f"p={p}"
    assert idx.size() == len(expect)


@pytest.mark.parametrize("cls", [KmerValueIndex, SortedKmerValueIndex])
def test_save_load_roundtrip(tmp_path, cls):
    rng = np.random.default_rng(5)
    keys = list(dict.fromkeys(rng.integers(0, 1 << 20, size=64).tolist()))
    vals = rng.integers(0, 1 << 50, size=len(keys), dtype=np.uint64)
    idx = cls(SPEC, canonical=False, reduce="min")
    idx.insert(_words(keys), vals)
    f = tmp_path / "kv.npz"
    idx.save(f)
    idx2 = cls.load(f)
    assert idx2.to_dict() == idx.to_dict()


def test_canonical_value_map():
    """Canonical preset: both strands answer the same entry."""
    from kmerind_jax.ops import bitops
    idx = KmerValueIndex(SPEC, canonical=True, reduce="min")
    w = _words([12345])
    rc = np.asarray(bitops.revcomp(jnp.asarray(w), SPEC))
    idx.insert(w, [111])
    vals, found = idx.find(rc)
    assert found[0] and vals[0] == 111


def test_config_makes_value_index():
    from kmerind_jax.config import IndexConfig
    idx = IndexConfig(k=15, index="value", reduce="min").make_index()
    assert isinstance(idx, KmerValueIndex)
    idx2 = IndexConfig(k=15, index="value",
                       distribution="range").make_index()
    assert isinstance(idx2, SortedKmerValueIndex)

"""Top-level k-mer index API.

JAX counterpart of ``bliss::index::kmer::Index``
(/root/reference/src/index/kmer_index.hpp:98-394) and its preset aliases
(:399-411): `CountIndex`, `PositionIndex` (and, later, PositionQualityIndex)
over a device mesh.  The map-parameter presets (kmer_index.hpp:436-562) map
to constructor arguments:

* ``canonical=True``  — Canonical maps: ``lex_less`` canonicalization on
  ingest *and* on queries (InputTransform).
* ``canonical=False`` — SingleStrand maps: k-mers used as-is.
* ``hash_name``       — DistHash preset (murmur / fmix32 / identity).

Host-side responsibilities (this file): sharding inputs onto the mesh,
choosing bucket capacities, checking overflow outputs and retrying with
doubled capacity (replacing the reference's two-pass size estimation,
distributed_densehash_map.hpp:328-420), and growing store capacity.
All device work happens in the jitted steps of `distributed.py`.
"""

from __future__ import annotations

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..kmer import KmerSpec
from ..io.batch import ReadBatch
from ..io.files import (file_size, read_fasta_block, read_fastq_block,
                        read_file, sniff_format)
from ..ops import packing
from ..parallel.mesh import axes_of, make_mesh
from ..utils.timers import PhaseTimer
from . import distributed as dx
from . import store as st

__all__ = ["CountIndex", "BimoleculeCountIndex", "PositionIndex",
           "PositionQualityIndex"]

_SENTINEL = 0xFFFFFFFF


def _next_pow2(n: int) -> int:
    return 1 << max(4, (max(n, 1) - 1).bit_length())


class _IndexBase:
    """Shared mesh/shard bookkeeping for all index flavors."""

    #: default streaming granularity: batches above this many bases are
    #: split into equal padded chunks so compiles and device memory stay
    #: bounded regardless of file size (one executable per chunk shape)
    default_chunk_bases = 1 << 23

    def __init__(self, spec: KmerSpec, mesh=None, canonical: bool = True,
                 hash_name: str = "murmur", fill_factor: float = 1.6,
                 timer: PhaseTimer | None = None):
        self.spec = spec
        self.mesh = mesh if mesh is not None else make_mesh()
        self.nparts = self.mesh.devices.size
        self.canonical = canonical
        self.hash_name = hash_name
        self.fill_factor = fill_factor
        self.timer = timer if timer is not None else PhaseTimer()
        self._sharding = NamedSharding(self.mesh, P(axes_of(self.mesh)))
        self._step_cache: dict = {}

    # -- input marshalling -------------------------------------------------
    def _shard_rows(self, rows: np.ndarray, extra=()):
        """[m, ...] host rows -> ([p, mq, ...] padded arrays, valid, m).

        Multi-process: every process passes the SAME full rows (queries are
        SPMD-replicated host input); each contributes only its own shards'
        slice to the global array."""
        m = rows.shape[0]
        p = self.nparts
        mq = max(1, -(-m // p))
        pad = p * mq - m
        valid = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])
        lo, hi = self._local_shard_range()

        def _pad(a, fill=0):
            if pad == 0:
                return a
            fill_block = np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)
            return np.concatenate([a, fill_block])

        def _put(a):
            stacked = _pad(a).reshape((p, mq) + a.shape[1:])
            return self._put_global(stacked[lo:hi], p)

        out = [_put(rows)]
        for a in extra:
            out.append(_put(a))
        vsh = self._put_global(valid.reshape(p, mq)[lo:hi], p)
        return out, vsh, m

    def _to_words(self, kmers) -> np.ndarray:
        """Accept uint32[m, w] rows, iterable of strings, or big ints."""
        if isinstance(kmers, np.ndarray) and kmers.ndim == 2:
            return kmers.astype(np.uint32)
        if hasattr(kmers, "shape") and getattr(kmers, "ndim", 0) == 2:
            return np.asarray(kmers, dtype=np.uint32)
        rows = []
        for km in kmers:
            if isinstance(km, str):
                rows.append(self.spec.from_string(km))
            elif isinstance(km, (int, np.integer)):
                # big-integer view (spec.to_int inverse) — a bare uint32
                # cast overflows for any k-mer wider than 32 bits
                rows.append(self.spec.from_int(int(km)))
            else:
                rows.append(np.asarray(km, dtype=np.uint32))
        return np.stack(rows).astype(np.uint32)

    @property
    def transform(self) -> str:
        """Input-transform name (kmer_transform.hpp:90-145): `canonical`
        may be a bool (the Canonical/SingleStrand presets) or a transform
        name ("lex_less" / "lex_greater" / "xor_rev_comp")."""
        return {False: "single", True: "lex_less"}.get(
            self.canonical, self.canonical)

    def _maybe_canonicalize_queries(self, words: np.ndarray) -> np.ndarray:
        """Canonical presets transform queries too (transform_input on the
        query path, distributed_map_base.hpp:286-301)."""
        t = self.transform
        if t == "single":
            return words
        from ..ops import bitops
        rc = np.asarray(bitops.revcomp(jnp.asarray(words), self.spec))
        if t == "xor_rev_comp":
            return (words ^ rc).astype(np.uint32)
        less = np.asarray(packing.lex_less(jnp.asarray(rc), jnp.asarray(words)))
        if t == "lex_greater":
            return np.where(less[:, None], words, rc).astype(np.uint32)
        return np.where(less[:, None], rc, words)

    def _zero_col(self, shape, dtype):
        """Cached device-resident zero column: families whose ingest steps
        take (but ignore) id/quality columns reuse ONE transferred zero
        buffer instead of allocating + shipping zeros per chunk."""
        key = ("zero", shape, np.dtype(dtype).str)
        cache = getattr(self, "_zeros_cache", None)
        if cache is None:
            cache = self._zeros_cache = {}
        if key not in cache:
            cache[key] = self._put_global(np.zeros(shape, dtype),
                                          self.nparts)
        return cache[key]

    def _batch_to_stacked(self, batch: ReadBatch, id_kind,
                          halo: int | None = None, halo_left: int = 0,
                          need_ids: bool = True, need_qual: bool = True,
                          real_qual: bool = True):
        """ReadBatch -> per-base stacked arrays [p, L] on the mesh.

        Families declare which columns their ingest step takes: id/qual
        columns are OMITTED when unused (need_ids/need_qual False — the
        count/de Bruijn families), and a step that takes-but-ignores
        quality (real_qual False: PositionIndex without the quality
        variant) gets a cached device-resident zero buffer instead of a
        fresh marshal+transfer.  For count-family builds this removes 12
        of the 18 marshalled+transferred bytes per base.

        Multi-process: `batch` is THIS process's file block
        (`parallel.multihost.host_block_batch`); it is split over the
        process's local shards and the per-shard length is padded to the
        max across processes so the global shape agrees.

        Marshalling writes each needed byte exactly ONCE into pooled
        [shards, L] buffers (2-generation ring — the previous chunk's
        async transfer may still read its buffers).  The old
        shard_with_halo + pad_to + np.stack flow copied every per-base
        column (19 B/base) twice through fresh allocations; measured
        ~310M bases/s vs ~1.5G for the direct fill."""
        p = self.nparts
        if halo is None:
            halo = self.spec.k - 1
        lo_sh, hi_sh = self._local_shard_range()
        n_local_shards = hi_sh - lo_sh
        n = batch.num_bases
        owned = -(-n // n_local_shards)
        pad_to = halo_left + owned + halo
        if self._multiprocess:
            from jax.experimental import multihost_utils
            pad_to = int(multihost_utils.process_allgather(
                np.int64(pad_to)).max())
        # (source column, pad fill) per marshalled output
        srcs = [("codes", batch.codes, 0),
                ("valid", batch.valid, False),
                ("seg_id", batch.seg_id, -1)]
        if need_ids and id_kind is not None:
            ids_full = self._pooled_ids(batch, id_kind)
            if sys.byteorder == "little":
                # zero-copy u64 -> (hi, lo) u32 halves
                v = ids_full.view(np.uint32).reshape(-1, 2)
                srcs.append(("id_hi", v[:, 1], 0))
                srcs.append(("id_lo", v[:, 0], 0))
            else:
                srcs.append(("id_hi", (ids_full >> np.uint64(32))
                             .astype(np.uint32), 0))
                srcs.append(("id_lo", ids_full.astype(np.uint32), 0))
        if need_qual and real_qual:
            srcs.append(("qual", batch.qual, 0))
        bufs = self._marshal_bufs(
            n_local_shards, pad_to,
            tuple((nm, a.dtype) for nm, a, _ in srcs) + (("owned", bool),))
        for s in range(n_local_shards):
            own_start = min(s * owned, n)
            lo = max(0, own_start - halo_left)
            left = own_start - lo
            hi = min(own_start + owned + halo, n)
            ln = hi - lo
            for nm, src, fill in srcs:
                d = bufs[nm][s]
                d[:ln] = src[lo:hi]
                d[ln:] = fill
            ob = bufs["owned"][s]
            ob[:ln] = batch.owned[lo:hi]
            ob[ln:] = False
            ob[:left] = False
            ob[left + owned:] = False
        cols = {nm: self._put_global(bufs[nm], p)
                for nm, _, _ in srcs}
        cols["owned"] = self._put_global(bufs["owned"], p)
        if need_ids and id_kind is None:
            cols["id_hi"] = self._zero_col((n_local_shards, pad_to),
                                           np.uint32)
            cols["id_lo"] = cols["id_hi"]
        if need_qual and not real_qual:
            cols["qual"] = self._zero_col((n_local_shards, pad_to),
                                          np.uint8)
        return cols, owned

    def _pooled_ids(self, batch: ReadBatch, id_kind: str) -> np.ndarray:
        """64-bit position ids over the whole batch, computed into pooled
        buffers with in-place ops — `ReadBatch.ids()` allocates ~7 fresh
        [n] u64 temporaries whose first-touch page faults dominated the
        position-family marshal (measured ~30x the in-place cost)."""
        n = batch.num_bases
        pool = getattr(self, "_ids_pool", None)
        if pool is None:
            pool = self._ids_pool = {}
        bufs = pool.get(n)
        if bufs is None:
            bufs = pool[n] = (np.empty(n, np.uint64), np.empty(n, np.uint64))
        out, tmp = bufs
        if batch.num_records == 0:
            out[:] = 0
            return out
        _POS40 = np.uint64((1 << 40) - 1)
        if id_kind == "short":
            # fid<<56 | (record_start & POS40)<<16 | offset16
            np.take(batch.record_start, batch.seg_id, out=out)
            out &= _POS40
            out <<= np.uint64(16)
            np.copyto(tmp, batch.offset_in_record, casting="unsafe")
            tmp &= np.uint64(0xFFFF)
            out |= tmp
            np.take(batch.file_id.astype(np.uint64), batch.seg_id, out=tmp)
            tmp <<= np.uint64(56)
            out |= tmp
        elif id_kind == "long":
            # fid<<56 | seq_index<<40 | (global_pos & POS40)
            np.copyto(out, batch.global_pos)
            out &= _POS40
            np.take(batch.seq_index.astype(np.uint64), batch.seg_id,
                    out=tmp)
            tmp <<= np.uint64(40)
            out |= tmp
            np.take(batch.file_id.astype(np.uint64), batch.seg_id, out=tmp)
            tmp <<= np.uint64(56)
            out |= tmp
        else:
            raise ValueError(f"unknown id kind {id_kind!r}")
        return out

    def _marshal_bufs(self, nshards: int, pad_to: int, layout: tuple):
        """Pooled marshal buffers: one [nshards, pad_to] array per column,
        alternating between two generations so the previous chunk's
        (possibly still in-flight) device transfer never reads memory the
        current marshal is overwriting.  Reuse avoids the fresh-allocation
        first-touch faults that dominated the old flow."""
        pool = getattr(self, "_marshal_pool", None)
        if pool is None:
            pool = self._marshal_pool = {}
        key = (nshards, pad_to, layout)
        gens = pool.get(key)
        if gens is None:
            gens = pool[key] = [
                {nm: np.empty((nshards, pad_to), dt) for nm, dt in layout}
                for _ in range(2)], [0]
        ring, ctr = gens
        ctr[0] ^= 1
        return ring[ctr[0]]

    def _bucket_capacity(self, n_per_shard: int) -> int:
        """Per-destination exchange bucket for n_per_shard routed rows:
        ~n/p with fill-factor headroom, grown by the overflow retry when a
        destination is hot.  The reference's all2allv ships exact
        per-destination counts (incremental_mxx.hpp:1087-1098); a dense
        exchange approximates with 1/p scaling so the tensor stays ~n, not
        p*n."""
        return _next_pow2(
            int(math.ceil(n_per_shard / self.nparts * self.fill_factor)))

    @property
    def num_shards(self) -> int:
        return self.nparts

    # -- multi-process SPMD helpers ------------------------------------
    # Under jax.distributed (the mpirun analog, SURVEY §4), arrays sharded
    # over the global mesh are not fully addressable from one process:
    # host->device feeding must go through make_array_from_process_local_data
    # and device->host results through an all_gather to a replicated
    # sharding.  Single-process keeps the direct paths.

    @property
    def _multiprocess(self) -> bool:
        return jax.process_count() > 1

    def _fetch(self, garr) -> np.ndarray:
        """Global (possibly non-addressable) array -> full numpy copy on
        every process (collective in multi-process mode)."""
        if not self._multiprocess:
            return np.asarray(garr)
        key = ("_fetch_rep", jax.typeof(garr))
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda x: x,
                out_shardings=NamedSharding(self.mesh, P()))
        return np.asarray(self._step_cache[key](garr))

    def _put_global(self, local_rows: np.ndarray, global_rows: int):
        """Host rows -> [p, ...]-sharded global array.

        Single-process: device_put of the full stack.  Multi-process: each
        process passes only its own shards' rows ([d_local, ...]) and the
        global array is assembled per-process
        (jax.make_array_from_process_local_data — the documented multi-host
        feeding path)."""
        if not self._multiprocess:
            return jax.device_put(local_rows, self._sharding)
        return jax.make_array_from_process_local_data(
            self._sharding, local_rows,
            (global_rows,) + local_rows.shape[1:])

    def _device_concat(self, parts, axis=1):
        """jnp.concatenate under jit (eager ops on non-addressable global
        arrays are not allowed in multi-process mode)."""
        if len(parts) == 1:
            return parts[0]
        key = ("_concat", axis, tuple(jax.typeof(x) for x in parts))
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                functools.partial(
                    lambda axis, *xs: jnp.concatenate(xs, axis=axis), axis))
        return self._step_cache[key](*parts)

    def _local_shard_range(self):
        """Which global shard rows this process owns (contiguous)."""
        if not self._multiprocess:
            return 0, self.nparts
        d_local = self.nparts // jax.process_count()
        h = jax.process_index()
        return h * d_local, (h + 1) * d_local

    def _init_store(self, factory):
        """Per-shard store pytree sharded over the mesh — computed under
        jit with explicit out_shardings (SPMD-safe: a plain device_put of
        host data cannot target non-addressable devices)."""
        fn = jax.jit(
            lambda: jax.vmap(lambda _: factory())(jnp.arange(self.nparts)),
            out_shardings=self._sharding)
        return fn()

    def _valid_counts(self, valid) -> np.ndarray:
        """int32[p] live-row counts of a [p, n] validity tensor."""
        key = ("_vsum", jax.typeof(valid))
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda v: jnp.sum(v.astype(jnp.int32), axis=1))
        return self._fetch(self._step_cache[key](valid))

    def _equalize_chunks(self, chunks: list):
        """SPMD discipline: every process must run the SAME number of jit
        steps.  When hosts' file blocks split into different chunk counts,
        pad the short lists with all-invalid copies of the last chunk (no
        windows are owned, so they contribute nothing)."""
        if not self._multiprocess:
            return chunks
        import dataclasses as _dc

        from jax.experimental import multihost_utils
        gmax = int(multihost_utils.process_allgather(
            np.int64(len(chunks))).max())
        while len(chunks) < gmax:
            t = chunks[-1]
            chunks.append(_dc.replace(
                t, valid=np.zeros_like(t.valid),
                owned=np.zeros_like(t.owned)))
        return chunks

    def _stream_chunks(self, chunks: list, marshal, consume):
        """Double-buffered host→device feeding: marshal chunk i+1 on a
        worker thread while the device runs chunk i.

        The reference overlaps MPI-IO reads with insert via its loader's
        L1/L2 block pipeline (file_loader.hpp two-level partitioning);
        here the host-side work (shard_with_halo, padding, device_put)
        overlaps the jitted ingest step, whose `_fetch(overflow)` sync is
        the bubble being hidden.  Single chunk (or multi-process SPMD,
        where marshalling itself runs collectives and must stay on the
        main thread in program order) degrades to the serial loop."""
        if len(chunks) <= 1 or self._multiprocess:
            for b in chunks:
                consume(marshal(b))
            return
        import concurrent.futures as _cf
        with _cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(marshal, chunks[0])
            for i in range(len(chunks)):
                cols = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(marshal, chunks[i + 1])
                consume(cols)

    # -- container-base collective surface (dsc::map_base,
    # distributed_map_base.hpp:149-302) --------------------------------
    def empty(self) -> bool:
        """True iff no shard holds any entry (dsc::empty allreduce)."""
        return self.size() == 0

    def local_sizes(self) -> list[int]:
        """Per-shard entry counts (load-balance introspection)."""
        if hasattr(self, "_flush"):
            self._flush()
        return [int(x) for x in self._fetch(self.store.size)]

    def clear(self):
        """Drop all entries, keeping capacity (map_base::clear).

        Keys reset to the all-ones sentinel (not zero): the store invariant
        "rows >= size hold sentinel keys" is what `lookup_join` and the
        merge sorts rely on (matching empty_count_store/empty_multi_store).
        """
        if hasattr(self, "_pending"):
            self._pending = []
            self._pending_rows = 0

        def _reset(a):
            if a.dtype == jnp.uint32 and a.ndim >= 3:  # [p, cap, w] key leaf
                return jnp.full_like(a, jnp.uint32(_SENTINEL))
            return jnp.zeros_like(a)

        key = ("_clear", tuple(jax.typeof(l) for l in
                               jax.tree.leaves(self.store)))
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda s: jax.tree.map(_reset, s),
                out_shardings=self._sharding)
        self.store = self._step_cache[key](self.store)
        return self

    def reserve(self, n: int):
        """Pre-grow store capacity to hold ~n entries total
        (map_base::reserve)."""
        per = _next_pow2(-(-n // self.nparts))
        if per > self.capacity:
            self._grow(per)
        return self

    def build(self, path, fmt: str | None = None, file_id: int = 0):
        """Read a FASTQ/FASTA file and insert all its k-mers
        (Index::build_posix/build_mmap, kmer_index.hpp:201-394).

        Files above `stream_threshold_bytes` stream block-by-block
        (`build_stream`) so host memory stays O(block); smaller files are
        parsed whole into zero-copy parser-ring views (reuse=True — the
        batch is fully consumed by insert_batch before this returns).

        Multi-process (`jax.distributed`): collective — every process
        must call build() on the same path.  Each host parses only ITS
        byte block (record-boundary repaired, the partitioned_file
        contract) and the index lands sharded over the global mesh, like
        the reference's build_mpiio over MPI ranks."""
        fmt = fmt or sniff_format(path)
        if (file_size(path) > self.stream_threshold_bytes
                and self._stream_supported(fmt)):
            return self.build_stream(path, fmt, file_id)
        if self._multiprocess:
            from ..parallel.multihost import host_block_batch
            halo, halo_left = self._chunk_halo()
            with self.timer.phase("read"):
                batch = host_block_batch(path, self.parse_alphabet, fmt,
                                         halo=halo, file_id=file_id,
                                         halo_left=halo_left)
        else:
            with self.timer.phase("read"):
                batch = read_file(path, self.parse_alphabet, fmt, file_id,
                                  reuse=True)
        self.insert_batch(batch)
        return self

    @property
    def parse_alphabet(self):
        """Alphabet the build paths parse files with.  Normally the k-mer
        alphabet; DeBruijnGraph overrides with the identity (ASCII)
        alphabet so edge bytes can see the raw characters."""
        return self.spec.alphabet

    def exists(self, kmers) -> np.ndarray:
        """bool[m] membership per query (the plain KmerIndex/exists view,
        kmer_index.hpp:399) — available on every family with count()."""
        return self.count(kmers) > 0

    def build_posix(self, path, fmt: str | None = None, file_id: int = 0):
        """Alias of build (the reference exposes per-reader entry points
        build_posix/build_mmap/build_mpiio, kmer_index.hpp:332-394; one
        memory-mapped reader serves all three roles here)."""
        return self.build(path, fmt, file_id)

    build_mmap = build_posix
    build_mpiio = build_posix

    # -- streaming block build -----------------------------------------
    stream_threshold_bytes = 64 << 20

    def _chunk_halo(self) -> tuple[int, int]:
        """(halo, halo_left) context bases each device chunk needs — the
        k-1 window lookahead (kmer_file_helper.hpp:361); de Bruijn
        overrides with one extra base on each side for edge context."""
        return self.spec.k - 1, 0

    def _stream_supported(self, fmt: str) -> bool:
        # every family/format streams, single- and multi-process alike;
        # subclasses may veto (hook kept for future format restrictions)
        return True

    def build_stream(self, path, fmt: str | None = None, file_id: int = 0,
                     block_bytes: int | None = None):
        """Build by streaming byte blocks of the file through the parser
        ring and the device — O(block) host memory for corpora of any
        size (the reference's read_block loop over a partitioned file,
        kmer_file_helper.hpp:293-331 + file.hpp:1216-1432).  Block i+1 is
        parsed + marshalled on a worker thread while the device ingests
        block i; every chunk shares one static shape, so one compiled
        program serves the whole stream."""
        fmt = fmt or sniff_format(path)
        if not self._stream_supported(fmt):
            raise ValueError("streaming build unsupported for this "
                             "index/format combination; use build()")
        halo, halo_left = self._chunk_halo()
        if block_bytes is None:
            # FASTQ bytes ≈ 2.2x bases (quality + headers); FASTA ≈ 1.01x
            block_bytes = self.default_chunk_bases * (
                2 if fmt == "fastq" else 1)
        # one static chunk shape serves every block; a block never yields
        # more than block_bytes bases, so cap the chunk size accordingly
        chunk_bases = min(self.default_chunk_bases, block_bytes)
        total = file_size(path)
        if self._multiprocess:
            return self._build_stream_spmd(path, fmt, file_id, block_bytes,
                                           chunk_bases, halo, halo_left,
                                           total)
        nblocks = max(1, -(-total // block_bytes))

        def chunks():
            for p in range(nblocks):
                with self.timer.phase("read"):
                    if fmt == "fastq":
                        b = read_fastq_block(path, self.parse_alphabet, p,
                                             nblocks, file_id=file_id,
                                             reuse=True)
                    else:
                        b = read_fasta_block(path, self.parse_alphabet, p,
                                             nblocks, file_id=file_id,
                                             halo=halo, halo_left=halo_left,
                                             reuse=True)
                if b.num_bases == 0:
                    continue
                yield from b.iter_chunks(chunk_bases, halo, halo_left)

        self._stream_chunks_iter(chunks(), self._marshal_chunk,
                                 self._insert_cols)
        return self

    def _build_stream_spmd(self, path, fmt, file_id, block_bytes,
                           chunk_bases, halo, halo_left, total):
        """Streamed build under `jax.distributed`: each host streams ITS
        byte range of the file through the parser ring in sub-blocks, so
        host memory stays O(block) no matter how large the corpus — the
        multi-process analog of `build_stream` (the reference's
        block-partitioned parallel reads, file.hpp:1216-1432, with the
        rank block further subdivided for streaming).

        SPMD discipline: the ingest step and its overflow fetch are
        collectives, so every process must run the SAME number of jit
        steps even though hosts' blocks parse into different chunk counts
        — `_stream_chunks_lockstep` keeps the group in step with one tiny
        allgathered continue-flag per chunk, exhausted hosts feeding
        all-invalid chunks of the shared static shape."""
        from ..parallel.multihost import distributed_fasta_grid_context
        nh = jax.process_count()
        h = jax.process_index()
        # identical on every process (total/block_bytes agree), so the
        # grid — and the collective call pattern — is globally consistent
        bph = max(1, -(-total // (nh * block_bytes)))
        nblocks = nh * bph
        ctxs = (distributed_fasta_grid_context(path, bph)
                if fmt == "fasta" else None)

        def chunks():
            for j in range(bph):
                p = h * bph + j
                with self.timer.phase("read"):
                    if fmt == "fastq":
                        b = read_fastq_block(path, self.parse_alphabet, p,
                                             nblocks, file_id=file_id,
                                             reuse=True)
                    else:
                        b = read_fasta_block(path, self.parse_alphabet, p,
                                             nblocks, file_id=file_id,
                                             halo=halo, halo_left=halo_left,
                                             context=ctxs[j], reuse=True)
                if b.num_bases == 0:
                    continue
                yield from b.iter_chunks(chunk_bases, halo, halo_left)

        self._stream_chunks_lockstep(chunks(), self._marshal_chunk,
                                     self._insert_cols,
                                     chunk_bases, halo, halo_left)
        return self

    def _invalid_chunk(self, chunk_bases, halo, halo_left):
        """All-invalid chunk of the shared static stream shape (no valid
        bases, no owned windows) — what an exhausted host feeds the
        lockstep loop so its jit steps mirror the group's."""
        from ..io.fasta import parse_fasta
        empty = parse_fasta(np.zeros(0, np.uint8), self.parse_alphabet)
        return empty.pad_to(halo_left + chunk_bases + halo)

    def _stream_chunks_lockstep(self, it, marshal, consume,
                                chunk_bases, halo, halo_left):
        """SPMD streaming driver: per chunk, one small allgather decides
        whether ANY process still has data; everyone then runs exactly one
        marshal+consume step (exhausted hosts on an all-invalid chunk) —
        the streaming analog of `_equalize_chunks`.  Serial loop, no
        marshal worker thread: marshalling itself runs collectives
        (`_batch_to_stacked`'s pad_to allgather) that must stay on the
        main thread in program order."""
        from jax.experimental import multihost_utils
        dummy = None
        while True:
            b = next(it, None)
            more = np.asarray(multihost_utils.process_allgather(
                np.int64(0 if b is None else 1)))
            if int(more.max()) == 0:
                return
            if b is None:
                if dummy is None:
                    dummy = self._invalid_chunk(chunk_bases, halo,
                                                halo_left)
                b = dummy
            consume(marshal(b))

    def _stream_chunks_iter(self, it, marshal, consume):
        """Double-buffered streaming over a lazy chunk iterator: a worker
        thread pulls (parses) + marshals the next chunk while the device
        consumes the current one.  Parser ring slots stay live exactly
        for the double-buffer window (io/native.py _RING_SIZE=2): block
        p+1 parses only after block p's last chunk is marshalled, and
        block p's slot is overwritten only by block p+2."""
        import concurrent.futures as _cf

        def produce():
            b = next(it, None)
            return None if b is None else marshal(b)

        with _cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(produce)
            while True:
                cols = fut.result()
                if cols is None:
                    return
                fut = ex.submit(produce)
                consume(cols)

    def build_files(self, paths, fmt: str | None = None):
        """Build from multiple files; file_id is the position in `paths`
        (multi-file corpora, SequenceId file_id field).  Files build
        sequentially — identical contents to a concatenated ingest, with
        host memory bounded per file (streamed above the threshold)."""
        for fid, path in enumerate(paths):
            self.build(path, fmt, file_id=fid)
        return self


class CountIndex(_IndexBase):
    """Distributed k-mer → count index (CountIndex preset,
    kmer_index.hpp:409-411; counting_densehash_map semantics).

    The local store is a SMALL LIST of sorted runs in the RUN layout
    (`store.RunCountStore`: sorted keys with duplicates + a prefix sum of
    per-row weights) — log-structured-merge discipline.  Each ingest chunk
    leaves the exchange sorter as one sorted run; the index is queryable
    immediately (count/find visit every run and sum), and runs merge
    pairwise with a bitonic merge network (log2 n elementwise stages — no
    re-sort, no compaction sort) only when the list
    exceeds `max_runs`.  The reference's own sorted map is lazy the same
    way: inserts append, the first query sorts
    (distributed_sorted_map.hpp:341,940).  Predicate scans, size() and
    exports consolidate to one run first; `compact()` additionally
    collapses duplicate/erased rows to reclaim memory."""

    def __init__(self, spec: KmerSpec, mesh=None, canonical: bool = True,
                 hash_name: str = "murmur", saturate: int | None = None,
                 initial_capacity: int = 1 << 12, max_runs: int = 8, **kw):
        super().__init__(spec, mesh, canonical, hash_name, **kw)
        self.saturate = saturate
        self.initial_capacity = initial_capacity
        self.max_runs = max_runs
        self.runs: list = [self._init_store(
            lambda: st.empty_run_count_store(initial_capacity, spec.nwords))]
        #: per-run host flag: True when every live row has weight 1 and
        #: sentinels mark exactly the dead tail (file-ingest output) —
        #: such pairs merge keys-only with closed-form weights/csum
        #: (st.run_merge_unit); erase/compact/explicit-count inserts
        #: clear it.  Only meaningful for sentinel-safe specs.
        self._unit: list = [spec.sentinel_safe]
        #: the initial empty run is replaced by the first real run
        self._virgin = True
        #: compact when capacity >= compact_factor * next_pow2(2*distinct)
        self.compact_factor = 4
        #: host-side upper bound on any shard's raw weight total — the
        #: int32 prefix sums overflow past 2^31; the guard either forces a
        #: clamped compact (saturating maps, exact) or raises before the
        #: sums can wrap (see _append_run)
        self._ingested_weight = 0

    # the store pytree = the run list (checkpointing flattens it)
    @property
    def store(self):
        return self.runs

    @store.setter
    def store(self, value):
        self.runs = list(value) if isinstance(value, (list, tuple)) \
            else [value]
        # restored/externally-assigned runs have unknown weight shape
        self._unit = [False] * len(self.runs)

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return sum(r.keys.shape[-1] for r in self.runs)

    def _run_caps(self) -> tuple:
        return tuple(r.keys.shape[-1] for r in self.runs)

    def _distinct(self) -> np.ndarray:
        """int32[p] distinct live keys per shard (single-run stores)."""
        assert len(self.runs) == 1
        key = ("run_stats", self._run_caps())
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_stats_step(self.mesh)
        return self._fetch(self._step_cache[key](self.runs[0]))

    def size(self) -> int:
        """Collective distinct-key count (dsc::map_base::size allreduce)."""
        self._consolidate()
        return int(self._distinct().sum())

    def local_sizes(self) -> list[int]:
        self._consolidate()
        return [int(x) for x in self._distinct()]

    def clear(self):
        if hasattr(self, "_pending"):
            self._pending = []
        self.runs = [self._init_store(
            lambda: st.empty_run_count_store(self.initial_capacity,
                                             self.spec.nwords))]
        self._unit = [self.spec.sentinel_safe]
        self._virgin = True
        self._ingested_weight = 0
        return self

    def _flush(self):
        """No deferred work on the build path: each ingested chunk is
        already a queryable run (the LSM laziness bound is max_runs)."""
        return

    def _checkpoint_prepare(self):
        """One consolidated run per shard — a stable pytree structure for
        sharded checkpoints (utils.checkpoint)."""
        self._consolidate()

    def _merge_two_smallest(self):
        order = sorted(range(len(self.runs)),
                       key=lambda i: self.runs[i].keys.shape[-1],
                       reverse=True)
        self.runs = [self.runs[i] for i in order]
        self._unit = [self._unit[i] for i in order]
        b, ub = self.runs.pop(), self._unit.pop()
        a, ua = self.runs.pop(), self._unit.pop()
        unit = ua and ub
        key = ("run_merge_pair", a.keys.shape[-1], b.keys.shape[-1], unit)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_merge_pair_step(
                self.mesh, unit=unit)
        with self.timer.phase("merge"):
            self.runs.append(self._step_cache[key](a, b))
        self._unit.append(unit)

    #: weight budget before a pressure check: headroom under int32 max
    _I32_WEIGHT_GUARD = (1 << 31) - (1 << 26)

    def _note_weight(self, add: int):
        """Account `add` incoming weight against the per-shard int32
        prefix-sum budget (self._ingested_weight conservatively bounds any
        shard's raw weight total — the worst case routes everything to one
        shard).  On pressure, tighten the bound from the true device
        totals / a clamped compact before the sums can wrap."""
        if self._ingested_weight + add > self._I32_WEIGHT_GUARD:
            self._relieve_weight_pressure(add)
        self._ingested_weight += add

    def _relieve_weight_pressure(self, incoming: int):
        """The conservative host counter says a shard's raw int32 weight
        total could pass 2^31 after the next append.  Saturating maps
        compact with the clamp (exact — saturation is monotone,
        store.run_compact) and rebound the counter; plain counting maps
        tighten the bound to the true worst shard total and raise before
        the prefix sums can wrap (the reference's uint32 counts overflow
        silently at 2^32; its bounded alternative is
        saturating_counting_densehash_map,
        distributed_densehash_map.hpp:2947)."""
        if self.saturate is not None and not self._virgin:
            self.compact()
            # after the clamp every key's weight <= saturate
            self._ingested_weight = self.size() * int(self.saturate)
        else:
            totals = np.zeros(self.nparts, np.int64)
            for r in self.runs:
                totals += self._fetch(r.csum[..., -1]).astype(np.int64)
            self._ingested_weight = int(totals.max())
        if self._ingested_weight + incoming > (1 << 31) - 1:
            raise OverflowError(
                "count index raw weight total would overflow the int32 "
                "prefix sums on a shard; use saturate= (clamped counts), "
                "more shards, or smaller insert batches")

    def _append_run(self, words, weights, unit: bool = False):
        unit = unit and self.spec.sentinel_safe
        key = ("run_adopt", words.shape[-1], unit)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_adopt_step(self.mesh,
                                                           unit=unit)
        run = self._step_cache[key](words, weights)
        if self._virgin:
            self.runs = [run]
            self._unit = [unit]
            self._virgin = False
        else:
            self.runs.append(run)
            self._unit.append(unit)
        while len(self.runs) > self.max_runs:
            self._merge_two_smallest()

    def _consolidate(self):
        """Merge every run into one (smallest pairs first) and reclaim
        dead rows if the result is mostly duplicates/erasures."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        self._maybe_compact()

    def _maybe_compact(self):
        """Reclaim dead rows when the store is mostly duplicates/erasures.

        Amortized O(1) per ingested row: compaction costs one stable sort
        but only fires after the store at least compact_factor/2-folds its
        live data."""
        cap = self.capacity
        if len(self.runs) != 1 or cap <= (1 << 14):
            return
        distinct = int(self._distinct().max())
        target = _next_pow2(max(2 * distinct, 1 << 12))
        if cap >= self.compact_factor * target:
            self.compact(target)

    def compact(self, new_cap: int | None = None):
        """Consolidate to one run, collapse every key's rows to one
        (key, count) row, and shrink capacity to new_cap (default:
        next_pow2(2 * max shard distinct))."""
        while len(self.runs) > 1:
            self._merge_two_smallest()
        if new_cap is None:
            new_cap = _next_pow2(max(2 * int(self._distinct().max()), 16))
        while True:
            key = ("run_compact", new_cap, self._run_caps())
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_compact_step(
                    self.mesh, new_cap, self.saturate)
            new_store, ovf = self._step_cache[key](self.runs[0])
            if int(self._fetch(ovf).max()) == 0:
                self.runs = [new_store]
                self._unit = [False]
                return self
            new_cap = _next_pow2(new_cap + int(self._fetch(ovf).max()))

    def reserve(self, n: int):
        """Pre-grow total capacity to hold ~n entries (map_base::reserve).

        Run capacities are otherwise data-driven (LSM growth); reserving
        pads the last run's sentinel tail, which is harmless under the
        run-store convention (weight-0 rows never affect a count)."""
        per = _next_pow2(-(-n // self.nparts))
        cur = self.capacity
        if per <= cur:
            return self
        pad = per - cur
        key = ("_grow", pad, self._run_caps())
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda s: st.RunCountStore(
                    keys=jnp.pad(s.keys, ((0, 0), (0, 0), (0, pad)),
                                 constant_values=np.uint32(_SENTINEL)),
                    weights=jnp.pad(s.weights, ((0, 0), (0, pad))),
                    csum=jnp.pad(s.csum, ((0, 0), (0, pad)), mode="edge"),
                ),
                out_shardings=self._sharding)
        self.runs[-1] = self._step_cache[key](self.runs[-1])
        return self

    # ------------------------------------------------------------------
    def insert_batch(self, batch: ReadBatch, chunk_bases: int | None = None):
        """Extract + canonicalize + distribute + merge a parsed batch.

        chunk_bases: stream the batch through the device in chunks of this
        many bases (k-1 lookahead keeps boundary windows) — for inputs
        larger than device memory.  Defaults to default_chunk_bases."""
        if chunk_bases is None:
            chunk_bases = self.default_chunk_bases
        if batch.num_bases > chunk_bases:
            # chunks are padded to chunk_bases + halo, so they must go
            # straight to the single-chunk path (re-chunking a padded chunk
            # would recurse forever)
            chunks = list(batch.iter_chunks(chunk_bases, self.spec.k - 1))
        else:
            chunks = [batch]
        self._stream_chunks(self._equalize_chunks(chunks),
                            self._marshal_chunk, self._insert_cols)
        return self

    def _marshal_chunk(self, batch: ReadBatch):
        with self.timer.phase("extract"):
            return self._batch_to_stacked(batch, id_kind=None,
                                          need_ids=False,
                                          need_qual=False)[0]

    def _insert_one_chunk(self, batch: ReadBatch):
        return self._insert_cols(self._marshal_chunk(batch))

    def _insert_cols(self, cols):
        n_local = cols["codes"].shape[1]
        bucket_cap = self._bucket_capacity(n_local)
        while True:
            key = ("ingest", n_local, bucket_cap)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_ingest_step(
                    self.mesh, self.nparts, self.spec, self.canonical,
                    bucket_cap, self.hash_name)
            with self.timer.phase("insert"):
                rw, rwt, route_ovf = self._step_cache[key](
                    cols["codes"], cols["valid"], cols["owned"],
                    cols["seg_id"])
            if int(self._fetch(route_ovf).max()) == 0:
                # chunk weight <= its window count (pre-reduced run
                # lengths sum to the valid windows routed here)
                self._note_weight(self.nparts * rw.shape[-1])
                self._append_run(rw, rwt, unit=True)
                return self
            bucket_cap = _next_pow2(
                bucket_cap + int(self._fetch(route_ovf).max()))

    def _insert_rows(self, words: np.ndarray, counts: np.ndarray):
        """Route explicit (key, count) rows to owners, sort them into a
        pending run, and flush eagerly (Index::insert semantics)."""
        self._note_weight(int(np.asarray(counts, np.int64).sum()))
        (wsh, csh), vsh, m = self._shard_rows(
            words, extra=(counts.astype(np.int32),))
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("insert", mq, bucket_cap)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_insert_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            rw, rwt, route_ovf = self._step_cache[key](wsh, csh, vsh)
            if int(self._fetch(route_ovf).max()) == 0:
                self._append_run(rw, rwt)
                return self
            bucket_cap *= 2

    def insert(self, kmers):
        """Insert explicit k-mers (Index::insert, kmer_index.hpp:201)."""
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        return self._insert_rows(words, np.ones(words.shape[0], np.int32))

    def _ensure_aux(self):
        """Per-run query-aux metadata (run totals + fused-gather operand
        + prefix-bucket table, st.run_query_aux), cached by run IDENTITY:
        any mutation replaces the run pytree objects, so staleness is
        impossible by construction.  The cache removes per-call O(cap)
        scans whose cost is flat in m."""
        cache = getattr(self, "_aux_cache", [])
        new, out = [], []
        for r in self.runs:
            hit = next((a for (rr, a) in cache if rr is r), None)
            if hit is None:
                key = ("run_aux", r.keys.shape[-1])
                if key not in self._step_cache:
                    self._step_cache[key] = dx.make_run_aux_step(
                        self.mesh)
                hit = self._step_cache[key](r)
            new.append((r, hit))
            out.append(hit)
        self._aux_cache = new
        return out

    def count(self, kmers) -> np.ndarray:
        """Per-query counts, original order (Index::count,
        kmer_index.hpp:142)."""
        self._flush()
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        # ALWAYS the cached-aux lookup: the sort-merge join scales
        # ~linearly in m, and only ever beat the UNCACHED bsearch's
        # per-call O(cap) scans, which the aux cache removes (a rule
        # from an earlier accelerator, to re-check on the GPU: ROADMAP
        # S5)
        cached = True
        aux = self._ensure_aux()
        while True:
            key = ("count", mq, bucket_cap, self._run_caps(), cached)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_runs_count_query_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    self.saturate, len(self.runs), cached=cached)
            with self.timer.phase("count"):
                counts, ovf = self._step_cache[key](
                    tuple(self.runs), wsh, vsh, *aux)
            if int(self._fetch(ovf).max()) == 0:
                return self._fetch(counts).reshape(-1)[:m]
            bucket_cap *= 2

    def find(self, kmers):
        """Found (kmer, count) pairs for the queries — Index::find
        (kmer_index.hpp:115-140) returns the matching pairs.  Returned as
        (found_words uint32[f, w], found_counts int32[f]) in query order;
        keys are in stored (post-InputTransform, i.e. canonical) form, and
        duplicated queries yield duplicated pairs like the reference."""
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = self.count(words)
        hit = counts > 0
        return words[hit], counts[hit]

    def erase(self, kmers) -> int:
        """Erase keys; returns number of erased entries (Index::erase)."""
        self._flush()
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("erase", mq, bucket_cap, self._run_caps())
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_runs_erase_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    len(self.runs))
            new_runs, nerased, ovf = self._step_cache[key](
                tuple(self.runs), wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                self.runs = list(new_runs)
                self._unit = [False] * len(self.runs)
                return int(self._fetch(nerased).sum())
            bucket_cap *= 2

    # -- predicate variants (kmer_index.hpp:153-195) -------------------
    def erase_if(self, pred, kmers=None) -> int:
        """Erase entries satisfying pred.

        pred: traceable (keys uint32[n, w], counts int32[n]) -> bool[n].
        With `kmers`, only those query keys whose (key, count) satisfies
        pred are erased (evaluated via a count round trip, equivalent to
        the reference's owner-side predicate).
        """
        if kmers is None:
            self._consolidate()
            key = ("erase_if", pred, self._run_caps())
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_filter_step(
                    self.mesh, lambda k, c: ~pred(k, c), self.saturate)
            new_store, nerased = self._step_cache[key](self.runs[0])
            self.runs = [new_store]
            self._unit = [False]
            return int(self._fetch(nerased).sum())
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = self.count(words)
        import jax.numpy as _jnp
        keep = np.asarray(pred(_jnp.asarray(words), _jnp.asarray(counts)))
        hits = keep & (counts > 0)
        if not hits.any():
            return 0
        return self.erase(words[hits])

    def filter(self, pred) -> int:
        """Keep only entries satisfying pred (dsc container filter);
        returns number erased."""
        return self.erase_if(lambda k, c: ~pred(k, c))

    def count_if(self, pred, kmers=None):
        """Without kmers: all (kmer_int, count) entries satisfying pred.
        With kmers: per-query counts, zeroed where pred fails."""
        if kmers is None:
            # device-side selection: matching entries compact to the front
            # per shard, the host slices n rows (no cap-sized mask scans)
            self._consolidate()
            key = ("select_if", pred, self._run_caps())
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_select_step(
                    self.mesh, pred, self.saturate)
            keys_out, totals, n = self._step_cache[key](self.runs[0])
            keys_out = self._fetch(keys_out)
            totals = self._fetch(totals)
            n = self._fetch(n)
            out = []
            for p in range(self.nparts):
                c = int(n[p])
                if c == 0:
                    continue
                ints = self.spec.to_ints(keys_out[p, :c])
                out.extend(zip(ints.tolist(),
                               totals[p, :c].astype(int).tolist()))
            return out
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = self.count(words)
        import jax.numpy as _jnp
        keep = np.asarray(pred(_jnp.asarray(words), _jnp.asarray(counts)))
        return np.where(keep, counts, 0)

    def find_if(self, pred, kmers=None):
        """find restricted to entries satisfying pred."""
        if kmers is None:
            return self.count_if(pred)
        counts = self.count_if(pred, kmers)
        return counts > 0, counts

    def unique_size(self) -> int:
        """Distinct-key count == size() for a unique-key map
        (map_base::unique_size)."""
        return self.size()

    def get_multiplicity(self, kmers) -> np.ndarray:
        """Counts per key (multiplicity of a counting map's entries)."""
        return self.count(kmers)

    def histogram(self, max_count: int = 255) -> np.ndarray:
        """K-mer frequency spectrum: hist[c] = number of distinct k-mers
        stored with count c, for c in [0, max_count]; counts above
        max_count accumulate in the last bin.  Device-side (no host
        gather) analog of the reference's utils/kmer_distribution.R
        frequency histogram over index dumps."""
        self._consolidate()
        key = ("hist", max_count + 1, self._run_caps())
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_histogram_step(
                self.mesh, max_count + 1, self.saturate)
        return self._fetch(
            self._step_cache[key](self.runs[0])).astype(np.int64)

    def insert_counts(self, kmers, counts) -> "CountIndex":
        """Insert (kmer, count) pairs — the reference counting map's
        second input flavor (counting_densehash_map insert of
        ::std::pair<Kmer, T>, distributed_densehash_map.hpp:2669+).
        Counts must be non-negative (the reference's counts are
        unsigned)."""
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = np.asarray(counts, dtype=np.int32)
        if counts.size and counts.min() < 0:
            raise ValueError("counts must be non-negative")
        return self._insert_rows(words, counts)

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(words uint32[t, w], counts int64[t]) — every distinct live
        entry, vectorized host export (to_vector analog,
        distributed_map_base.hpp:202-217)."""
        self._consolidate()
        keys = self._fetch(self.runs[0].keys)
        weights = self._fetch(self.runs[0].weights)
        rows, cnts = [], []
        for p in range(self.nparts):
            k = keys[p].T  # column-major store -> [cap, w] rows
            w = weights[p].astype(np.int64)
            neq_prev = np.ones(k.shape[0], bool)
            neq_prev[1:] = (k[1:] != k[:-1]).any(axis=1)
            head_pos = np.flatnonzero(neq_prev)
            cs = np.concatenate([[0], np.cumsum(w)])
            ends = np.append(head_pos[1:], k.shape[0])
            totals = cs[ends] - cs[head_pos]
            live = totals > 0
            rows.append(k[head_pos[live]])
            cnts.append(totals[live])
        rows = (np.concatenate(rows) if rows
                else np.zeros((0, self.spec.nwords), np.uint32))
        cnts = np.concatenate(cnts) if cnts else np.zeros(0, np.int64)
        if self.saturate is not None:
            cnts = np.minimum(cnts, self.saturate)
        return rows, cnts

    # -- persistence (beyond the reference, which is memory-only —
    # SURVEY §5 "checkpoint/resume: absent") ---------------------------
    def save(self, path):
        """Serialize the index contents + config to one .npz file
        (compacted: one row per distinct key)."""
        rows, cnts = self.items()
        np.savez_compressed(
            path,
            kind="count",
            k=self.spec.k,
            alphabet=self.spec.alphabet.name,
            canonical=self.canonical,
            hash_name=self.hash_name,
            saturate=-1 if self.saturate is None else self.saturate,
            nparts=self.nparts,
            rows=rows,
            row_counts=cnts.astype(np.int64),
        )
        return self

    @classmethod
    def load(cls, path, mesh=None):
        """Restore a saved index.  The mesh may differ from the saving
        mesh: entries are re-inserted through the distributed path."""
        from .. import alphabets as _al
        z = np.load(path, allow_pickle=False)
        spec = KmerSpec(int(z["k"]), _al.by_name(str(z["alphabet"])))
        sat = int(z["saturate"])
        idx = cls(spec, mesh=mesh, canonical=bool(z["canonical"]),
                  hash_name=str(z["hash_name"]),
                  saturate=None if sat < 0 else sat)
        rows = z["rows"]
        vals = z["row_counts"]
        if rows.shape[0]:
            # keys were stored post-transform; bypass re-canonicalization
            canonical = idx.canonical
            idx.canonical = False
            try:
                idx.insert_counts(rows.astype(np.uint32),
                                  vals.astype(np.int32))
            finally:
                idx.canonical = canonical
        return idx

    def to_dict(self) -> dict[int, int]:
        """Full index contents as {kmer_int: count} (to_vector analog,
        distributed_map_base.hpp:202-217).  Host-side; for tests/tools."""
        rows, cnts = self.items()
        if rows.shape[0] == 0:
            return {}
        return dict(zip(self.spec.to_ints(rows).tolist(),
                        cnts.astype(int).tolist()))


class BimoleculeCountIndex(CountIndex):
    """Counting index with the Bimolecule map preset
    (kmer_index.hpp:436-562): keys are hashed and compared in CANONICAL
    form — both strands of a k-mer answer the same entry — but the stored
    (reported) key keeps the INPUT-strand orientation, like the
    reference's hash table keeping the first-inserted key.

    The representative orientation is the earliest occurrence in file
    order (deterministic; equals the reference's sequential single-rank
    insertion order — with multiple MPI ranks the reference's own stored
    orientation is arrival-order-dependent).  Counts, queries, and erases
    behave exactly like the canonical CountIndex.
    """

    def __init__(self, spec: KmerSpec, mesh=None,
                 hash_name: str = "murmur", saturate: int | None = None,
                 initial_capacity: int = 1 << 12, **kw):
        _IndexBase.__init__(self, spec, mesh, True, hash_name, **kw)
        self.saturate = saturate
        self.initial_capacity = initial_capacity
        self.store = self._init_store(
            lambda: st.empty_run_bimol_store(initial_capacity,
                                             spec.nwords))
        self._virgin = True
        self._pending = []
        self._pending_rows = 0
        self.flush_rows = 1 << 24
        self.compact_factor = 4
        self._ingested_weight = 0
        #: ids for explicitly inserted k-mers rank after any file-derived
        #: occurrence id (file ids use at most 63 bits)
        self._insert_seq = 1 << 63

    # -- run-store management (single consolidated run: the flush merges
    # each pre-sorted ingest run into the store with a (w + 4)-column
    # bitonic merge — no store-scale re-sort; the count/histogram/select
    # steps of the count family apply duck-typed) ----------------------
    @property
    def store(self):
        return self._bimol_store

    @store.setter
    def store(self, value):
        self._bimol_store = value

    @property
    def capacity(self) -> int:
        return self.store.keys.shape[-1]

    def clear(self):
        self._pending = []
        self._pending_rows = 0
        self.store = self._init_store(
            lambda: st.empty_run_bimol_store(self.initial_capacity,
                                             self.spec.nwords))
        self._virgin = True
        self._ingested_weight = 0
        return self

    def reserve(self, n: int):
        per = _next_pow2(-(-n // self.nparts))
        cur = self.capacity
        if per <= cur:
            return self
        pad = per - cur
        key = ("_grow", pad, self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda s: st.RunBimolStore(
                    keys=jnp.pad(s.keys, ((0, 0), (0, 0), (0, pad)),
                                 constant_values=np.uint32(_SENTINEL)),
                    weights=jnp.pad(s.weights, ((0, 0), (0, pad))),
                    csum=jnp.pad(s.csum, ((0, 0), (0, pad)),
                                 mode="edge"),
                    rep_hi=jnp.pad(s.rep_hi, ((0, 0), (0, pad)),
                                   constant_values=np.uint32(_SENTINEL)),
                    rep_lo=jnp.pad(s.rep_lo, ((0, 0), (0, pad)),
                                   constant_values=np.uint32(_SENTINEL)),
                    rep_strand=jnp.pad(s.rep_strand, ((0, 0), (0, pad))),
                ),
                out_shardings=self._sharding)
        self.store = self._step_cache[key](self.store)
        return self

    def _note_weight(self, add: int):
        if self._ingested_weight + add > CountIndex._I32_WEIGHT_GUARD:
            true_total = int(self._fetch(
                self.store.csum[..., -1]).astype(np.int64).max())
            self._ingested_weight = true_total
            if self._ingested_weight + add > (1 << 31) - 1:
                if self.saturate is not None:
                    self.compact()
                    self._ingested_weight = \
                        self.size() * int(self.saturate)
                if self._ingested_weight + add > (1 << 31) - 1:
                    raise OverflowError(
                        "Bimolecule raw weight total would overflow the "
                        "int32 prefix sums on a shard; use saturate=, "
                        "more shards, or smaller insert batches")
        self._ingested_weight += add

    def _adopt_run(self, run_cols):
        """Adopt one sorted (kcols, weights, hi, lo, strand) ingest run
        as a RunBimolStore."""
        key = ("run_adopt", run_cols[0].shape[-1])
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_bimol_adopt_step(
                self.mesh)
        return self._step_cache[key](*run_cols)

    def _merge_pair(self, a, b):
        key = ("run_merge", a.keys.shape[-1], b.keys.shape[-1])
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_bimol_merge_pair_step(
                self.mesh)
        return self._step_cache[key](a, b)

    def _flush(self):
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_rows = 0
        # BALANCED pairwise merging (two smallest first, the count
        # family's LSM discipline): merging each pending run into the
        # consolidated store one at a time doubles the store capacity
        # per run — next_pow2(big + small) == 2*big — which at ~60
        # streamed blocks is 2^60x growth (measured: 51 GB RSS and
        # climbing on a 9 KB corpus).  A size-sorted tree keeps every
        # merge's operands comparable, so capacity stays
        # ~next_pow2(total rows).
        runs = [self._adopt_run(rc) for rc in pending]
        if not self._virgin:
            runs.append(self.store)
        while len(runs) > 1:
            runs.sort(key=lambda r: r.keys.shape[-1], reverse=True)
            b = runs.pop()
            a = runs.pop()
            with self.timer.phase("merge"):
                runs.append(self._merge_pair(a, b))
        self.store = runs[0]
        self._virgin = False
        self._maybe_compact()

    def _maybe_compact(self):
        cap = self.capacity
        if cap <= (1 << 14):
            return
        distinct = int(self._distinct().max())
        target = _next_pow2(max(2 * distinct, 1 << 12))
        if cap >= self.compact_factor * target:
            self.compact(target)

    def _distinct(self) -> np.ndarray:
        key = ("run_stats", self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_stats_step(self.mesh)
        return self._fetch(self._step_cache[key](self.store))

    def compact(self, new_cap: int | None = None):
        """Collapse every key's rows to one (key, total, min-rep) row and
        shrink capacity; retries with doubled capacity on overflow."""
        self._flush()
        cap = self.capacity
        if new_cap is None:
            new_cap = _next_pow2(
                max(2 * int(self._distinct().max()), 1 << 12))
        while True:
            key = ("run_compact", new_cap, self.capacity, self.saturate)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_bimol_compact_step(
                    self.mesh, new_cap, self.saturate)
            new_store, ovf = self._step_cache[key](self.store)
            if int(self._fetch(ovf).max()) == 0:
                self.store = new_store
                return self
            if new_cap >= cap:
                return self
            new_cap *= 2

    def _checkpoint_prepare(self):
        self._flush()

    def local_sizes(self) -> list[int]:
        self._flush()
        return [int(x) for x in self._distinct()]

    def size(self) -> int:
        self._flush()
        return int(self._distinct().sum())

    # -- build path ----------------------------------------------------
    def _marshal_chunk(self, batch: ReadBatch):
        with self.timer.phase("extract"):
            return self._batch_to_stacked(batch, id_kind="long",
                                          need_qual=False)[0]

    def _insert_cols(self, cols):
        n_local = cols["codes"].shape[1]
        self._note_weight(n_local * self.nparts)
        bucket_cap = self._bucket_capacity(n_local)
        while True:
            key = ("bimol_ingest", n_local, bucket_cap)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_bimol_run_ingest_step(
                    self.mesh, self.nparts, self.spec, bucket_cap,
                    self.hash_name)
            with self.timer.phase("insert"):
                rw, rwt, rhi, rlo, rs, route_ovf = self._step_cache[key](
                    cols["codes"], cols["valid"], cols["owned"],
                    cols["seg_id"], cols["id_hi"], cols["id_lo"])
            if int(self._fetch(route_ovf).max()) == 0:
                self._pending.append((rw, rwt, rhi, rlo, rs))
                self._pending_rows += rw.shape[-1]
                if self._pending_rows >= self.flush_rows:
                    self._flush()
                return self
            bucket_cap = _next_pow2(
                bucket_cap + int(self._fetch(route_ovf).max()))

    # -- query surface -------------------------------------------------
    def count(self, kmers) -> np.ndarray:
        self._flush()
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("count", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_count_query_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    self.saturate)
            with self.timer.phase("count"):
                counts, ovf = self._step_cache[key](self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                return self._fetch(counts).reshape(-1)[:m]
            bucket_cap *= 2

    def count_if(self, pred, kmers=None):
        if kmers is None:
            self._flush()
            key = ("select_if", pred, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_select_step(
                    self.mesh, pred, self.saturate)
            keys_out, counts_out, n = self._step_cache[key](self.store)
            keys_out = self._fetch(keys_out)
            counts_out = self._fetch(counts_out)
            n = self._fetch(n)
            out = []
            for p in range(self.nparts):
                c = int(n[p])
                if c == 0:
                    continue
                ints = self.spec.to_ints(keys_out[p, :c])
                out.extend(zip(ints.tolist(),
                               counts_out[p, :c].astype(int).tolist()))
            return out
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = self.count(words)
        import jax.numpy as _jnp
        keep = np.asarray(pred(_jnp.asarray(words), _jnp.asarray(counts)))
        return np.where(keep, counts, 0)

    def histogram(self, max_count: int = 255) -> np.ndarray:
        self._flush()
        key = ("hist", max_count + 1, self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_histogram_step(
                self.mesh, max_count + 1, self.saturate)
        return self._fetch(
            self._step_cache[key](self.store)).astype(np.int64)

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(stored-orientation words, counts) for every entry."""
        rows, cnts = self._stored_words()
        return rows, cnts.astype(np.int64)

    def _strand_of(self, input_words: np.ndarray,
                   canon: np.ndarray) -> np.ndarray:
        return (~np.all(input_words == canon, axis=1)).astype(np.uint32)

    def insert(self, kmers):
        """Insert input-strand k-mers: stored canonically with the input
        orientation remembered (first insertion wins)."""
        raw = self._to_words(kmers)
        canon = self._maybe_canonicalize_queries(raw)
        strand = self._strand_of(raw, canon)
        m = raw.shape[0]
        ids = (np.arange(m, dtype=np.uint64)
               + np.uint64(self._insert_seq))
        self._insert_seq += m
        return self._insert_tuples(
            canon, np.ones(m, np.int32),
            (ids >> np.uint64(32)).astype(np.uint32),
            ids.astype(np.uint32), strand)

    def insert_counts(self, kmers, counts):
        raw = self._to_words(kmers)
        canon = self._maybe_canonicalize_queries(raw)
        strand = self._strand_of(raw, canon)
        m = raw.shape[0]
        ids = (np.arange(m, dtype=np.uint64)
               + np.uint64(self._insert_seq))
        self._insert_seq += m
        return self._insert_tuples(
            canon, np.asarray(counts, np.int32),
            (ids >> np.uint64(32)).astype(np.uint32),
            ids.astype(np.uint32), strand)

    def _insert_tuples(self, canon, weights, rhi, rlo, strand):
        self._flush()
        self._note_weight(int(np.int64(np.asarray(weights)).sum()))
        (wsh, csh, hish, losh, ssh), vsh, m = self._shard_rows(
            canon, extra=(np.asarray(weights, np.int32), rhi, rlo,
                          np.asarray(strand, np.uint32)))
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("bimol_tuples", mq, bucket_cap)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_bimol_tuples_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            run_cols = self._step_cache[key](
                wsh, csh, hish, losh, ssh, vsh)
            if int(self._fetch(run_cols[-1]).max()) == 0:
                # pending + balanced flush (first query flushes) — an
                # eager per-insert merge into the consolidated store
                # doubles its capacity per call (next_pow2(big + small)
                # == 2*big), the same pathology the streamed-build
                # flush fix removed
                self._pending.append(tuple(run_cols[:-1]))
                self._pending_rows += run_cols[0].shape[-1]
                if self._pending_rows >= self.flush_rows:
                    self._flush()
                return self
            bucket_cap *= 2

    def erase(self, kmers) -> int:
        self._flush()
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("bimol_erase", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_bimol_erase_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            new_store, nerased, ovf = self._step_cache[key](
                self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                self.store = new_store
                return int(self._fetch(nerased).sum())
            bucket_cap *= 2

    def erase_if(self, pred, kmers=None) -> int:
        if kmers is None:
            self._flush()
            key = ("bimol_erase_if", pred, self.capacity, self.saturate)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_bimol_filter_step(
                    self.mesh, lambda k, c: ~pred(k, c), self.saturate)
            new_store, nerased = self._step_cache[key](self.store)
            self.store = new_store
            return int(self._fetch(nerased).sum())
        return CountIndex.erase_if(self, pred, kmers)

    def _stored_words(self):
        """(words uint32[t, w], counts int32[t]) — keys in their STORED
        (input-strand) orientation, concatenated over shards
        (device-side export: one compacted row per distinct key)."""
        self._flush()
        from ..ops import bitops
        key = ("export", self.capacity, self.saturate)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_run_bimol_export_step(
                self.mesh, self.saturate)
        keys_out, counts_out, strand_out, n = self._step_cache[key](
            self.store)
        keys_out = self._fetch(keys_out)
        counts_out = self._fetch(counts_out)
        strand_out = self._fetch(strand_out)
        n = self._fetch(n)
        rows, cnts, sts = [], [], []
        for p in range(self.nparts):
            c = int(n[p])
            rows.append(keys_out[p, :c])
            cnts.append(counts_out[p, :c])
            sts.append(strand_out[p, :c])
        rows = np.concatenate(rows) if rows else np.zeros(
            (0, self.spec.nwords), np.uint32)
        cnts = np.concatenate(cnts) if cnts else np.zeros(0, np.int32)
        sts = np.concatenate(sts) if sts else np.zeros(0, np.uint32)
        if rows.shape[0]:
            rc = np.asarray(bitops.revcomp(jnp.asarray(rows), self.spec))
            rows = np.where((sts == 1)[:, None], rc, rows)
        return rows, cnts

    def to_dict(self) -> dict[int, int]:
        """{input_strand_kmer_int: count} — keys in stored orientation."""
        rows, cnts = self._stored_words()
        return {self.spec.to_int(rows[i]): int(cnts[i])
                for i in range(rows.shape[0])}

    def find(self, kmers):
        """Found (stored-orientation kmer words, count) pairs.

        Device-side: one routed lookup returns (count, stored strand) per
        canonical query; the stored orientation is reconstructed by
        reverse-complementing flagged hits — no store gather."""
        self._flush()
        canon = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(canon)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("bimol_find", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_run_bimol_find_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    self.saturate)
            with self.timer.phase("find"):
                counts, strand, ovf = self._step_cache[key](
                    self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                counts = self._fetch(counts).reshape(-1)[:m]
                strand = self._fetch(strand).reshape(-1)[:m]
                break
            bucket_cap *= 2
        hit = counts > 0
        if not hit.any():
            return canon[:0], counts[:0]
        from ..ops import bitops
        hits = canon[hit]
        rc = np.asarray(bitops.revcomp(jnp.asarray(hits), self.spec))
        out = np.where((strand[hit] == 1)[:, None], rc, hits)
        return out.astype(np.uint32), counts[hit]

    def save(self, path):
        """Serialize: one compacted (key, count, min-rep) row per
        distinct key — ids are re-issued on load (orientation and counts
        are what the format promises, matching the compacted layout)."""
        self._flush()
        self.compact()
        r = self.store
        np.savez_compressed(
            path,
            kind="bimol_count",
            k=self.spec.k,
            alphabet=self.spec.alphabet.name,
            hash_name=self.hash_name,
            saturate=-1 if self.saturate is None else self.saturate,
            nparts=self.nparts,
            keys=self._fetch(r.keys),
            weights=self._fetch(r.weights),
            rep_hi=self._fetch(r.rep_hi),
            rep_lo=self._fetch(r.rep_lo),
            rep_strand=self._fetch(r.rep_strand),
        )
        return self

    @classmethod
    def load(cls, path, mesh=None):
        from .. import alphabets as _al
        z = np.load(path, allow_pickle=False)
        spec = KmerSpec(int(z["k"]), _al.by_name(str(z["alphabet"])))
        sat = int(z["saturate"])
        idx = cls(spec, mesh=mesh, hash_name=str(z["hash_name"]),
                  saturate=None if sat < 0 else sat)
        keys, weights = z["keys"], z["weights"]
        rhi, rlo, rst = z["rep_hi"], z["rep_lo"], z["rep_strand"]
        P_ = keys.shape[0]
        live = weights > 0
        rows = np.concatenate([
            keys[p].T[live[p]] for p in range(P_)]).astype(np.uint32)
        if rows.shape[0]:
            idx._insert_tuples(
                rows,
                np.concatenate([weights[p][live[p]] for p in range(P_)]),
                np.concatenate([rhi[p][live[p]] for p in range(P_)]),
                np.concatenate([rlo[p][live[p]] for p in range(P_)]),
                np.concatenate([rst[p][live[p]] for p in range(P_)]))
        return idx


class _MultimapSurfaceMixin:
    """The generic Index surface (kmer_index.hpp:157-201) applied to the
    multimaps — shared by the hash-partitioned PositionIndex and the
    range-partitioned SortedPositionIndex (both store MultiStore pytrees
    and expose _to_words/_maybe_canonicalize_queries/_insert_pairs/
    count/find/_fetch)."""

    def insert(self, kmers, ids, quals=None):
        """Insert explicit (kmer, position-id) pairs — the multimap insert
        of (key, T) tuples (densehash_multimap insert,
        distributed_densehash_map.hpp:2067+; sorted_multimap,
        distributed_sorted_map.hpp:2333+).  ids: uint64 position ids
        (ShortSequence/LongSequenceKmerId encodings or arbitrary 64-bit
        payloads); quals: optional float32 per pair."""
        words = self._to_words(kmers)
        ids = np.asarray(ids, dtype=np.uint64).reshape(-1)
        if ids.shape[0] != words.shape[0]:
            raise ValueError("kmers and ids length mismatch")
        q = (np.zeros(ids.shape[0], np.float32) if quals is None
             else np.asarray(quals, np.float32).reshape(-1))
        return self._insert_pairs(
            words, (ids >> np.uint64(32)).astype(np.uint32),
            (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32), q)

    def count_if(self, pred, kmers=None):
        """Without kmers: sorted [(kmer_int, n_matching_pairs)] over the
        whole multimap, keys with >= 1 pair satisfying pred
        (count_if(pred), kmer_index.hpp:181; pred over the
        (keys, id_hi, id_lo, qual) pair columns as in erase_if).  With
        kmers: per-query multiplicities, zeroed where pred(words, counts)
        fails (count_if(query, pred), kmer_index.hpp:175)."""
        if kmers is None:
            # device-side: per distinct key the number of matching pairs,
            # compacted to the front per shard (the host slices n rows —
            # no cap-sized mask fetch + np.unique per shard)
            self._flush()
            key = ("select_if", pred, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_select_step(
                    self.mesh, pred)
            keys_out, mcounts, n = self._step_cache[key](self.store)
            keys_out = self._fetch(keys_out)
            mcounts = self._fetch(mcounts)
            n = self._fetch(n)
            out: dict = {}
            for p in range(self.nparts):
                c = int(n[p])
                if c == 0:
                    continue
                ints = self.spec.to_ints(keys_out[p, :c])
                # a key's run may straddle shard boundaries under the
                # sorted (range) distribution: aggregate across shards
                for v, m in zip(ints.tolist(),
                                mcounts[p, :c].astype(int).tolist()):
                    out[v] = out.get(v, 0) + m
            return sorted(out.items())
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        counts = self._count_words(words)
        import jax.numpy as _jnp
        keep = np.asarray(pred(_jnp.asarray(words), _jnp.asarray(counts)))
        return np.where(keep, counts, 0)

    def find_if(self, pred, kmers=None, max_per_query: int = 64):
        """find restricted by pred (find_if, kmer_index.hpp:157-170).
        Without kmers: count_if(pred).  With kmers: (ids, mask) with
        queries failing pred(words, counts) masked out entirely."""
        if kmers is None:
            return self.count_if(pred)
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        ids, mask = self._find_words(words, max_per_query)
        counts = mask.sum(axis=1).astype(np.int32)
        import jax.numpy as _jnp
        keep = np.asarray(pred(_jnp.asarray(words), _jnp.asarray(counts)))
        return ids, mask & keep[:, None]


class PositionIndex(_MultimapSurfaceMixin, _IndexBase):
    """Distributed k-mer → positions multimap (PositionIndex preset,
    kmer_index.hpp:399-404; densehash_multimap semantics).

    id_kind: "short" (FASTQ, ShortSequenceKmerId) or "long" (FASTA,
    LongSequenceKmerId) — chosen per file format like the reference's
    parser presets (kmer_parser.hpp:304+).
    """

    with_quality = False

    def __init__(self, spec: KmerSpec, mesh=None, canonical: bool = False,
                 hash_name: str = "murmur", id_kind: str = "short",
                 initial_capacity: int = 1 << 12, codec=None, **kw):
        super().__init__(spec, mesh, canonical, hash_name, **kw)
        from ..quality import ILLUMINA18
        self.id_kind = id_kind
        self.codec = codec if codec is not None else ILLUMINA18
        self.store = self._init_store(
            lambda: st.empty_multi_store(initial_capacity, spec.nwords))
        self._pending: list = []
        self._pending_rows = 0
        self.flush_rows = 1 << 24

    @property
    def capacity(self) -> int:
        return self.store.keys.shape[1]

    def size(self) -> int:
        """Total number of (kmer, position) pairs."""
        self._flush()
        return int(self._fetch(self.store.size).sum())

    def _flush(self):
        if not self._pending:
            return
        words = self._device_concat([t[0] for t in self._pending])
        hi = self._device_concat([t[1] for t in self._pending])
        lo = self._device_concat([t[2] for t in self._pending])
        q = self._device_concat([t[3] for t in self._pending])
        valid = self._device_concat([t[4] for t in self._pending])
        self._pending = []
        self._pending_rows = 0
        n_rows = words.shape[1]
        live = int(self._valid_counts(valid).max())
        if int(self._fetch(self.store.size).max()) + live > self.capacity:
            self._grow(_next_pow2(
                int(self._fetch(self.store.size).max()) + live))
        while True:
            key = ("merge", n_rows, self.capacity, self.with_quality)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_merge_step(
                    self.mesh, sentinel_ok=self.spec.sentinel_safe,
                    with_q=self.with_quality)
            new_store, ovf = self._step_cache[key](
                self.store, words, hi, lo, q, valid)
            if int(self._fetch(ovf).max()) == 0:
                self.store = new_store
                return
            self._grow(_next_pow2(self.capacity + int(self._fetch(ovf).max())))

    def _grow(self, new_cap: int):
        pad = new_cap - self.capacity
        key = ("_grow", new_cap, self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = jax.jit(
                lambda s: st.MultiStore(
                    keys=jnp.pad(s.keys, ((0, 0), (0, pad), (0, 0)),
                                 constant_values=np.uint32(_SENTINEL)),
                    val_hi=jnp.pad(s.val_hi, ((0, 0), (0, pad))),
                    val_lo=jnp.pad(s.val_lo, ((0, 0), (0, pad))),
                    val_q=jnp.pad(s.val_q, ((0, 0), (0, pad))),
                    size=s.size,
                ),
                out_shardings=self._sharding)
        self.store = self._step_cache[key](self.store)

    def insert_batch(self, batch: ReadBatch, chunk_bases: int | None = None):
        if chunk_bases is None:
            chunk_bases = self.default_chunk_bases
        if batch.num_bases > chunk_bases:
            chunks = list(batch.iter_chunks(chunk_bases, self.spec.k - 1))
        else:
            chunks = [batch]
        self._stream_chunks(self._equalize_chunks(chunks),
                            self._marshal_chunk, self._insert_cols)
        return self

    def _marshal_chunk(self, batch: ReadBatch):
        with self.timer.phase("extract"):
            return self._batch_to_stacked(
                batch, id_kind=self.id_kind,
                real_qual=self.with_quality)[0]

    def _insert_one_chunk(self, batch: ReadBatch):
        return self._insert_cols(self._marshal_chunk(batch))

    def _insert_cols(self, cols):
        n_local = cols["codes"].shape[1]
        bucket_cap = self._bucket_capacity(n_local)
        while True:
            key = ("ingest", n_local, bucket_cap)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_ingest_step(
                    self.mesh, self.nparts, self.spec, self.canonical,
                    bucket_cap, self.hash_name, self.with_quality,
                    self.codec)
            with self.timer.phase("insert"):
                rw, rhi, rlo, rq, rv, route_ovf = self._step_cache[key](
                    cols["codes"], cols["valid"], cols["owned"],
                    cols["seg_id"], cols["id_hi"], cols["id_lo"],
                    cols["qual"])
            if int(self._fetch(route_ovf).max()) == 0:
                self._pending.append((rw, rhi, rlo, rq, rv))
                self._pending_rows += rw.shape[1]
                if self._pending_rows >= self.flush_rows:
                    with self.timer.phase("merge"):
                        self._flush()
                return self
            bucket_cap = _next_pow2(
                bucket_cap + int(self._fetch(route_ovf).max()))

    def unique_size(self) -> int:
        """Number of distinct keys in the multimap (map_base::unique_size):
        counted on device per shard as key-change boundaries + psum —
        only one scalar reaches the host."""
        self._flush()
        key = ("unique_size", self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_unique_size_step(self.mesh)
        return int(self._fetch(self._step_cache[key](self.store)))

    def get_multiplicity(self, kmers) -> np.ndarray:
        return self.count(kmers)

    def count(self, kmers) -> np.ndarray:
        """Multiplicity per query (get_multiplicity / count on multimap)."""
        return self._count_words(
            self._maybe_canonicalize_queries(self._to_words(kmers)))

    def _count_words(self, words: np.ndarray) -> np.ndarray:
        """count() for already-canonicalized word rows (the mixin
        predicate paths canonicalize once and reuse)."""
        self._flush()
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("count", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_count_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            counts, ovf = self._step_cache[key](self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                return self._fetch(counts).reshape(-1)[:m]
            bucket_cap *= 2

    def find(self, kmers, max_per_query: int = 64, with_quality: bool = False,
             grow_to_fit: bool = True):
        """Per-query position-id lists: (ids uint64[m, max], mask[m, max]),
        plus float32 qualities when with_quality.

        The reference's find returns ALL matching pairs (two-pass size
        estimation, distributed_densehash_map.hpp:328-420); here the gather
        width starts at max_per_query and, when any query's true
        multiplicity exceeds it, the query is retried with the width
        doubled until nothing truncates (grow_to_fit=True, default).  With
        grow_to_fit=False the result is truncated at max_per_query and the
        third/fourth return value `counts` (int32[m], the true
        multiplicity) lets callers detect truncation: counts[i] >
        mask[i].sum() means query i lost pairs.
        """
        return self._find_words(
            self._maybe_canonicalize_queries(self._to_words(kmers)),
            max_per_query, with_quality, grow_to_fit)

    def _ensure_aux(self):
        """Query-aux metadata for the multimap store (st.multi_query_aux),
        cached by store IDENTITY — any mutation replaces the store pytree
        object, so staleness is impossible by construction."""
        cache = getattr(self, "_aux_cache", None)
        if cache is not None and cache[0] is self.store:
            return cache[1]
        key = ("multi_aux", self.capacity)
        if key not in self._step_cache:
            self._step_cache[key] = dx.make_multi_aux_step(self.mesh)
        aux = self._step_cache[key](self.store)
        self._aux_cache = (self.store, aux)
        return aux

    def _find_words(self, words, max_per_query, with_quality=False,
                    grow_to_fit=True):
        self._flush()
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        # ALWAYS the cached-aux lookup (see CountIndex.count: the join
        # only beat the uncached per-call scans)
        cached = True
        aux = (self._ensure_aux(),)
        while True:
            key = ("find", mq, bucket_cap, self.capacity, max_per_query,
                   cached)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_find_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    max_per_query, cached=cached)
            with self.timer.phase("find"):
                hi, lo, q, mask, nfound, ovf = self._step_cache[key](
                    self.store, wsh, vsh, *aux)
            if int(self._fetch(ovf).max()) != 0:
                bucket_cap *= 2
                continue
            counts = self._fetch(nfound).reshape(-1)[:m]
            worst = int(counts.max()) if m else 0
            if grow_to_fit and worst > max_per_query:
                max_per_query = _next_pow2(worst)
                continue
            hi = self._fetch(hi).reshape(-1, max_per_query)[:m]
            lo = self._fetch(lo).reshape(-1, max_per_query)[:m]
            q = self._fetch(q).reshape(-1, max_per_query)[:m]
            mask = self._fetch(mask).reshape(-1, max_per_query)[:m]
            ids = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
            if with_quality:
                if grow_to_fit:
                    return ids, q, mask
                return ids, q, mask, counts
            if grow_to_fit:
                return ids, mask
            return ids, mask, counts

    # -- erase family (densehash_multimap::erase/erase_if/filter,
    # distributed_densehash_map.hpp:1603+) -----------------------------
    def erase(self, kmers) -> int:
        """Remove ALL pairs whose key matches a query k-mer; returns the
        number of erased pairs (Index::erase, kmer_index.hpp:148)."""
        self._flush()
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("erase", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_erase_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            new_store, nerased, ovf = self._step_cache[key](
                self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                self.store = new_store
                return int(self._fetch(nerased).sum())
            bucket_cap *= 2

    def erase_if(self, pred, kmers=None) -> int:
        """Erase (key, id, quality) pairs satisfying pred.

        pred: traceable (keys uint32[n, w], id_hi uint32[n],
        id_lo uint32[n], qual float32[n]) -> bool[n].  With `kmers`, only
        pairs whose key is among the (canonicalized) query keys AND
        satisfies pred are erased.
        """
        self._flush()
        if kmers is None:
            key = ("erase_if", pred, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_filter_step(
                    self.mesh, lambda k, h, l, q: ~pred(k, h, l, q))
            new_store, nerased = self._step_cache[key](self.store)
            self.store = new_store
            return int(self._fetch(nerased).sum())
        # keyed erase_if: the query keys route to owners and mark covered
        # store ranges; pred applies only inside them (device-side — the
        # old path unrolled one compare per query row into the predicate)
        words = self._maybe_canonicalize_queries(self._to_words(kmers))
        (wsh,), vsh, m = self._shard_rows(words)
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("erase_if_keys", pred, mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_erase_if_keys_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name,
                    pred)
            new_store, nerased, ovf = self._step_cache[key](
                self.store, wsh, vsh)
            if int(self._fetch(ovf).max()) == 0:
                self.store = new_store
                return int(self._fetch(nerased).sum())
            bucket_cap *= 2

    def filter(self, pred) -> int:
        """Keep only pairs satisfying pred; returns number erased."""
        return self.erase_if(lambda k, h, l, q: ~pred(k, h, l, q))

    def save(self, path):
        """Serialize the sharded multimap + config to one .npz file."""
        self._flush()
        np.savez_compressed(
            path,
            kind="position",
            k=self.spec.k,
            alphabet=self.spec.alphabet.name,
            canonical=self.canonical,
            hash_name=self.hash_name,
            id_kind=self.id_kind,
            with_quality=self.with_quality,
            nparts=self.nparts,
            keys=self._fetch(self.store.keys),
            val_hi=self._fetch(self.store.val_hi),
            val_lo=self._fetch(self.store.val_lo),
            val_q=self._fetch(self.store.val_q),
            sizes=self._fetch(self.store.size),
        )
        return self

    @classmethod
    def load(cls, path, mesh=None):
        """Restore a saved multimap; the mesh may differ from the saving
        mesh (pairs are re-routed through the distributed path)."""
        from .. import alphabets as _al
        z = np.load(path, allow_pickle=False)
        spec = KmerSpec(int(z["k"]), _al.by_name(str(z["alphabet"])))
        idx = cls(spec, mesh=mesh, canonical=bool(z["canonical"]),
                  hash_name=str(z["hash_name"]), id_kind=str(z["id_kind"]))
        keys, hi, lo, q, sizes = (z["keys"], z["val_hi"], z["val_lo"],
                                  z["val_q"], z["sizes"])
        rows = np.concatenate([keys[p, : sizes[p]] for p in range(keys.shape[0])])
        if rows.shape[0] == 0:
            return idx
        vhi = np.concatenate([hi[p, : sizes[p]] for p in range(keys.shape[0])])
        vlo = np.concatenate([lo[p, : sizes[p]] for p in range(keys.shape[0])])
        vq = np.concatenate([q[p, : sizes[p]] for p in range(keys.shape[0])])
        canonical = idx.canonical
        idx.canonical = False  # stored keys are post-transform
        try:
            idx._insert_pairs(rows.astype(np.uint32), vhi, vlo, vq)
        finally:
            idx.canonical = canonical
        return idx

    def _insert_pairs(self, words, val_hi, val_lo, val_q):
        """Insert explicit (key, id, quality) tuples through the
        distributed path (used by load and the public insert)."""
        import jax.numpy as _jnp
        m = words.shape[0]
        if self.size() + m > self.capacity * self.nparts:
            self._grow(_next_pow2(-(-(self.size() + m) // self.nparts)))
        (wsh, hsh, lsh, qsh), vsh, _ = self._shard_rows(
            self._maybe_canonicalize_queries(words),
            extra=(val_hi.astype(np.uint32), val_lo.astype(np.uint32),
                   val_q.astype(np.float32)))
        mq = wsh.shape[1]
        bucket_cap = self._bucket_capacity(mq)
        while True:
            key = ("insert_pairs", mq, bucket_cap, self.capacity)
            if key not in self._step_cache:
                self._step_cache[key] = dx.make_multi_insert_step(
                    self.mesh, self.nparts, bucket_cap, self.hash_name)
            new_store, route_ovf, store_ovf = self._step_cache[key](
                self.store, wsh, hsh, lsh, qsh, vsh)
            if int(self._fetch(route_ovf).max()) == 0 and                int(self._fetch(store_ovf).max()) == 0:
                self.store = new_store
                return self
            bucket_cap *= 2
            if int(self._fetch(store_ovf).max()) > 0:
                self._grow(self.capacity * 2)

    def to_dict(self) -> dict[int, list[int]]:
        """Full contents: {kmer_int: sorted position ids} (tests/tools)."""
        self._flush()
        out: dict[int, list[int]] = {}
        keys = self._fetch(self.store.keys)
        hi = self._fetch(self.store.val_hi)
        lo = self._fetch(self.store.val_lo)
        sizes = self._fetch(self.store.size)
        for p in range(self.nparts):
            n = int(sizes[p])
            if n == 0:
                continue
            ints = self.spec.to_ints(keys[p, :n]).tolist()
            pids = ((hi[p, :n].astype(np.uint64) << np.uint64(32))
                    | lo[p, :n].astype(np.uint64)).tolist()
            for v, pid in zip(ints, pids):
                out.setdefault(v, []).append(pid)
        return {k: sorted(v) for k, v in out.items()}


class PositionQualityIndex(PositionIndex):
    """Distributed k-mer → (position, windowed quality) multimap —
    the PositionQualityIndex preset (kmer_index.hpp:406;
    KmerPositionQualityTupleParser, kmer_parser.hpp:578+).

    find(..., with_quality=True) returns (ids, qualities, mask).
    """

    with_quality = True

    def to_dict(self):
        """{kmer_int: sorted [(position id, quality), ...]}."""
        self._flush()
        out: dict[int, list] = {}
        keys = self._fetch(self.store.keys)
        hi = self._fetch(self.store.val_hi)
        lo = self._fetch(self.store.val_lo)
        q = self._fetch(self.store.val_q)
        sizes = self._fetch(self.store.size)
        for p in range(self.nparts):
            n = int(sizes[p])
            if n == 0:
                continue
            ints = self.spec.to_ints(keys[p, :n]).tolist()
            pids = ((hi[p, :n].astype(np.uint64) << np.uint64(32))
                    | lo[p, :n].astype(np.uint64)).tolist()
            qs = q[p, :n].tolist()
            for v, pid, qv in zip(ints, pids, qs):
                out.setdefault(v, []).append((pid, float(qv)))
        return {k: sorted(v) for k, v in out.items()}

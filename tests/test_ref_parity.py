"""Bit-exact parity against the REFERENCE'S OWN COMPILED CODE.

The full kmerind binaries cannot be built in this sandbox (empty
mxx/sparsehash/gtest submodules, no MPI — see tests/make_golden.py), but
the serial header-only core needs none of that.  tests/native_parity/
ref_dump.cpp compiles /root/reference's actual kmer.hpp / alphabets.hpp /
kmer_transform.hpp / quality_scores.hpp / ext/smhasher/MurmurHash3.cpp and
dumps, for every window of every input sequence under 16 (alphabet, K,
word-type) configs:

  packed k-mer value, reverse, reverse_complement, lex_less, lex_greater,
  xor_rev_comp   (as big-integer hex — layout-independent value compare),
  MurmurHash3_x86_32 digests, and quality DecodeLUT entries (hexfloat).

This test runs that binary and asserts bit-equality with this framework's
KmerSpec packing, bitops.reverse/revcomp, packing.lex_less/greater,
kmer_xor, ops.hashing.murmur3_32, and quality.QualityCodec LUTs.  The
big-integer *value* is the right comparison object: both layouts define the
k-mer's value as sum(code[i] << B*(k-1-i)) (kmer.hpp:78-100 vs
kmer.KmerSpec docstring), so values must agree even though word layouts
deliberately differ.

Skips (never fails) when /root/reference or a C++ toolchain is absent.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

from kmerind_jax import alphabets as al
from kmerind_jax.kmer import KmerSpec
from kmerind_jax.ops import bitops, hashing, packing
from kmerind_jax import quality

REF = pathlib.Path("/root/reference")
HERE = pathlib.Path(__file__).resolve().parent

pytestmark = pytest.mark.skipif(
    not (REF / "src/common/kmer.hpp").exists() or shutil.which("g++") is None,
    reason="reference sources or g++ unavailable",
)

# tag -> (k, alphabet).  Word type only affects the reference's internal
# layout, not the value, so w64/w32/w16 variants all map to the same spec.
CONFIGS = {
    "DNA_k21_w64": (21, al.DNA),
    "DNA_k21_w32": (21, al.DNA),
    "DNA_k21_w16": (21, al.DNA),
    "DNA_k31_w64": (31, al.DNA),
    "DNA_k32_w64": (32, al.DNA),
    "DNA_k33_w64": (33, al.DNA),
    "DNA_k63_w64": (63, al.DNA),
    "DNA_k5_w64": (5, al.DNA),
    "RNA_k21_w64": (21, al.RNA),
    "DNA6_k21_w64": (21, al.DNA6),
    "RNA6_k10_w64": (10, al.RNA6),
    "DNA16_k8_w64": (8, al.DNA16),
    "DNA16_k15_w64": (15, al.DNA16),
    "DNA16_k16_w64": (16, al.DNA16),
    "IUPAC_k9_w64": (9, al.DNA_IUPAC),
    "ASCII_k4_w64": (4, al.ASCII),
}


def _sequences() -> list[str]:
    seqs = [
        "ACGTACGTTAGCGATCGATCGGCTAAGCTCATGNACGTNNACGTAGGGCCCTTTAAACCGTGA"
        "CGATCGTAGCTAGCTAGCATCGATCG",
        "A" * 70,
        "T" * 70,  # poly-T: the all-ones full-word key (sentinel hazard)
        "ACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACAC",
        "acgtACGTnN-uU.xyz*acgtacgtacgtacgtacgtacgtacgtacgtacgtacgtacgtacgt",
        "RYSWKMBDHVNACGTUryswkmbdhvn-ACGTACGTACGTACGTACGTACGTACGTACGTACGT",
    ]
    rng = np.random.RandomState(12345)
    seqs.append("".join(rng.choice(list("ACGTN"), size=200)))
    seqs.append("".join(rng.choice(list("ACGT"), size=150)))
    # real reads from the reference's own fixtures
    fq = REF / "test/data/test.small.fastq"
    if fq.exists():
        lines = fq.read_text().splitlines()
        seqs.extend(lines[1:24:4])  # sequence line of the first 6 records
    return seqs


_MXX_STUB = """\
// Minimal stub standing in for the (empty-submodule) mxx headers.  Only what
// the reference's serial, USE_MPI-undefined code paths need; no MPI.  All
// collectives are p=1 identities.
#ifndef KMERIND_MXX_STUB_HPP
#define KMERIND_MXX_STUB_HPP
#include <cstddef>
#include <utility>
#include <vector>
typedef int MPI_Datatype;
namespace mxx {
struct comm {
  int rank() const { return 0; }
  int size() const { return 1; }
  void barrier() const {}
};
template <typename T> struct datatype_builder {
  static MPI_Datatype get_type() { return 0; }
  static std::size_t num_basic_elements() { return 1; }
};
template <typename T, std::size_t N> struct datatype_contiguous {
  static MPI_Datatype get_type() { return 0; }
  static std::size_t num_basic_elements() { return N; }
};
template <typename T, typename Op>
inline std::vector<T> reduce(std::vector<T> const &x, int, Op, comm const &) {
  return x;
}
template <typename T, typename Op>
inline T reduce(T const &x, int, Op, comm const &) { return x; }
template <typename T>
inline std::vector<std::pair<T, int>> min_element(std::vector<T> const &x,
                                                  comm const &) {
  std::vector<std::pair<T, int>> out;
  for (auto const &v : x) out.emplace_back(v, 0);
  return out;
}
template <typename T>
inline std::vector<std::pair<T, int>> max_element(std::vector<T> const &x,
                                                  comm const &) {
  return min_element(x, comm());
}
template <typename T> inline T allreduce(T const &x, comm const &) { return x; }
template <typename T, typename Op>
inline T allreduce(T const &x, Op, comm const &) { return x; }
}  // namespace mxx
#endif
"""


def _write_gen_headers(gen: pathlib.Path) -> None:
    """Stand-ins for the CMake-generated config headers (macro names from
    src/config/*.hpp.in; NO_LOG, benchmarking off, USE_MPI undefined) and
    stub mxx headers for the unconditional #includes in the io loaders."""
    (gen / "bliss-logger_config.hpp").write_text(
        "#ifndef LOGGER_CONFIG_H\n#define LOGGER_CONFIG_H\n"
        "#define USE_LOGGER BLISS_LOGGING_NO_LOG\n"
        "#define LOGGER_VERBOSITY BLISS_LOGGER_VERBOSITY_FATAL\n"
        "#define BL_BENCHMARK 0\n#define BL_BENCHMARK_MEM 0\n"
        "#define BL_BENCHMARK_TIME 0\n#endif\n")
    (gen / "bliss-config.hpp").write_text(
        "#ifndef CONFIG_H\n#define CONFIG_H\n"
        '#define PROJ_SRC_DIR "/root/reference"\n'
        '#define PROJ_BIN_DIR ""\n#define OMP_SHARE_DEFAULT\n'
        "#define BLISS_UNUSED(x) do { (void)(x); } while(0)\n"
        "#define BLISS_ALIGNED_ARRAY(name, count, alignsize) "
        "name alignas(alignsize) [count]\n"
        "#define BLISS_ALIGNED_VAR(name, alignsize) "
        "name alignas(alignsize)\n#endif\n")
    mxx = gen / "mxx"
    mxx.mkdir(exist_ok=True)
    for h in ("comm.hpp", "shift.hpp", "datatypes.hpp", "sort.hpp",
              "reduction.hpp"):
        (mxx / h).write_text(_MXX_STUB)


def _compile(build: pathlib.Path, name: str, *extra_srcs: str) -> pathlib.Path:
    gen = build / "gen"
    gen.mkdir(exist_ok=True)
    _write_gen_headers(gen)
    exe = build / name
    subprocess.run(
        ["g++", "-std=c++14", "-O1", "-march=native", f"-I{gen}",
         f"-I{REF}/src", f"-I{REF}/ext", f"-I{REF}/ext/Nadeau",
         f"-I{REF}/test/test",  # debruijn/edge_iterator.hpp
         "-DFARMHASH_DEBUG=0",  # production farmhash values (no DebugTweak)
         "-o", str(exe),
         str(HERE / f"native_parity/{name}.cpp"), *extra_srcs],
        check=True, capture_output=True, text=True)
    return exe


@pytest.fixture(scope="module")
def ref_output(tmp_path_factory) -> dict:
    build = tmp_path_factory.mktemp("refparity")
    exe = _compile(build, "ref_dump", str(REF / "ext/smhasher/MurmurHash3.cpp"))
    seqs = _sequences()
    out = subprocess.run(
        [str(exe)], input="\n".join(seqs) + "\n",
        check=True, capture_output=True, text=True).stdout
    windows: dict[str, list] = {}
    murmur, qual, enc_lut, enc = [], [], [], []
    for line in out.splitlines():
        f = line.split()
        if f[0] == "K":
            windows.setdefault(f[1], []).append(
                (int(f[2]), [int(x, 16) for x in f[3:9]]))
        elif f[0] == "P":
            windows.setdefault(f[1], []).append((int(f[2]),
                                                 [int(f[3], 16)]))
        elif f[0] == "H":
            murmur.append((int(f[1]), int(f[2]), int(f[3], 16)))
        elif f[0] == "Q":
            qual.append((f[1], f[2], int(f[3]), float.fromhex(f[4])))
        elif f[0] == "EL":
            enc_lut.append((f[1], int(f[2]), float.fromhex(f[3])))
        elif f[0] == "E":
            enc.append((f[1], float.fromhex(f[2]), int(f[3])))
    return {"windows": windows, "murmur": murmur, "qual": qual,
            "enc_lut": enc_lut, "enc": enc, "seqs": seqs}


def _our_values(tag: str, seqs: list[str]) -> list[tuple[int, list[int]]]:
    """(pos-within-concatenated-order, [kmer, rev, rc, lexless, lexgreater,
    xor]) for every window, via THIS framework's ops."""
    k, alph = CONFIGS[tag]
    spec = KmerSpec(k, alph)
    pack_only = tag.startswith(("IUPAC", "ASCII"))
    out = []
    for s in seqs:
        if len(s) < k:
            continue
        codes = alph.encode(s)
        rows = np.stack([np.atleast_1d(spec.pack_codes(codes[i:i + k]))
                         for i in range(len(s) - k + 1)])
        rows = rows.reshape(-1, spec.nwords)
        vals = [spec.to_int(r) for r in rows]
        if pack_only:
            for i, v in enumerate(vals):
                out.append((i, [v]))
            continue
        j = jnp.asarray(rows)
        rev = np.asarray(bitops.reverse(j, spec))
        rc = np.asarray(bitops.revcomp(j, spec))
        # packing.lex_less is the row-wise a<b predicate; the reference's
        # lex_less/lex_greater transforms are (x<y)?x:y and (x>y)?x:y.
        less = np.asarray(packing.lex_less(j, jnp.asarray(rc)))[:, None]
        canon = np.where(less, rows, rc)
        canong = np.where(less, rc, rows)
        xor = np.asarray(bitops.kmer_xor(j, jnp.asarray(rc)))
        for i in range(rows.shape[0]):
            out.append((i, [vals[i], spec.to_int(rev[i]), spec.to_int(rc[i]),
                            spec.to_int(canon[i]), spec.to_int(canong[i]),
                            spec.to_int(xor[i])]))
    return out


@pytest.mark.parametrize("tag", sorted(CONFIGS))
def test_kmer_ops_bit_exact(ref_output, tag):
    ref = ref_output["windows"].get(tag)
    assert ref, f"reference produced no windows for {tag}"
    ours = _our_values(tag, ref_output["seqs"])
    assert len(ref) == len(ours)
    names = ["kmer", "reverse", "revcomp", "lex_less", "lex_greater",
             "xor_rev_comp"]
    for (rp, rv), (op, ov) in zip(ref, ours):
        assert rp == op
        for name, a, b in zip(names, rv, ov):
            assert a == b, (f"{tag} window {rp} {name}: "
                            f"ref={a:#x} ours={b:#x}")


@pytest.fixture(scope="module")
def ref_farm_output(tmp_path_factory) -> dict:
    """Compile the reference's own farmhash (ext/farmhash, farmhashna,
    FARMHASH_DEBUG=0) + Kmer packing and dump Hash64WithSeed digests —
    raw buffers 1..64 bytes and real k-mer byte streams (the farm
    functor's exact call, kmer_hash.hpp:288)."""
    build = tmp_path_factory.mktemp("reffarm")
    exe = _compile(build, "ref_farm",
                   str(REF / "ext/farmhash/src/farmhash.cc"))
    seqs = _sequences()
    out = subprocess.run(
        [str(exe)], input="\n".join(seqs) + "\n",
        check=True, capture_output=True, text=True).stdout
    bufs, kmers = [], {}
    for line in out.splitlines():
        f = line.split()
        if f[0] == "F":
            bufs.append((int(f[1]), int(f[2]), int(f[3], 16)))
        elif f[0] == "KF":
            kmers.setdefault(f[1], []).append(
                (int(f[2]), int(f[3]), int(f[4], 16)))
    return {"bufs": bufs, "kmers": kmers, "seqs": seqs}


def test_farmhash64_buffers_bit_exact(ref_farm_output):
    """Our u32-pair FarmHash64 == the compiled reference farmhash over
    every length 1..64 and four seeds (all three HashLen* branches)."""
    from kmerind_jax.ops import farmhash
    assert len(ref_farm_output["bufs"]) == 64 * 4
    for length, seed, want in ref_farm_output["bufs"]:
        data = bytes((i * 167 + length * 13 + 5) & 0xFF
                     for i in range(length))
        got = farmhash.hash64_bytes(data, seed)
        assert got == want, (length, seed, hex(got), hex(want))


_FARM_CONFIGS = {
    "DNA_k21_w64": (21, al.DNA),
    "DNA_k21_w32": (21, al.DNA),
    "DNA_k15_w64": (15, al.DNA),
    "DNA_k12_w64": (12, al.DNA),
    "DNA_k31_w64": (31, al.DNA),
    "DNA_k32_w64": (32, al.DNA),
    "DNA_k63_w64": (63, al.DNA),
    "DNA6_k21_w64": (21, al.DNA6),
    "DNA16_k15_w64": (15, al.DNA16),
    "DNA16_k16_w64": (16, al.DNA16),
}


@pytest.mark.parametrize("tag", sorted(_FARM_CONFIGS))
def test_farmhash64_kmer_bit_exact(ref_farm_output, tag):
    """hash64_kmers over OUR packed windows == Hash64WithSeed over the
    REFERENCE's kmer.getData() bytes — pins both the farmhash algorithm
    and the byte-stream reconstruction from the char-aligned word layout
    (incl. the 3-bit DNA6 case where the layouts differ)."""
    from kmerind_jax.ops import farmhash
    ref = ref_farm_output["kmers"].get(tag)
    assert ref, f"reference produced no farm digests for {tag}"
    k, alph = _FARM_CONFIGS[tag]
    spec = KmerSpec(k, alph)
    rows = []
    for s in ref_farm_output["seqs"]:
        if len(s) < k:
            continue
        codes = alph.encode(s)
        rows.extend(np.atleast_1d(spec.pack_codes(codes[i:i + k]))
                    for i in range(len(s) - k + 1))
    rows = np.stack(rows).reshape(-1, spec.nwords)
    j = jnp.asarray(rows)
    by_seed = {}
    for seed in (42, 83, 0, 0x12345678):
        hi, lo = farmhash.hash64_kmers(j, spec, seed)
        by_seed[seed] = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                         | np.asarray(lo).astype(np.uint64))
    n = rows.shape[0]
    assert len(ref) == 4 * n
    for i, (pos, seed, want) in enumerate(ref):
        got = int(by_seed[seed][i // 4])
        assert got == want, (tag, pos, seed, hex(got), hex(want))


def test_murmur3_x86_32_bit_exact(ref_output):
    for nbytes, seed, want in ref_output["murmur"]:
        buf = bytes((i * 131 + nbytes * 7 + 3) & 0xFF for i in range(nbytes))
        words = np.frombuffer(buf, dtype="<u4")[None, :]
        got = int(np.asarray(hashing.murmur3_32(jnp.asarray(words),
                                                seed=seed))[0])
        assert got == want, (nbytes, seed, hex(got), hex(want))


def test_quality_luts_bit_exact(ref_output):
    codecs = {"Illumina18": quality.ILLUMINA18,
              "Illumina13": quality.ILLUMINA13,
              "Illumina15": quality.ILLUMINA15}
    n64 = n32 = 0
    for preset, ctype, ascii_code, val in ref_output["qual"]:
        codec = codecs[preset]
        ours = float(codec.decode_lut[ascii_code - codec.min_input])
        if ctype == "f64":
            assert ours == val or (np.isinf(ours) and np.isinf(val)), (
                preset, ascii_code, ours.hex(), val.hex())
            n64 += 1
        else:  # reference float LUT vs our float64 LUT narrowed to float32
            if ours == float(np.finfo(np.float64).min):
                # numeric_limits<OutT>::lowest() is type-specific
                assert val == float(np.finfo(np.float32).min), (
                    preset, ascii_code, val)
            else:
                ours32 = float(np.float32(ours))
                assert ours32 == val or \
                    abs(ours32 - val) <= abs(np.spacing(np.float32(val))), (
                    preset, ascii_code, ours, val)
            n32 += 1
    assert n64 == 94 + 63 + 63 and n32 == 94


def test_quality_encode_lut_bit_exact(ref_output):
    """EncodeLUT bit-equality vs the compiled reference
    (quality_scores.hpp:216): our (q - 0.5L) long-double + %.17f pipeline
    must reproduce every hard-coded literal, incl. the MinScore
    lowest() substitutions."""
    codecs = {"Illumina18": quality.ILLUMINA18,
              "Illumina13": quality.ILLUMINA13,
              "Illumina15": quality.ILLUMINA15}
    n = 0
    for preset, q, val in ref_output["enc_lut"]:
        ours = float(codecs[preset].encode_lut[q])
        if val == float(np.finfo(np.float64).min):
            assert ours == float(np.finfo(np.float64).min) or q >= 94, (
                preset, q, ours)
        if q >= 94:
            # reference stores 0.0 rounding boundaries at 94/95 (decode 0);
            # our searchsorted ceiling uses +max — the ENCODE answers must
            # still agree (covered by test_quality_encode_parity)
            n += 1
            continue
        assert ours == val, (preset, q, ours.hex(), val.hex())
        n += 1
    assert n == 3 * 96


def test_quality_encode_parity(ref_output):
    """encode() bit-parity against the COMPILED reference over the full
    sweep (every decode value round-trips, every EncodeLUT boundary and
    its nextafter neighbors, min_score floor and the +-inf edges) —
    quality_scores.hpp:360-373."""
    codecs = {"Illumina18": quality.ILLUMINA18,
              "Illumina13": quality.ILLUMINA13,
              "Illumina15": quality.ILLUMINA15}
    n = 0
    for preset, v, want in ref_output["enc"]:
        codec = codecs[preset]
        got = int(codec.encode(np.array([v]))[0])
        assert got == want, (preset, float(v).hex(), got, want)
        n += 1
    assert n > 3 * (96 * 3 + 60)


# ---------------------------------------------------------------------------
# Parser + quality-window parity: tests/native_parity/ref_parse.cpp drives
# the reference's OWN SequentialFASTQParser / FASTAParser (serial paths, via
# SequencesIterator) and QualityScoreGenerationIterator over real fixtures.
# ---------------------------------------------------------------------------

FASTQ_FIXTURES = ["test.small.fastq", "natural.fastq", "natural.withN.fastq",
                  "test.unitiq1.fastq", "test.debruijn.small.fastq"]
FASTA_FIXTURES = ["test.fasta", "test.medium.fasta", "natural.withN.fasta",
                  "test.unitiqs.fasta", "test2.fasta"]


@pytest.fixture(scope="module")
def ref_parse_exe(tmp_path_factory) -> pathlib.Path:
    return _compile(tmp_path_factory.mktemp("refparse"), "ref_parse")


def _ref_records(exe, fmt: str, path: pathlib.Path):
    out = subprocess.run([str(exe), fmt, str(path)], check=True,
                         capture_output=True, text=True).stdout
    recs, qwins = [], {}
    for line in out.splitlines():
        f = line.split(" ", 5 if line.startswith("R") else 1)
        if f[0] == "R":
            seq, qual = f[5].rsplit(" ", 1)
            recs.append((int(f[2]), int(f[3]), seq, qual))
        elif f[0] == "Q21":
            rest = line.split()
            qwins[int(rest[1])] = [float.fromhex(x) for x in rest[2:]]
    return recs, qwins


def _our_records(fmt: str, path: pathlib.Path, engine: str):
    """(record_start, seq_global_offset, seq, qual) per record via this
    framework's parsers, using the identity (ASCII) alphabet so codes are
    the raw sequence bytes."""
    from kmerind_jax.io import files as iofiles
    batch = iofiles.read_file(str(path), al.ASCII, fmt=fmt, engine=engine)
    recs = []
    quals = []
    starts = np.asarray(batch.record_start, dtype=np.uint64)
    seg = np.asarray(batch.seg_id)
    codes = np.asarray(batch.codes, dtype=np.uint8)
    offs = np.asarray(batch.offset_in_record, dtype=np.uint64)
    qual = np.asarray(batch.qual, dtype=np.uint8)
    for r in range(starts.shape[0]):
        sel = seg == r
        seq = codes[sel].tobytes().decode("latin1")
        q = qual[sel].tobytes().decode("latin1") if fmt == "fastq" else "-"
        first = int(starts[r] + offs[sel][0]) if sel.any() else int(starts[r])
        recs.append((int(starts[r]), first, seq, q))
        quals.append(qual[sel])
    return recs, quals


@pytest.mark.parametrize("fixture", FASTQ_FIXTURES)
@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_fastq_parser_parity(ref_parse_exe, fixture, engine):
    path = REF / "test/data" / fixture
    if engine == "native":
        from kmerind_jax.io import native
        if not native.available():
            pytest.skip("native scanner not built")
    ref, _ = _ref_records(ref_parse_exe, "fastq", path)
    ours, _ = _our_records("fastq", path, engine)
    assert len(ref) == len(ours)
    for i, (r, o) in enumerate(zip(ref, ours)):
        assert r == o, f"record {i}: ref={r[:2]}+... ours={o[:2]}+..."


@pytest.mark.parametrize("fixture", FASTA_FIXTURES)
@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_fasta_parser_parity(ref_parse_exe, fixture, engine):
    path = REF / "test/data" / fixture
    if engine == "native":
        from kmerind_jax.io import native
        if not native.available():
            pytest.skip("native scanner not built")
    ref, _ = _ref_records(ref_parse_exe, "fasta", path)
    ours, _ = _our_records("fasta", path, engine)
    assert len(ref) == len(ours)
    for i, (r, o) in enumerate(zip(ref, ours)):
        assert r == o, f"record {i}: ref={r[:2]} ours={o[:2]}"


def _adversarial_fastq() -> bytes:
    """Records whose quality lines start with '@' / '+' — the inputs the
    4-line `@..+` heuristic exists to disambiguate."""
    rng = np.random.RandomState(7)
    out = []
    for i in range(40):
        n = int(rng.randint(8, 60))
        seq = "".join(rng.choice(list("ACGTN"), size=n))
        lead = "@+I"[i % 3]
        qual = lead + "".join(chr(int(c)) for c in rng.randint(33, 74,
                                                               size=n - 1))
        out.append(f"@read_{i} desc\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("source", ["test.small.fastq", "adversarial"])
def test_find_first_record_parity(ref_parse_exe, tmp_path, source):
    """Our find_record_start vs the reference's compiled find_first_record
    at EVERY split offset.  Reference semantics: a record starting exactly
    at the search start is NOT found unless the search starts at file start
    (it belongs to the left neighbor via the prefix shift); a block whose
    lines fit no marker pattern throws — ours returns len(data) there."""
    from kmerind_jax.io import fastq as iofastq
    if source == "adversarial":
        path = tmp_path / "adv.fastq"
        path.write_bytes(_adversarial_fastq())
    else:
        path = REF / "test/data" / source
    data = np.frombuffer(path.read_bytes(), dtype=np.uint8)
    n = data.shape[0]
    positions = list(range(n + 1))
    out = subprocess.run(
        [str(ref_parse_exe), "findfirst", str(path)],
        input="\n".join(str(p) for p in positions) + "\n",
        check=True, capture_output=True, text=True).stdout
    results = {}
    for line in out.splitlines():
        _, pos, r = line.split()
        results[int(pos)] = None if r == "THROW" else int(r)
    assert len(results) == len(positions)
    n_throw = 0
    for pos in positions:
        rel = iofastq.find_record_start(data[pos:], at_parent_start=(pos == 0))
        want = results[pos]
        if want is None:
            assert rel == n - pos, f"pos {pos}: ref threw, ours {rel}"
            n_throw += 1
        else:
            assert pos + rel == want, (f"pos {pos}: ref {want} "
                                       f"ours {pos + rel}")
    # the tail of the file can legitimately fit no pattern; the bulk must
    # have been real comparisons
    assert n_throw < n // 4


# ---------------------------------------------------------------------------
# End-to-end index-content parity: the harness's index_* modes run the
# reference's OWN KmerParser / KmerPositionTupleParser pipelines (NonEOL ->
# ASCII2 -> KmerGenerationIterator -> [zip with ShortSequenceKmerId]) over
# its own file parsers; only the final counter is a std::map.
# ---------------------------------------------------------------------------

def _ref_index(exe, mode: str, path: pathlib.Path):
    out = subprocess.run([str(exe), mode, str(path)], check=True,
                         capture_output=True, text=True).stdout
    counts: dict[str, dict[int, int]] = {}
    tuples = []
    for line in out.splitlines():
        f = line.split()
        if f[0] == "C":
            counts.setdefault(f[1], {})[int(f[2], 16)] = int(f[3])
        elif f[0] == "T":
            tuples.append((int(f[1], 16), int(f[2], 16)))
    return counts, tuples


INDEX_CONFIGS = [  # (ref tag, k, canonical)
    ("k21_canon", 21, True), ("k21_single", 21, False),
    ("k31_canon", 31, True),
]


@pytest.mark.parametrize("fixture,fmt", [
    ("test.small.fastq", "fastq"), ("natural.fastq", "fastq"),
    ("natural.withN.fastq", "fastq"), ("test.fasta", "fasta"),
    ("natural.withN.fasta", "fasta"),
])
def test_count_index_contents_parity(ref_parse_exe, fixture, fmt):
    """CountIndex contents == counts built from the reference's own parser +
    Kmer + lex_less code, per (k, strand) config."""
    from kmerind_jax.index import CountIndex
    path = REF / "test/data" / fixture
    counts, _ = _ref_index(ref_parse_exe, f"index_{fmt}", path)
    configs = list(INDEX_CONFIGS)
    if fmt == "fastq":
        configs += [("k63_canon", 63, True), ("k63_single", 63, False)]
    prefix = "fq" if fmt == "fastq" else "fa"
    for tag, k, canonical in configs:
        want = counts.get(f"{prefix}_{tag}")
        if want is None:
            continue
        spec = KmerSpec(k, al.DNA)
        idx = CountIndex(spec, canonical=canonical)
        idx.build(str(path))
        got = {int(ki): int(c) for ki, c in
               idx.count_if(lambda kw, c: jnp.ones_like(c, bool))}
        assert got == want, (
            f"{fixture} {tag}: {len(got)} vs {len(want)} distinct; "
            f"sample diff: "
            f"{list(set(got.items()) ^ set(want.items()))[:3]}")


@pytest.mark.parametrize("fixture", ["test.small.fastq", "natural.fastq",
                                     "test.unitiq1.fastq"])
def test_position_tuples_parity(ref_parse_exe, fixture):
    """(kmer, ShortSequenceKmerId) tuples from our fused extraction ==
    the reference's zip pipeline, as multisets (bit-exact 64-bit ids)."""
    from collections import Counter
    from kmerind_jax.io import files as iofiles
    from kmerind_jax.io.kmer_parsers import batch_to_arrays, extract_tuples
    path = REF / "test/data" / fixture
    _, ref_tuples = _ref_index(ref_parse_exe, "index_fastq", path)
    spec = KmerSpec(21, al.DNA)
    batch = iofiles.read_file(str(path), al.DNA, fmt="fastq")
    tup = extract_tuples(batch_to_arrays(batch, id_kind="short"), spec,
                         canonical=False)
    valid = np.asarray(tup.valid)
    words = np.asarray(tup.words)[valid]
    ids = ((np.asarray(tup.id_hi)[valid].astype(np.uint64) << np.uint64(32))
           | np.asarray(tup.id_lo)[valid].astype(np.uint64))
    ours = Counter((int(spec.to_ints(words[i:i + 1])[0]), int(ids[i]))
                   for i in range(words.shape[0]))
    assert ours == Counter(ref_tuples)


@pytest.mark.parametrize("fixture", ["test.debruijn.small.fastq",
                                     "test.debruijn.tiny.fastq",
                                     "natural.withN.fastq"])
def test_debruijn_edge_parity(ref_parse_exe, fixture):
    """(kmer, edge byte) tuples from our vectorized edge extraction == the
    reference's own KmerGenerationIterator x edge_iterator<_, DNA16> zip
    (the exact chain de_bruijn_parser::operator() assembles)."""
    from collections import Counter
    from kmerind_jax.io import files as iofiles
    from kmerind_jax.io.kmer_parsers import batch_to_arrays
    from kmerind_jax.ops import packing
    from kmerind_jax.debruijn import edges as dedges
    path = REF / "test/data" / fixture
    out = subprocess.run([str(ref_parse_exe), "debruijn", str(path)],
                         check=True, capture_output=True, text=True).stdout
    ref = Counter()
    for line in out.splitlines():
        _, kh, eh = line.split()
        ref[(int(kh, 16), int(eh, 16))] += 1
    spec = KmerSpec(21, al.DNA)
    # raw-byte parse + dual LUTs — exactly what DeBruijnGraph's build does
    batch = iofiles.read_file(str(path), al.ASCII, fmt="fastq")
    bases = batch_to_arrays(batch)
    kcodes = jnp.take(jnp.asarray(al.DNA.from_ascii),
                      bases.codes.astype(jnp.int32))
    words = np.asarray(packing.extract_kmers(kcodes, spec))
    valid = np.asarray(packing.window_valid(bases.valid, bases.seg_id,
                                            spec.k))
    ebytes = np.asarray(dedges.edge_bytes_for_windows(
        bases.codes, bases.valid, bases.seg_id, spec.k, al.DNA, raw=True))
    kints = spec.to_ints(words[valid])
    ours = Counter(zip((int(x) for x in kints),
                       (int(e) for e in ebytes[valid])))
    assert ours == ref, (
        f"{len(ours)} vs {len(ref)}; "
        f"sample diff {list((ours - ref).items())[:3]} / "
        f"{list((ref - ours).items())[:3]}")

    # and through the full DeBruijnGraph (single-strand): node counters ==
    # per-bit accumulation of the reference's tuples
    from kmerind_jax.debruijn import DeBruijnGraph
    g = DeBruijnGraph(spec, canonical=False)
    g.build(str(path))
    want: dict[int, list[int]] = {}
    for (ki, eb), mult in ref.items():
        cnt = want.setdefault(ki, [0] * 9)
        for _ in range(mult):
            cnt[8] += 1
            for b in range(4):
                if (eb >> b) & 1:
                    cnt[b] += 1
                if (eb >> (4 + b)) & 1:
                    cnt[4 + b] += 1
    got = g.to_dict()
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("fixture", ["test.small.fastq", "natural.fastq"])
def test_quality_window_parity(ref_parse_exe, fixture):
    """quality.window_quality (float32, tree-summed) vs the reference's
    QualityScoreGenerationIterator (double, serial circular sum): same
    exact zeros (any incorrect base), everything else equal to float32
    rounding of the same exp2-sum."""
    path = REF / "test/data" / fixture
    ref, qwins = _ref_records(ref_parse_exe, "fastq", path)
    ours, quals = _our_records("fastq", path, "numpy")
    checked = 0
    for (start, _o, _s, _q), q in zip(ours, quals):
        if start not in qwins:
            continue
        want = np.array(qwins[start], dtype=np.float64)
        nw = want.shape[0]
        got = np.asarray(quality.window_quality(jnp.asarray(q), 21))[:nw]
        zero = want == 0.0
        assert np.array_equal(got == 0.0, zero)
        np.testing.assert_allclose(got[~zero], want[~zero].astype(np.float32),
                                   rtol=2e-5)
        checked += nw
    assert checked > 50

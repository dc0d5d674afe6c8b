// Parity harness: compiles the REFERENCE's own serial header-only core
// (/root/reference/src/common/kmer.hpp, kmer_transform.hpp, alphabets.hpp,
// index/quality_scores.hpp, ext/smhasher/MurmurHash3.cpp) and dumps its
// outputs so tests/test_ref_parity.py can bit-compare them against this
// framework's implementations.
//
// This file is original test scaffolding written for kmerind_jax; it only
// *includes* the read-only reference headers (never copies them).  The full
// reference binaries cannot be built here (mxx/sparsehash/gtest submodules
// are empty and there is no MPI), but the serial k-mer data model needs
// none of that — so the core layer's parity is checked against the actual
// compiled reference code rather than only the Python oracle.
//
// Output (stdout, line-oriented):
//   K <tag> <pos> <kmer> <rev> <rc> <lexless> <lexgreater> <xor>   (hex big-ints)
//   H <nbytes> <seed> <hash32hex>                                  (MurmurHash3_x86_32)
//   Q <preset> <ctype> <ascii> <hexfloat>                          (DecodeLUT entry)
// Sequences are read from stdin, one per line; every configured
// (alphabet, K, word type) is applied to every line.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <string>
#include <cmath>
#include <limits>
#include <vector>

#include "common/alphabets.hpp"
#include "common/kmer.hpp"
#include "common/kmer_transform.hpp"
#include "index/quality_scores.hpp"
#include "smhasher/MurmurHash3.h"

// Hex big-integer of the kmer value: array element 0 holds the LSB of the
// packed kmer, the highest element the MSB + padding (kmer.hpp:78-100), so
// print words from high to low, zero-padded per word.
template <typename KM>
static std::string hexval(KM const &km) {
  auto const *d = km.getData();
  char buf[2 * sizeof(*d) + 1];
  std::string out;
  for (int i = (int)KM::nWords - 1; i >= 0; --i) {
    std::snprintf(buf, sizeof buf, "%0*llx", (int)(2 * sizeof(*d)),
                  (unsigned long long)d[i]);
    out += buf;
  }
  return out;
}

template <unsigned K, typename ALPHABET, typename WORD>
static void dump_windows(const char *tag, const std::string &seq) {
  using KM = bliss::common::Kmer<K, ALPHABET, WORD>;
  if (seq.size() < K) return;
  bliss::kmer::transform::lex_less<KM> lless;
  bliss::kmer::transform::lex_greater<KM> lgreater;
  bliss::kmer::transform::xor_rev_comp<KM> lxor;
  KM km;  // default ctor zero-initializes
  for (size_t i = 0; i + K <= seq.size(); ++i) {
    if (i == 0) {
      for (size_t j = 0; j < K; ++j)
        km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[j]]);
    } else {
      km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[i + K - 1]]);
    }
    KM rev = km.reverse();
    KM rc = km.reverse_complement();
    std::printf("K %s %zu %s %s %s %s %s %s\n", tag, i, hexval(km).c_str(),
                hexval(rev).c_str(), hexval(rc).c_str(),
                hexval(lless(km)).c_str(), hexval(lgreater(km)).c_str(),
                hexval(lxor(km)).c_str());
  }
}

// DNA_IUPAC / ASCII have NO do_reverse specialization in the reference
// (kmer.hpp:1619,1684 enable_if lists only DNA/RNA/DNA16/DNA6/RNA6), i.e.
// reverse()/reverse_complement() do not even compile for them — packing
// parity is all the reference itself supports for these alphabets.
template <unsigned K, typename ALPHABET, typename WORD>
static void dump_windows_pack_only(const char *tag, const std::string &seq) {
  using KM = bliss::common::Kmer<K, ALPHABET, WORD>;
  if (seq.size() < K) return;
  KM km;
  for (size_t i = 0; i + K <= seq.size(); ++i) {
    if (i == 0) {
      for (size_t j = 0; j < K; ++j)
        km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[j]]);
    } else {
      km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[i + K - 1]]);
    }
    std::printf("P %s %zu %s\n", tag, i, hexval(km).c_str());
  }
}

static void dump_all_configs(const std::string &seq) {
  using namespace bliss::common;
  dump_windows<21, DNA, uint64_t>("DNA_k21_w64", seq);
  dump_windows<21, DNA, uint32_t>("DNA_k21_w32", seq);
  dump_windows<21, DNA, uint16_t>("DNA_k21_w16", seq);
  dump_windows<31, DNA, uint64_t>("DNA_k31_w64", seq);
  dump_windows<32, DNA, uint64_t>("DNA_k32_w64", seq);  // full-word, no padding
  dump_windows<33, DNA, uint64_t>("DNA_k33_w64", seq);  // multi-word
  dump_windows<63, DNA, uint64_t>("DNA_k63_w64", seq);  // 2x u64
  dump_windows<5, DNA, uint64_t>("DNA_k5_w64", seq);
  dump_windows<21, RNA, uint64_t>("RNA_k21_w64", seq);
  dump_windows<21, DNA6, uint64_t>("DNA6_k21_w64", seq);   // 3-bit, non-pow2
  dump_windows<10, RNA6, uint64_t>("RNA6_k10_w64", seq);
  dump_windows<8, DNA16, uint64_t>("DNA16_k8_w64", seq);
  dump_windows<15, DNA16, uint64_t>("DNA16_k15_w64", seq);
  dump_windows<16, DNA16, uint64_t>("DNA16_k16_w64", seq);  // full-word 4-bit
  dump_windows_pack_only<9, DNA_IUPAC, uint64_t>("IUPAC_k9_w64", seq);
  dump_windows_pack_only<4, ASCII, uint64_t>("ASCII_k4_w64", seq);
}

static void dump_murmur() {
  // Deterministic byte patterns, lengths = multiples of 4 (the framework
  // hashes uint32 words as little-endian 4-byte blocks, tail empty).
  for (unsigned len = 4; len <= 64; len += 4) {
    std::vector<unsigned char> buf(len);
    for (unsigned i = 0; i < len; ++i)
      buf[i] = (unsigned char)((i * 131 + len * 7 + 3) & 0xFF);
    for (uint32_t seed : {0u, 42u, 0x9747B28Cu}) {
      uint32_t out = 0;
      MurmurHash3_x86_32(buf.data(), (int)len, seed, &out);
      std::printf("H %u %u %08x\n", len, seed, out);
    }
  }
}

template <typename CODEC>
static void dump_quality_preset(const char *name, const char *ctype, int lo,
                                int hi) {
  for (int a = lo; a <= hi; ++a) {
    double v = (double)CODEC::decode((unsigned char)a);
    std::printf("Q %s %s %d %a\n", name, ctype, a, v);
  }
}

static void dump_quality() {
  using namespace bliss::index;
  dump_quality_preset<Illumina18QualityScoreCodec<double>>("Illumina18", "f64",
                                                           33, 126);
  dump_quality_preset<Illumina18QualityScoreCodec<float>>("Illumina18", "f32",
                                                          33, 126);
  dump_quality_preset<Illumina13QualityScoreCodec<double>>("Illumina13", "f64",
                                                           64, 126);
  dump_quality_preset<Illumina15QualityScoreCodec<double>>("Illumina15", "f64",
                                                           64, 126);
}

// ENCODE parity: the reference's encode is an upper_bound search over the
// 96-entry EncodeLUT with begin/end floor/ceiling rules
// (quality_scores.hpp:216, 360-373).  Dump the encoded char for a value
// sweep that hits every interesting region: every decode-LUT value (the
// round-trip), every EncodeLUT boundary and its neighbors (one ULP-ish
// nudges via nextafter), midpoints, and the edges.
template <typename CODEC>
static void dump_quality_encode(const char *name, int lo, int hi) {
  std::vector<double> sweep;
  for (int a = lo; a <= hi; ++a)
    sweep.push_back((double)CODEC::decode((unsigned char)a));
  for (int q = 0; q < 96; ++q) {
    double b = (double)CODEC::EncodeLUT[q];
    std::printf("EL %s %d %a\n", name, q, b);
    sweep.push_back(b);
    sweep.push_back(std::nextafter(b, -1e308));
    sweep.push_back(std::nextafter(b, 1e308));
  }
  sweep.push_back(0.0);
  sweep.push_back(-1e-9);
  sweep.push_back(-40.0);
  sweep.push_back(-1e30);
  sweep.push_back(std::numeric_limits<double>::lowest());
  sweep.push_back(-std::numeric_limits<double>::infinity());
  sweep.push_back(std::numeric_limits<double>::infinity());
  for (double v : sweep)
    std::printf("E %s %a %u\n", name, v,
                (unsigned)CODEC::encode(v));
}

static void dump_quality_encode_all() {
  using namespace bliss::index;
  dump_quality_encode<Illumina18QualityScoreCodec<double>>("Illumina18", 33,
                                                           126);
  dump_quality_encode<Illumina13QualityScoreCodec<double>>("Illumina13", 64,
                                                           126);
  dump_quality_encode<Illumina15QualityScoreCodec<double>>("Illumina15", 64,
                                                           126);
}

int main() {
  std::string line;
  while (std::getline(std::cin, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (!line.empty()) dump_all_configs(line);
  }
  dump_murmur();
  dump_quality();
  dump_quality_encode_all();
  return 0;
}

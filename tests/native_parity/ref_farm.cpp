// FarmHash64 parity oracle: compiles the reference's own farmhash
// (/root/reference/ext/farmhash/src/farmhash.cc, namespace farmhashna via
// util::Hash64WithSeed, FARMHASH_DEBUG=0 — the production values the
// reference's farm functor sees, src/index/kmer_hash.hpp:288) plus the
// reference Kmer packing, and dumps:
//
//   F <len> <seed> <hash64hex>        Hash64WithSeed over a deterministic
//                                     byte pattern of each length 1..64
//   KF <tag> <pos> <seed> <hash64hex> Hash64WithSeed(kmer.getData(),
//                                     (nBits+7)/8, seed) per window kmer
//
// Sequences are read from stdin, one per line.  Original test scaffolding
// for kmerind_jax; only *includes* the read-only reference sources.

#include <cstdint>
#include <cstdio>
#include <string>
#include <iostream>
#include <vector>

#include "common/alphabets.hpp"
#include "common/kmer.hpp"
#include "farmhash/src/farmhash.h"

static const uint64_t SEEDS[] = {42u, 83u /* (42<<1)-1, the Prefix seed */,
                                 0u, 0x12345678u};

template <unsigned K, typename ALPHABET, typename WORD>
static void dump_kmer_farm(const char *tag, const std::string &seq) {
  using KM = bliss::common::Kmer<K, ALPHABET, WORD>;
  if (seq.size() < K) return;
  constexpr unsigned nBytes = (KM::nBits + 7) / 8;  // kmer_hash.hpp:291
  KM km;
  for (size_t i = 0; i + K <= seq.size(); ++i) {
    if (i == 0) {
      for (size_t j = 0; j < K; ++j)
        km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[j]]);
    } else {
      km.nextFromChar(ALPHABET::FROM_ASCII[(unsigned char)seq[i + K - 1]]);
    }
    for (uint64_t seed : SEEDS) {
      uint64_t h = util::Hash64WithSeed(
          reinterpret_cast<const char *>(km.getData()), nBytes, seed);
      std::printf("KF %s %zu %llu %016llx\n", tag, i,
                  (unsigned long long)seed, (unsigned long long)h);
    }
  }
}

static void dump_buffers() {
  for (unsigned len = 1; len <= 64; ++len) {
    std::vector<char> buf(len);
    for (unsigned i = 0; i < len; ++i)
      buf[i] = (char)((i * 167 + len * 13 + 5) & 0xFF);
    for (uint64_t seed : SEEDS) {
      uint64_t h = util::Hash64WithSeed(buf.data(), len, seed);
      std::printf("F %u %llu %016llx\n", len, (unsigned long long)seed,
                  (unsigned long long)h);
    }
  }
}

static void dump_all(const std::string &seq) {
  using namespace bliss::common;
  dump_kmer_farm<21, DNA, uint64_t>("DNA_k21_w64", seq);    // 6-byte stream
  dump_kmer_farm<21, DNA, uint32_t>("DNA_k21_w32", seq);    // same bytes
  dump_kmer_farm<15, DNA, uint64_t>("DNA_k15_w64", seq);    // 4 bytes
  dump_kmer_farm<12, DNA, uint64_t>("DNA_k12_w64", seq);    // 3 bytes
  dump_kmer_farm<31, DNA, uint64_t>("DNA_k31_w64", seq);    // 8 bytes
  dump_kmer_farm<32, DNA, uint64_t>("DNA_k32_w64", seq);    // full word
  dump_kmer_farm<63, DNA, uint64_t>("DNA_k63_w64", seq);    // 16 bytes
  dump_kmer_farm<21, DNA6, uint64_t>("DNA6_k21_w64", seq);  // 3-bit, 8 bytes
  dump_kmer_farm<15, DNA16, uint64_t>("DNA16_k15_w64", seq); // 8 bytes (7.5)
  dump_kmer_farm<16, DNA16, uint64_t>("DNA16_k16_w64", seq); // 8 bytes full
}

int main() {
  std::string line;
  while (std::getline(std::cin, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (!line.empty()) dump_all(line);
  }
  dump_buffers();
  return 0;
}

// Parity harness #2: drives the REFERENCE's own serial FASTQ/FASTA parsers
// (io/fastq_loader.hpp SequentialFASTQParser, io/fasta_loader.hpp
// FASTAParser via io/sequence_iterator.hpp) and its quality sliding window
// (index/quality_score_iterator.hpp) over real files, dumping per-record
// boundaries and per-window scores for tests/test_ref_parity.py to compare
// against this framework's io/ and quality modules.
//
// Original test scaffolding for kmerind_jax — includes the read-only
// reference headers, copies nothing.
//
// Usage: ref_parse (fastq|fasta) <path>
// Output:
//   R <fmt> <record_pos> <seq_global_offset> <record_size> <seq> <qual|->
//   Q21 <record_pos> <%a window scores...>      (FASTQ, seqs >= 21 chars)

#include <cstdio>
#include <iostream>
#include <fstream>
#include <iterator>
#include <string>
#include <vector>

#include <map>

#include "common/kmer.hpp"
#include "common/kmer_transform.hpp"
#include "index/quality_score_iterator.hpp"
#include "index/quality_scores.hpp"
#include "io/fasta_loader.hpp"
#include "io/fastq_loader.hpp"
#include "io/kmer_parser.hpp"
#include "io/sequence_iterator.hpp"
#include "debruijn/edge_iterator.hpp"  // -I<ref>/test/test

using RangeT = bliss::partition::range<size_t>;

static std::string slurp(const char *p) {
  std::ifstream f(p, std::ios::binary);
  return std::string((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
}

static void run_fastq(const std::string &data) {
  const char *d = data.data();
  RangeT r(0, data.size());
  bliss::io::SequentialFASTQParser<const char *> parser;
  parser.init_parser(d, r, r, r);
  using SeqIter =
      bliss::io::SequencesIterator<const char *,
                                   bliss::io::SequentialFASTQParser>;
  SeqIter it(parser, d, d + data.size(), 0);
  SeqIter end(d + data.size());
  for (; it != end; ++it) {
    auto const &s = *it;
    std::string sq(s.seq_begin, s.seq_end);
    std::string qu(s.qual_begin, s.qual_end);
    std::printf("R fastq %zu %zu %zu %s %s\n", (size_t)s.id.get_pos(),
                s.seq_global_offset(), s.record_size, sq.c_str(), qu.c_str());
    if (qu.size() >= 21) {
      using QIter = bliss::index::QualityScoreGenerationIterator<
          const char *, 21, bliss::index::Illumina18QualityScoreCodec<double>>;
      const char *qb = &*s.qual_begin;
      QIter qit(qb, true);
      size_t nw = qu.size() - 21 + 1;
      std::printf("Q21 %zu", (size_t)s.id.get_pos());
      for (size_t i = 0; i < nw; ++i) {
        std::printf(" %a", (double)*qit);
        if (i + 1 < nw) ++qit;
      }
      std::printf("\n");
    }
  }
}

static void run_fasta(const std::string &data) {
  const char *d = data.data();
  RangeT r(0, data.size());
  bliss::io::FASTAParser<const char *> parser;
  parser.init_parser(d, r, r, r);
  using SeqIter =
      bliss::io::SequencesIterator<const char *, bliss::io::FASTAParser>;
  SeqIter it(parser, d, d + data.size(), 0);
  SeqIter end(d + data.size());
  for (; it != end; ++it) {
    auto const &s = *it;
    // the reference strips EOLs downstream via the NonEOL filter iterator
    // (io/kmer_parser.hpp:79); apply the same here so the dumped sequence
    // is the k-mer-ized character stream
    std::string sq;
    for (auto p = s.seq_begin; p != s.seq_end; ++p)
      if (*p != '\n' && *p != '\r') sq += *p;
    std::printf("R fasta %zu %zu %zu %s -\n", (size_t)s.id.get_pos(),
                s.seq_global_offset(), s.record_size, sq.c_str());
  }
}

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

// End-to-end index-content parity: run the reference's OWN k-mer parser
// pipelines (io/kmer_parser.hpp KmerParser / KmerPositionTupleParser —
// NonEOL filter -> ASCII2 -> KmerGenerationIterator [-> zip with id]) over
// every record from its own file parser, and emit
//   C <tag> <kmer_hex> <count>      count-index contents (std::map is just
//                                   the counter; all semantics are the
//                                   reference's)
//   T <kmer_hex> <id_hex>           (kmer, ShortSequenceKmerId) tuples in
//                                   parse order (FASTQ, K=21, single strand)
template <unsigned K, typename SEQITER>
static void count_records(const char *tag_canon, const char *tag_single,
                          SEQITER it, SEQITER end, size_t file_size) {
  using KM = bliss::common::Kmer<K, bliss::common::DNA, uint64_t>;
  bliss::index::kmer::KmerParser<KM> kparser(
      bliss::partition::range<size_t>(0, file_size));
  bliss::kmer::transform::lex_less<KM> lless;
  std::map<std::string, unsigned long long> canon, single;
  for (; it != end; ++it) {
    auto const &s = *it;
    for (auto kit = kparser.begin(s); kit != kparser.end(s); ++kit) {
      KM km = *kit;
      ++single[hexval(km)];
      ++canon[hexval(lless(km))];
    }
  }
  for (auto const &kv : canon)
    std::printf("C %s %s %llu\n", tag_canon, kv.first.c_str(), kv.second);
  for (auto const &kv : single)
    std::printf("C %s %s %llu\n", tag_single, kv.first.c_str(), kv.second);
}

static void run_index(const std::string &data, bool fasta) {
  const char *d = data.data();
  RangeT r(0, data.size());
  if (fasta) {
    bliss::io::FASTAParser<const char *> parser;
    parser.init_parser(d, r, r, r);
    using SeqIter =
        bliss::io::SequencesIterator<const char *, bliss::io::FASTAParser>;
    count_records<21>("fa_k21_canon", "fa_k21_single",
                      SeqIter(parser, d, d + data.size(), 0),
                      SeqIter(d + data.size()), data.size());
    count_records<31>("fa_k31_canon", "fa_k31_single",
                      SeqIter(parser, d, d + data.size(), 0),
                      SeqIter(d + data.size()), data.size());
    return;
  }
  bliss::io::SequentialFASTQParser<const char *> parser;
  parser.init_parser(d, r, r, r);
  using SeqIter =
      bliss::io::SequencesIterator<const char *,
                                   bliss::io::SequentialFASTQParser>;
  count_records<21>("fq_k21_canon", "fq_k21_single",
                    SeqIter(parser, d, d + data.size(), 0),
                    SeqIter(d + data.size()), data.size());
  count_records<31>("fq_k31_canon", "fq_k31_single",
                    SeqIter(parser, d, d + data.size(), 0),
                    SeqIter(d + data.size()), data.size());
  count_records<63>("fq_k63_canon", "fq_k63_single",
                    SeqIter(parser, d, d + data.size(), 0),
                    SeqIter(d + data.size()), data.size());
  // (kmer, position id) tuples via the reference's own zip pipeline
  using KM = bliss::common::Kmer<21, bliss::common::DNA, uint64_t>;
  using Tuple = std::pair<KM, bliss::common::ShortSequenceKmerId>;
  bliss::index::kmer::KmerPositionTupleParser<Tuple> pparser(r);
  for (SeqIter it(parser, d, d + data.size(), 0), end(d + data.size());
       it != end; ++it) {
    auto const &s = *it;
    for (auto pit = pparser.begin(s); pit != pparser.end(s); ++pit) {
      Tuple t = *pit;
      std::printf("T %s %016llx\n", hexval(t.first).c_str(),
                  (unsigned long long)t.second.id);
    }
  }
}

// De Bruijn (kmer, edge-byte) tuples via the reference's own iterator
// pipeline — exactly the chain de_bruijn_parser::operator() builds
// (de_bruijn_construct_engine.hpp:109-158: NonEOL -> ASCII2 ->
// KmerGenerationIterator zipped with edge_iterator<_, DNA16>); the engine
// header itself unconditionally includes mpi.h so the chain is assembled
// here instead.  Emits "D <kmer_hex> <edge_byte_hex>" in parse order.
static void run_debruijn(const std::string &data) {
  using namespace bliss;
  using KM = common::Kmer<21, common::DNA, uint64_t>;
  const char *d = data.data();
  RangeT r(0, data.size());
  io::SequentialFASTQParser<const char *> parser;
  parser.init_parser(d, r, r, r);
  using SeqIter =
      io::SequencesIterator<const char *, io::SequentialFASTQParser>;
  using CharIter = index::kmer::NonEOLIter<const char *>;
  using BaseCharIterator = bliss::iterator::transform_iterator<
      CharIter, common::ASCII2<common::DNA>>;
  using KmerIter = common::KmerGenerationIterator<BaseCharIterator, KM>;
  using EdgeIterType =
      de_bruijn::iterator::edge_iterator<CharIter, common::DNA16>;
  utils::file::NotEOL neol;
  for (SeqIter it(parser, d, d + data.size(), 0), end(d + data.size());
       it != end; ++it) {
    auto const &s = *it;
    if (s.seq_begin == s.seq_end) continue;
    KmerIter kit(BaseCharIterator(CharIter(neol, s.seq_begin, s.seq_end),
                                  common::ASCII2<common::DNA>()),
                 true);
    KmerIter kend(BaseCharIterator(CharIter(neol, s.seq_end),
                                   common::ASCII2<common::DNA>()),
                  false);
    EdgeIterType eit(CharIter(neol, s.seq_begin, s.seq_end),
                     CharIter(neol, s.seq_end), KM::size);
    for (; kit != kend; ++kit, ++eit)
      std::printf("D %s %02x\n", hexval(*kit).c_str(), (unsigned)*eit);
  }
}

// Drive the reference's serial `find_first_record` (the `@..+` 4-line
// boundary heuristic, fastq_loader.hpp:269-358) at arbitrary split offsets
// read from stdin.  Prints "F <pos> <found>" or "F <pos> THROW" (the
// reference throws logic_error when no marker pattern fits the block).
static void run_findfirst(const std::string &data) {
  const char *d = data.data();
  RangeT whole(0, data.size());
  bliss::io::SequentialFASTQParser<const char *> parser;
  std::string line;
  while (std::getline(std::cin, line)) {
    if (line.empty()) continue;
    size_t pos = std::stoull(line);
    RangeT search(pos, data.size());
    try {
      size_t r = parser.find_first_record(d, whole, whole, search);
      std::printf("F %zu %zu\n", pos, r);
    } catch (...) {
      std::printf("F %zu THROW\n", pos);
    }
  }
}

int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s (fastq|fasta|findfirst) <path>\n",
                 argv[0]);
    return 2;
  }
  std::string data = slurp(argv[2]);
  std::string mode(argv[1]);
  if (mode == "fastq")
    run_fastq(data);
  else if (mode == "findfirst")
    run_findfirst(data);
  else if (mode == "index_fastq")
    run_index(data, false);
  else if (mode == "index_fasta")
    run_index(data, true);
  else if (mode == "debruijn")
    run_debruijn(data);
  else
    run_fasta(data);
  return 0;
}

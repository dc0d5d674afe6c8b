// fastscan — native single-pass FASTQ/FASTA scanners.
//
// Columnar counterpart of the reference's C++ parsing stack
// (/root/reference/src/io/fastq_loader.hpp get_next_record :389-490,
// fasta_loader.hpp get_next_record :618+): where the reference walks
// per-character iterators lazily, these scanners make ONE fused pass over a
// byte block and emit the framework's columnar ReadBatch arrays directly
// (codes translated through the alphabet LUT, per-base record ids, raw byte
// offsets, quality bytes), so host parsing keeps up with chip ingest on
// weak host cores where multi-pass numpy parsing cannot.
//
// Large blocks parse multi-threaded: ranges split at record boundaries
// (the same mid-block heuristics the partitioned block readers use), a
// cheap counting pass sizes each thread's output slice, then threads fill
// disjoint slices in parallel — bit-identical output to the serial walk.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>

#include <thread>
#include <vector>

// Error codes (negative returns)
enum {
  FS_ERR_TRUNCATED = -1,   // incomplete trailing record
  FS_ERR_BAD_HEADER = -2,  // record does not start with '@'
  FS_ERR_BAD_PLUS = -3,    // separator line does not start with '+'
  FS_ERR_LEN_MISMATCH = -4,  // quality length != sequence length
  FS_ERR_CAPACITY = -5,    // output capacity exceeded
};

namespace {

inline const uint8_t* find_eol(const uint8_t* p, const uint8_t* end) {
  const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
  return nl ? static_cast<const uint8_t*>(nl) : end;
}

inline const uint8_t* line_end(const uint8_t* start, const uint8_t* eol) {
  // trim ALL trailing \r bytes (the reference's NotEOL predicate drops
  // every \r, file_utils.hpp:43-53)
  while (eol > start && eol[-1] == '\r') --eol;
  return eol;
}

struct RangeOut {
  int64_t nrec = 0;  // records emitted (or counted)
  int64_t nb = 0;    // bases emitted (or counted)
  int64_t err = 0;   // 0 or FS_ERR_*
};

// Walk FASTQ records in [p, end).  fill=false only counts; fill=true
// writes outputs at rec_base / base_base offsets (capacities are absolute).
RangeOut fastq_range(const uint8_t* data, const uint8_t* p,
                     const uint8_t* end, const uint8_t* from_ascii,
                     int64_t file_offset, bool fill, int64_t rec_base,
                     int64_t base_base, uint64_t* record_start,
                     int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                     int32_t* seg_id, uint32_t* offset_in_record,
                     uint64_t* global_pos, int64_t nbase_cap) {
  RangeOut r;
  int64_t nrec = rec_base;
  int64_t nb = base_base;
  while (p < end) {
    // skip blank lines between records
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    const uint8_t* rec = p;
    if (*p != '@') { r.err = FS_ERR_BAD_HEADER; return r; }
    // line 1: header
    const uint8_t* eol = find_eol(p, end);
    if (eol >= end) { r.err = FS_ERR_TRUNCATED; return r; }
    p = eol + 1;
    // line 2: sequence
    const uint8_t* seq = p;
    eol = find_eol(p, end);
    const uint8_t* seq_end = line_end(seq, eol);
    if (eol >= end) { r.err = FS_ERR_TRUNCATED; return r; }
    p = eol + 1;
    // line 3: '+'
    if (p >= end || *p != '+') { r.err = FS_ERR_BAD_PLUS; return r; }
    eol = find_eol(p, end);
    if (eol >= end) { r.err = FS_ERR_TRUNCATED; return r; }
    p = eol + 1;
    // line 4: quality
    const uint8_t* qual = p;
    eol = find_eol(p, end);
    const uint8_t* qual_end = line_end(qual, eol);
    p = (eol < end) ? eol + 1 : end;

    const int64_t slen = seq_end - seq;
    if (qual_end - qual != slen) { r.err = FS_ERR_LEN_MISMATCH; return r; }
    if (fill) {
      if (nrec >= nrec_cap || nb + slen > nbase_cap) {
        r.err = FS_ERR_CAPACITY;
        return r;
      }
      record_start[nrec] = static_cast<uint64_t>(file_offset + (rec - data));
      const uint32_t seq_off0 = static_cast<uint32_t>(seq - rec);
      const uint64_t gpos0 = static_cast<uint64_t>(file_offset + (seq - data));
      const int32_t seg = static_cast<int32_t>(nrec);
      for (int64_t i = 0; i < slen; ++i) {
        codes[nb + i] = from_ascii[seq[i]];
        quals[nb + i] = qual[i];
        seg_id[nb + i] = seg;
        offset_in_record[nb + i] = seq_off0 + static_cast<uint32_t>(i);
        global_pos[nb + i] = gpos0 + static_cast<uint64_t>(i);
      }
    }
    nb += slen;
    ++nrec;
  }
  r.nrec = nrec - rec_base;
  r.nb = nb - base_base;
  return r;
}

// Walk FASTA lines in [p, end).  `leading` >= 0 means the range begins
// inside a record whose header-run starts at absolute position `leading`
// (record index rec_base-1 .. i.e. the CURRENT record is rec_base with
// record_start already written by the caller when filling); prev_hdr is
// the header-ness of the line just before the range.
RangeOut fasta_range(const uint8_t* data, const uint8_t* p,
                     const uint8_t* end, const uint8_t* from_ascii,
                     int64_t file_offset, bool have_open_record,
                     bool prev_hdr, bool fill, int64_t rec_base,
                     int64_t base_base, uint64_t* record_start,
                     int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                     int32_t* seg_id, uint32_t* offset_in_record,
                     uint64_t* global_pos, int64_t nbase_cap) {
  RangeOut r;
  int64_t nrec = rec_base;  // count INCLUDING any open leading record
  int64_t nb = base_base;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '>' || *p == ';') {  // header line
      if (!prev_hdr) {             // first line of a run => record start
        if (fill) {
          if (nrec >= nrec_cap) { r.err = FS_ERR_CAPACITY; return r; }
          record_start[nrec] =
              static_cast<uint64_t>(file_offset + (p - data));
        }
        ++nrec;
      }
      prev_hdr = true;
      p = find_eol(p, end);
      continue;
    }
    prev_hdr = false;
    if (nrec == 0 && !have_open_record) {
      r.err = FS_ERR_BAD_HEADER;
      return r;
    }
    // sequence line
    const uint8_t* eol = find_eol(p, end);
    const uint8_t* sl_end = line_end(p, eol);
    const int64_t slen = sl_end - p;
    if (fill) {
      if (nb + slen > nbase_cap) { r.err = FS_ERR_CAPACITY; return r; }
      const int32_t seg = static_cast<int32_t>(nrec - 1);
      const uint64_t rec_pos = record_start[nrec - 1];
      const uint64_t gpos0 = static_cast<uint64_t>(file_offset + (p - data));
      for (int64_t i = 0; i < slen; ++i) {
        codes[nb + i] = from_ascii[p[i]];
        quals[nb + i] = 0;
        seg_id[nb + i] = seg;
        offset_in_record[nb + i] =
            static_cast<uint32_t>(gpos0 - rec_pos + i);
        global_pos[nb + i] = gpos0 + static_cast<uint64_t>(i);
      }
    }
    nb += slen;
    p = eol;
  }
  r.nrec = nrec - rec_base;
  r.nb = nb - base_base;
  return r;
}

int64_t fastq_find_start(const uint8_t* data, int64_t n,
                         int32_t at_parent_start);

// First FASTA record start (header-run start) at-or-after `cut`,
// back-scanning (bounded) for the previous line's header-ness.
// Returns n if none.
int64_t fasta_find_start(const uint8_t* data, int64_t n, int64_t cut) {
  const uint8_t* end = data + n;
  // find the start of the line containing/following cut
  const uint8_t* p = data + cut;
  if (cut > 0 && data[cut - 1] != '\n') p = find_eol(p, end);
  // previous VISIBLE line's first char (bounded back-scan)
  bool prev_hdr = false;
  if (p > data) {
    const uint8_t* q = p;  // q points at '\n' terminator region start
    // step back over the just-terminated line to its start
    const uint8_t* line_e = q;
    while (line_e > data && (line_e[-1] == '\n' || line_e[-1] == '\r'))
      --line_e;
    const uint8_t* line_s = line_e;
    const int64_t lim = 1 << 20;
    while (line_s > data && line_s[-1] != '\n' && line_e - line_s < lim)
      --line_s;
    prev_hdr = line_s < line_e && (*line_s == '>' || *line_s == ';');
  }
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '>' || *p == ';') {
      if (!prev_hdr) return p - data;
      prev_hdr = true;
    } else {
      prev_hdr = false;
    }
    p = find_eol(p, end);
  }
  return n;
}

// Shared multi-threaded driver: boundaries[t] delimit T ranges that each
// start at a record boundary; count pass sizes slices, fill pass writes.
template <typename CountFn, typename FillFn>
int64_t parse_mt(int64_t T, const std::vector<int64_t>& bounds,
                 CountFn count_fn, FillFn fill_fn, int64_t nrec_cap,
                 int64_t nbase_cap, int64_t* out_nbases) {
  std::vector<RangeOut> counts(T);
  {
    std::vector<std::thread> ths;
    for (int64_t t = 0; t < T; ++t)
      ths.emplace_back(
          [&, t] { counts[t] = count_fn(bounds[t], bounds[t + 1]); });
    for (auto& th : ths) th.join();
  }
  int64_t nrec = 0, nb = 0;
  std::vector<int64_t> rec_base(T), base_base(T);
  for (int64_t t = 0; t < T; ++t) {
    if (counts[t].err) return counts[t].err;
    rec_base[t] = nrec;
    base_base[t] = nb;
    nrec += counts[t].nrec;
    nb += counts[t].nb;
  }
  if (nrec > nrec_cap || nb > nbase_cap) return FS_ERR_CAPACITY;
  std::vector<RangeOut> fills(T);
  {
    std::vector<std::thread> ths;
    for (int64_t t = 0; t < T; ++t)
      ths.emplace_back([&, t] {
        fills[t] = fill_fn(bounds[t], bounds[t + 1], rec_base[t],
                           base_base[t]);
      });
    for (auto& th : ths) th.join();
  }
  for (int64_t t = 0; t < T; ++t)
    if (fills[t].err) return fills[t].err;
  *out_nbases = nb;
  return nrec;
}

}  // namespace

extern "C" {

// Parse a FASTQ block that begins at a record boundary.
//
// data[0..n): block bytes.  from_ascii: 256-entry alphabet LUT.
// file_offset: absolute position of data[0] (for global ids).
// nthreads: parallel ranges for large blocks (<=1 = serial).
//
// Outputs (caller-allocated):
//   per record (cap nrec_cap): record_start (absolute), seq_index base
//     handled by caller; per base (cap nbase_cap): codes, quals, seg_id,
//     offset_in_record (raw bytes from record start), global_pos.
//
// Returns the number of records parsed (>= 0) and writes the base count to
// *out_nbases, or a negative FS_ERR_*.
int64_t fastq_parse_mt(const uint8_t* data, int64_t n,
                       const uint8_t* from_ascii, int64_t file_offset,
                       int32_t nthreads, uint64_t* record_start,
                       int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                       int32_t* seg_id, uint32_t* offset_in_record,
                       uint64_t* global_pos, int64_t nbase_cap,
                       int64_t* out_nbases) {
  int64_t T = nthreads;
  if (T < 1) T = 1;
  if (n < (4 << 20)) T = 1;  // thread setup not worth it on small blocks
  std::vector<int64_t> bounds;
  bounds.push_back(0);
  for (int64_t t = 1; t < T; ++t) {
    int64_t cut = n * t / T;
    if (cut <= bounds.back()) continue;
    int64_t b = cut + fastq_find_start(data + cut, n - cut, 0);
    // the 4-line heuristic is NOT monotone (a pathological cluster can
    // defeat one cut while later cuts land in clean regions) — keep
    // probing instead of breaking
    if (b >= n) continue;
    if (b > bounds.back()) bounds.push_back(b);
  }
  bounds.push_back(n);
  T = static_cast<int64_t>(bounds.size()) - 1;

  auto count_fn = [&](int64_t s, int64_t e) {
    return fastq_range(data, data + s, data + e, from_ascii, file_offset,
                       false, 0, 0, nullptr, 0, nullptr, nullptr, nullptr,
                       nullptr, nullptr, 0);
  };
  auto fill_fn = [&](int64_t s, int64_t e, int64_t rb, int64_t bb) {
    return fastq_range(data, data + s, data + e, from_ascii, file_offset,
                       true, rb, bb, record_start, nrec_cap, codes, quals,
                       seg_id, offset_in_record, global_pos, nbase_cap);
  };
  if (T > 1) {
    int64_t r = parse_mt(T, bounds, count_fn, fill_fn, nrec_cap, nbase_cap,
                         out_nbases);
    // A pathological record mix (e.g. empty sequence lines collapsing the
    // 4-line cycle) can defeat the mid-block boundary heuristic and fail
    // a range that the serial walk accepts — fall back rather than reject
    // input whose validity would otherwise depend on the thread count.
    if (r >= 0 || r == FS_ERR_CAPACITY) return r;
  }
  RangeOut r = fill_fn(0, n, 0, 0);
  if (r.err) return r.err;
  *out_nbases = r.nb;
  return r.nrec;
}

// Back-compatible serial entry.
int64_t fastq_parse(const uint8_t* data, int64_t n, const uint8_t* from_ascii,
                    int64_t file_offset, uint64_t* record_start,
                    int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                    int32_t* seg_id, uint32_t* offset_in_record,
                    uint64_t* global_pos, int64_t nbase_cap,
                    int64_t* out_nbases) {
  return fastq_parse_mt(data, n, from_ascii, file_offset, 1, record_start,
                        nrec_cap, codes, quals, seg_id, offset_in_record,
                        global_pos, nbase_cap, out_nbases);
}

// Parse a FASTA block.
//
// Both '>' and ';' start header lines, and a RUN of consecutive header
// lines is ONE record header (the reference's mxx::unique collapse on the
// header flag, fasta_loader.hpp:295-325): a record starts at a header line
// whose previous visible line is not a header.  Blank lines are invisible
// (they neither break a header run nor contribute sequence).
// Same output layout as fastq_parse; quals are zero-filled.
//
// Block-parallel context (the numpy parser's leading_record_start /
// prev_line_is_header contract, io/fasta.py parse_fasta): when a block
// slice begins mid-record, `leading_record_start` is the ABSOLUTE file
// position of the containing record's header-run start (-1 = the block
// begins at a record header) and leading sequence lines belong to that
// record; `prev_line_is_header` says whether the line just before the
// slice is a header line, so a header run spanning the slice start does
// not open a second record.
int64_t fasta_parse_mt(const uint8_t* data, int64_t n,
                       const uint8_t* from_ascii, int64_t file_offset,
                       int64_t leading_record_start,
                       int32_t prev_line_is_header, int32_t nthreads,
                       uint64_t* record_start, int64_t nrec_cap,
                       uint8_t* codes, uint8_t* quals, int32_t* seg_id,
                       uint32_t* offset_in_record, uint64_t* global_pos,
                       int64_t nbase_cap, int64_t* out_nbases) {
  const bool open = leading_record_start >= 0;
  int64_t rec0 = 0;
  if (open) {
    if (nrec_cap < 1) return FS_ERR_CAPACITY;
    record_start[0] = static_cast<uint64_t>(leading_record_start);
    rec0 = 1;
  }
  int64_t T = nthreads;
  if (T < 1) T = 1;
  if (n < (4 << 20)) T = 1;
  std::vector<int64_t> bounds;
  bounds.push_back(0);
  for (int64_t t = 1; t < T; ++t) {
    int64_t cut = n * t / T;
    if (cut <= bounds.back()) continue;
    int64_t b = fasta_find_start(data, n, cut);
    if (b >= n) break;  // monotone in cut: later cuts find nothing either
    if (b > bounds.back()) bounds.push_back(b);
  }
  bounds.push_back(n);
  T = static_cast<int64_t>(bounds.size()) - 1;

  // Range 0 inherits the caller's leading context; ranges 1.. start at a
  // record boundary (no open record, previous line is not a header by
  // construction of fasta_find_start).
  auto count_fn = [&](int64_t s, int64_t e) {
    const bool first = s == 0;
    RangeOut r = fasta_range(
        data, data + s, data + e, from_ascii, file_offset,
        first ? open : false, first ? (prev_line_is_header != 0) : false,
        false, first ? rec0 : 0, 0, record_start, nrec_cap, nullptr,
        nullptr, nullptr, nullptr, nullptr, 0);
    if (first) r.nrec += rec0;  // report TOTAL records for slicing
    return r;
  };
  auto fill_fn = [&](int64_t s, int64_t e, int64_t rb, int64_t bb) {
    const bool first = s == 0;
    // range 0's records start after the pre-written open record (rec0);
    // later ranges use the prefix-sum base (which already includes rec0
    // via count_fn's total for range 0)
    return fasta_range(
        data, data + s, data + e, from_ascii, file_offset,
        first ? open : false, first ? (prev_line_is_header != 0) : false,
        true, first ? rec0 : rb, bb,
        record_start, nrec_cap, codes, quals, seg_id, offset_in_record,
        global_pos, nbase_cap);
  };
  if (T == 1) {
    RangeOut r = fasta_range(data, data, data + n, from_ascii, file_offset,
                             open, prev_line_is_header != 0, true, rec0, 0,
                             record_start, nrec_cap, codes, quals, seg_id,
                             offset_in_record, global_pos, nbase_cap);
    if (r.err) return r.err;
    *out_nbases = r.nb;
    return r.nrec + rec0;
  }
  return parse_mt(T, bounds, count_fn, fill_fn, nrec_cap, nbase_cap,
                  out_nbases);
}

// Back-compatible context entry (serial or threaded by caller choice).
int64_t fasta_parse_ctx(const uint8_t* data, int64_t n,
                        const uint8_t* from_ascii, int64_t file_offset,
                        int64_t leading_record_start,
                        int32_t prev_line_is_header, uint64_t* record_start,
                        int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                        int32_t* seg_id, uint32_t* offset_in_record,
                        uint64_t* global_pos, int64_t nbase_cap,
                        int64_t* out_nbases) {
  return fasta_parse_mt(data, n, from_ascii, file_offset,
                        leading_record_start, prev_line_is_header, 1,
                        record_start, nrec_cap, codes, quals, seg_id,
                        offset_in_record, global_pos, nbase_cap, out_nbases);
}

// Back-compatible entry: block begins at a record header.
int64_t fasta_parse(const uint8_t* data, int64_t n, const uint8_t* from_ascii,
                    int64_t file_offset, uint64_t* record_start,
                    int64_t nrec_cap, uint8_t* codes, uint8_t* quals,
                    int32_t* seg_id, uint32_t* offset_in_record,
                    uint64_t* global_pos, int64_t nbase_cap,
                    int64_t* out_nbases) {
  return fasta_parse_ctx(data, n, from_ascii, file_offset, -1, 0,
                         record_start, nrec_cap, codes, quals, seg_id,
                         offset_in_record, global_pos, nbase_cap, out_nbases);
}

// Locate the first FASTQ record start in a mid-file block — the 4-line
// '@..+' / '+..@' disambiguation (fastq_loader.hpp:269-358).
// Returns the offset, or n if not found.
int64_t fastq_find_record_start(const uint8_t* data, int64_t n,
                                int32_t at_parent_start) {
  const uint8_t* end = data + n;
  // collect up to 4 line-start first-chars + offsets
  const uint8_t* starts[4];
  int cnt = 0;
  const uint8_t* p = data;
  if (!at_parent_start) {
    // skip the partial first line
    if (p < end && *p != '\n' && *p != '\r') p = find_eol(p, end);
  }
  while (p < end && cnt < 4) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    starts[cnt++] = p;
    p = find_eol(p, end);
  }
  if (cnt >= 3 && *starts[0] == '@' && *starts[2] == '+')
    return starts[0] - data;
  if (cnt >= 4 && *starts[1] == '@' && *starts[3] == '+')
    return starts[1] - data;
  if (cnt >= 3 && *starts[0] == '+' && *starts[2] == '@')
    return starts[2] - data;
  if (cnt >= 4 && *starts[1] == '+' && *starts[3] == '@')
    return starts[3] - data;
  return n;
}

}  // extern "C"

namespace {
int64_t fastq_find_start(const uint8_t* data, int64_t n,
                         int32_t at_parent_start) {
  return fastq_find_record_start(data, n, at_parent_start);
}
}  // namespace

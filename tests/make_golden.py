"""Generate pinned golden index dumps for the reference's test/data
fixtures.

BASELINE.md's correctness bar is bit-exact parity with kmerind on
test/data.  Building the reference binaries is impossible in this sandbox
(see PARITY.md: the mxx / sparsehash-c11 / gtest submodules are EMPTY
checkouts, there is no MPI toolchain, and the build environment has no
network egress to fetch them), so per the documented fallback the oracle's
outputs are pinned as golden files: the oracle (tests/oracle.py) is an
independent ~100-line reimplementation of the reference semantics
(kmer.hpp packing order, lex_less canonicalization, per-alphabet
complements), reviewed line-by-line against the reference sources it
cites.  Golden files freeze those outputs so any later regression in
EITHER the oracle or the framework is caught.

Run: python tests/make_golden.py   (writes tests/golden/*.json.gz)
"""

import gzip
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import oracle  # noqa: E402
from test_io import py_parse_fastq  # noqa: E402

from kmerind_jax import DNA  # noqa: E402

DATA = pathlib.Path("/root/reference/test/data")
OUT = HERE / "golden"

# (fixture, k, canonical) matrix — mirrors BASELINE.md's config list
COUNT_CONFIGS = [
    ("test.small.fastq", 21, True),
    ("test.small.fastq", 21, False),
    ("test.small.fastq", 31, True),
    ("test.unitiq1.fastq", 63, True),    # multi-word (4x u32), long reads
    ("test.medium.fastq", 21, True),
    ("test.unitiq1.fastq", 21, True),
    ("natural.fastq", 21, True),
]

POSITION_CONFIGS = [
    ("test.small.fastq", 21),
    ("test.unitiq2.fastq", 21),
]


def _fasta_records(text: str):
    """(header, seq) pairs of a FASTA file.

    Reference semantics (fasta_loader.hpp:295-325): both '>' and ';' start
    header lines, and a RUN of consecutive header lines is ONE record
    header (the mxx::unique collapse on the header flag)."""
    recs, hdr, cur = [], None, []
    prev_hdr = False
    for line in text.splitlines():
        if not line.strip():
            continue  # blank lines are invisible (no line start)
        if line.startswith(">") or line.startswith(";"):
            if not prev_hdr:
                if hdr is not None:
                    recs.append((hdr, "".join(cur)))
                hdr, cur = line[1:], []
            prev_hdr = True
        else:
            prev_hdr = False
            cur.append(line.strip())
    if hdr is not None:
        recs.append((hdr, "".join(cur)))
    return recs


FASTA_CONFIGS = [
    ("test.fasta", 21, True),
    ("test2.fasta", 21, True),
    ("test.unitiqs.fasta", 21, True),
]


def main():
    OUT.mkdir(exist_ok=True)
    manifest = {}
    for name, k, canonical in COUNT_CONFIGS:
        seqs = [r[1] for r in py_parse_fastq((DATA / name).read_text())]
        idx = oracle.count_index(seqs, k, DNA, canonical=canonical)
        fn = f"count_{name}_k{k}_{'canon' if canonical else 'single'}.json.gz"
        payload = {str(key): int(c) for key, c in sorted(idx.items())}
        with gzip.open(OUT / fn, "wt") as f:
            json.dump(payload, f)
        manifest[fn] = {"fixture": name, "k": k, "canonical": canonical,
                        "kind": "count", "fmt": "fastq",
                        "distinct": len(payload),
                        "total": int(sum(idx.values()))}
        print(f"{fn}: {len(payload)} distinct")

    for name, k in POSITION_CONFIGS:
        recs = py_parse_fastq((DATA / name).read_text())
        seqs_ids = []
        for hdr, seq, qual, rstart, sstart in recs:
            ids = [(rstart << 16) | (sstart - rstart + i)
                   for i in range(len(seq) - k + 1)]
            seqs_ids.append((seq, ids))
        idx = oracle.position_index(seqs_ids, k, DNA, canonical=False)
        fn = f"position_{name}_k{k}.json.gz"
        payload = {str(key): v for key, v in sorted(idx.items())}
        with gzip.open(OUT / fn, "wt") as f:
            json.dump(payload, f)
        manifest[fn] = {"fixture": name, "k": k, "kind": "position",
                        "fmt": "fastq", "distinct": len(payload)}
        print(f"{fn}: {len(payload)} distinct")

    for name, k, canonical in FASTA_CONFIGS:
        recs = _fasta_records((DATA / name).read_text())
        seqs = [seq for _, seq in recs]
        idx = oracle.count_index(seqs, k, DNA, canonical=canonical)
        fn = f"count_{name}_k{k}_{'canon' if canonical else 'single'}.json.gz"
        payload = {str(key): int(c) for key, c in sorted(idx.items())}
        with gzip.open(OUT / fn, "wt") as f:
            json.dump(payload, f)
        manifest[fn] = {"fixture": name, "k": k, "canonical": canonical,
                        "kind": "count", "fmt": "fasta",
                        "distinct": len(payload),
                        "total": int(sum(idx.values()))}
        print(f"{fn}: {len(payload)} distinct")

    with open(OUT / "MANIFEST.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"wrote {len(manifest)} golden files to {OUT}")


if __name__ == "__main__":
    main()

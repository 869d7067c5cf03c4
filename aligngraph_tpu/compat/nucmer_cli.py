"""nucmer-compatible CLI frontend to the in-engine contig aligner.

Consumes the exact invocations the reference makes
(`nucmer <ref.fa> <qry.fa> -p <prefix>`, AlignGraph.cpp:3634-3641,
2960-2970; `nucmer -h` availability probe, :4688) and writes
`<prefix>.delta` in the subset of the NUCMER delta format the
reference's `delta2psl` reader consumes (AlignGraph.cpp:588-729).

The engine runs in fastMap mode (sparser anchoring) — the same mode our
pipeline uses when `--fastMap` selects the nucmer-class aligner, so the
golden harness compares like against like.
"""

from __future__ import annotations

import os
import sys

USAGE = "USAGE: nucmer [options] <Reference> <Query> -p <prefix>\n"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "--help" in argv:
        sys.stdout.write(USAGE)
        return 0
    prefix = "out"
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-p" and i + 1 < len(argv):
            prefix = argv[i + 1]
            i += 2
            continue
        if not a.startswith("-"):
            pos.append(a)
        i += 1
    if len(pos) < 2:
        sys.stderr.write(USAGE)
        return 1
    db_path, q_path = pos[0], pos[1]
    out_path = prefix + ".delta"

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import numpy as np

    from aligngraph_tpu.align.contig_aligner import ContigAligner
    from aligngraph_tpu.compat.textout import delta_lines
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.io.fasta import encode, read_fasta
    from aligngraph_tpu.io.formalize import Contigs

    gids, gseqs = read_fasta(db_path)
    sep = 30_000                # > chain join gap: no cross-record chains
    rec_starts = []
    pieces = []
    cursor = 0
    for s in gseqs:
        rec_starts.append(cursor)
        e = encode(s)
        pieces.append(e)
        pieces.append(np.full(sep, 4, np.int8))
        cursor += len(e) + sep
    genome = np.concatenate(pieces) if pieces else np.zeros(0, np.int8)
    rec_starts = np.asarray(rec_starts, np.int64)
    rec_lens = np.asarray([len(s) for s in gseqs], np.int64)

    qids, qseqs = read_fasta(q_path)
    contigs = Contigs(
        ids=qids, seqs=[encode(s) for s in qseqs],
        chaff_ids=[], chaff_seqs=[],
        chunk_real=np.arange(len(qseqs), dtype=np.int32),
        chunk_start=np.zeros(len(qseqs), np.int64),
        chunk_len=np.array([len(s) for s in qseqs], np.int64),
    )

    cfg = Config(fast_map=True)
    with open(out_path, "w") as f:
        # reader skips the first two lines (AlignGraph.cpp:605-606)
        f.write(f"{os.path.abspath(db_path)} {os.path.abspath(q_path)}\n")
        f.write("NUCMER\n")
        if len(genome) < cfg.seed_len or not len(qseqs):
            return 0
        ali = ContigAligner(genome, cfg, accept=(0.0, 0.0, 0)).align(
            contigs)
        row_names = [qids[int(ali.chunk_id[r])] for r in range(ali.n)]
        row_sizes = [int(ali.source_size[r]) for r in range(ali.n)]
        for line in delta_lines(ali, row_names, row_sizes, gids,
                                rec_starts, rec_lens):
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

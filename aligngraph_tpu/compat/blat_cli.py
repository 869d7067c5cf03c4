"""pblat/blat-compatible CLI frontend to the in-engine contig aligner.

Consumes the exact invocation the reference makes (AlignGraph.cpp:
3648-3653, 2976-2981): `pblat <db.fa> <query.fa> -noHead <out.psl>
[-fastMap] [-threads=N]` and writes headerless PSL.

Raw output (no acceptance thresholds) — the reference binary applies its
own INIT_CONTIG_THRESHOLD / refinement filters when parsing the PSL.
"""

from __future__ import annotations

import os
import sys

USAGE = "usage: pblat database query [-noHead] output.psl [-fastMap]\n"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "--help" in argv:
        sys.stdout.write(USAGE)
        return 0
    pos = [a for a in argv if not a.startswith("-")]
    if len(pos) < 3:
        sys.stderr.write(USAGE)
        return 1
    db_path, q_path, out_path = pos[0], pos[1], pos[2]
    fast_map = "-fastMap" in argv

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import numpy as np

    from aligngraph_tpu.align.contig_aligner import ContigAligner
    from aligngraph_tpu.compat.textout import psl_lines
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

    cfg = Config(fast_map=fast_map)
    if len(genome) < cfg.seed_len or not len(qseqs):
        open(out_path, "w").close()
        return 0
    ali = ContigAligner(genome, cfg, accept=(0.0, 0.0, 0)).align(contigs)
    row_names = [qids[int(ali.chunk_id[r])] for r in range(ali.n)]
    with open(out_path, "w") as f:
        for line in psl_lines(ali, row_names, gids, rec_starts, rec_lens):
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

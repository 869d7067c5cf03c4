"""CLI entrypoint — C1 (`main` + `print`, AlignGraph.cpp:4696-4796,
4304-4327).  Same flag surface as the reference:

  python -m aligngraph_tpu --read1 r1.fa --read2 r2.fa --contig c.fa
      --genome g.fa --distanceLow 300 --distanceHigh 700
      --extendedContig out.fa --remainingContig rem.fa
      [--kMer k --insertVariation v --coverage c --part p --fastMap
       --ratioCheck --iterativeMap --misassemblyRemoval --uniqueExtension
       --resume]
"""

from __future__ import annotations

import sys

USAGE = """\
aligngraph_tpu: reference-guided genome reassembly on GPU or CPU
(AlignGraph-compatible capability surface, in-engine aligners)

usage: python -m aligngraph_tpu --read1 reads_1.fa --read2 reads_2.fa
    --contig contigs.fa --genome genome.fa --distanceLow dLow
    --distanceHigh dHigh --extendedContig extended.fa
    --remainingContig remaining.fa
    [--kMer k --insertVariation iv --coverage c --part p --fastMap
     --ratioCheck --iterativeMap --misassemblyRemoval --uniqueExtension
     --resume]
"""


def main(argv=None) -> int:
    from aligngraph_tpu.config import Config, ConfigError

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    try:
        cfg = Config.from_argv(argv)
    except ConfigError as e:
        print(f"error: {e}\n\n{USAGE}", file=sys.stderr)
        return 2

    from aligngraph_tpu.pipeline.checkpoint import Checkpoint
    from aligngraph_tpu.pipeline.driver import run_pipeline

    ckpt = Checkpoint(cfg.work_dir)
    try:
        cfg.validate()
    except ConfigError as e:
        if not cfg.resume:
            print(f"error: {e}\n\n{USAGE}", file=sys.stderr)
            return 2
    result = run_pipeline(cfg, checkpoint=ckpt)
    print(f"FINISHED: {len(result.extended_ids)} extended contigs, "
          f"{len(result.remaining_ids)} remaining, "
          f"{result.wall_seconds:.1f}s total "
          f"({result.align_seconds:.1f}s alignment)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end pipeline benchmark — BASELINE.json config 1 scale.

Prints ONE JSON line (naming the device; exits non-zero without a GPU
unless JAX_PLATFORMS=cpu is set explicitly) with the full-pipeline wall
time, the per-stage split
(alignment / contig layer / k-mer graph build / traversal+scaffold /
refinement), the extension product (the pipeline's actual output — the
bench FAILS if zero contigs are extended), and the Eval-module assembly
metrics (N50 / covered length / MPMB / identity, E6,
Eval-AlignGraph.cpp:369-398) of the extended contigs against the TRUE
target genome.  The reference's own self-reporting is total + alignment
seconds only (AlignGraph.cpp:4794-4795).

Workload (models the reference paper's setting, like tests/simdata but
vectorized for Mb scale): a true target genome; a reference genome =
target + 1% SNPs + small indels; PE 100bp reads drawn from the target at
BENCH_PIPE_DEPTH x coverage (default 25x >= the --coverage 20 pruning
threshold); draft contigs = ~3kb fragments of the target separated by
50-400bp gaps (bridgeable by the 500bp insert, like real draft
assemblies the reference targets).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.int8)


def mutate_fast(rng, target, snp=0.01, indel=0.0005, max_indel=3):
    """Vectorized SNP + small-indel mutation (simdata.mutate semantics at
    Mb scale: per-base loops would take minutes)."""
    n = len(target)
    out = target.copy()
    m = rng.random(n) < snp
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    ev = np.nonzero(rng.random(n) < indel)[0]
    if len(ev) == 0:
        return out
    pieces, prev = [], 0
    for p in ev:
        if p < prev:
            continue
        if rng.random() < 0.5:       # deletion from target
            d = int(rng.integers(1, max_indel + 1))
            pieces.append(out[prev:p])
            prev = p + d
        else:                        # insertion
            ins = rng.integers(0, 4, int(rng.integers(1, max_indel + 1)))
            pieces.append(out[prev:p + 1])
            pieces.append(ins.astype(np.int8))
            prev = p + 1
    pieces.append(out[prev:])
    return np.concatenate(pieces)


def simulate_pe_reads(rng, target, n_pairs, read_len=100, insert=500,
                      insert_sd=30, err=0.003):
    """Vectorized FR PE read simulation with gaussian insert sizes."""
    n = len(target)
    ins = np.clip(rng.normal(insert, insert_sd, n_pairs).astype(np.int64),
                  2 * read_len, n - 1)
    starts = (rng.random(n_pairs) * (n - ins - 1)).astype(np.int64)
    r1 = target[starts[:, None] + np.arange(read_len)]
    ends = starts + ins
    r2 = COMP[target[(ends - read_len)[:, None]
                     + np.arange(read_len)]][:, ::-1]
    data = np.empty((2 * n_pairs, read_len), np.int8)
    data[0::2] = r1
    data[1::2] = r2
    e = rng.random(data.shape) < err
    data[e] = (data[e] + rng.integers(1, 4, int(e.sum()))) % 4
    return data, np.full(n_pairs, read_len, np.int32)


def cut_contigs(rng, target, mean_len=3000, gap_lo=50, gap_hi=400):
    """Draft fragments of the target with insert-bridgeable gaps."""
    n = len(target)
    seqs, pos = [], 0
    while pos + 500 < n:
        ln = max(400, int(rng.normal(mean_len, mean_len // 3)))
        e = min(pos + ln, n)
        seqs.append(target[pos:e])
        pos = e + int(rng.integers(gap_lo, gap_hi))
    return seqs


def main():
    glen = int(os.environ.get("BENCH_PIPE_GENOME", 4_600_000))
    depth = float(os.environ.get("BENCH_PIPE_DEPTH", 25))
    read_len = 100
    n_pairs = int(os.environ.get(
        "BENCH_PIPE_PAIRS", int(depth * glen / (2 * read_len))))

    from aligngraph_tpu.config import Config
    from aligngraph_tpu.evaluate.evaluate import evaluate
    from aligngraph_tpu.io.fasta import decode, write_fasta
    from aligngraph_tpu.io.formalize import (Reads, formalize_contigs,
                                             formalize_genome)
    from aligngraph_tpu.pipeline.driver import run_pipeline
    from aligngraph_tpu.utils.device import measurement_device
    from aligngraph_tpu.utils.hostmem import warm_heap

    device = measurement_device()

    warm_heap(1 << 30)
    rng = np.random.default_rng(7)
    target = rng.integers(0, 4, glen).astype(np.int8)
    ref = mutate_fast(rng, target)
    data, lens = simulate_pe_reads(rng, target, n_pairs, read_len=read_len)
    reads = Reads(n_pairs, read_len, data, lens)
    contig_seqs = cut_contigs(rng, target)

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_pipeline")
    os.makedirs(d, exist_ok=True)
    write_fasta(f"{d}/genome.fa", ["chr"], [decode(ref)])
    write_fasta(f"{d}/target.fa", ["chr"], [decode(target)])
    write_fasta(f"{d}/contigs.fa",
                [f"c{i}" for i in range(len(contig_seqs))],
                [decode(c) for c in contig_seqs])
    cfg = Config(read1="-", read2="-", contig=f"{d}/contigs.fa",
                 genome=f"{d}/genome.fa", distance_low=300,
                 distance_high=700,
                 extended_contig=f"{d}/extended.fa",
                 remaining_contig=f"{d}/remaining.fa",
                 work_dir=f"{d}/tmp")
    t0 = time.time()
    res = run_pipeline(cfg, reads=reads,
                       contigs=formalize_contigs(cfg.contig),
                       genome=formalize_genome(cfg.genome, 1))
    wall = time.time() - t0
    st = {k: round(v, 2) for k, v in
          res.stats.get("stage_seconds", {}).items()}

    n_ext = len(res.extended_ids)
    ext_bases = int(sum(len(s) for s in res.extended_seqs))
    ev = {}
    if n_ext:
        m = evaluate(f"{d}/target.fa", f"{d}/extended.fa")
        ev = {k: (round(float(m[k]), 4) if isinstance(m[k], float)
                  else int(m[k]))
              for k in ("n_contigs", "n_true_contigs", "n50",
                        "covered_length", "average_identity", "mpmb")
              if k in m}
    print(json.dumps({
        "metric": "pipeline_wall_s",
        "value": round(wall, 2),
        "unit": "s",
        "stages": st,
        "n_pairs": n_pairs,
        "genome_mb": glen / 1e6,
        "depth": depth,
        "n_draft_contigs": len(contig_seqs),
        "extended": n_ext,
        "extended_bases": ext_bases,
        "eval": ev,
        "kmer_stats": res.stats.get("kmer_build"),
        **device,
    }))
    if n_ext == 0:
        print("FAIL: pipeline produced zero extended contigs",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

"""Stage-level profile of the contig aligner on a bench_pipeline-shaped
workload (scaled by --mb).  Times _seed_hits / cluster+chain / tile DP /
finalize separately so the pipeline's alignment wall can be attributed
and tracked.

Usage: python scripts/profile_contig_align.py [genome_mb] [backend]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if len(sys.argv) > 2:
    os.environ["JAX_PLATFORMS"] = sys.argv[2]

import numpy as np

from bench_pipeline import cut_contigs, mutate_fast
from aligngraph_tpu.align import contig_aligner as cal
from aligngraph_tpu.config import Config
from aligngraph_tpu.io.formalize import Contigs


def main():
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    rng = np.random.default_rng(5)
    target = rng.integers(0, 4, int(mb * 1e6)).astype(np.int8)
    reference = mutate_fast(rng, target)
    contigs_l = cut_contigs(rng, target)
    contigs = Contigs(
        ids=[f"c{i}" for i in range(len(contigs_l))],
        seqs=[np.asarray(c, np.int8) for c in contigs_l],
        chaff_ids=[], chaff_seqs=[],
        chunk_real=np.arange(len(contigs_l), dtype=np.int32),
        chunk_start=np.zeros(len(contigs_l), np.int64),
        chunk_len=np.array([len(c) for c in contigs_l], np.int64))
    cfg = Config()
    t0 = time.time()
    ca = cal.ContigAligner(reference, cfg)
    t_index = time.time() - t0

    stage = {"seed": 0.0, "chain": 0.0, "tiles": 0.0, "dp": 0.0,
             "final": 0.0}
    orig_seed = ca._seed_hits
    orig_chain = cal._cluster_and_chain
    orig_jobs = ca._run_tile_jobs
    orig_fin = ca._finalize

    def seed(seq):
        t = time.time()
        r = orig_seed(seq)
        stage["seed"] += time.time() - t
        return r

    def chain(*a, **k):
        t = time.time()
        r = orig_chain(*a, **k)
        stage["chain"] += time.time() - t
        return r

    def jobs(j, p):
        t = time.time()
        r = orig_jobs(j, p)
        stage["dp"] += time.time() - t
        return r

    def fin(p, c):
        t = time.time()
        r = orig_fin(p, c)
        stage["final"] += time.time() - t
        return r

    ca._seed_hits = seed
    cal._cluster_and_chain = chain
    ca._run_tile_jobs = jobs
    ca._finalize = fin
    t0 = time.time()
    ali = ca.align(contigs)
    wall = time.time() - t0
    cal._cluster_and_chain = orig_chain
    print(f"genome={mb}Mb contigs={len(contigs_l)} placements={ali.n} "
          f"backend={os.environ.get('JAX_PLATFORMS', 'default')}")
    print(f"index_build={t_index:.1f}s align_wall={wall:.1f}s "
          f"seed={stage['seed']:.1f}s chain={stage['chain']:.1f}s "
          f"dp={stage['dp']:.1f}s finalize={stage['final']:.1f}s "
          f"other={wall - sum(stage.values()):.1f}s")


if __name__ == "__main__":
    main()

"""Profile the k-mer graph build at scale with synthesized records
(no aligner, no accelerator).

Usage: JAX_PLATFORMS=cpu python scripts/profile_kmer.py [n_pairs] [glen]
"""

import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from aligngraph_tpu.align.types import PairAlignments
from aligngraph_tpu.graph.kmer_layer import build_kmer_layer
from aligngraph_tpu.graph.model import GraphTensors
from aligngraph_tpu.io.formalize import Reads


def synth(n_pairs, glen, L=100, insert=500, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, glen).astype(np.int8)
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    starts = rng.integers(0, glen - insert - 1, n_pairs)
    idx1 = starts[:, None] + np.arange(L)
    idx2 = (starts + insert - L)[:, None] + np.arange(L)
    r1 = target[idx1]
    r2 = comp[target[idx2]][:, ::-1]
    data = np.empty((2 * n_pairs, L), np.int8)
    data[0::2] = r1
    data[1::2] = r2
    reads = Reads(n_pairs, L, data, np.full(n_pairs, L, np.int32))
    pm = np.full((n_pairs, 2, L), -1, np.int32)
    pm[:, 0, :] = starts[:, None] + np.arange(L)
    pm[:, 1, :] = (starts + insert - L)[:, None] + np.arange(L)
    pa = PairAlignments(
        pair_id=np.arange(n_pairs, dtype=np.int32),
        fr=np.tile(np.array([[0, 1]], np.int8), (n_pairs, 1)),
        score=np.full((n_pairs, 2), 200, np.int32),
        source_start=np.zeros((n_pairs, 2), np.int32),
        source_end=np.full((n_pairs, 2), L, np.int32),
        source_gap=np.zeros((n_pairs, 2), np.int32),
        source_size=np.full((n_pairs, 2), L, np.int32),
        target_start=pm[:, :, 0].copy(),
        target_end=pm[:, :, -1] + 1,
        target_gap=np.zeros((n_pairs, 2), np.int32),
        pos_map=pm)
    return target, reads, pa


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    glen = int(sys.argv[2]) if len(sys.argv) > 2 else 4_600_000
    with_contigs = len(sys.argv) > 3 and sys.argv[3] == "contigs"
    target, reads, pa = synth(n_pairs, glen)
    g = GraphTensors.create(target)
    if with_contigs:
        # realistic anchor density: a contig layer covering most of the
        # genome (every position gets 1 ContiMer -> 4x candidate rows)
        from aligngraph_tpu.align.types import ContigAlignments
        from aligngraph_tpu.graph.contig_layer import build_contig_layer
        from aligngraph_tpu.io.formalize import Contigs
        rng = np.random.default_rng(1)
        seqs, rows = [], dict(chunk_id=[], fr=[], score=[],
                              source_start=[], source_end=[],
                              source_gap=[], source_size=[],
                              target_start=[], target_end=[],
                              target_gap=[])
        maps = []
        pos = 0
        while pos + 25_000 < glen:
            ln = int(rng.integers(12_000, 28_000))
            seqs.append(target[pos:pos + ln])
            cid = len(seqs) - 1
            rows["chunk_id"].append(cid)
            rows["fr"].append(0)
            rows["score"].append(2 * ln)
            rows["source_start"].append(0)
            rows["source_end"].append(ln)
            rows["source_gap"].append(0)
            rows["source_size"].append(ln)
            rows["target_start"].append(pos)
            rows["target_end"].append(pos + ln)
            rows["target_gap"].append(0)
            maps.append(np.arange(pos, pos + ln, dtype=np.int32))
            pos += ln + int(rng.integers(1000, 3000))
        contigs = Contigs(
            ids=[f"c{i}" for i in range(len(seqs))],
            seqs=[np.asarray(s) for s in seqs],
            chaff_ids=[], chaff_seqs=[],
            chunk_real=np.arange(len(seqs)),
            chunk_start=np.zeros(len(seqs), np.int64),
            chunk_len=np.array([len(s) for s in seqs], np.int64))
        cali = ContigAlignments(
            **{k: np.asarray(v) for k, v in rows.items()},
            pos_map=maps)
        t0 = time.time()
        build_contig_layer(g, contigs, cali)
        print(f"contig layer: {time.time()-t0:.1f}s "
              f"(cm occupancy {float((g.cm_cnt > 0).mean()):.2f})")
    t0 = time.time()
    pr = cProfile.Profile()
    pr.enable()
    st = build_kmer_layer(g, pa, reads, 5, 50)
    pr.disable()
    print(f"kmer build {n_pairs} pairs / {glen/1e6:.1f}Mb: "
          f"{time.time()-t0:.1f}s tuples={st.tuples} rows={st.rows} "
          f"groups={st.groups}")
    pstats.Stats(pr).sort_stats("tottime").print_stats(15)

    from aligngraph_tpu.graph.traverse import extend_and_scaffold
    t0 = time.time()
    scaffolds, pre = extend_and_scaffold(g, 3, 5)
    print(f"extend_and_scaffold: {time.time()-t0:.1f}s "
          f"({len(scaffolds)} scaffolds, {len(pre)} pre)")


if __name__ == "__main__":
    main()


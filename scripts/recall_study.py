"""Repeat-seed recall study (round-4 verdict #8).

Synthetic genome with planted repeat families of copy number {4, 8, 16,
32} (each copy 1% diverged), PE reads simulated uniformly (including
from repeats).  For max_seed_hits in {8, 16, 32} vs an exhaustive-ish
oracle (64): what fraction of simulated pairs yield (a) any accepted
record, (b) an accepted record at the TRUE source position (+-16 bp)?

Seeds occurring at > max_seed_hits genome positions are dropped by the
repetitive-seed policy, so reads inside high-copy families lose seeds;
this measures what that costs.  Results table goes to BASELINE.md.

Usage: python scripts/recall_study.py [n_pairs] [cpu]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if len(sys.argv) > 2:
    os.environ["JAX_PLATFORMS"] = sys.argv[2]

import jax
import numpy as np


def build_repeat_genome(rng, unique_mb=2.0, family_copies=(4, 8, 16, 32),
                        unit_len=20_000, divergence=0.01):
    """Unique backbone + one family per copy number; returns
    (genome, [(start, end, family)] spans of every repeat copy)."""
    parts = [rng.integers(0, 4, int(unique_mb * 1e6)).astype(np.int8)]
    spans = []
    cursor = len(parts[0])
    for fam, copies in enumerate(family_copies):
        unit = rng.integers(0, 4, unit_len).astype(np.int8)
        for _ in range(copies):
            c = unit.copy()
            m = rng.random(unit_len) < divergence
            c[m] = (c[m] + rng.integers(1, 4, int(m.sum()))) % 4
            spacer = rng.integers(0, 4, 2_000).astype(np.int8)
            parts.append(c)
            spans.append((cursor, cursor + unit_len, fam))
            cursor += unit_len
            parts.append(spacer)
            cursor += len(spacer)
    return np.concatenate(parts), spans


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    from aligngraph_tpu.align.read_aligner import ReadAligner
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.io.formalize import Reads

    rng = np.random.default_rng(17)
    genome, spans = build_repeat_genome(rng)
    glen = len(genome)
    rep_lo = spans[0][0]
    read_len, insert = 100, 500
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    starts = rng.integers(0, glen - insert - 1, n_pairs)
    r1 = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    i2 = (starts + insert - read_len)[:, None] + np.arange(read_len)[None, :]
    r2 = comp[genome[i2]][:, ::-1].copy()
    for r in (r1, r2):
        e = rng.random(r.shape) < 0.003
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
    data = np.empty((2 * n_pairs, read_len), np.int8)
    data[0::2] = r1
    data[1::2] = r2
    reads = Reads(n_pairs, read_len, data,
                  np.full(n_pairs, read_len, np.int32))
    in_repeat = starts >= rep_lo    # pair's mate-1 starts inside a family
    fam_of = np.full(n_pairs, -1)
    for (s, e, f) in spans:
        fam_of[(starts >= s) & (starts < e)] = f

    rows = []
    for mh in (8, 16, 32, 64):
        cfg = Config(distance_low=300, distance_high=700,
                     max_seed_hits=mh)
        t0 = time.time()
        al = ReadAligner.build(genome, cfg, batch_pairs=16384)
        res = al.align(reads)
        wall = time.time() - t0
        # recall: any accepted record / true-position record per pair
        got_any = np.zeros(n_pairs, bool)
        got_true = np.zeros(n_pairs, bool)
        pid = res.pair_id
        ts0 = res.target_start[:, 0]
        got_any[pid] = True
        near = np.abs(ts0 - starts[pid]) <= 16
        np.logical_or.at(got_true, pid[near], True)
        row = dict(max_seed_hits=mh,
                   recall_any=round(float(got_any.mean()), 4),
                   recall_true=round(float(got_true.mean()), 4),
                   recall_any_unique=round(
                       float(got_any[~in_repeat].mean()), 4),
                   recall_true_unique=round(
                       float(got_true[~in_repeat].mean()), 4),
                   wall_s=round(wall, 1))
        for f, copies in enumerate((4, 8, 16, 32)):
            m = fam_of == f
            row[f"recall_any_x{copies}"] = round(
                float(got_any[m].mean()), 4) if m.any() else None
            row[f"recall_true_x{copies}"] = round(
                float(got_true[m].mean()), 4) if m.any() else None
        rows.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

"""GraphTensors memory accounting + chr20-scale allocation check.

Prints the exact bytes/position of every graph tensor family, allocates a
human-chr20-scale (100 Mb) part to confirm the footprint against RSS, and
derives the --part sizing rule.  Slot-cap pressure (dropped_* counters)
depends on COVERAGE DEPTH, not genome length — it is validated at real
density by bench_pipeline (25x depth) whose kmer_stats are committed in
BASELINE.md.

Usage: python scripts/memory_accounting.py [part_mb]
"""

import json
import os
import resource
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from aligngraph_tpu.graph.model import GraphTensors


def tensor_bytes_per_position():
    g = GraphTensors.create(np.zeros(1000, np.int8), overflow_cap=0)
    n = g.km_cnt.shape[0]
    fams = {"contig layer (cm_*)": [], "read layer (km_*)": [],
            "edges (ed_*)": [], "base": []}
    total = 0
    for name in vars(g):
        arr = getattr(g, name)
        if not isinstance(arr, np.ndarray):
            continue
        b = arr.nbytes / n
        total += b
        key = ("contig layer (cm_*)" if name.startswith("cm_") else
               "read layer (km_*)" if name.startswith("km_") else
               "edges (ed_*)" if name.startswith("ed_") else "base")
        fams[key].append((name, b))
    return fams, total


def main():
    part_mb = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    fams, bpp = tensor_bytes_per_position()
    for fam, items in fams.items():
        sub = sum(b for _, b in items)
        print(f"# {fam}: {sub:.1f} B/pos "
              f"({', '.join(f'{n} {b:.0f}' for n, b in items)})")
    print(f"# TOTAL: {bpp:.1f} B/pos (+10% default overflow segment)")

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    n = part_mb * 1_000_000
    g = GraphTensors.create(np.zeros(n, np.int8))
    # create() fills every array, so all pages are already resident
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    expect_gb = bpp * n * 1.1 / 1e9
    print(json.dumps({
        "metric": "graph_bytes_per_position",
        "value": round(bpp, 1),
        "unit": "bytes",
        "part_mb": part_mb,
        "expected_gb": round(expect_gb, 1),
        "rss_gb": round(rss1 - rss0, 1),
        "part_rule_positions_per_gb": int(1e9 / (bpp * 1.1)),
    }))


if __name__ == "__main__":
    main()

"""Benchmark: aligned reads/s/device for the in-engine PE read aligner.

Prints ONE JSON line:
  {"metric": "aligned_reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": R, "walls": [...], "platform": ..., "device_kind": ...,
   "device_count": ..., "card": "<nvidia-smi name, power.limit>"}

value is the median of 5 timed passes.  Exits non-zero without a GPU,
unless JAX_PLATFORMS=cpu is set explicitly for a rehearsal.

vs_baseline compares against the C++ reference stack's aligner throughput.
The reference shells out to bowtie2 with a fixed `-p 8` (AlignGraph.cpp:
3601, README FAQ 6); bowtie2 cannot run in this image, so the baseline is
the documented bowtie2-class throughput for 100bp local-mode PE alignment:
~12.5k reads/s/thread x 8 threads = 1.0e5 reads/s (order-of-magnitude
consistent with the Langmead 2012 paper and bowtie2's own benchmarks).
BASELINE.json's target is >= 20x that baseline per chip.

Workload: E. coli-scale synthetic genome (4.6 Mb), closely related
reference (1% SNPs), 100bp PE reads at 500bp insert — BASELINE.json
config 1.  Timed after a compile warmup; the measured path is the full
end-to-end align() (seeding + banded SW + traceback + pairing + host
transfer of accepted records).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BOWTIE2_8T_BASELINE = 1.0e5   # reads/s, see module docstring


def make_workload(genome_len=4_600_000, n_pairs=100_000, read_len=100,
                  insert=500, snp=0.01, seed=0, return_target=False):
    """Synthetic PE workload. With return_target=True also returns the
    true (unmutated) genome the reads were drawn from, so consumers that
    cut contigs from it (bench_pipeline) don't have to replay the RNG."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, genome_len).astype(np.int8)
    ref = target.copy()
    m = rng.random(genome_len) < snp
    ref[m] = (ref[m] + rng.integers(1, 4, int(m.sum()))) % 4
    # vectorized PE read simulation
    starts = rng.integers(0, genome_len - insert - 1, n_pairs)
    idx1 = starts[:, None] + np.arange(read_len)[None, :]
    r1 = target[idx1]
    idx2 = (starts + insert - read_len)[:, None] + \
        np.arange(read_len)[None, :]
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    r2 = comp[target[idx2]][:, ::-1]
    # sequencing errors 0.3%
    for r in (r1, r2):
        e = rng.random(r.shape) < 0.003
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
    data = np.empty((2 * n_pairs, read_len), np.int8)
    data[0::2] = r1
    data[1::2] = r2
    lens = np.full(n_pairs, read_len, np.int32)
    if return_target:
        return ref, data, lens, target
    return ref, data, lens


def main():
    n_pairs = int(os.environ.get("BENCH_PAIRS", 100_000))
    genome_len = int(os.environ.get("BENCH_GENOME", 4_600_000))

    from aligngraph_tpu.align.read_aligner import ReadAligner
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.io.formalize import Reads
    from aligngraph_tpu.utils.device import measurement_device

    device = measurement_device()
    batch = int(os.environ.get("BENCH_BATCH", 32768))
    ref, data, lens = make_workload(genome_len=genome_len, n_pairs=n_pairs)
    reads = Reads(n_pairs, data.shape[1], data, lens)
    cfg = Config(distance_low=100, distance_high=900)
    t0 = time.time()
    aligner = ReadAligner.build(ref, cfg, batch_pairs=batch)
    index_s = time.time() - t0

    # warmup: compile on a small slice + pre-fault host heap pages
    # (utils/hostmem.py)
    from aligngraph_tpu.utils.hostmem import warm_heap
    warm_heap(1 << 30)
    nw = min(batch, n_pairs)
    warm = Reads(nw, reads.max_len, data[: 2 * nw], lens[:nw])
    t0 = time.time()
    aligner.align(warm)
    tail = n_pairs % batch
    if tail:
        # the tail batch uses a smaller power-of-two device shape; compile
        # it during warmup so the timed region is compile-free
        aligner.align(Reads(tail, reads.max_len, data[: 2 * tail],
                            lens[:tail]))
    warm_s = time.time() - t0

    walls = []
    for _ in range(5):
        t0 = time.time()
        res = aligner.align(reads)
        walls.append(time.time() - t0)
    dt = float(np.median(walls))
    aligned_reads = 2 * len(np.unique(res.pair_id))
    total_reads = 2 * n_pairs
    rps = aligned_reads / dt

    print(json.dumps({
        "metric": "aligned_reads_per_s_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BOWTIE2_8T_BASELINE, 2),
        "walls": walls,
        **device,
    }))
    print(f"# total_reads={total_reads} aligned={aligned_reads} "
          f"({aligned_reads/total_reads:.1%}) wall={dt:.2f}s "
          f"walls={[round(w, 2) for w in walls]} "
          f"index_build={index_s:.2f}s warmup={warm_s:.2f}s "
          f"records={res.n}", file=sys.stderr)


if __name__ == "__main__":
    main()

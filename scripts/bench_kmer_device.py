"""Benchmark the device (jitted) k-mer graph build against the host
oracle at pipeline scale, with the device->host graph sync reported as
its own line item.

Usage: python scripts/bench_kmer_device.py [n_pairs] [genome_len]
Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    glen = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000

    from bench import make_workload
    from aligngraph_tpu.align.read_aligner import ReadAligner
    from aligngraph_tpu.align.types import PairAlignments
    from aligngraph_tpu.config import Config, THRESHOLD
    from aligngraph_tpu.graph.kmer_layer import build_kmer_layer
    from aligngraph_tpu.graph.kmer_layer_jit import (
        _state_from_graph, _state_to_graph, build_kmer_layer_device,
    )
    from aligngraph_tpu.graph.model import GraphTensors
    from aligngraph_tpu.io.formalize import Reads
    from aligngraph_tpu.utils.hostmem import warm_heap
    import dataclasses

    warm_heap(1 << 30)
    ref, data, lens = make_workload(genome_len=glen, n_pairs=n_pairs)
    reads = Reads(n_pairs, data.shape[1], data, lens)
    cfg = Config(distance_low=100, distance_high=900)
    rali = ReadAligner.build(ref, cfg).align(reads)
    mask = rali.ratio_ok(THRESHOLD)
    rali = dataclasses.replace(
        rali, **{f.name: getattr(rali, f.name)[mask]
                 for f in dataclasses.fields(PairAlignments)})

    # host oracle
    g_h = GraphTensors.create(ref)
    t0 = time.time()
    build_kmer_layer(g_h, rali, reads, cfg.k_mer, cfg.insert_variation)
    host_s = time.time() - t0

    # device build: warm (compile), then measure build-only and sync
    g_d = GraphTensors.create(ref)
    build_kmer_layer_device(g_d, rali, reads, cfg.k_mer,
                            cfg.insert_variation)
    g_d = GraphTensors.create(ref)
    t0 = time.time()
    st = build_kmer_layer_device(g_d, rali, reads, cfg.k_mer,
                                 cfg.insert_variation)
    dev_total_s = time.time() - t0
    # isolate the d2h sync cost (the build function already synced once;
    # re-sync a fresh state snapshot)
    state = _state_from_graph(g_d)
    jax.block_until_ready(state["km_cov"])
    t0 = time.time()
    _state_to_graph(state, GraphTensors.create(ref))
    sync_s = time.time() - t0

    # same field tuple as tests/test_kmer_jit.py::KM_FIELDS so the
    # printed bit_equal covers everything the unit tests cover
    from tests.test_kmer_jit import KM_FIELDS
    equal = all(
        np.array_equal(getattr(g_d, f), getattr(g_h, f))
        for f in KM_FIELDS)
    print(json.dumps({
        "metric": "kmer_build_seconds",
        "backend": jax.default_backend(),
        "n_pairs": n_pairs,
        "genome_mb": glen / 1e6,
        "host_s": round(host_s, 2),
        "device_total_s": round(dev_total_s, 2),
        "device_build_s": round(dev_total_s - sync_s, 2),
        "graph_sync_s": round(sync_s, 2),
        "speedup_build": round(host_s / max(dev_total_s - sync_s, 1e-9), 1),
        "speedup_total": round(host_s / max(dev_total_s, 1e-9), 1),
        "groups": st.groups,
        "bit_equal": bool(equal),
    }))


if __name__ == "__main__":
    main()

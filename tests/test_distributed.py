"""D4: multi-process jax.distributed test (2 OS processes, CPU backend).

Spawns two worker processes that each contribute 4 virtual CPU devices,
form one 8-device global mesh via jax.distributed.initialize, and run
(a) the sharded span-coverage collectives and (b) the PRODUCTION sharded
aligner with dp shards spanning the process boundary.  The parent
compares process-0's gathered results against single-process oracles.

The reference has no distributed story at all (SURVEY.md §2.4.5: no
MPI/NCCL/sockets); BASELINE.json requires N>=2 hosts.  Process
boundaries on the CPU backend stand in for host boundaries — the
collective paths exercised (psum_scatter / all_gather / psum across
processes) are the same XLA collectives a multi-host run uses.
"""

import os
import socket
import subprocess
import sys

import numpy as np


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_distributed(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    worker = os.path.join(os.path.dirname(__file__),
                          "distributed_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    res = np.load(tmp_path / "result.npz")

    # (a) coverage == numpy oracle
    from aligngraph_tpu.parallel.coverage import span_coverage_np
    oracle = span_coverage_np(res["starts"], res["ends"], int(res["G"]))
    np.testing.assert_array_equal(res["cov"], oracle)

    # (b) production aligner records == single-process align() oracle
    from aligngraph_tpu.align.read_aligner import (
        ReadAligner, _expand_packed, unpack_records)
    from aligngraph_tpu.config import Config
    from tests.simdata import make_simdata

    sim = make_simdata(seed=5, genome_len=10_000, n_pairs=64, read_len=80,
                       insert=400, snp_rate=0.01)
    n, L = 64, 80
    data = np.empty((2 * n, L), np.int8)
    for i in range(n):
        data[2 * i] = sim.reads1[i]
        data[2 * i + 1] = sim.reads2[i]
    reads_lens = np.full(n, L, np.int32)
    from aligngraph_tpu.io.formalize import Reads
    cfg = Config(distance_low=100, distance_high=700)
    al = ReadAligner.build(sim.reference, cfg, batch_pairs=n, c13=True)
    want = al.align(Reads(n, L, data, reads_lens))
    assert int(res["n_valid_total"]) == want.n > 50

    bufs = res["bufs"]
    pl = res["pl"]
    n_sh = bufs.shape[0]
    per = len(pl) // n_sh
    chunks = []
    for s in range(n_sh):
        dec = unpack_records(bufs[s], per)
        chunks.append(_expand_packed(dec, s * per, per, L,
                                     pl[s * per:(s + 1) * per]))
    got = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    for field in ("pair_id", "fr", "score", "source_start", "source_end",
                  "target_start", "target_end", "pos_map"):
        np.testing.assert_array_equal(got[field], getattr(want, field),
                                      err_msg=field)

    # (c) sharded k-mer GRAPH build across the process boundary ==
    # host oracle built from the SAME records (D2/D3)
    import dataclasses as _dc

    from aligngraph_tpu.align.types import PairAlignments
    from aligngraph_tpu.graph.kmer_layer import build_kmer_layer
    from aligngraph_tpu.graph.model import GraphTensors

    krali = PairAlignments(**{
        f.name: res[f"rali_{f.name}"]
        for f in _dc.fields(PairAlignments)})
    kreads = Reads(n, L, res["reads_data"], reads_lens)
    g_h = GraphTensors.create(res["ref"])
    build_kmer_layer(g_h, krali, kreads, cfg.k_mer, cfg.insert_variation,
                     chunk_records=1 << 30)
    for f in ("km_cnt", "km_cov", "km_votes", "km_s", "ed_cnt",
              "ed_item"):
        np.testing.assert_array_equal(res[f], getattr(g_h, f),
                                      err_msg=f)
    np.testing.assert_array_equal(res["ed_pos"],
                                  g_h.ed_pos.view(np.int32))
    assert res["km_cnt"].sum() > 0

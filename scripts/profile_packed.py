"""Quick profile of the PRODUCTION packed align path (cached compile).

Separates: device compute (block_until_ready on device outputs), d2h pull,
host expand, and the end-to-end align() wall, at a given batch size.

Usage: python scripts/profile_packed.py [P] [NBATCH]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import make_workload
from aligngraph_tpu.align import read_aligner as ra
from aligngraph_tpu.config import Config
from aligngraph_tpu.io.formalize import Reads


def t(f, n=3):
    f()  # warm
    ts = time.time()
    for _ in range(n):
        f()
    return (time.time() - ts) / n


def main():
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    NB = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    ref, data, lens = make_workload(n_pairs=P)
    cfg = Config(distance_low=100, distance_high=900)
    t0 = time.time()
    al = ra.ReadAligner.build(ref, cfg, batch_pairs=P)
    print(f"index build: {time.time()-t0:.2f}s", flush=True)
    idx = al.index
    _ = idx.device_arrays()

    L = max(100, cfg.seed_len)
    seqs = np.full((2 * P, L), 4, np.int8)
    seqs[:2 * P] = data[:2 * P]
    plens = np.full(P, 100, np.int32)
    u2, nmask = ra.pack_reads_np(seqs)
    rcseqs = ra.revcomp_padded_np(seqs, np.repeat(plens, 2))
    u2r, nmr = ra.pack_reads_np(rcseqs)
    u2_d, nm_d = jnp.asarray(u2), jnp.asarray(nmask)
    u2r_d, nmr_d = jnp.asarray(u2r), jnp.asarray(nmr)
    plens_d = jnp.asarray(plens)

    kw = dict(seed_len=cfg.seed_len, stride=cfg.seed_stride,
              pad=cfg.band_pad, C=cfg.max_candidates, K=ra.MAX_PAIR_HITS,
              dlow=cfg.distance_low, dhigh=cfg.distance_high,
              bsteps=idx.search_steps, sbits=idx.suffix_bits)

    def run_packed():
        out = ra._align_pairs_packed(al.genome, idx.sorted_kmers,
                                     idx.sorted_posflip, idx.bucket_lo,
                                     u2_d, nm_d, u2r_d, nmr_d, plens_d, L=L, c13=True,
                                     **kw)
        jax.block_until_ready(out)
        return out

    tc0 = time.time()
    out = run_packed()
    print(f"first call (compile or cache load): {time.time()-tc0:.1f}s",
          flush=True)
    dt_p = t(run_packed)
    n_pairs_aligned = int(np.asarray(out)[0])
    print(f"device compute packed: {dt_p*1e3:.0f} ms "
          f"({2*P/dt_p:.0f} reads/s device-only) n_valid={n_pairs_aligned}",
          flush=True)

    nbytes = np.asarray(out).nbytes
    dt = t(lambda: np.asarray(run_packed()))
    print(f"d2h packed ({nbytes/1e6:.2f} MB incl exec): {dt*1e3:.0f} ms",
          flush=True)
    res = ra.unpack_records(np.asarray(out), P)
    dt = t(lambda: ra._expand_packed(res, 0, P, L, plens))
    print(f"host expand packed: {dt*1e3:.0f} ms", flush=True)
    dt = t(lambda: ra.pack_reads_np(seqs))
    print(f"host pack_reads_np: {dt*1e3:.0f} ms", flush=True)

    # dispatch-latency probe: enqueue NB batches then pull
    def burst():
        outs = [ra._align_pairs_packed(al.genome, idx.sorted_kmers,
                                       idx.sorted_posflip, idx.bucket_lo,
                                       u2_d, nm_d, u2r_d, nmr_d, plens_d, L=L, c13=True,
                                       **kw) for _ in range(NB)]
        jax.block_until_ready(outs)
    dt = t(burst, n=2)
    print(f"{NB}-batch burst: {dt*1e3:.0f} ms ({dt/NB*1e3:.0f} ms/batch)",
          flush=True)

    reads = Reads(NB * P, L, np.tile(data[:2 * P], (NB, 1)),
                  np.full(NB * P, 100, np.int32))
    dt = t(lambda: al.align(reads), n=2)
    print(f"align() e2e {NB}x{P}: {dt*1e3:.0f} ms -> "
          f"{2*NB*P/dt:.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()

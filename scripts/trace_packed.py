"""Capture a jax.profiler trace of one packed align batch (cached compile).

Usage: python scripts/trace_packed.py [P]
Writes /tmp/jaxtrace; then summarize with
`python scripts/summarize_trace.py /tmp/jaxtrace`.
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


def main():
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    ref, data, lens = make_workload(n_pairs=P)
    cfg = Config(distance_low=100, distance_high=900)
    al = ra.ReadAligner.build(ref, cfg, batch_pairs=P)
    idx = al.index
    _ = idx.device_arrays()

    L = 100
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

    def run():
        out = ra._align_pairs_packed(al.gwords, idx.sorted_kmers,
                                     idx.sorted_posflip, idx.bucket_lo,
                                     u2_d, nm_d, u2r_d, nmr_d, plens_d, L=L, c13=True, G=len(ref),
                                     **kw)
        jax.block_until_ready(out)

    run()  # warm
    t0 = time.time()
    run()
    print(f"steady-state: {(time.time()-t0)*1e3:.0f} ms", flush=True)
    with jax.profiler.trace("/tmp/jaxtrace"):
        run()
    print("trace written to /tmp/jaxtrace", flush=True)


if __name__ == "__main__":
    main()

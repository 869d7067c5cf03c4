"""Dump compiled HLO of the packed align program; print per-fusion source
attribution (metadata op_name / source_file) for the big fusions."""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import make_workload
from aligngraph_tpu.align import read_aligner as ra
from aligngraph_tpu.config import Config


def main():
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    want = set(sys.argv[2].split(",")) if len(sys.argv) > 2 else None
    ref, data, lens = make_workload(n_pairs=P)
    cfg = Config(distance_low=100, distance_high=900)
    al = ra.ReadAligner.build(ref, cfg, batch_pairs=P)
    idx = al.index
    L = 100
    seqs = np.full((2 * P, L), 4, np.int8)
    plens = np.full(P, 100, np.int32)
    u2, nmask = ra.pack_reads_np(seqs)
    rcseqs = ra.revcomp_padded_np(seqs, np.repeat(plens, 2))
    u2r, nmr = ra.pack_reads_np(rcseqs)

    kw = dict(seed_len=cfg.seed_len, stride=cfg.seed_stride,
              pad=cfg.band_pad, C=cfg.max_candidates, K=ra.MAX_PAIR_HITS,
              dlow=cfg.distance_low, dhigh=cfg.distance_high,
              bsteps=idx.search_steps, sbits=idx.suffix_bits)
    lowered = ra._align_pairs_packed.lower(
        al.gwords, idx.sorted_kmers, idx.sorted_posflip, idx.bucket_lo,
        jnp.asarray(u2), jnp.asarray(nmask), jnp.asarray(u2r),
        jnp.asarray(nmr), jnp.asarray(plens), L=L,
        c13=True, G=len(ref), **kw)
    txt = lowered.compile().as_text()
    with open("/tmp/packed_hlo.txt", "w") as f:
        f.write(txt)
    print(f"HLO dumped: {len(txt)} chars -> /tmp/packed_hlo.txt")

    # print the computation each big fusion calls + source attribution
    for m in re.finditer(r'^\s*(?:ROOT )?%?([\w.-]+) = \S+ fusion\(.*?calls=%?([\w.-]+).*?metadata={([^}]*)}',
                         txt, re.M):
        name, calls, meta = m.groups()
        if want and name not in want:
            continue
        op = re.search(r'op_name="([^"]*)"', meta)
        src = re.search(r'source_file="([^"]*)"', meta)
        line = re.search(r'source_line=(\d+)', meta)
        print(f"{name}: calls={calls} op={op.group(1) if op else '?'} "
              f"src={src.group(1) if src else '?'}:"
              f"{line.group(1) if line else '?'}")


if __name__ == "__main__":
    main()

"""Device mesh + sharded execution — SURVEY.md §2.4's distributed design.

The reference has no distributed backend (files are the transport;
2 pthreads share nothing, AlignGraph.cpp:3720-3735).  Our scale-out maps
the workload onto a mesh with two axes of parallelism:

  dp  — PE read batches data-parallel across devices (the hot
        DP/alignment work; replaces bowtie2 -p threading)
  sp  — the genome position axis sharded across devices for the
        graph-merge tensors (the device generalization of --part), merged
        with reduce_scatter/psum collectives (parallel/halo.py)

`make_sharded_aligner` shards THE production align program
(read_aligner._align_pairs_packed — the same jitted function the
single-chip path dispatches) under shard_map: reads dp-sharded,
genome + seed index replicated, per-shard packed record buffers out,
scalar counters psum'd across the mesh.  tests/test_parallel.py asserts
shard-merge == single-shard output record-for-record; __graft_entry__'s
dryrun_multichip compiles and runs it on an N-device mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aligngraph_tpu.align import read_aligner as ra
from aligngraph_tpu.config import Config

# engine-knob defaults derive from Config so the sharded and single-chip
# paths cannot silently drift (they previously did: stride=8 here vs
# Config.seed_stride=12)
_DEF = Config()


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def make_sharded_aligner(mesh: Mesh, *, L: int, seed_len=_DEF.seed_len,
                         stride=_DEF.seed_stride, pad=_DEF.band_pad,
                         C=_DEF.max_candidates, K=ra.MAX_PAIR_HITS, dlow=0,
                         dhigh=99999, bsteps=8, sbits=6, c13=True,
                         G=None):
    """Build the jitted multi-chip read-align step over the PRODUCTION
    align program.

    Pass G = genome length and feed the first argument with
    read_aligner.pack_genome_words_np(genome) (the production word
    table); with G=None the raw int8 genome is accepted (compat).

    Input shardings: (genome words, sorted_kmers, sorted_posflip,
    bucket_lo) replicated; (u2, nmask, u2r, nmr) dp-sharded on rows (2 rows per
    pair); plens dp-sharded.  Output: the packed record dict of
    _align_pairs_packed, each leaf dp-sharded on its leading axis (slot
    tables are per-shard; slot_id values index the SHARD-LOCAL (pair, k)
    table), plus psum'd global counters.
    """
    axis = mesh.axis_names[0]

    def shard_fn(genome, sorted_kmers, sorted_posflip, bucket_lo, u2,
                 nmask, u2r, nmr, plens):
        buf = ra._align_pairs_packed.__wrapped__(
            genome, sorted_kmers, sorted_posflip, bucket_lo, u2, nmask,
            u2r, nmr, plens, L=L, seed_len=seed_len, stride=stride,
            pad=pad, C=C, K=K, dlow=dlow, dhigh=dhigh, bsteps=bsteps,
            sbits=sbits, c13=c13, dense=False, G=G)
        # buf words 0/1 are the shard-local n_valid / n_ovf counters
        return {"buf": buf,
                "n_valid_total": jax.lax.psum(buf[0], axis)[None],
                "n_ovf_total": jax.lax.psum(buf[1], axis)[None]}

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def shard_reads_pairwise(u2: np.ndarray, nmask: np.ndarray,
                         plens: np.ndarray, n_shards: int):
    """Pad a packed read batch so pairs split evenly across dp shards.

    Returns (u2, nmask, plens) padded to a multiple of n_shards pairs
    (pad pairs have length 0 -> no seeds -> no records)."""
    P_ = len(plens)
    tgt = -(-P_ // n_shards) * n_shards
    if tgt != P_:
        u2 = np.concatenate(
            [u2, np.zeros((2 * (tgt - P_), u2.shape[1]), u2.dtype)])
        nmask = np.concatenate(
            [nmask, np.full((2 * (tgt - P_), nmask.shape[1]), 0xFF,
                            nmask.dtype)])
        plens = np.concatenate([plens, np.zeros(tgt - P_, plens.dtype)])
    return u2, nmask, plens

"""Position-axis sharding with halo exchange — the device
generalization of the reference's `--part` genome splitting.

The reference cuts each chromosome into parts with NO overlap: contigs
and k-mer windows spanning a cut are lost (SURVEY.md §5; the per-part
bowtie/blat runs simply never see cross-part context).  Sharding the
position axis over a mesh axis with `ppermute` halo exchange keeps
k-wide windows and insert-size-wide contexts intact across shard
boundaries — strictly better than the reference's lossy cut.

Usage (inside shard_map over mesh axis `axis_name`):

    padded = exchange_halos(local_block, "sp", halo)   # [h + n + h, ...]
    ... windowed op valid across boundaries ...
    result = padded[halo:-halo]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exchange_halos(x: jax.Array, axis_name: str, halo: int) -> jax.Array:
    """Concatenate each shard's block with `halo` rows from its neighbors.

    x: the shard-local block [n_local, ...]; returns
    [halo + n_local + halo, ...].  Edge shards receive zero padding
    (the genome has nothing beyond its ends).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    right_edge = x[-halo:]     # goes to the right neighbor's left halo
    left_edge = x[:halo]       # goes to the left neighbor's right halo
    # send right_edge to idx+1; receive from idx-1
    from_left = jax.lax.ppermute(
        right_edge, axis_name,
        [(i, (i + 1) % n) for i in range(n)])
    # send left_edge to idx-1; receive from idx+1
    from_right = jax.lax.ppermute(
        left_edge, axis_name,
        [(i, (i - 1) % n) for i in range(n)])
    zeros = jnp.zeros_like(from_left)
    from_left = jnp.where(idx == 0, zeros, from_left)
    from_right = jnp.where(idx == n - 1, zeros, from_right)
    return jnp.concatenate([from_left, x, from_right], axis=0)


def sliding_window_sum_sharded(mesh, axis_name: str, window: int):
    """Build a jitted position-sharded sliding-window sum (an archetype of
    the k-mer-window ops in the graph build): result[i] = sum of
    x[i : i+window] computed correctly ACROSS shard boundaries."""
    from jax.sharding import PartitionSpec as P

    halo = window - 1

    def shard_fn(x):
        padded = exchange_halos(x, axis_name, halo)
        # windows starting at local positions [0, n_local)
        n_local = x.shape[0]
        out = jnp.zeros(n_local, x.dtype)
        for w in range(window):
            out = out + jax.lax.dynamic_slice_in_dim(
                padded, halo + w, n_local, axis=0)
        return out

    mapped = jax.shard_map(shard_fn, mesh=mesh, in_specs=P(axis_name),
                           out_specs=P(axis_name), check_vma=False)
    return jax.jit(mapped)

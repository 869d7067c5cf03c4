"""Position-sharded span-coverage accumulation (D3: graph-tensor
collectives).

The reference accumulates per-base read coverage with a sequential
`for each alignment: cov[lo:hi] += 1` loop (`loadReadAlignment`,
AlignGraph.cpp:3940-3984).  Device formulation: coverage of a set of
half-open spans = cumulative sum of an interval-delta vector
(+1 at start, -1 at end) — one scatter-add plus one prefix scan.

Distributed formulation over a device mesh (records data-parallel,
position axis sharded):

  1. each dp shard scatter-adds ITS records' deltas into a full-length
     [G+1] delta vector                  (local compute)
  2. `reduce_scatter` sums the delta vectors across shards while
     scattering the position axis        (the graph-tensor collective)
  3. shard-local inclusive cumsum
  4. exclusive prefix of the per-shard totals via `all_gather` closes
     the scan across shard boundaries    (spans crossing a shard cut are
     exact — nothing is lost at the boundary, unlike --part's cut)

Used in production by pipeline/misassembly.py's coverage loader; the
single-device path is the same math under plain jit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _deltas(starts: jax.Array, ends: jax.Array, G: int) -> jax.Array:
    """Interval-delta vector [G+1] from half-open spans (clipped)."""
    s = jnp.clip(starts, 0, G)
    e = jnp.clip(ends, 0, G)
    e = jnp.maximum(e, s)                      # empty spans contribute 0
    d = jnp.zeros(G + 1, jnp.int32)
    d = d.at[s].add(1)
    d = d.at[e].add(-1)
    return d


@partial(jax.jit, static_argnames=("G",))
def span_coverage(starts: jax.Array, ends: jax.Array, G: int) -> jax.Array:
    """Single-device: coverage[g] = #spans with start <= g < end."""
    return jnp.cumsum(_deltas(starts, ends, G)[:G])


def span_coverage_np(starts: np.ndarray, ends: np.ndarray,
                     G: int) -> np.ndarray:
    """NumPy oracle (same semantics)."""
    s = np.clip(starts, 0, G)
    e = np.clip(ends, 0, G)
    e = np.maximum(e, s)
    d = np.zeros(G + 1, np.int64)
    np.add.at(d, s, 1)
    np.add.at(d, e, -1)
    return np.cumsum(d[:G]).astype(np.int32)


def make_sharded_coverage(mesh: Mesh, G: int):
    """Jitted multi-device coverage: records dp-sharded in, coverage
    position-sharded out.

    G must be a multiple of the mesh size.  Returns fn(starts, ends)
    where starts/ends are [N] int32 sharded on the dp axis; output is
    [G] int32 sharded along the position axis (same mesh axis reused —
    1-D mesh, two roles).
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    assert G % n == 0, f"G={G} not a multiple of mesh size {n}"

    def shard_fn(starts, ends):
        # (1) local full-length deltas from this shard's records
        d = _deltas(starts, ends, G)[:G]                    # [G]
        # (2) sum across shards + scatter the position axis
        d_loc = jax.lax.psum_scatter(d.reshape(n, G // n), axis,
                                     scatter_dimension=0,
                                     tiled=False)           # [G/n]
        # (3) local inclusive scan
        c_loc = jnp.cumsum(d_loc)
        # (4) close the scan across shards: exclusive prefix of totals
        totals = jax.lax.all_gather(c_loc[-1], axis)        # [n]
        idx = jax.lax.axis_index(axis)
        prefix = jnp.sum(jnp.where(jnp.arange(n) < idx, totals, 0))
        return c_loc + prefix

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(mapped)


def pad_spans(starts: np.ndarray, ends: np.ndarray, n_shards: int):
    """Pad span lists to a multiple of n_shards (pad spans are empty)."""
    N = len(starts)
    tgt = -(-max(N, 1) // n_shards) * n_shards
    if tgt != N:
        starts = np.concatenate([starts, np.zeros(tgt - N, starts.dtype)])
        ends = np.concatenate([ends, np.zeros(tgt - N, ends.dtype)])
    return starts, ends

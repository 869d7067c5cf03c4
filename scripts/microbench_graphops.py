"""Microbenchmark the device primitives the k-mer graph build rests on.

The build (graph/kmer_layer_jit.py) is sorts + segment reductions + row
gathers/scatters over ~3M-row tensors per 16k-record chunk.  This script
measures, on the live backend (GPU or CPU):

  - multi-operand lax.sort throughput at build-like sizes
  - row gather / row scatter cost into [n_pos, 64]-word state matrices
  - elementwise scatter-add (vote accumulation shape)
  - d2h / h2d bandwidth for graph-sized buffers
  - cumsum / segment boundary ops

Run: python scripts/microbench_graphops.py [N_rows] (default 3_000_000)
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def timeit(fn, *args, n=5):
    fn(*args)  # compile
    jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.time() - t0) / n


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 3_000_000
    P = 1_200_000          # positions in a 1 Mb part + overflow
    F = 64                 # packed state words per position row
    rng = np.random.default_rng(0)
    print(f"backend={jax.default_backend()} N={N} P={P}")

    keys = jnp.asarray(rng.integers(0, 2**62, N))
    k2 = jnp.asarray(rng.integers(0, 2**31, N, dtype=np.int32))
    pay = [jnp.asarray(rng.integers(0, 2**31, N, dtype=np.int32))
           for _ in range(4)]

    sort1 = jax.jit(lambda k, p: jax.lax.sort((k,) + tuple(p), num_keys=1,
                                              is_stable=True))
    dt = timeit(sort1, keys, pay)
    print(f"sort i64key+4xi32 payload: {dt*1e3:.1f} ms "
          f"({N/dt/1e6:.0f} M rows/s)")

    sort2 = jax.jit(lambda a, b, p: jax.lax.sort((a, b) + tuple(p),
                                                 num_keys=2, is_stable=True))
    dt = timeit(sort2, k2, k2, pay)
    print(f"sort 2xi32key+4xi32 payload: {dt*1e3:.1f} ms")

    # row gather: U rows of F words
    U = min(P, N)
    state = jnp.asarray(rng.integers(0, 2**31, (P, F), dtype=np.int32))
    idx = jnp.asarray(np.sort(rng.choice(P, U, replace=False))
                      .astype(np.int32))
    rowg = jax.jit(lambda s, i: s[i])
    dt = timeit(rowg, state, idx)
    print(f"row gather [{U}x{F}]: {dt*1e3:.1f} ms ({dt/U*1e9:.1f} ns/row)")

    rows = jnp.asarray(rng.integers(0, 2**31, (U, F), dtype=np.int32))
    rsc = jax.jit(lambda s, i, v: s.at[i].set(v, unique_indices=True,
                                              indices_are_sorted=True))
    dt = timeit(rsc, state, idx, rows)
    print(f"row scatter-set [{U}x{F}]: {dt*1e3:.1f} ms "
          f"({dt/U*1e9:.1f} ns/row)")

    vals = jnp.asarray(rng.integers(0, 100, N, dtype=np.int32))
    iN = jnp.asarray(rng.integers(0, P, N, dtype=np.int32))
    sadd = jax.jit(lambda s, i, v: s.at[i].add(v))
    dt = timeit(sadd, jnp.zeros(P, jnp.int32), iN, vals)
    print(f"elementwise scatter-add [{N}] -> [{P}]: {dt*1e3:.1f} ms")

    seg = jax.jit(lambda k: jnp.cumsum(
        (k != jnp.roll(k, 1)).astype(jnp.int32)))
    dt = timeit(seg, k2)
    print(f"segment-id cumsum [{N}]: {dt*1e3:.1f} ms")

    # transfers
    for mb in (8, 32, 128):
        host = np.empty(mb << 20, np.uint8)
        dev = jax.device_put(jnp.zeros(mb << 20, jnp.uint8))
        jax.block_until_ready(dev)
        t0 = time.time()
        _ = np.asarray(dev)
        d2h = time.time() - t0
        t0 = time.time()
        jax.block_until_ready(jax.device_put(host))
        h2d = time.time() - t0
        print(f"{mb} MB: d2h {mb/d2h:.0f} MB/s  h2d {mb/h2d:.0f} MB/s")


if __name__ == "__main__":
    main()

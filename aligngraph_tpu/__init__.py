"""aligngraph_tpu — reference-guided genome reassembly engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of AlignGraph
(Bao, Jiang, Girke 2014): align PE reads and de-novo contigs to a closely
related reference genome with an *in-engine* seed-and-extend aligner
(replacing the reference's Bowtie2/BLAT/NUCMER subprocess calls), build a
position-annotated A-Bruijn graph as tensors over the genome position
axis, and extend/join contigs by coverage-thresholded path traversal.  It
runs on an NVIDIA GPU and on the CPU.

Architecture (arrays, not files; positions, not pointers):
  io/        FASTA parsing + input formalization (reference C2-C4 semantics)
  ops/       device ops: banded SW DP, seed hashing
  align/     seed-and-extend aligners (read mode = bowtie2 replacement,
             long-query mode = BLAT/NUCMER replacement)
  graph/     position-indexed graph tensors, contig/k-mer layers, traversal
  pipeline/  end-to-end driver, refinement, checkpointing, misassembly removal
  evaluate/  assembly statistics (Eval-AlignGraph equivalent)
  parallel/  device mesh, shardings, collectives for multi-device/multi-host
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache sits at a fixed path in the checkout (the
# path is part of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Host malloc tuning: on sandboxed kernels first-touch page faults make
# fresh large allocations ~1000x slower than warm memory; keep freed
# pages on the heap so numpy temporaries reuse them (utils/hostmem.py).
from aligngraph_tpu.utils.hostmem import tune_host_malloc as _thm

_thm()

from aligngraph_tpu.config import Config  # noqa: F401

"""Seed index + candidate-diagonal selection (bowtie2/BLAT seeding replaced).

The reference shells out to bowtie2 (FM-index) / BLAT for seeding+alignment
(AlignGraph.cpp:3581-3656).  Our device equivalent is a sorted
CANONICAL k-mer position index over the concatenated genome axis:

 - build (host, numpy): pack every `seed_len`-mer (2-bit codes) into int32,
   drop windows containing N, canonicalize (min of the packed k-mer and
   its reverse complement; odd seed_len so no palindromes), sort by
   canonical value -> (sorted_kmers, sorted_posflip).  Each position entry
   packs the genome offset (bits 0-30) and a flip bit (bit 31: the genome
   k-mer was NOT the canonical form).  One-time cost per reference genome.
 - lookup (device, XLA): canonicalize query seeds, bucketed binary search,
   gather up to `max_hits` (position, flip) entries per seed.  ONE lookup
   per read serves BOTH orientations: hit orientation = query_flip XOR
   genome_flip (the bowtie2 strand bit, SAM 0x10).
 - candidate selection (device): per read, cluster hit diagonals within
   `band_pad` — reverse-orientation diagonals are offset by RC_OFFSET so
   the two strands can never co-cluster — and emit the top
   `max_candidates` clusters by vote count (deterministic tie-break on
   diagonal), jointly over both orientations.

seed_len must be odd and <= 15 so a packed seed fits in a non-negative
int32; genome length must be < RC_OFFSET (2^29) — larger genomes must be
sharded (--part / per-chromosome iterativeMap), exactly like the
reference's own memory sharding.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INVALID_DIAG = np.int32(2**31 - 1)
RC_OFFSET = np.int32(1 << 29)     # added to reverse-orientation diagonals
POS_MASK = np.int32(0x7FFFFFFF)


@dataclasses.dataclass
class SeedIndex:
    """Sorted canonical k-mer position index + prefix bucket table.

    Host (numpy) arrays are authoritative; device copies are created
    lazily (reads use device lookup in the hot path, contigs use host
    np.searchsorted for one-off long queries).

    sorted_posflip[i] = genome position | (flip << 31) as int32 (negative
    iff the genome k-mer was reverse-complemented into canonical form).

    bucket_lo[p] is the first index in sorted_kmers whose top
    (2*seed_len - suffix_bits) packed bits are >= p; a device lookup is
    then one table gather + a short binary search inside the bucket
    (search_steps = log2 of the largest bucket) instead of a full-depth
    searchsorted over all k-mers.  The prefix width adapts to the genome
    (~4 table slots per k-mer, capped at 26 bits / 256MB)."""
    seed_len: int
    genome_len: int
    sorted_kmers_np: np.ndarray    # [M] int32 canonical, ascending
    sorted_posflip_np: np.ndarray  # [M] int32 pos | flip<<31
    bucket_lo_np: np.ndarray       # [2^prefix_bits + 1] int32
    search_steps: int              # binary-search iterations within bucket
    suffix_bits: int               # low packed bits not covered by table
    _device: tuple = None

    @property
    def n_kmers(self) -> int:
        return int(self.sorted_kmers_np.shape[0])

    def device_arrays(self):
        if self._device is None:
            self._device = (jnp.asarray(self.sorted_kmers_np),
                            jnp.asarray(self.sorted_posflip_np),
                            jnp.asarray(self.bucket_lo_np))
        return self._device

    @property
    def sorted_kmers(self):
        return self.device_arrays()[0]

    @property
    def sorted_posflip(self):
        return self.device_arrays()[1]

    @property
    def bucket_lo(self):
        return self.device_arrays()[2]


def pack_kmers_np(codes: np.ndarray, seed_len: int):
    """All overlapping seed_len-mers of `codes` -> (packed int32, valid bool).

    packed[i] encodes codes[i:i+seed_len] big-endian 2 bits/base; windows
    containing N (code>=4) are invalid.
    """
    n = len(codes)
    m = n - seed_len + 1
    if m <= 0:
        return (np.zeros(0, np.int32), np.zeros(0, bool))
    c = codes.astype(np.int64)
    packed = np.zeros(m, dtype=np.int64)
    invalid = np.zeros(m, dtype=bool)
    for k in range(seed_len):
        w = c[k:k + m]
        packed = (packed << 2) | np.where(w >= 4, 0, w)
        invalid |= w >= 4
    return packed.astype(np.int32), ~invalid


def rc_packed_np(packed: np.ndarray, seed_len: int) -> np.ndarray:
    """Reverse complement of 2-bit packed k-mers (complement = base^3)."""
    p = packed.astype(np.int64)
    out = np.zeros_like(p)
    for i in range(seed_len):
        out = (out << 2) | (((p >> (2 * i)) & 3) ^ 3)
    return out.astype(np.int32)


def rc_packed(packed: jax.Array, seed_len: int) -> jax.Array:
    """Device rc_packed_np."""
    p = packed.astype(jnp.int32)
    out = jnp.zeros_like(p)
    for i in range(seed_len):
        out = (out << 2) | (((p >> (2 * i)) & 3) ^ 3)
    return out


def build_index(genome_codes: np.ndarray, seed_len: int = 15) -> SeedIndex:
    """Host-side one-time canonical index build over the concatenated
    genome."""
    if seed_len > 15:
        raise ValueError("seed_len must be <= 15 (int32 packing)")
    if seed_len % 2 == 0:
        raise ValueError("seed_len must be odd (canonical k-mers need "
                         "palindrome-free packing)")
    if len(genome_codes) >= int(RC_OFFSET) - (1 << 20):
        raise ValueError(
            f"genome part too large for the int32 seed index "
            f"({len(genome_codes)} >= 2^29): shard it with --part / "
            f"--iterativeMap (per-chromosome parts, like the reference's "
            f"memory sharding, AlignGraph.cpp:3347-3418)")
    packed, valid = pack_kmers_np(genome_codes, seed_len)
    pos = np.nonzero(valid)[0].astype(np.int32)
    fwd = packed[pos]
    rc = rc_packed_np(fwd, seed_len)
    flip = rc < fwd
    kmers = np.where(flip, rc, fwd)
    posflip = np.where(flip, pos | np.int32(-2**31), pos).astype(np.int32)
    order = np.argsort(kmers, kind="stable")
    sorted_kmers = kmers[order]
    # ~4 table slots per k-mer; cap 26 bits = 256 MB table (a finer table
    # shrinks the largest bucket and hence the probe count)
    prefix_bits = min(26, 2 * seed_len,
                      max(14, int(np.ceil(np.log2(max(len(kmers), 2)))) + 2))
    if 2 * seed_len <= 26 and len(kmers) >= (1 << 20):
        # big genome + short seed: pay for the full-width table (<=256 MB)
        # so lookups are direct-addressed (suffix_bits == 0 -> no binary
        # probes, no key-row gather)
        prefix_bits = 2 * seed_len
    suffix_bits = 2 * seed_len - prefix_bits
    n_buckets = 1 << prefix_bits
    counts = np.bincount(sorted_kmers >> suffix_bits, minlength=n_buckets)
    bucket_lo = np.zeros(n_buckets + 1, np.int32)
    bucket_lo[1:] = np.cumsum(counts).astype(np.int32)
    max_bucket = int(counts.max()) if counts.size else 0
    return SeedIndex(
        seed_len=seed_len,
        genome_len=int(len(genome_codes)),
        sorted_kmers_np=sorted_kmers,
        sorted_posflip_np=posflip[order],
        bucket_lo_np=bucket_lo,
        search_steps=(0 if suffix_bits == 0 else
                      max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)),
        suffix_bits=suffix_bits,
    )


def pack_query_seeds(seqs: jax.Array, seed_len: int, stride: int):
    """Device: pack seeds at `stride` offsets from padded reads [R, L].

    Returns (packed [R, S] int32, offsets [S] int32, valid [R, S] bool);
    seeds whose window contains a pad/N code are invalid.
    """
    R, L = seqs.shape
    offsets = jnp.arange(0, max(L - seed_len + 1, 1), stride, dtype=jnp.int32)
    S = offsets.shape[0]
    idx = offsets[:, None] + jnp.arange(seed_len, dtype=jnp.int32)[None, :]
    win = seqs[:, idx]                       # [R, S, seed_len]
    w = win.astype(jnp.int32)
    invalid = jnp.any(w >= 4, axis=-1)
    w = jnp.where(w >= 4, 0, w)
    shifts = (2 * (seed_len - 1 - jnp.arange(seed_len)))[None, None, :]
    packed = jnp.sum(w << shifts, axis=-1).astype(jnp.int32)
    return packed, offsets, ~invalid


def _slice_gather(arr: jax.Array, lo: jax.Array, width: int,
                  pad_value=0) -> jax.Array:
    """Gather contiguous runs: out[..., j] = arr_padded[lo[...] + j].

    Rows-of-8 formulation: one gather index per aligned 8-element row,
    phase-shifted in registers, instead of one index per element
    (arrp[lo[...,None]+arange]) or lax.gather with slice_sizes /
    vmap(dynamic_slice).  The choice was timed on the former accelerator
    only; not measured on the H100."""
    M = arr.shape[0]
    nr = (width + 14) // 8          # rows covering width bytes + phase 7
    M8 = (M + 8 * nr + 7) // 8 * 8
    pad = jnp.full((M8 - M,), pad_value, arr.dtype)
    a2 = jnp.concatenate([arr, pad]).reshape(-1, 8)
    lo_c = jnp.clip(lo, 0, M).astype(jnp.int32)
    rows = a2[(lo_c >> 3)[..., None] + jnp.arange(nr, dtype=jnp.int32)]
    flat = rows.reshape(lo.shape + (nr * 8,))
    ph = (lo_c & 7)[..., None]
    out = flat[..., 0:width]
    for s in range(1, 8):
        out = jnp.where(ph == s, flat[..., s:s + width], out)
    return out


@partial(jax.jit, static_argnames=("max_hits",))
def lookup_seeds(sorted_kmers, sorted_posflip, packed, valid,
                 max_hits: int):
    """Full-depth searchsorted lookup of CANONICAL query packs.

    Seeds with more than max_hits occurrences are *dropped entirely*
    (repetitive-seed policy, analogous to aligner multiseed filters) —
    this keeps candidate selection deterministic and bounded.

    packed/valid: [R, S] (already canonicalized).  Returns
    (posflip [R, S, max_hits] int32, ok [R, S, max_hits] bool).
    """
    lo = jnp.searchsorted(sorted_kmers, packed, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(sorted_kmers, packed, side="right").astype(jnp.int32)
    count = hi - lo
    ok = (
        valid[..., None]
        & (count[..., None] <= max_hits)
        & (jnp.arange(max_hits) < count[..., None])
    )
    pf = _slice_gather(sorted_posflip, lo, max_hits)
    return pf, ok


@partial(jax.jit, static_argnames=("max_hits", "steps", "suffix_bits"))
def lookup_seeds_bucketed(sorted_kmers, sorted_posflip, bucket_lo, packed,
                          valid, max_hits: int, steps: int,
                          suffix_bits: int):
    """Two-level lookup_seeds: identical results, far fewer gathers.

    A full searchsorted over M k-mers costs ~2*log2(M) dependent random
    gathers per query.  Here the prefix bucket table bounds the range in
    one gather, then `steps` (= log2 of the largest bucket) bounded
    binary-search iterations resolve the LEFT bound of the k-mer run.
    There is no right-bound search: the run length (capped at
    max_hits + 1, which is all the repetitive-seed policy needs) is read
    from a (max_hits+1)-wide key gather at lo — keys are sorted, so the
    equal run is a prefix.  The key-row gather costs ~1 probe; the
    right-bound search it replaces costs `steps` probes."""
    M = sorted_kmers.shape[0]
    prefix = (packed >> suffix_bits).astype(jnp.int32)
    # (lo0, hi0) are adjacent table entries: one 2-wide row gather
    lohi = _slice_gather(bucket_lo, prefix, 2)
    lo, hi = lohi[..., 0], lohi[..., 1]
    if suffix_bits == 0:
        # direct-addressed table: the bucket IS the exact k-mer run, so
        # (lo, hi) already bound it — no binary probes, no key gather
        count = hi - lo
        ok = (
            valid[..., None]
            & (count[..., None] <= max_hits)
            & (jnp.arange(max_hits) < count[..., None])
        )
        pf = _slice_gather(sorted_posflip, lo, max_hits)
        return pf, ok
    for _ in range(steps):
        go = lo < hi
        mid = (lo + hi) >> 1
        less = sorted_kmers[jnp.clip(mid, 0, M - 1)] < packed
        lo = jnp.where(go & less, mid + 1, lo)
        hi = jnp.where(go & ~less, mid, hi)

    # run-length count from a (max_hits+1)-wide key row gather (keys are
    # sorted, so the equal run is a prefix).  Pad value 2^31-1 can never
    # equal a packed k-mer (< 2^(2*seed_len) <= 2^30), so off-end reads
    # never inflate the count.
    keys = _slice_gather(sorted_kmers, lo, max_hits + 1,
                         pad_value=np.int32(2**31 - 1))
    count = jnp.sum(keys == packed[..., None], axis=-1)  # min(run, mh+1)
    ok = (
        valid[..., None]
        & (count[..., None] <= max_hits)
        & (jnp.arange(max_hits) < count[..., None])
    )
    pf = _slice_gather(sorted_posflip, lo, max_hits)
    return pf, ok


@partial(jax.jit, static_argnames=("seed_len", "band_pad",
                                   "max_candidates"))
def select_candidates(posflip, ok, qflip, seed_offsets, qlens,
                      seed_len: int, band_pad: int, max_candidates: int):
    """Cluster hit diagonals per read (both orientations at once) ->
    top candidate diagonals.

    posflip/ok: [R, S, H] from lookup (canonical index);
    qflip: [R, S] query-seed flip bits; seed_offsets: [S]; qlens: [R].

    Hit orientation o = qflip ^ genome_flip.  Forward diagonal =
    pos - offset; reverse diagonal = pos - (qlen - offset - seed_len)
    (the seed's offset within the reverse-complemented read), offset by
    RC_OFFSET so strands never co-cluster.

    Clustering: sort diagonals; a new cluster starts when the gap to the
    previous diagonal exceeds band_pad; cluster vote = size; representative
    diagonal = cluster minimum (deterministic).  Top-C by (votes desc,
    diag asc).

    Returns (diags [R, C] int32 = genome position aligned to base 0 of the
    read in ALIGNED orientation, votes [R, C], orient [R, C] int32); empty
    slots have diag=INVALID_DIAG, votes=0.
    """
    R, S, H = posflip.shape
    N = S * H
    pos = posflip & POS_MASK
    gflip = posflip < 0
    o = gflip ^ qflip[..., None]                       # [R, S, H]
    off_f = seed_offsets[None, :, None].astype(jnp.int32)
    off_r = (qlens[:, None, None] - off_f
             - jnp.int32(seed_len))
    diag = jnp.where(o, pos - off_r + RC_OFFSET, pos - off_f)
    diag = jnp.where(ok, diag, INVALID_DIAG).reshape(R, N)

    diag = jnp.sort(diag, axis=1)        # invalids sort to the end
    prev = jnp.concatenate(
        [jnp.full((R, 1), -(2**30), jnp.int32), diag[:, :-1]], axis=1)
    is_valid = diag != INVALID_DIAG
    new_cluster = is_valid & ((diag - prev) > band_pad)
    # cluster votes via run lengths: for a cluster-start at i, votes =
    # (index of next cluster start, or #valid) - i.  next-start index is a
    # suffix-min over start positions (flip + cummin + flip).
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (R, N))
    n_valid = jnp.sum(is_valid, axis=1, keepdims=True).astype(jnp.int32)
    start_idx = jnp.where(new_cluster, idx, jnp.int32(N))
    nxt = jnp.concatenate([start_idx[:, 1:],
                           jnp.full((R, 1), N, jnp.int32)], axis=1)
    next_start = jnp.flip(
        jax.lax.cummin(jnp.flip(nxt, axis=1), axis=1), axis=1)
    votes_at_start = jnp.minimum(next_start, n_valid) - idx
    votes = jnp.where(new_cluster, votes_at_start, 0)
    rep_diag = jnp.where(new_cluster, diag, INVALID_DIAG)
    # rank clusters by (votes desc, rep_diag asc): ONE multi-operand
    # lexicographic lax.sort carries both keys, with no argsort +
    # take_along_axis gather chain.
    neg_sorted, diag_sorted = jax.lax.sort(
        (-votes, rep_diag), dimension=1, num_keys=2, is_stable=True)
    out_votes = -neg_sorted[:, :max_candidates]
    out_diag = diag_sorted[:, :max_candidates]
    orient = ((out_diag != INVALID_DIAG)
              & (out_diag >= RC_OFFSET)).astype(jnp.int32)
    out_diag = jnp.where(out_votes > 0,
                         out_diag - orient * RC_OFFSET, INVALID_DIAG)
    return out_diag, out_votes, orient

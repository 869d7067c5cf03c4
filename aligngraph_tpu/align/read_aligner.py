"""In-engine PE short-read aligner — the bowtie2 replacement (C5).

Reference invocation being replaced (AlignGraph.cpp:3601-3609):
  bowtie2 -f --no-mixed -k 5 --local --mp 3,1 --rdg 2,1 --rfg 2,1
          --score-min G,5,2 -I distanceLow -X distanceHigh
          --no-discordant --reorder

Device pipeline (all device work under jit, static shapes):
  1. both orientations of every mate (fwd + revcomp)
  2. seed lookup in the sorted k-mer genome index (ops/seeding.py)
  3. candidate diagonals by clustered seed votes
  4. banded affine local SW + exact traceback (ops/banded_sw.py)
  5. per-candidate parse quantities (parseBOWTIE equivalents)
  6. PE pairing: opposite strands, facing orientation, fragment length in
     [distanceLow, distanceHigh] (-I/-X), per-mate score >= 5 + 2*ln(len)
     (--score-min G,5,2), top-K pairs by combined score (-k 5),
     deterministic tie-break (fragment start, then end)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from aligngraph_tpu.align.types import PairAlignments
from aligngraph_tpu.config import Config
from aligngraph_tpu.io.formalize import Reads
from aligngraph_tpu.ops.banded_sw import banded_sw_posmap_auto
from aligngraph_tpu.ops.seeding import (
    INVALID_DIAG, SeedIndex, build_index, lookup_seeds_bucketed,
    pack_query_seeds, rc_packed, select_candidates,
)

SCORE_MIN_CONST = 5.0   # bowtie2 --score-min G,5,2
SCORE_MIN_COEFF = 2.0
MAX_PAIR_HITS = 5       # bowtie2 -k 5
MAXSEG = 8              # M-block segments per alignment (transfer format)
THRESHOLD = 0.6         # C13 read-pair ratio filter (AlignGraph.cpp:34)

_COMP = jnp.array([3, 2, 1, 0, 4], dtype=jnp.int8)


def pack_reads_np(seqs: np.ndarray):
    """Host: int8 codes [R, L] -> (2-bit packed [R, ceil(L/4)] uint8,
    N/pad bitmask [R, ceil(L/8)] uint8).  2.25 bits/base vs 8 shrinks the
    host->device input ~3.6x."""
    R, L = seqs.shape
    L4 = (L + 3) // 4
    L8 = (L + 7) // 8
    pad4 = np.zeros((R, 4 * L4 - L), np.int8)
    s4 = np.concatenate([seqs, pad4], axis=1).astype(np.uint8)
    b = s4 & 3
    u2 = (b[:, 0::4] | (b[:, 1::4] << 2) | (b[:, 2::4] << 4)
          | (b[:, 3::4] << 6))
    isn = (s4 >= 4)
    pad8 = np.ones((R, 8 * L8 - 4 * L4), bool)
    n8 = np.concatenate([isn, pad8], axis=1)
    nmask = np.zeros((R, L8), np.uint8)
    for k in range(8):
        nmask |= n8[:, k::8].astype(np.uint8) << k
    return u2, nmask


def _unpack_reads(u2: jax.Array, nmask: jax.Array, L: int) -> jax.Array:
    """Device inverse of pack_reads_np -> int8 codes [R, L] (N/pad = 4)."""
    i = jnp.arange(L, dtype=jnp.int32)
    b = (u2[:, i // 4].astype(jnp.int32) >> (2 * (i % 4))) & 3
    n = (nmask[:, i // 8].astype(jnp.int32) >> (i % 8)) & 1
    return jnp.where(n == 1, 4, b).astype(jnp.int8)


def _revcomp_padded(seqs: jax.Array, lens: jax.Array) -> jax.Array:
    """Reverse-complement padded reads: rc[i] = comp(seq[len-1-i]) for
    i < len, pad 4 beyond.  (Device path of the full-layout fallback; the
    production packed pipeline receives it computed on the host.)"""
    R, L = seqs.shape
    idx = lens[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
    ok = idx >= 0
    vals = jnp.take_along_axis(seqs, jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(ok, _COMP[vals.astype(jnp.int32)], jnp.int8(4))


_COMP_NP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def revcomp_padded_np(seqs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host revcomp of padded reads (same semantics as _revcomp_padded)."""
    R, L = seqs.shape
    if np.all(lens == L):
        # uniform full-length rows (the common case): pure slice + table
        return _COMP_NP[seqs[:, ::-1]]
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(L)[None, :]
    ok = idx >= 0
    vals = np.take_along_axis(seqs, np.clip(idx, 0, L - 1), axis=1)
    return np.where(ok, _COMP_NP[vals], np.int8(4))


WORDS_FP = 8192   # fixed front/back pad of the packed word table


def pack_genome_words_np(genome_codes: np.ndarray) -> np.ndarray:
    """Host: genome int8 codes -> the 32-byte-aligned word table
    [T/32, 8] int32 that _window_slices row-gathers (padding value 4 on
    both flanks; front pad WORDS_FP covers negative window starts)."""
    G = len(genome_codes)
    T = (WORDS_FP + G + WORDS_FP + 31) // 32 * 32
    gp = np.full(T, 4, np.int8)
    gp[WORDS_FP:WORDS_FP + G] = genome_codes
    v = gp.reshape(-1, 4).astype(np.int32)
    return (v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16)
            | (v[:, 3] << 24)).reshape(-1, 8)


def _candidate_stats(pos_map, qlens):
    """parseBOWTIE-equivalent quantities from a position map.

    Returns dict of [B] arrays: src_start/src_end/src_gap (I), tgt_start,
    tgt_end (reference formula ts + size + D - I, AlignGraph.cpp:282),
    tgt_gap (D), match count.
    """
    B, L = pos_map.shape
    aligned = pos_map >= 0
    m = jnp.sum(aligned, axis=1).astype(jnp.int32)
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    big = jnp.int32(2**30)
    ss = jnp.min(jnp.where(aligned, idx, big), axis=1)
    se = jnp.max(jnp.where(aligned, idx + 1, -1), axis=1)
    ss = jnp.where(m > 0, ss, 0)
    se = jnp.where(m > 0, se, 0)
    ins = (se - ss) - m
    ts = jnp.min(jnp.where(aligned, pos_map, big), axis=1)
    tea = jnp.max(jnp.where(aligned, pos_map + 1, -1), axis=1)
    ts = jnp.where(m > 0, ts, -1)
    tea = jnp.where(m > 0, tea, -1)
    dele = jnp.where(m > 0, (tea - ts) - m, 0)
    te_ref = jnp.where(m > 0, ts + qlens + dele - ins, -1)
    return dict(match=m, src_start=ss, src_end=se, src_gap=ins,
                tgt_start=ts, tgt_end_actual=tea, tgt_end=te_ref,
                tgt_gap=dele)


def _extract_segments(pm: jax.Array):
    """Device: pos_map rows [B, L] -> M-block segments [B, MAXSEG, 3]
    (src_start, tgt_start, size; -1-filled) + overflow flag [B].

    Segments are ~8x smaller than position maps and reconstruct them
    exactly, so the device->host transfer moves ~8x fewer bytes.
    Implemented as masked reductions per segment slot (dense masked
    reduces over [B, L], no scatter)."""
    B, L = pm.shape
    aligned = pm >= 0
    prev_a = jnp.concatenate([jnp.zeros((B, 1), bool), aligned[:, :-1]],
                             axis=1)
    prev_p = jnp.concatenate([jnp.full((B, 1), -2, pm.dtype),
                              pm[:, :-1]], axis=1)
    is_start = aligned & (~prev_a | (pm != prev_p + 1))
    run_id = jnp.cumsum(is_start.astype(jnp.int32), axis=1) - 1
    n_runs = run_id[:, -1] + 1
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    cols = []
    for s in range(MAXSEG):
        in_run = aligned & (run_id == s)
        start_s = is_start & (run_id == s)
        src = jnp.max(jnp.where(start_s, idx, -1), axis=1)
        tgt = jnp.max(jnp.where(start_s, pm, -1), axis=1)
        size = jnp.sum(in_run, axis=1).astype(jnp.int32)
        cols.append(jnp.stack(
            [src, tgt, jnp.where(size > 0, size, -1)], axis=-1))
    segs = jnp.stack(cols, axis=1)                    # [B, MAXSEG, 3]
    overflow = n_runs > MAXSEG
    return segs, overflow


def reconstruct_pos_map(segs: np.ndarray, L: int) -> np.ndarray:
    """Host: segments [..., MAXSEG, 3] -> pos_map [..., L] int32."""
    lead = segs.shape[:-2]
    pm = np.full(lead + (L,), -1, np.int32)
    idx = np.arange(L, dtype=np.int32)
    for s in range(segs.shape[-2]):
        st = segs[..., s, 0:1]
        ts = segs[..., s, 1:2]
        sz = segs[..., s, 2:3]
        m = (sz > 0) & (idx >= st) & (idx < st + sz)
        pm = np.where(m, ts + (idx - st), pm)
    return pm


@dataclasses.dataclass
class ReadAligner:
    """Holds the genome on device + seed index; aligns batches of pairs.

    c13: apply the reference's read-pair ratio filter (C13,
    AlignGraph.cpp:1261, THRESHOLD 0.6) ON DEVICE so rejected records
    are never transferred to the host.  Identical end state to the
    host-side filter the driver applies (records failing it are dropped
    there anyway); set False for consumers that need raw records (the
    misassembly-removal coverage loader, AlignGraph.cpp:3940-3984).
    """
    genome: jax.Array          # [G] int8
    index: SeedIndex
    cfg: Config
    batch_pairs: int = 32768
    c13: bool = True
    gwords: Optional[jax.Array] = None   # pack_genome_words_np table
    glen: int = 0

    @classmethod
    def build(cls, genome_codes: np.ndarray, cfg: Config,
              batch_pairs: int = 32768, c13: bool = True) -> "ReadAligner":
        idx = build_index(genome_codes, cfg.seed_len)
        return cls(genome=jnp.asarray(genome_codes), index=idx, cfg=cfg,
                   batch_pairs=batch_pairs, c13=c13,
                   gwords=jnp.asarray(pack_genome_words_np(genome_codes)),
                   glen=int(len(genome_codes)))

    # ------------------------------------------------------------------
    def align(self, reads: Reads) -> PairAlignments:
        """Align all pairs; returns accepted pair alignments (host SoA).

        Device dispatch is asynchronous: all batches are enqueued before
        any result is pulled, so compute, device->host transfer, and host
        post-processing of consecutive batches overlap.

        Transfer format: the device compacts the [P, K] pair-hit table to
        its valid slots (~1 per pair in practice) and ships int16-packed
        M-block segments only; the parse quantities (C9 equivalents) are
        recomputed on host from the segments with the exact device
        formulas.  If a batch has more valid slots than the compaction
        capacity (extreme multi-mapping), it transparently re-runs through
        the full-layout path."""
        cfg = self.cfg
        L = max(reads.max_len, cfg.seed_len)
        if L > 32767 - 2 * cfg.band_pad:
            # packed transfer fields (seg1/ovf_src/ovf_dt/ovf_sz/score)
            # are int16 and would wrap silently for ultra-long reads
            raise ValueError(
                f"read length {L} exceeds the PE read aligner's int16 "
                f"transfer limit ({32767 - 2 * cfg.band_pad}); long "
                f"queries belong to the contig aligner")
        n = reads.n_pairs
        pending = []
        for start in range(0, max(n, 1), self.batch_pairs):
            cnt = min(self.batch_pairs, n - start) if n else 0
            # per-batch adaptive shape: batch_pairs is a memory CAP, not an
            # exact size.  Small inputs and the tail batch of a large input
            # use the next power of two (>= 1024) so a 1.7k-pair tail does
            # not burn a full 32k-pair device program.  Shapes stay
            # power-of-two so at most log2 distinct programs ever compile.
            # The packed transfer layout needs P % 128 == 0 (M = 3P/2,
            # E = P/2 and the P/4 meta bytes pack whole int32 words).
            P = min(self.batch_pairs,
                    max(1024, 1 << (max(cnt, 1) - 1).bit_length()))
            P = -(-P // 128) * 128
            seqs = np.full((2 * P, L), 4, np.int8)
            plens = np.zeros(P, np.int32)
            if cnt > 0:
                blk = reads.data[2 * start:2 * (start + cnt)]
                seqs[:2 * cnt, :blk.shape[1]] = blk
                plens[:cnt] = reads.lengths[start:start + cnt]
            u2, nmask = pack_reads_np(seqs)
            rcseqs = revcomp_padded_np(seqs, np.repeat(plens, 2))
            u2r, nmr = pack_reads_np(rcseqs)
            dev = _align_pairs_packed(
                self.gwords, self.index.sorted_kmers,
                self.index.sorted_posflip, self.index.bucket_lo,
                jnp.asarray(u2), jnp.asarray(nmask),
                jnp.asarray(u2r), jnp.asarray(nmr),
                jnp.asarray(plens), L=L,
                seed_len=cfg.seed_len, stride=cfg.seed_stride,
                pad=cfg.band_pad, C=cfg.max_candidates,
                K=MAX_PAIR_HITS, dlow=cfg.distance_low,
                dhigh=cfg.distance_high,
                bsteps=self.index.search_steps,
                sbits=self.index.suffix_bits, c13=self.c13,
                mh=cfg.max_seed_hits, G=self.glen)
            # start the device->host copy as soon as compute finishes so
            # it overlaps later batches' device work instead of
            # serializing in the fetch loop
            try:
                dev.copy_to_host_async()
            except AttributeError:
                pass
            pending.append((start, cnt, P, dev, seqs, plens))
        dense = L <= 255 and cfg.distance_high <= 32000
        out_chunks = []
        for start, cnt, P, dev, seqs, plens in pending:
            if dense:
                res = unpack_dense(np.asarray(dev), P)
                overflow = (res["n_extras"] > res["ex_id"].shape[0]
                            or res["n_ovf"] > res["ov_id"].shape[0])
            else:
                res = unpack_records(np.asarray(dev), P)
                overflow = (int(res["n_valid"]) > res["slot_id"].shape[0]
                            or int(res["n_ovf"]) > res["ovf_slot"].shape[0])
            if overflow:
                # compaction overflow (pathological multi-mapping or
                # ultra-gappy batch): re-run through the uncompacted path
                full = _align_pairs_device(
                    self.gwords, self.index.sorted_kmers,
                    self.index.sorted_posflip, self.index.bucket_lo,
                    jnp.asarray(seqs),
                    jnp.asarray(plens), seed_len=cfg.seed_len,
                    stride=cfg.seed_stride, pad=cfg.band_pad,
                    C=cfg.max_candidates, K=MAX_PAIR_HITS,
                    dlow=cfg.distance_low, dhigh=cfg.distance_high,
                    bsteps=self.index.search_steps,
                    sbits=self.index.suffix_bits,
                    mh=cfg.max_seed_hits, G=self.glen)
                full = jax.tree_util.tree_map(np.asarray, full)
                if self.c13:
                    # np.asarray views of jax arrays are read-only
                    full["valid"] = full["valid"] & np.asarray(
                        _c13_mask_np(full))
                out_chunks.append(_expand_full(full, start, cnt, L))
            elif dense:
                out_chunks.append(
                    _expand_dense(res, start, cnt, L, plens))
            else:
                out_chunks.append(
                    _expand_packed(res, start, cnt, L, plens))
        cat = {k: np.concatenate([c[k] for c in out_chunks])
               for k in out_chunks[0]}
        return PairAlignments(**cat)


def _expand_full(res, start: int, cnt: int, L: int) -> dict:
    """Host extraction from the full [P, K] device layout."""
    valid = res["valid"]
    p_ids, k_ids = np.nonzero(valid[:cnt] if cnt else valid[:0])
    sel = (p_ids, k_ids)
    return dict(
        pair_id=(p_ids + start).astype(np.int32),
        fr=res["fr"][sel],
        score=res["score"][sel],
        source_start=res["src_start"][sel],
        source_end=res["src_end"][sel],
        source_gap=res["src_gap"][sel],
        source_size=res["src_size"][sel],
        target_start=res["tgt_start"][sel],
        target_end=res["tgt_end"][sel],
        target_gap=res["tgt_gap"][sel],
        pos_map=reconstruct_pos_map(res["segs"][sel], L),
    )


def _window_slices(genome: jax.Array, start: jax.Array, WL: int,
                   P0: int, G=None) -> jax.Array:
    """Per-row contiguous genome windows, 32-byte-aligned-row gather.

    out[i] = genome[start[i] : start[i]+WL] with out-of-range bases = 4.
    start must satisfy start >= -P0.  Gathers aligned 32-byte rows (as
    8 x int32) and phase-shifts them in registers: one gather index per
    row instead of one per base.  (The formulation was chosen by timings
    on the former accelerator; not measured on the H100.)  Without the
    precomputed word table the int32 packing of the genome is recomputed
    per call."""
    B = start.shape[0]
    if G is not None:
        # production path: `genome` IS the precomputed word table from
        # pack_genome_words_np (host-packed once at build, so no batch
        # repacks the whole genome)
        FP = WORDS_FP
        words = genome
    else:
        G = genome.shape[0]
        FP = (P0 + 31) // 32 * 32
        T = (FP + G + FP + 32 * ((WL + 62) // 32) + 31) // 32 * 32
        gp = jnp.concatenate([
            jnp.full((FP,), 4, jnp.int8), genome,
            jnp.full((T - FP - G,), 4, jnp.int8)])
        v = gp.reshape(-1, 4).astype(jnp.int32)
        words = (v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16)
                 | (v[:, 3] << 24)).reshape(-1, 8)   # [T/32, 8]
    NR = (WL + 62) // 32                 # rows covering WL + byte phase
    NWv = (WL + 3) // 4 + 1              # words covering WL + word phase
    assert NWv + 7 <= NR * 8
    if words is genome:
        # precomputed table: the BACK pad must absorb the row-gather
        # overrun (the compat path sizes its tail by 32*NR instead)
        assert WL + 64 <= WORDS_FP
    lo = jnp.clip(start + FP, 0, G + FP).astype(jnp.int32)
    rows = words[(lo >> 5)[:, None] + jnp.arange(NR, dtype=jnp.int32)]
    ww = rows.reshape(B, NR * 8)
    sw = ((lo >> 2) & 7)[:, None]
    out_w = ww[:, 0:NWv]
    for s in range(1, 8):
        out_w = jnp.where(sw == s, ww[:, s:s + NWv], out_w)
    by = jnp.stack([out_w & 0xFF, (out_w >> 8) & 0xFF,
                    (out_w >> 16) & 0xFF, (out_w >> 24) & 0xFF],
                   axis=-1).reshape(B, 4 * NWv)
    ph = (lo & 3)[:, None]
    out = by[:, 0:WL]
    for s in range(1, 4):
        out = jnp.where(ph == s, by[:, s:s + WL], out)
    return out.astype(jnp.int8)


@partial(jax.jit, static_argnames=("seed_len", "stride", "pad", "C", "K",
                                   "dlow", "dhigh", "bsteps", "sbits",
                                   "mh", "G"))
def _align_pairs_device(genome, sorted_kmers, sorted_posflip, bucket_lo,
                        seqs, plens, *, seed_len, stride, pad, C, K, dlow,
                        dhigh, bsteps, sbits, mh=8, G=None):
    """One batch of P pairs -> top-K pair alignments per pair.

    Full-layout path (fallback + tests): computes the reverse complement
    on device; the production packed path receives it precomputed from
    the host."""
    rlens = jnp.repeat(plens, 2)
    rc = _revcomp_padded(seqs, rlens)
    return _align_core(genome, sorted_kmers, sorted_posflip, bucket_lo,
                       seqs, rc, plens, seed_len=seed_len, stride=stride,
                       pad=pad, C=C, K=K, dlow=dlow, dhigh=dhigh,
                       bsteps=bsteps, sbits=sbits, mh=mh, G=G)


def _align_core(genome, sorted_kmers, sorted_posflip, bucket_lo,
                seqs, rc, plens, *, seed_len, stride, pad, C, K, dlow,
                dhigh, bsteps, sbits, mh=8, G=None):
    R, L = seqs.shape            # R = 2P (mate-interleaved)
    P = R // 2
    W = 2 * pad
    WL = L + W
    rlens = jnp.repeat(plens, 2)                     # [R]
    qseqs = jnp.concatenate([seqs, rc])              # [2R, L] for DP gather
    qlens = jnp.concatenate([rlens, rlens])

    # --- seeding: ONE canonical lookup per read serves both orientations
    packed, offs, valid = pack_query_seeds(seqs, seed_len, stride)
    valid = valid & (offs[None, :] <= (rlens[:, None] - seed_len))
    pk_rc = rc_packed(packed, seed_len)
    qflip = pk_rc < packed
    pcan = jnp.minimum(packed, pk_rc)
    pf, ok = lookup_seeds_bucketed(sorted_kmers, sorted_posflip, bucket_lo,
                                   pcan, valid, mh, bsteps, sbits)
    diag_s, votes_s, orient_s = select_candidates(
        pf, ok, qflip, offs, rlens, seed_len, pad, C)    # [R, C] each
    # single-vote candidates are almost always spurious seed collisions
    # (expected ~0.5/read at 13-mers on a 4.6 Mb genome); a true placement
    # of a C13-acceptable read hits >= 2 seeds on its diagonal with
    # overwhelming probability (>= 60 aligned bases = 4+ intact seed
    # windows at stride 12).  Dropping them keeps the DP/traceback lanes
    # for real candidates.
    diag_s = jnp.where(votes_s >= 2, diag_s, INVALID_DIAG)

    # --- validity compaction: most candidate slots are empty (avg ~1.2
    # real candidates/read); sort valid-first and run DP/traceback/stats
    # on TOP = 1.5 slots/read only.  The flatten is RANK-major (all
    # rank-0 candidates of every read first), so when a repeat-heavy
    # batch overflows capacity, only the lowest-vote-rank candidates are
    # shed (deterministic; PARITY.md).
    diag_f = diag_s.T.reshape(-1)                    # [C*R] rank-major
    cvalid_f = diag_f != INVALID_DIAG
    B_full = R * C
    # DP capacity ~1.5 rows/read (at least 128), clamped to the full
    # table for tiny batches
    TOP = min(B_full, max(128, 3 * R // 2))
    # valid rows first: ONE multi-operand stable sort carries the values
    # (diag, orient, source row) through the compaction so no post-sort
    # gathers are needed
    iota_f = jnp.arange(B_full, dtype=jnp.int32)
    orient_f = orient_s.T.reshape(-1)
    inval_s, diag_s_top, orient_top, src_row = jax.lax.sort(
        ((~cvalid_f).astype(jnp.int32), diag_f, orient_f, iota_f),
        dimension=0, num_keys=1, is_stable=True)
    top = src_row[:TOP]
    inv = jnp.full(B_full, -1, jnp.int32).at[top].set(
        jnp.arange(TOP, dtype=jnp.int32))            # full row -> top row

    cvalid = inval_s[:TOP] == 0
    diag_safe = jnp.where(cvalid, diag_s_top[:TOP], 0)
    rr = top % R                                     # read row of each slot
    qidx = orient_top[:TOP] * R + rr                 # row in qseqs
    windows = _window_slices(genome, diag_safe - pad, WL, L + W,
                             G=G)
    creads = qseqs[qidx]
    clens = qlens[qidx]
    score_min = jnp.ceil(
        SCORE_MIN_CONST
        + SCORE_MIN_COEFF * jnp.log(jnp.maximum(clens, 2).astype(jnp.float32))
    ).astype(jnp.int32)
    sw_score, pos_map = banded_sw_posmap_auto(
        creads, jnp.where(cvalid, clens, 0), windows, diag_safe, pad=pad,
        smin=score_min)
    st = _candidate_stats(pos_map, clens)            # pos_map [TOP, L]
    score = jnp.where(cvalid, sw_score, -1)
    good = cvalid & (score >= score_min) & (st["match"] > 0)

    # --- per-mate candidate tables [P, 2, C] ---
    # rank-major full-layout candidate index for (pair p, mate m, cand c):
    # c*R + (2p + m), remapped through the compaction permutation
    r_ids = (2 * jnp.arange(P, dtype=jnp.int32)[:, None, None]
             + jnp.arange(2, dtype=jnp.int32)[None, :, None])   # [P,2,1]
    c_ids = jnp.arange(C, dtype=jnp.int32)[None, None, :]
    cand_full = c_ids * R + r_ids                    # [P, 2, C]
    cand = inv[cand_full]                            # top-row idx or -1
    present = cand >= 0
    cand = jnp.where(present, cand, 0)
    m_fr = orient_f[cand_full].astype(jnp.int8)
    # consolidated row-gather: every per-candidate quantity pairing needs,
    # in ONE [.., 4]-row gather instead of four scalar gathers
    mt = jnp.stack([good.astype(jnp.int32), score,
                    st["tgt_start"], st["tgt_end_actual"]], axis=-1)
    m_all = mt[cand]                                 # [P, 2, C, 4]
    m_good = (m_all[..., 0] > 0) & present
    m_score = m_all[..., 1]
    m_ts = m_all[..., 2]
    m_tea = m_all[..., 3]
    # dedup identical placements (same tgt_start & fr, earlier slot wins)
    same = ((m_ts[..., None, :] == m_ts[..., :, None])
            & (m_fr[..., None, :] == m_fr[..., :, None])
            & m_good[..., None, :] & m_good[..., :, None])
    j = jnp.arange(C)
    earlier = j[None, :] < j[:, None]                # [C, C] j' < j
    dup = jnp.any(same & earlier[None, None, :, :], axis=-1)
    m_good = m_good & ~dup

    # --- pairing [P, C, C] ---
    g1 = m_good[:, 0, :, None]
    g2 = m_good[:, 1, None, :]
    fr1 = m_fr[:, 0, :, None]
    fr2 = m_fr[:, 1, None, :]
    ts1 = m_ts[:, 0, :, None]
    ts2 = m_ts[:, 1, None, :]
    te1 = m_tea[:, 0, :, None]
    te2 = m_tea[:, 1, None, :]
    s1 = m_score[:, 0, :, None]
    s2 = m_score[:, 1, None, :]
    opp = fr1 != fr2
    ts_fwd = jnp.where(fr1 == 0, ts1, ts2)
    ts_rev = jnp.where(fr1 == 0, ts2, ts1)
    lo = jnp.minimum(ts1, ts2)
    hi = jnp.maximum(te1, te2)
    frag = hi - lo
    ok = (g1 & g2 & opp & (ts_fwd <= ts_rev)
          & (frag >= dlow) & (frag <= dhigh))
    total = jnp.where(ok, s1 + s2, -1)
    # rank: total desc, then fragment-start asc (deterministic); ONE
    # multi-operand stable sort ((score, frag-start) keys + every payload
    # pairing needs) — same ordering as the previous composed argsort +
    # take_along_axis chains (lexicographic with original-index ties) but
    # without their elementwise gathers
    big = jnp.int32(2**30)
    key_lo = jnp.where(ok, lo, big).reshape(P, -1)
    key_sc = jnp.where(ok, -total, big).reshape(P, -1)
    cand1_full = jnp.broadcast_to(cand[:, 0, :, None],
                                  (P, C, C)).reshape(P, -1)
    cand2_full = jnp.broadcast_to(cand[:, 1, None, :],
                                  (P, C, C)).reshape(P, -1)
    fr1_full = jnp.broadcast_to(m_fr[:, 0, :, None].astype(jnp.int32),
                                (P, C, C)).reshape(P, -1)
    fr2_full = jnp.broadcast_to(m_fr[:, 1, None, :].astype(jnp.int32),
                                (P, C, C)).reshape(P, -1)
    _, _, ok_s, c1_s, c2_s, f1_s, f2_s = jax.lax.sort(
        (key_sc, key_lo, ok.reshape(P, -1).astype(jnp.int32),
         cand1_full, cand2_full, fr1_full, fr2_full),
        dimension=1, num_keys=2, is_stable=True)
    out = {}
    kvalid = ok_s[:, :K] > 0
    both = jnp.stack([c1_s[:, :K], c2_s[:, :K]], axis=-1)   # [P, K, 2]
    out["fr"] = jnp.stack([f1_s[:, :K], f2_s[:, :K]],
                          axis=-1).astype(jnp.int8)
    # compact transfer format: M-block segments, extracted once over the
    # TOP DP rows (2.5x fewer rows than the [P, K, 2] hit table); then ONE
    # consolidated row-gather ships every per-hit output column (8 stats +
    # overflow flag + MAXSEG*3 segment words) per selected hit
    segs_top, ovf_top = _extract_segments(pos_map)   # [TOP, MAXSEG, 3]
    allcols = jnp.concatenate([
        jnp.stack([score, st["src_start"], st["src_end"], st["src_gap"],
                   clens, st["tgt_start"], st["tgt_end"], st["tgt_gap"],
                   ovf_top.astype(jnp.int32)], axis=-1),
        segs_top.reshape(TOP, MAXSEG * 3)], axis=1)  # [TOP, 9 + 24]
    gsel = allcols[both]                             # [P, K, 2, 33]
    out["valid"] = kvalid & ~jnp.any(gsel[..., 8] > 0, axis=-1)
    out["score"] = gsel[..., 0]
    out["src_start"] = gsel[..., 1]
    out["src_end"] = gsel[..., 2]
    out["src_gap"] = gsel[..., 3]
    out["src_size"] = gsel[..., 4]
    out["tgt_start"] = gsel[..., 5]
    out["tgt_end"] = gsel[..., 6]
    out["tgt_gap"] = gsel[..., 7]
    out["segs"] = gsel[..., 9:].reshape(P, K, 2, MAXSEG, 3)
    return out


def _c13_mask_np(out: dict) -> np.ndarray:
    """Host C13 mask over the full [P, K] layout (integer-exact 3/5)."""
    ss, se, sg = out["src_start"], out["src_end"], out["src_gap"]
    sz = out["src_size"]
    ts, te, tg = out["tgt_start"], out["tgt_end"], out["tgt_gap"]
    ok = ((se - ss - sg) * 5 >= 3 * sz) & ((te - ts - tg) * 5
                                           >= 3 * (te - ts))
    return ok.all(axis=-1)


def _pack_dense(out, P: int, K: int):
    """Dense-per-pair transfer serialization (the common case).

    Most pairs report exactly ONE hit with a single M-block per mate, so a
    [P]-dense primary record plus small sparse overflow buffers is ~2.6x
    smaller than the per-slot layout.  Requires (checked statically by
    the caller):
    L <= 255 (8-bit ss/sz) and distance_high <= 32000 (int16 mate-1
    tgt delta; |tgt1 - tgt0| <= fragment <= distance_high).

    Word layout (P % 128 == 0; capacities must match unpack_dense:
    E2 = max(P//8, min(256, P*K)) extras,
    E3 = max(P//4, min(256, P*K*2*(S-1))) segment-overflow entries):
      [0] n_extras  [1] n_ovf
      [2, 2+P/4)  meta u8 x4:  has | frp<<1 | segovf<<3
      [+P)        score  [P,2] int16 x2
      [+P)        tgt0   [P]   int32 (mate-0 tgt_start)
      [+P/2)      dt     [P]   int16 x2 (tgt1 - tgt0)
      [+P)        seg    [P]   (ss0, sz0, ss1, sz1) u8 x4
      extras (valid hits beyond the first per pair):
      [+E2)       ex_id   int32: (p*K + k) | segovf<<30, -1 empty
      [+E2/4)     ex_frp  u8 x4
      [+E2)       ex_score int16 x2
      [+2*E2)     ex_tgt  [E2, 2] int32
      [+E2)       ex_seg  (ss0, sz0, ss1, sz1) u8 x4
      segment-overflow entries (M-blocks beyond the first, any valid hit):
      [+E3)       ov_id   int32: (p*K + k)*16 + mate*8 + seg, -1 empty
      [+E3/2)     ov_ss   (src u8, sz u8) x2
      [+E3/2)     ov_dt   int16 x2 (tgt - hit tgt_base of that mate)
    """
    valid = out["valid"]                          # [P, K] bool
    segs = out["segs"]                            # [P, K, 2, S, 3] int32
    tgt = out["tgt_start"]                        # [P, K, 2]
    bc = partial(jax.lax.bitcast_convert_type, new_dtype=jnp.int32)
    S = MAXSEG
    # sparse capacities, clamped to the flat source sizes (tiny per-shard
    # P in the shard_map path would otherwise under-fill the buffers)
    E2 = max(P // 8, min(256, P * K))
    E3 = max(P // 4, min(256, P * K * 2 * (S - 1)))
    karange = jnp.arange(K, dtype=jnp.int32)

    has = valid.any(axis=1)
    k0 = jnp.argmax(valid, axis=1).astype(jnp.int32)

    def prim(a):
        return jnp.take_along_axis(
            a, k0.reshape((P, 1) + (1,) * (a.ndim - 2)), axis=1)[:, 0]

    p_fr = prim(out["fr"])                        # [P, 2] int8
    p_score = prim(out["score"])                  # [P, 2] i32
    p_tgt = prim(tgt)                             # [P, 2]
    p_segs = prim(segs)                           # [P, 2, S, 3]
    p_ovf = jnp.any(p_segs[:, :, 1:, 2] > 0, axis=(1, 2)) & has
    frp = (p_fr[:, 0] | (p_fr[:, 1] << 1)).astype(jnp.int32)
    # meta byte: bit0 has, bits1-2 frp, bit3 segovf, bits4-6 primary k
    meta = jnp.where(
        has, 1 | (frp << 1) | (p_ovf.astype(jnp.int32) << 3) | (k0 << 4),
        0)
    sc16 = jnp.where(has[:, None], p_score, 0).astype(jnp.int16)
    tgt0 = jnp.where(has, p_tgt[:, 0], -1)
    dt16 = jnp.where(has, p_tgt[:, 1] - p_tgt[:, 0], 0).astype(jnp.int16)
    ss0 = jnp.where(has[:, None] & (p_segs[:, :, 0, 2] > 0),
                    p_segs[:, :, 0, 0], 0)
    sz0 = jnp.where(has[:, None], p_segs[:, :, 0, 2], 0)
    sz0 = jnp.maximum(sz0, 0)
    seg8 = jnp.stack([ss0[:, 0], sz0[:, 0], ss0[:, 1], sz0[:, 1]],
                     axis=-1).astype(jnp.uint8)

    # extras: valid slots beyond the first, compacted in (p, k) order
    mask_e = valid & (karange[None, :] != k0[:, None])
    ef = mask_e.reshape(P * K)
    eorder = jnp.argsort(~ef, stable=True)[:E2]
    evalid = ef[eorder]
    e_p = (eorder // K).astype(jnp.int32)
    e_k = (eorder % K).astype(jnp.int32)
    e_segs = segs[e_p, e_k]                       # [E2, 2, S, 3]
    e_ovf = jnp.any(e_segs[:, :, 1:, 2] > 0, axis=(1, 2))
    ex_id = jnp.where(evalid,
                      (e_p * K + e_k) | (e_ovf.astype(jnp.int32) << 30), -1)
    e_fr = out["fr"][e_p, e_k]
    ex_frp = jnp.where(evalid, (e_fr[:, 0] | (e_fr[:, 1] << 1))
                       .astype(jnp.int32), 0).astype(jnp.uint8)
    ex_sc = jnp.where(evalid[:, None], out["score"][e_p, e_k],
                      0).astype(jnp.int16)
    ex_tgt = jnp.where(evalid[:, None], tgt[e_p, e_k], -1)
    exs = jnp.where(evalid[:, None] & (e_segs[:, :, 0, 2] > 0),
                    e_segs[:, :, 0, 0], 0)
    exz = jnp.maximum(jnp.where(evalid[:, None], e_segs[:, :, 0, 2], 0), 0)
    ex_seg = jnp.stack([exs[:, 0], exz[:, 0], exs[:, 1], exz[:, 1]],
                       axis=-1).astype(jnp.uint8)

    # segment-overflow entries over ALL valid hits
    ov_mask = valid[:, :, None, None] & (segs[:, :, :, 1:, 2] > 0)
    of = ov_mask.reshape(P * K * 2 * (S - 1))
    oorder = jnp.argsort(~of, stable=True)[:E3]
    ovalid = of[oorder]
    o_pk = (oorder // (2 * (S - 1))).astype(jnp.int32)
    rem = oorder % (2 * (S - 1))
    o_m = (rem // (S - 1)).astype(jnp.int32)
    o_s = (rem % (S - 1)).astype(jnp.int32) + 1
    o_p, o_k = o_pk // K, o_pk % K
    ov_id = jnp.where(ovalid, o_pk * 16 + o_m * 8 + o_s, -1)
    o_row = segs[o_p, o_k, o_m, o_s]              # [E3, 3]
    ov_src = jnp.where(ovalid, o_row[:, 0], 0).astype(jnp.uint8)
    ov_sz = jnp.where(ovalid, o_row[:, 2], 0).astype(jnp.uint8)
    ov_dt = jnp.where(ovalid, o_row[:, 1] - tgt[o_p, o_k, o_m],
                      0).astype(jnp.int16)

    return jnp.concatenate([
        jnp.stack([jnp.sum(ef.astype(jnp.int32)),
                   jnp.sum(of.astype(jnp.int32))]),
        bc(meta.astype(jnp.uint8).reshape(P // 4, 4)),
        bc(sc16),
        tgt0,
        bc(dt16.reshape(P // 2, 2)),
        bc(seg8),
        ex_id,
        bc(ex_frp.reshape(E2 // 4, 4)),
        bc(ex_sc),
        ex_tgt.reshape(2 * E2),
        bc(ex_seg),
        ov_id,
        bc(jnp.stack([ov_src, ov_sz], axis=-1).reshape(E3 // 2, 4)),
        bc(ov_dt.reshape(E3 // 2, 2)),
    ])


def unpack_dense(buf: np.ndarray, P: int) -> dict:
    """Host decode of the _pack_dense buffer (zero-copy views)."""
    K, S = MAX_PAIR_HITS, MAXSEG
    E2 = max(P // 8, min(256, P * K))
    E3 = max(P // 4, min(256, P * K * 2 * (S - 1)))
    o = 2
    out = {"n_extras": int(buf[0]), "n_ovf": int(buf[1]), "dense": True}
    out["meta"] = buf[o:o + P // 4].view(np.uint8); o += P // 4
    out["score"] = buf[o:o + P].view(np.int16).reshape(P, 2); o += P
    out["tgt0"] = buf[o:o + P]; o += P
    out["dt"] = buf[o:o + P // 2].view(np.int16); o += P // 2
    out["seg"] = buf[o:o + P].view(np.uint8).reshape(P, 4); o += P
    out["ex_id"] = buf[o:o + E2]; o += E2
    out["ex_frp"] = buf[o:o + E2 // 4].view(np.uint8); o += E2 // 4
    out["ex_score"] = buf[o:o + E2].view(np.int16).reshape(E2, 2); o += E2
    out["ex_tgt"] = buf[o:o + 2 * E2].reshape(E2, 2); o += 2 * E2
    out["ex_seg"] = buf[o:o + E2].view(np.uint8).reshape(E2, 4); o += E2
    out["ov_id"] = buf[o:o + E3]; o += E3
    out["ov_ss"] = buf[o:o + E3 // 2].view(np.uint8).reshape(E3, 2)
    o += E3 // 2
    out["ov_dt"] = buf[o:o + E3 // 2].view(np.int16); o += E3 // 2
    assert o == buf.shape[0]
    return out


@partial(jax.jit, static_argnames=("L", "seed_len", "stride", "pad", "C",
                                   "K", "dlow", "dhigh", "bsteps", "sbits",
                                   "c13", "dense", "mh", "G"))
def _align_pairs_packed(genome, sorted_kmers, sorted_posflip, bucket_lo, u2,
                        nmask, u2r, nmr, plens, *, L, seed_len, stride, pad,
                        C, K, dlow, dhigh, bsteps, sbits, c13, dense=True,
                        mh=8, G=None):
    """Transfer-compact batch: 2-bit packed reads (forward AND host-side
    reverse complement) in, first-segment + overflow-buffer records out,
    C13 ratio filter applied on device.

    Transfer budget: input 2x 2.25 bits/base (fwd + rc; still ~4x smaller
    than one int8 leg), output ~30 bytes/slot (most short-read alignments
    are a single M-block — indels split blocks, mismatches do not — so
    only segments beyond the first go through the sparse overflow
    buffer)."""
    seqs = _unpack_reads(u2, nmask, L)
    rc = _unpack_reads(u2r, nmr, L)
    out = _align_core(
        genome, sorted_kmers, sorted_posflip, bucket_lo, seqs, rc, plens,
        seed_len=seed_len, stride=stride, pad=pad, C=C, K=K, dlow=dlow,
        dhigh=dhigh, bsteps=bsteps, sbits=sbits, mh=mh, G=G)
    if c13:
        # C13 (AlignGraph.cpp:1261): both mates (se-ss-I)/size >= 0.6 and
        # (te-ts-D)/(te-ts) >= 0.6; 0.6 == 3/5 so the compare is exact in
        # integers (no float-boundary hazard)
        ss, se, sg = out["src_start"], out["src_end"], out["src_gap"]
        sz = out["src_size"]
        ts, te, tg = out["tgt_start"], out["tgt_end"], out["tgt_gap"]
        ok = ((se - ss - sg) * 5 >= 3 * sz) & ((te - ts - tg) * 5
                                               >= 3 * (te - ts))
        out["valid"] = out["valid"] & jnp.all(ok, axis=-1)

    P = out["valid"].shape[0]
    if dense and L <= 255 and dhigh <= 32000:
        # dense-per-pair serialization (statically safe: 8-bit ss/sz,
        # int16 tgt delta bounded by the fragment window); consumers of
        # the per-slot layout (the shard_map path) pass dense=False
        return _pack_dense(out, P, K)
    M = (3 * P) // 2
    S = MAXSEG
    valid_f = out["valid"].reshape(P * K)
    order = jnp.argsort(~valid_f, stable=True)   # valid slots first, in
    slots = order[:M].astype(jnp.int32)          # (pair, k) order
    svalid = valid_f[slots]
    p_ids = slots // K
    k_ids = slots % K

    def g(a):
        return a[p_ids, k_ids]

    segs = g(out["segs"])                        # [M, 2, S, 3] int32
    tgt_base = g(out["tgt_start"])               # [M, 2]
    frp = (g(out["fr"])[:, 0] | (g(out["fr"])[:, 1] << 1)).astype(jnp.uint8)
    seg1 = jnp.stack([segs[:, :, 0, 0], segs[:, :, 0, 2]],
                     axis=-1).astype(jnp.int16)  # [M, 2, 2] (ss, sz)
    seg1 = jnp.where(svalid[:, None, None], seg1, -1)

    # sparse overflow buffer for segments beyond the first
    E = max(P // 2, 128)
    extra = (segs[:, :, 1:, 2] > 0) & svalid[:, None, None]   # [M,2,S-1]
    ef = extra.reshape(M * 2 * (S - 1))
    eorder = jnp.argsort(~ef, stable=True)[:E]
    evalid = ef[eorder]
    e_slot = (eorder // (2 * (S - 1))).astype(jnp.int32)
    rem = eorder % (2 * (S - 1))
    e_mate = (rem // (S - 1)).astype(jnp.int32)
    e_seg = (rem % (S - 1)).astype(jnp.int32) + 1
    esel = (e_slot, e_mate, e_seg)
    e_src = segs[..., 0][esel].astype(jnp.int16)
    e_dt = (segs[..., 1][esel]
            - tgt_base[e_slot, e_mate]).astype(jnp.int16)
    e_sz = segs[..., 2][esel].astype(jnp.int16)

    # serialize every output field into ONE int32 buffer: one
    # device->host fetch per batch instead of twelve.  Layout (words;
    # M % 4 == 0, E % 4 == 0 — P is a multiple of 128):
    #   [0] n_valid  [1] n_ovf
    #   [2, 2+M)          slot_id        int32
    #   [+M/4)            frp            uint8 x4/word
    #   [+M)              score[M,2]     int16 x2/word
    #   [+2M)             tgt_base[M,2]  int32
    #   [+2M)             seg1[M,2,2]    int16 x2/word
    #   [+E)              ovf_slot       int32
    #   [+E/4)            ovf_ms         int8 x4/word
    #   [+E/2)            ovf_src        int16 x2/word
    #   [+E/2)            ovf_dt         int16 x2/word
    #   [+E/2)            ovf_sz         int16 x2/word
    bc = partial(jax.lax.bitcast_convert_type, new_dtype=jnp.int32)
    buf = jnp.concatenate([
        jnp.stack([jnp.sum(valid_f.astype(jnp.int32)),
                   jnp.sum(extra.astype(jnp.int32))]),
        jnp.where(svalid, slots, -1),
        bc(jnp.where(svalid, frp, jnp.uint8(255)).reshape(M // 4, 4)),
        bc(g(out["score"]).astype(jnp.int16)),
        tgt_base.reshape(2 * M),
        bc(seg1).reshape(2 * M),
        jnp.where(evalid, e_slot, -1),
        bc(jnp.where(evalid, e_mate * 8 + e_seg,
                     -1).astype(jnp.int8).reshape(E // 4, 4)),
        bc(jnp.where(evalid, e_src, jnp.int16(-1)).reshape(E // 2, 2)),
        bc(jnp.where(evalid, e_dt, jnp.int16(-1)).reshape(E // 2, 2)),
        bc(jnp.where(evalid, e_sz, jnp.int16(-1)).reshape(E // 2, 2)),
    ])
    return buf


def _expand_dense(res: dict, start: int, cnt: int, L: int,
                  plens: np.ndarray) -> dict:
    """Host extraction from the dense-per-pair transfer format.

    Recomputes the parse quantities with the exact integer formulas of
    _candidate_stats (bit-equal to the full path, tested)."""
    K = MAX_PAIR_HITS
    meta = res["meta"]
    has = (meta & 1) == 1
    has[cnt:] = False
    p1 = np.nonzero(has)[0]
    k0 = (meta[p1].astype(np.int64) >> 4) & 7
    n1 = len(p1)

    exm = res["ex_id"] >= 0
    ex_id = res["ex_id"][exm].astype(np.int64)
    ex_pk = ex_id & ((1 << 30) - 1)
    ex_sel = np.nonzero(exm)[0]
    keep = (ex_pk // K) < max(cnt, 0)
    ex_sel, ex_pk = ex_sel[keep], ex_pk[keep]
    n2 = len(ex_sel)

    # record table in ascending (pair, k) order: primary first (its k is
    # the lowest valid k of the pair), then extras in flat (p, k) order
    keys = np.concatenate([p1 * K + k0, ex_pk])
    order = np.argsort(keys, kind="stable")
    n = n1 + n2
    pair = np.concatenate([p1, ex_pk // K])[order]
    pk_of = keys[order]
    frp_all = np.concatenate([
        (meta[p1].astype(np.int8) >> 1) & 3,
        res["ex_frp"][ex_sel].astype(np.int8) & 3])[order]
    fr = np.stack([frp_all & 1, (frp_all >> 1) & 1], axis=-1).astype(np.int8)
    score = np.concatenate([
        res["score"][p1], res["ex_score"][ex_sel]])[order].astype(np.int32)
    tgt0_p = res["tgt0"][p1]
    tgt_base = np.concatenate([
        np.stack([tgt0_p, tgt0_p + res["dt"][p1]], axis=-1),
        res["ex_tgt"][ex_sel]])[order].astype(np.int32)
    seg8 = np.concatenate([res["seg"][p1],
                           res["ex_seg"][ex_sel]])[order].astype(np.int32)
    seg1 = seg8.reshape(n, 2, 2)                       # (ss, sz) per mate

    # full segment table from seg1 + overflow entries
    segs = np.full((n, 2, MAXSEG, 3), -1, np.int32)
    segs[:, :, 0, 0] = seg1[..., 0]
    segs[:, :, 0, 1] = np.where(seg1[..., 1] > 0, tgt_base, -1)
    segs[:, :, 0, 2] = np.where(seg1[..., 1] > 0, seg1[..., 1], -1)
    row_of = np.full(res["meta"].shape[0] * K, -1, np.int64)
    row_of[pk_of] = np.arange(n)
    om = res["ov_id"] >= 0
    orow = np.zeros(0, np.int64)
    if om.any():
        ov_id = res["ov_id"][om].astype(np.int64)
        ov_sel = np.nonzero(om)[0]
        opk, orem = ov_id // 16, ov_id % 16
        orow = row_of[opk]
        ok_ = orow >= 0
        orow, orem, ov_sel = orow[ok_], orem[ok_], ov_sel[ok_]
        omate, oseg = orem // 8, orem % 8
        osrc = res["ov_ss"][ov_sel, 0].astype(np.int32)
        osz = res["ov_ss"][ov_sel, 1].astype(np.int32)
        odt = res["ov_dt"][ov_sel].astype(np.int32)
        segs[orow, omate, oseg, 0] = osrc
        segs[orow, omate, oseg, 1] = tgt_base[orow, omate] + odt
        segs[orow, omate, oseg, 2] = osz

    # pos_map: vectorized first segment + sparse overflow fills
    pm = np.full((n, 2, L), -1, np.int32)
    i_idx = np.arange(L, dtype=np.int32)
    ss0 = seg1[..., 0:1]
    sz0 = seg1[..., 1:2]
    m0 = (sz0 > 0) & (i_idx >= ss0) & (i_idx < ss0 + sz0)
    np.copyto(pm, tgt_base[..., None] + (i_idx - ss0), where=m0)
    for e in range(len(orow)):
        r_, m_ = orow[e], omate[e]
        src, szv = int(osrc[e]), int(osz[e])
        tgt = int(tgt_base[r_, m_]) + int(odt[e])
        pm[r_, m_, src:src + szv] = tgt + np.arange(szv, dtype=np.int32)

    sz = np.where(segs[..., 2] > 0, segs[..., 2], 0)
    match = sz.sum(axis=-1)
    nseg = np.maximum((sz > 0).sum(axis=-1), 1)
    last = (nseg - 1)[..., None]
    ss = segs[..., 0, 0]
    src_last = np.take_along_axis(segs[..., 0], last, axis=-1)[..., 0]
    sz_last = np.take_along_axis(sz, last, axis=-1)[..., 0]
    se = src_last + sz_last
    ins = (se - ss) - match
    tea = np.take_along_axis(segs[..., 1], last, axis=-1)[..., 0] + sz_last
    dele = (tea - tgt_base) - match
    qlen = plens[pair][:, None].astype(np.int32)
    te_ref = tgt_base + qlen + dele - ins
    return dict(
        pair_id=(pair + start).astype(np.int32),
        fr=fr,
        score=score,
        source_start=ss.astype(np.int32),
        source_end=se.astype(np.int32),
        source_gap=ins.astype(np.int32),
        source_size=np.broadcast_to(qlen, ins.shape).copy(),
        target_start=tgt_base,
        target_end=te_ref.astype(np.int32),
        target_gap=dele.astype(np.int32),
        pos_map=pm,
    )


def unpack_records(buf: np.ndarray, P: int) -> dict:
    """Host: decode the single-buffer transfer of _align_pairs_packed back
    into the per-field record dict (zero-copy numpy views)."""
    M = (3 * P) // 2
    E = max(P // 2, 128)
    o = 2
    out = {"n_valid": buf[0], "n_ovf": buf[1]}
    out["slot_id"] = buf[o:o + M]; o += M
    out["frp"] = buf[o:o + M // 4].view(np.uint8); o += M // 4
    out["score"] = buf[o:o + M].view(np.int16).reshape(M, 2); o += M
    out["tgt_base"] = buf[o:o + 2 * M].reshape(M, 2); o += 2 * M
    out["seg1"] = buf[o:o + 2 * M].view(np.int16).reshape(M, 2, 2)
    o += 2 * M
    out["ovf_slot"] = buf[o:o + E]; o += E
    out["ovf_ms"] = buf[o:o + E // 4].view(np.int8); o += E // 4
    out["ovf_src"] = buf[o:o + E // 2].view(np.int16); o += E // 2
    out["ovf_dt"] = buf[o:o + E // 2].view(np.int16); o += E // 2
    out["ovf_sz"] = buf[o:o + E // 2].view(np.int16); o += E // 2
    assert o == buf.shape[0]
    return out


def _expand_packed(res, start: int, cnt: int, L: int,
                   plens: np.ndarray) -> dict:
    """Host extraction from the packed first-segment transfer format.

    Recomputes the parse quantities from segment records with the exact
    integer formulas of _candidate_stats (bit-equal to the full path,
    tested)."""
    K = MAX_PAIR_HITS
    slot = res["slot_id"]
    mask = slot >= 0
    sel = np.nonzero(mask)[0]
    slot = slot[sel]
    p_ids = slot // K
    keep = p_ids < max(cnt, 0)
    sel = sel[keep]
    p_ids = p_ids[keep]
    n = len(sel)
    # compact-row index -> output row (-1 dropped)
    row_of = np.full(res["slot_id"].shape[0], -1, np.int64)
    row_of[sel] = np.arange(n)

    frp = res["frp"][sel].astype(np.int8)
    fr = np.stack([frp & 1, (frp >> 1) & 1], axis=-1).astype(np.int8)
    score = res["score"][sel].astype(np.int32)
    tgt_base = res["tgt_base"][sel].astype(np.int32)     # [n, 2]
    seg1 = res["seg1"][sel].astype(np.int32)             # [n, 2, 2]

    # full segment table [n, 2, MAXSEG, 3] from seg1 + overflow entries
    segs = np.full((n, 2, MAXSEG, 3), -1, np.int32)
    segs[:, :, 0, 0] = seg1[..., 0]
    segs[:, :, 0, 1] = np.where(seg1[..., 1] > 0, tgt_base, -1)
    segs[:, :, 0, 2] = seg1[..., 1]
    om = res["ovf_slot"] >= 0
    if om.any():
        orow = row_of[res["ovf_slot"][om]]
        okeep = orow >= 0
        orow = orow[okeep]
        oms = res["ovf_ms"][om][okeep].astype(np.int64)
        omate, oseg = oms // 8, oms % 8
        osrc = res["ovf_src"][om][okeep].astype(np.int32)
        odt = res["ovf_dt"][om][okeep].astype(np.int32)
        osz = res["ovf_sz"][om][okeep].astype(np.int32)
        segs[orow, omate, oseg, 0] = osrc
        segs[orow, omate, oseg, 1] = tgt_base[orow, omate] + odt
        segs[orow, omate, oseg, 2] = osz

    # fast pos_map reconstruction: one vectorized pass for the (dominant)
    # first segment, sparse per-entry fills for overflow segments
    pm = np.full((n, 2, L), -1, np.int32)
    i_idx = np.arange(L, dtype=np.int32)
    ss0 = seg1[..., 0:1]
    sz0 = seg1[..., 1:2]
    m0 = (sz0 > 0) & (i_idx >= ss0) & (i_idx < ss0 + sz0)
    np.copyto(pm, tgt_base[..., None] + (i_idx - ss0), where=m0)
    if om.any():
        for r_, m_, s_ in zip(orow, omate, range(len(orow))):
            src, tgt, szv = (int(osrc[s_]), int(tgt_base[r_, m_])
                             + int(odt[s_]), int(osz[s_]))
            pm[r_, m_, src:src + szv] = tgt + np.arange(szv, dtype=np.int32)

    sz = np.where(segs[..., 2] > 0, segs[..., 2], 0)
    segv = sz > 0
    match = sz.sum(axis=-1)                              # [n, 2]
    nseg = np.maximum(segv.sum(axis=-1), 1)
    last = (nseg - 1)[..., None]
    ss = segs[..., 0, 0]
    src_last = np.take_along_axis(segs[..., 0], last, axis=-1)[..., 0]
    sz_last = np.take_along_axis(sz, last, axis=-1)[..., 0]
    se = src_last + sz_last
    ins = (se - ss) - match
    tea = np.take_along_axis(segs[..., 1], last, axis=-1)[..., 0] + sz_last
    dele = (tea - tgt_base) - match
    qlen = plens[p_ids][:, None].astype(np.int32)
    te_ref = tgt_base + qlen + dele - ins
    return dict(
        pair_id=(p_ids + start).astype(np.int32),
        fr=fr,
        score=score,
        source_start=ss.astype(np.int32),
        source_end=se.astype(np.int32),
        source_gap=ins.astype(np.int32),
        source_size=np.broadcast_to(qlen, ins.shape).copy(),
        target_start=tgt_base,
        target_end=te_ref.astype(np.int32),
        target_gap=dele.astype(np.int32),
        pos_map=pm,
    )



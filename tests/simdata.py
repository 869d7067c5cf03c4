"""Synthetic genome / reads / contigs simulator for tests and benchmarks.

Models the reference's intended workload (AlignGraph paper setting): a target
genome, a closely related reference genome (target + SNPs/small indels),
PE reads simulated from the *target*, and incomplete draft contigs (fragments
of the target with gaps) to be extended.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from aligngraph_tpu.io.fasta import decode

BASES = 4


@dataclasses.dataclass
class SimData:
    target: np.ndarray          # the "true" genome being re-assembled
    reference: np.ndarray       # closely related reference (mutated target)
    reads1: List[np.ndarray]    # mate-1 sequences (encoded)
    reads2: List[np.ndarray]
    read_pos: np.ndarray        # mate-1 start on target (for debugging)
    contigs: List[np.ndarray]   # draft contig fragments of the target
    contig_pos: List[Tuple[int, int]]  # (start, end) on target


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, BASES, size=length).astype(np.int8)


def mutate(rng: np.random.Generator, seq: np.ndarray, snp_rate: float = 0.01,
           indel_rate: float = 0.0005, max_indel: int = 3) -> np.ndarray:
    """SNPs + small indels -> a 'closely related' genome."""
    out: List[np.ndarray] = []
    i = 0
    n = len(seq)
    snp_mask = rng.random(n) < snp_rate
    indel_mask = rng.random(n) < indel_rate
    while i < n:
        b = seq[i]
        if snp_mask[i]:
            b = (b + rng.integers(1, BASES)) % BASES
        if indel_mask[i]:
            if rng.random() < 0.5:  # deletion from target
                i += int(rng.integers(1, max_indel + 1))
                continue
            ins = rng.integers(0, BASES, size=int(rng.integers(1, max_indel + 1)))
            out.append(np.array([b], dtype=np.int8))
            out.append(ins.astype(np.int8))
            i += 1
            continue
        out.append(np.array([b], dtype=np.int8))
        i += 1
    return np.concatenate(out) if out else np.zeros(0, np.int8)


def revcomp_np(seq: np.ndarray) -> np.ndarray:
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int8)
    return comp[seq][::-1]


def simulate_reads(rng: np.random.Generator, target: np.ndarray,
                   n_pairs: int, read_len: int = 100, insert: int = 500,
                   insert_sd: int = 30, err_rate: float = 0.005):
    """FR-orientation PE reads: mate1 forward at p, mate2 = revcomp of
    [p+ins-L, p+ins)."""
    n = len(target)
    reads1, reads2, poss = [], [], []
    for _ in range(n_pairs):
        ins = int(np.clip(rng.normal(insert, insert_sd), 2 * read_len, n - 1))
        p = int(rng.integers(0, n - ins))
        r1 = target[p:p + read_len].copy()
        r2 = revcomp_np(target[p + ins - read_len:p + ins])
        for r in (r1, r2):
            errs = np.nonzero(rng.random(read_len) < err_rate)[0]
            r[errs] = (r[errs] + rng.integers(1, BASES, size=len(errs))) % BASES
        reads1.append(r1)
        reads2.append(r2)
        poss.append(p)
    return reads1, reads2, np.array(poss)


def simulate_contigs(rng: np.random.Generator, target: np.ndarray,
                     n_contigs: int, mean_len: int = 3000,
                     min_len: int = 400):
    """Disjoint draft fragments of the target with gaps between them."""
    n = len(target)
    starts = np.sort(rng.choice(n, size=n_contigs, replace=False))
    contigs, pos = [], []
    prev_end = 0
    for s in starts:
        s = max(int(s), prev_end + 50)
        ln = max(min_len, int(rng.normal(mean_len, mean_len // 3)))
        e = min(s + ln, n)
        if e - s < min_len or s >= n:
            continue
        contigs.append(target[s:e].copy())
        pos.append((s, e))
        prev_end = e
    return contigs, pos


def make_simdata(seed: int = 0, genome_len: int = 50_000, n_pairs: int = 2000,
                 read_len: int = 100, insert: int = 500, n_contigs: int = 12,
                 snp_rate: float = 0.01, err_rate: float = 0.005) -> SimData:
    rng = np.random.default_rng(seed)
    target = random_genome(rng, genome_len)
    reference = mutate(rng, target, snp_rate=snp_rate)
    reads1, reads2, read_pos = simulate_reads(
        rng, target, n_pairs, read_len=read_len, insert=insert,
        err_rate=err_rate)
    contigs, contig_pos = simulate_contigs(rng, target, n_contigs)
    return SimData(target, reference, reads1, reads2, read_pos,
                   contigs, contig_pos)


def write_fasta_seqs(path, seqs, prefix="seq"):
    from aligngraph_tpu.io.fasta import write_fasta
    ids = [f"{prefix}{i}" for i in range(len(seqs))]
    write_fasta(path, ids, [decode(s) for s in seqs])
    return ids


def dp_batch(seed: int, B: int, L: int, pad: int = 16,
             genome_len: int = 200_000, indel_frac: float = 0.3,
             junk_frac: float = 0.05, zero_every: int = 17) -> dict:
    """Seeded inputs of the banded DP (ops/banded_sw.py) for B candidates.

    Each lane is a read of length L/2..L drawn at g0 from a random genome
    with 1% SNPs and a few N bases; `indel_frac` of the lanes carry one
    1-3 bp insertion or deletion, `junk_frac` are unrelated sequence (they
    score below the floor), every `zero_every`-th lane has length 0, and
    the rest are gapless.  windows[:, x] = genome[g0 - pad + x] (4 outside
    the genome); smin is the read aligner's --score-min floor."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, BASES, genome_len).astype(np.int8)
    W = 2 * pad
    g0 = rng.integers(0, genome_len - L - 4, B).astype(np.int32)
    g0[:: max(1, B // 8)] = 2          # windows that run off the genome
    seqs = genome[g0[:, None] + np.arange(L + 3)[None, :]]
    snp = rng.random(seqs.shape) < 0.01
    seqs[snp] = (seqs[snp] + rng.integers(1, BASES, int(snp.sum()))) % BASES
    seqs[rng.random(seqs.shape) < 0.001] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[rng.random(B) < 0.5] = L
    reads = np.full((B, L), 4, np.int8)
    kind = rng.random(B)
    for i in range(B):
        s = seqs[i]
        if kind[i] < indel_frac:
            d = int(rng.integers(1, 4))
            cut = int(rng.integers(5, L - 5))
            if rng.random() < 0.5:
                s = np.concatenate([s[:cut], s[cut + d:]])
            else:
                s = np.concatenate([s[:cut], rng.integers(
                    0, BASES, d).astype(np.int8), s[cut:]])
        elif kind[i] < indel_frac + junk_frac:
            s = rng.integers(0, BASES, L).astype(np.int8)
        reads[i, :lens[i]] = s[:lens[i]]
    lens[::zero_every] = 0
    reads[::zero_every] = 4
    x = g0[:, None] - pad + np.arange(L + W)[None, :]
    windows = np.where((x >= 0) & (x < genome_len),
                       genome[np.clip(x, 0, genome_len - 1)],
                       np.int8(4)).astype(np.int8)
    smin = np.ceil(5.0 + 2.0 * np.log(
        np.maximum(lens, 2).astype(np.float32))).astype(np.int32)
    return dict(reads=reads, rlens=lens, windows=windows, g0=g0, smin=smin)

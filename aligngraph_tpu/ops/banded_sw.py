"""Banded affine-gap local alignment (Smith-Waterman) with exact traceback.

This replaces the DP core of bowtie2's local aligner (reference invocation
AlignGraph.cpp:3601-3609 with --local --mp 3,1 --rdg 2,1 --rfg 2,1
--score-min G,5,2).  Design:

 - band-relative coordinates: read base i may align genome positions
   g0 + i + delta, delta in [-pad, pad); band index b = delta + pad in
   [0, W).  In these coordinates the diagonal dependency stays at the SAME
   band index, "up" (read gap-extension source) is b+1, "left" is b-1.
 - the within-row affine F recurrence is computed EXACTLY with a log-step
   max-decay scan: F[b] = max_{b'<b} (Hno[b'] - open - ext*(b-b')).  Using
   Hno (H without F) in the scan is lossless because a gap-close-then-reopen
   within one row is always dominated by extending the existing gap
   (open >= ext).
 - traceback direction bits are emitted per cell (2 bits H-choice, 1 bit
   E-extend, 1 bit F-extend) and walked back OUTSIDE the DP loop,
   vectorized across the batch (each lane walks its own path in lockstep).

The same XLA functions run on the CPU (tests) and on the GPU.

Scoring (bowtie2-local-flavored): match +2, mismatch -3, N -1,
gap of length n costs open + ext*n (open=2, ext=1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = jnp.int32(-(10**7))

MATCH = 2
MISMATCH = -3
N_PEN = -1
GAP_OPEN = 2
GAP_EXT = 1


class SWResult(NamedTuple):
    score: jax.Array    # [B] int32 best local score
    best_i: jax.Array   # [B] int32 row (1-based read prefix) of best cell
    best_b: jax.Array   # [B] int32 band index of best cell
    tb: jax.Array       # [L, B, W] uint8 traceback bits


def gapless_diag(reads, rlens, windows, pad: int):
    """Best gapless local run along the seed diagonal (band b == pad).

    Returns (best [B], start [B], end_incl [B]) — read-base indices of
    the maximum-score ungapped substring match, with the DP's own
    tie-breaks: earliest best end row (the kernel keeps the first row
    achieving the max) and latest preceding zero-reset (a re-achieved
    prefix minimum resets H to 0, so the DP path starts at the LAST
    minimum).  When best == the banded-DP score, a gapless alignment
    attains the optimum and traceback can be skipped entirely (most
    reads are indel-free — the fast path behind banded_sw_posmap_auto).
    """
    B, L = reads.shape
    r = reads.astype(jnp.int32)
    w = windows[:, pad:pad + L].astype(jnp.int32)
    eq = (r == w) & (r < 4)
    anyn = (r >= 4) | (w >= 4)
    s = jnp.where(eq, MATCH, jnp.where(anyn, N_PEN, MISMATCH))
    j = jnp.arange(L, dtype=jnp.int32)
    s = jnp.where(j[None, :] < rlens[:, None], s, -(10 ** 6))
    S0 = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(s, axis=1)], axis=1)
    minpfx = jax.lax.cummin(S0, axis=1)
    ends = S0[:, 1:] - minpfx[:, :-1]          # best sum ending AT base j
    best = jnp.maximum(jnp.max(ends, axis=1), 0)
    ge = jnp.argmax(ends, axis=1).astype(jnp.int32)   # first max
    # start = LAST argmin of S0[0..ge]
    jj = jnp.arange(L + 1, dtype=jnp.int32)
    vals = jnp.where(jj[None, :] <= ge[:, None], S0, 2 ** 30)
    minv = jnp.min(vals, axis=1)
    is_min = vals == minv[:, None]
    gs = (L - jnp.argmax(is_min[:, ::-1], axis=1)).astype(jnp.int32)
    return best, gs, ge


def gapless_select(score, pm_tb, gb, gs, ge, g0, smin=None):
    """The gapless fast path's select -> pos_map [B, L].

    Lanes whose banded score is attained by an ungapped run on the seed
    diagonal (score == gb) get their pos_map synthesized directly (one
    iota range over [gs, ge]); only the rest keep the traceback walk
    `pm_tb`.  `smin` [B] (optional) is the caller's acceptance floor —
    lanes scoring below it are filtered downstream, so they take the
    synthesized diagonal run rather than a walk."""
    need = score > gb
    if smin is not None:
        need = need & (score >= smin)
    j = jnp.arange(pm_tb.shape[1], dtype=jnp.int32)
    syn_on = (~need[:, None]) & (score > 0)[:, None] \
        & (j[None, :] >= gs[:, None]) & (j[None, :] <= ge[:, None])
    pm_syn = jnp.where(syn_on, g0[:, None] + j[None, :], -1)
    return jnp.where(need[:, None], pm_tb, pm_syn)


def banded_sw_posmap_xla(reads, rlens, windows, g0, pad: int, smin=None):
    """DP + traceback + gapless select in plain XLA -> (score [B],
    pos_map [B, L])."""
    res = banded_sw(reads, rlens, windows, pad=pad)
    pm_tb = sw_traceback(res.tb, res.best_i, res.best_b, g0, pad=pad)
    gb, gs, ge = gapless_diag(reads, rlens, windows, pad)
    return res.score, gapless_select(res.score, pm_tb, gb, gs, ge, g0, smin)


def banded_sw_posmap_auto(reads, rlens, windows, g0, pad: int,
                          smin=None):
    """DP + traceback -> (score [B], pos_map [B, L]); backend dispatch.

    "cpu" and "gpu" both run the XLA implementation (on the GPU a fused
    CUDA kernel was 10x faster per DP batch but did not speed up the
    pipeline's alignment stage, which is host-bound; see PERF.md).  Any
    other backend raises rather than running untested code."""
    backend = jax.default_backend()
    if backend in ("cpu", "gpu"):
        return banded_sw_posmap_xla(reads, rlens, windows, g0, pad=pad,
                                    smin=smin)
    raise NotImplementedError(
        f"banded DP: no implementation for backend {backend!r} "
        f"(supported: cpu, gpu)")


def _shift_down(a, s):
    """band-index shift: out[b] = a[b-s] (NEG fill)."""
    B, W = a.shape
    return jnp.concatenate(
        [jnp.full((B, s), NEG, a.dtype), a[:, : W - s]], axis=1)


def _shift_up(a, s):
    B, W = a.shape
    return jnp.concatenate(
        [a[:, s:], jnp.full((B, s), NEG, a.dtype)], axis=1)


@partial(jax.jit, static_argnames=("pad",))
def banded_sw(reads, rlens, windows, pad: int) -> SWResult:
    """Batched banded local DP.

    reads:   [B, L] int8 codes (pad 4 beyond rlens)
    rlens:   [B] int32
    windows: [B, L + W] int8 where windows[:, x] = genome[g0 - pad + x]
             (caller gathers; out-of-genome = 4)
    pad:     half band; W = 2*pad.
    """
    B, L = reads.shape
    W = 2 * pad
    assert windows.shape[1] == L + W

    # substitution scores for every (row, band) cell: [L, B, W]
    widx = (jnp.arange(L, dtype=jnp.int32)[:, None]
            + jnp.arange(W, dtype=jnp.int32)[None, :])      # [L, W]
    wb = windows[:, widx]                                   # [B, L, W]
    rb = reads[:, :, None]
    eq = (rb == wb) & (rb < 4)
    anyn = (rb >= 4) | (wb >= 4)
    subs = jnp.where(eq, MATCH, jnp.where(anyn, N_PEN, MISMATCH))
    subs = subs.astype(jnp.int32).transpose(1, 0, 2)        # [L, B, W]

    row_valid = (jnp.arange(1, L + 1, dtype=jnp.int32)[:, None]
                 <= rlens[None, :])                          # [L, B]

    def row_fn(carry, x):
        Hprev, Eprev, best_s, best_i, best_b, i = carry
        s, valid = x                                         # [B, W], [B]
        M = Hprev + s
        e_open = _shift_up(Hprev, 1) - (GAP_OPEN + GAP_EXT)
        e_ext = _shift_up(Eprev, 1) - GAP_EXT
        E = jnp.maximum(e_open, e_ext)
        e_flag = e_ext > e_open                              # tie -> open
        Hno = jnp.maximum(jnp.maximum(M, E), 0)
        G = Hno - GAP_OPEN
        sh = 1
        while sh < W:
            G = jnp.maximum(G, _shift_down(G, sh) - GAP_EXT * sh)
            sh *= 2
        F = _shift_down(G, 1) - GAP_EXT
        H = jnp.maximum(Hno, F)
        f_open = _shift_down(Hno, 1) - (GAP_OPEN + GAP_EXT)
        f_flag = F > f_open                                  # tie -> open
        choice = jnp.where(
            H == 0, 0,
            jnp.where(M == H, 1, jnp.where(E == H, 2, 3))).astype(jnp.uint8)
        tb_row = (choice
                  | (e_flag.astype(jnp.uint8) << 2)
                  | (f_flag.astype(jnp.uint8) << 3))
        # best-cell tracking (score desc, i asc, b asc), masked by read len
        Hm = jnp.where(valid[:, None], H, NEG)
        row_best = jnp.max(Hm, axis=1)
        row_arg = jnp.argmax(Hm, axis=1).astype(jnp.int32)
        upd = row_best > best_s
        best_s = jnp.where(upd, row_best, best_s)
        best_i = jnp.where(upd, i, best_i)
        best_b = jnp.where(upd, row_arg, best_b)
        return (H, E, best_s, best_i, best_b, i + 1), tb_row

    H0 = jnp.zeros((B, W), jnp.int32)
    E0 = jnp.full((B, W), NEG, jnp.int32)
    init = (H0, E0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
            jnp.zeros(B, jnp.int32), jnp.int32(1))
    (H, E, best_s, best_i, best_b, _), tb = jax.lax.scan(
        row_fn, init, (subs, row_valid))
    return SWResult(best_s, best_i, best_b, tb)


@partial(jax.jit, static_argnames=("pad",))
def sw_traceback(tb, best_i, best_b, g0, pad: int):
    """Walk traceback bits -> per-read-base genome position map.

    tb: [L, B, W] uint8; best_i/best_b: [B]; g0: [B] int32 genome position
    aligned to read base 0 on the candidate diagonal.
    Returns pos_map [B, L] int32 (global genome position per read base,
    -1 where unaligned).
    """
    L, B, W = tb.shape
    tb_flat = tb.transpose(1, 0, 2).reshape(B, L * W)
    T = 2 * L + W + 2

    def step_once(state):
        i, b, phase, active = state
        inb = active & (i >= 1) & (b >= 0) & (b < W)
        idx = jnp.clip((i - 1) * W + b, 0, L * W - 1)
        byte = jnp.take_along_axis(tb_flat, idx[:, None], axis=1)[:, 0]
        byte = byte.astype(jnp.int32)
        choice = byte & 3
        e_ext = (byte >> 2) & 1
        f_ext = (byte >> 3) & 1

        in_h = inb & (phase == 0)
        in_e = inb & (phase == 1)
        in_f = inb & (phase == 2)

        stop = in_h & (choice == 0)
        diag = in_h & (choice == 1)
        to_e = in_h & (choice == 2)
        to_f = in_h & (choice == 3)

        # diag: emit read base i-1 -> genome g0 + (i-1) + b - pad
        gpos = g0 + (i - 1) + b - pad
        wr = jnp.where(diag, i - 1, L)          # L = dropped post-scan

        ni = jnp.where(diag | in_e, i - 1, i)
        nb = jnp.where(in_e, b + 1, jnp.where(in_f, b - 1, b))
        nphase = jnp.where(
            to_e | (in_e & (e_ext == 1)), 1,
            jnp.where(to_f | (in_f & (f_ext == 1)), 2, 0))
        nactive = active & ~stop & inb
        return (ni, nb, nphase, nactive), (wr, gpos)

    UNROLL = 8

    def step(state, _):
        # UNROLL moves per scan iteration: the per-iteration cost is
        # dominated by kernel-launch overhead of the [B] gathers, not the
        # work, so fewer+fatter iterations win
        wrs, gs = [], []
        for _u in range(UNROLL):
            state, (wr, g) = step_once(state)
            wrs.append(wr)
            gs.append(g)
        return state, (jnp.stack(wrs), jnp.stack(gs))

    state0 = (best_i, best_b, jnp.zeros(B, jnp.int32), jnp.ones(B, bool))
    _, (wr_all, gpos_all) = jax.lax.scan(step, state0, None,
                                         length=T // UNROLL + 1)
    # one scatter after the scan (each read index written at most once)
    pos_map = jnp.full((B, L), -1, jnp.int32)
    lane = jnp.broadcast_to(jnp.arange(B), wr_all.shape)
    pos_map = pos_map.at[lane.reshape(-1), wr_all.reshape(-1)].set(
        gpos_all.reshape(-1), mode="drop")
    return pos_map

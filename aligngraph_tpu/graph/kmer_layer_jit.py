"""Device-resident read/k-mer-layer graph build — the jitted twin of
graph/kmer_layer.py (C18/C19, `updateGenomeWithRead` + `updateKMer`,
AlignGraph.cpp:1635-1870, 1353-1624).

Same phases and bit-identical results as the host oracle (asserted in
tests/test_kmer_jit.py), reformulated for XLA on an accelerator:

  - rows are DENSE + masked (no host `nonzero`): every (record, base)
    cell owns fixed tuple slots, every tuple owns a fixed [CPO x CPM]
    anchor-combo grid; invalid rows ride the sorts with +inf keys
    (device sorts absorb the padding); the only dynamic-size structure (the "small insertion" bridge chains,
    AlignGraph.cpp:1705-1752) uses a fixed capacity with an overflow
    flag that falls the chunk back to the host oracle.
  - grouping (phase 3) is ONE multi-operand `lax.sort` on fixed-width
    packed keys + sorted-segment reductions via cumsum and boundary
    gathers — no scatter-adds.
  - the first-fit merge (phase 4) runs the host oracle's assign/create
    rounds (<= K_KM+2 fixed `lax.fori_loop` steps): per-group gathers of
    the resident slot rows + masked scatter-adds — the reference's
    per-k-mer `compatible()` scan, exactly, with no dense grid.
  - edges (phase 5) dedup with one packed-key sort, gate against the
    post-merge slot state, and append via per-(pos, slot) run ranks.

The graph state (km_*/ed_* arrays) lives ON DEVICE across chunks and is
donated through the jitted update, so alignment records are consumed
without the graph ever crossing the host boundary until traversal.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from aligngraph_tpu.config import EP
from aligngraph_tpu.graph.kmer_layer import (
    CPM, CPO, KmerBuildStats, normalize_records,
)
from aligngraph_tpu.graph.model import E_ED, K_KM, GraphTensors, NONE32

I32 = jnp.int32


# ----------------------------------------------------------------------
# phase 1: tuple emission (dense cell grid, oracle emit_tuples semantics)
# ----------------------------------------------------------------------

def _emit_tuples_jit(p1, p2, s1, lens, keep, k: int, B_cap: int):
    """Dense tuple streams; returns dict of [T_all] arrays + overflow."""
    M, L = p1.shape
    Lk = L - k
    i_idx = jnp.arange(Lk, dtype=I32)[None, :]
    cur = p1[:, :Lk]
    nxt = p1[:, 1:Lk + 1]
    mc = p2[:, :Lk]
    mn = p2[:, 1:Lk + 1]
    in_range = keep[:, None] & (i_idx < (lens - k)[:, None]) & (cur >= 0)

    big = I32(L + 1)
    rev = jnp.where(p1[:, ::-1] >= 0,
                    jnp.arange(L - 1, -1, -1, dtype=I32)[None, :], big)
    na = jax.lax.cummin(rev, axis=1)[:, ::-1]
    na = jnp.concatenate([na, jnp.full((M, 2), big, I32)], axis=1)
    npp = na[:, 2:][:, :Lk]
    npp_ok = npp < L
    nppc = jnp.clip(npp, 0, L - 1)
    tgt = jnp.take_along_axis(p1, nppc, axis=1)
    mate_tgt = jnp.take_along_axis(p2, nppc, axis=1)

    ordinary = in_range & (nxt == cur + 1)
    deletion = in_range & (nxt >= 0) & (nxt != cur + 1)
    insertion = in_range & (nxt < 0) & npp_ok
    ins_a1 = insertion & (tgt == cur + 1)
    ins_a2 = insertion & (tgt != cur + 1)

    # packed k-mers at every base (3-bit codes, oracle _pack)
    pk = jnp.zeros((M, Lk + 1), jnp.uint32)
    for i in range(k):
        c = jnp.minimum(s1[:, i:i + Lk + 1].astype(jnp.uint32), 4)
        pk = (pk << jnp.uint32(3)) | c
    packs = jnp.concatenate(
        [pk, jnp.zeros((M, L - (Lk + 1)), jnp.uint32)], axis=1)
    s0_all = s1

    rec = jnp.arange(M, dtype=I32)[:, None]

    def arr(sub):
        return (rec * L + i_idx) * 4 + sub         # [M, Lk] int32

    ns_len_np = (jnp.minimum(npp + k, lens[:, None]) - npp).astype(I32)
    packs_np = jnp.take_along_axis(packs, nppc, axis=1)
    s0_np = jnp.take_along_axis(s0_all, nppc, axis=1)
    NONE = I32(-1)

    # stream A: one tuple per cell (ordinary|deletion / ins_a1 / ins_a2(i))
    m_od = ordinary | deletion
    a_valid = m_od | ins_a1 | ins_a2
    sA = dict(
        cur=cur,
        nxt=jnp.where(ordinary, cur + 1,
                      jnp.where(deletion, nxt, cur + 1)),
        mate_cur=mc,
        mate_nxt=jnp.where(m_od, mn,
                           jnp.where(ins_a1, mate_tgt, NONE)),
        s_pack=packs[:, :Lk],
        s_len=jnp.full((M, Lk), k, I32),
        ns_pack=jnp.where(m_od, packs[:, 1:Lk + 1],
                          jnp.where(ins_a1, packs_np, 0)).astype(
                              jnp.uint32),
        ns_len=jnp.where(m_od, k, jnp.where(ins_a1, ns_len_np, 0)),
        s0=s1[:, :Lk].astype(I32),
        ns0=jnp.where(m_od, s1[:, 1:Lk + 1].astype(I32),
                      jnp.where(ins_a1, s0_np.astype(I32), 4)),
        arrival=arr(0),
        valid=a_valid,
    )

    # stream B: ins_a2 case (iii): (target-1) -> target
    sB = dict(
        cur=tgt - 1, nxt=tgt,
        mate_cur=jnp.full((M, Lk), NONE), mate_nxt=mate_tgt,
        s_pack=jnp.zeros((M, Lk), jnp.uint32),
        s_len=jnp.zeros((M, Lk), I32),
        ns_pack=packs_np.astype(jnp.uint32), ns_len=ns_len_np,
        s0=jnp.full((M, Lk), 4, I32), ns0=s0_np.astype(I32),
        arrival=arr(2),
        valid=ins_a2,
    )

    # stream C: bridge tuples through intermediate genome positions
    span = jnp.where(ins_a2, jnp.maximum(tgt - cur - 2, 0), 0)
    span_f = span.reshape(M * Lk)
    off = jnp.concatenate([jnp.zeros(1, I32), jnp.cumsum(span_f)])
    total = off[-1]
    overflow = total > B_cap
    b_idx = jnp.arange(B_cap, dtype=I32)
    cell = jnp.clip(jnp.searchsorted(off, b_idx, side="right") - 1,
                    0, M * Lk - 1).astype(I32)
    b_valid = b_idx < total
    cur_f = cur.reshape(-1)
    arr1_f = arr(1).reshape(-1)
    bc = cur_f[cell] + 1 + (b_idx - off[cell])
    sC = dict(
        cur=bc, nxt=bc + 1,
        mate_cur=jnp.full(B_cap, NONE), mate_nxt=jnp.full(B_cap, NONE),
        s_pack=jnp.zeros(B_cap, jnp.uint32), s_len=jnp.zeros(B_cap, I32),
        ns_pack=jnp.zeros(B_cap, jnp.uint32), ns_len=jnp.zeros(B_cap, I32),
        s0=jnp.full(B_cap, 4, I32), ns0=jnp.full(B_cap, 4, I32),
        arrival=arr1_f[cell],
        valid=b_valid,
    )

    out = {key: jnp.concatenate(
        [sA[key].reshape(-1), sB[key].reshape(-1), sC[key]])
        for key in sA}
    return out, overflow


# ----------------------------------------------------------------------
# phase 2: anchor-combo expansion (dense [T_all, CPO*CPM] grid)
# ----------------------------------------------------------------------

def _expand_jit(cmpack, n_pos: int, pos, mate, arrival_t, kind: int,
                s_pack, s_len, s0, tvalid):
    """cmpack [n_pos, 5] = (cm_cnt, contig0, contig1, coff0, coff1)."""
    NONE = I32(-1)
    posc = jnp.clip(pos, 0, n_pos - 1)
    matec = jnp.clip(mate, 0, n_pos - 1)
    own = cmpack[posc]                   # [T, 5]
    mat = cmpack[matec]
    c_cm = jnp.minimum(own[:, 0], CPO)
    m_cm = jnp.where(mate >= 0, jnp.minimum(mat[:, 0], CPM), 0)
    n_own = jnp.maximum(c_cm, 1)
    n_mate = jnp.maximum(m_cm, 1)
    rows = {}
    T = pos.shape[0]
    for jj in range(CPO):
        for jj0 in range(CPM):
            cvalid = tvalid & (jj < n_own) & (jj0 < n_mate)
            contig = jnp.where(c_cm > 0, own[:, 1 + jj], NONE)
            coff = jnp.where(c_cm > 0, own[:, 3 + jj], NONE)
            contig0 = jnp.where(m_cm > 0, mat[:, 1 + jj0], NONE)
            coff0 = jnp.where(m_cm > 0, mat[:, 3 + jj0], NONE)
            rows[(jj, jj0)] = dict(
                valid=cvalid, contig=contig, coff=coff,
                contig0=contig0, coff0=coff0)
    cat = {f: jnp.concatenate(
        [rows[(jj, jj0)][f] for jj in range(CPO) for jj0 in range(CPM)])
        for f in ("valid", "contig", "coff", "contig0", "coff0")}
    rep = lambda a: jnp.tile(a, CPO * CPM)       # noqa: E731
    cat.update(
        pos=rep(pos), gpos0=jnp.where(rep(mate) >= 0, rep(mate), NONE),
        arrival=rep(arrival_t) * 2 + kind,
        weight=jnp.full(T * CPO * CPM, 1 - kind, I32),
        s_pack=rep(s_pack), s_len=rep(s_len), s0=rep(s0),
        combo=jnp.repeat(jnp.arange(CPO * CPM, dtype=I32), T),
    )
    return cat


def _compat_jit(gc, gf, gc0, gf0, gg0, sc, sf, sc0, sf0, sg0, win):
    """Vectorized `compatible()` (kmer_layer._compat_vec semantics)."""
    bad1 = (gc >= 0) & (sc >= 0) & (gc == sc) & (jnp.abs(gf - sf) > 5 * EP)
    bad2 = (gc0 >= 0) & (sc0 >= 0) & (gc0 == sc0) & \
        (jnp.abs(gf0 - sf0) > win)
    bad3 = (gg0 >= 0) & (sg0 >= 0) & (jnp.abs(gg0 - sg0) > win)
    return ~(bad1 | bad2 | bad3)


# ----------------------------------------------------------------------
# the per-chunk jitted update
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "win", "n_pos", "B_cap", "G_cap"))
def _chunk_update(state, cmpack, p1, p2, s1, lens, keep, *, k, win,
                  n_pos, B_cap, G_cap):
    tup, bridge_ovf = _emit_tuples_jit(p1, p2, s1, lens, keep, k, B_cap)

    k1 = _expand_jit(cmpack, n_pos, tup["cur"], tup["mate_cur"],
                     tup["arrival"], 0, tup["s_pack"], tup["s_len"],
                     tup["s0"], tup["valid"])
    k2 = _expand_jit(cmpack, n_pos, tup["nxt"], tup["mate_nxt"],
                     tup["arrival"], 1, tup["ns_pack"], tup["ns_len"],
                     tup["ns0"], tup["valid"])
    T_all = tup["cur"].shape[0]
    NC = CPO * CPM

    rows = {f: jnp.concatenate([k1[f], k2[f]])
            for f in ("valid", "pos", "arrival", "weight", "contig",
                      "coff", "contig0", "coff0", "gpos0", "s_pack",
                      "s_len", "s0")}
    R_all = rows["pos"].shape[0]

    # ---- phase 3: grouping by multi-word int32 keys (x64-free) ----
    # keys are the EXACT anchor signature (no window quantization): rows
    # with identical signatures always make the same first-fit decision,
    # so grouping stays bit-identical to the reference's per-emission
    # scan (see kmer_layer.py phase 3/4 notes)
    coff0_q = rows["coff0"]
    gpos0_q = rows["gpos0"]
    # invalid rows get the sentinel ALONE (an OR with garbage negative
    # positions would produce keys that sort as valid)
    w0 = jnp.where(rows["valid"], rows["pos"] + 1, 1 << 30)
    misc = (rows["s0"] | (rows["s_len"] << 3)
            | (rows["weight"] << 8)).astype(I32)
    rowid = jnp.arange(R_all, dtype=I32)
    (w0_s, w1_s, w2_s, w3_s, w4_s, w5_s, arr_s, gpos0_s, coff0_s,
     spack_s, misc_s, rowid_s) = jax.lax.sort(
        (w0, rows["contig"], rows["coff"], rows["contig0"],
         coff0_q, gpos0_q, rows["arrival"],
         rows["gpos0"], rows["coff0"],
         rows["s_pack"].astype(I32), misc, rowid),
        num_keys=7, is_stable=True)

    valid_s = w0_s < (1 << 30)
    newg = jnp.ones(R_all, bool)
    newg = newg.at[1:].set(
        (w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
        | (w2_s[1:] != w2_s[:-1]) | (w3_s[1:] != w3_s[:-1])
        | (w4_s[1:] != w4_s[:-1]) | (w5_s[1:] != w5_s[:-1]))
    gstart = newg & valid_s
    gid = jnp.cumsum(gstart.astype(I32)) - 1          # valid prefix only
    G_real = jnp.sum(gstart.astype(I32))
    group_ovf = G_real > G_cap
    NV = jnp.sum(valid_s.astype(I32))

    # group starts compacted (ascending; stable argsort of ~gstart)
    starts = jnp.argsort(~gstart, stable=True)[:G_cap].astype(I32)
    g_ok = gstart[starts]
    g_pos = (w0_s[starts] & ((1 << 30) - 1)) - 1
    g_contig = w1_s[starts]
    g_coff = w2_s[starts]
    g_contig0 = w3_s[starts]
    g_gpos0 = gpos0_s[starts]
    g_coff0 = coff0_s[starts]
    g_first = arr_s[starts]
    g_spack = spack_s[starts]
    g_slen = (misc_s[starts] >> 3) & 31

    # segment sums via cumsum + boundary gathers
    ends = jnp.concatenate([starts[1:], jnp.full(1, R_all, I32)])
    ends = jnp.minimum(jnp.where(
        jnp.arange(G_cap) + 1 < G_real, ends, NV), R_all)
    w_row = jnp.where(valid_s, (misc_s >> 8) & 1, 0)
    cw = jnp.concatenate([jnp.zeros(1, I32), jnp.cumsum(w_row)])
    g_weight = cw[ends] - cw[starts]
    voters = valid_s & (((misc_s >> 3) & 31) > 0) & (w_row > 0)
    votes_cols = []
    for c in range(5):
        vc = jnp.concatenate([
            jnp.zeros(1, I32),
            jnp.cumsum((voters & ((misc_s & 7) == c)).astype(I32))])
        votes_cols.append(vc[ends] - vc[starts])
    g_votes = jnp.stack(votes_cols, axis=-1)          # [G_cap, 5]

    # ---- phase 4: first-fit merge, assign/create rounds ----
    # Same algorithm as the host oracle: each round (a) assigns every
    # pending group to its first compatible slot (per-group gathers of
    # the resident slot rows), then (b) the earliest-arrival pending
    # group per position creates one new slot.  Rounds are bounded by
    # the K_KM cap; no dense position grid is materialized.
    wR = jnp.where(g_ok, g_pos + 1, 1 << 30)
    gidx = jnp.arange(G_cap, dtype=I32)
    wR_s, _, gsort = jax.lax.sort((wR, g_first, gidx), num_keys=2,
                                  is_stable=True)
    pos_rs = (wR_s & ((1 << 30) - 1)) - 1
    okr = wR_s < (1 << 30)
    news = jnp.ones(G_cap, bool)
    news = news.at[1:].set(pos_rs[1:] != pos_rs[:-1])
    # index of each group's position-run start (for within-run prefix)
    run_start = jax.lax.cummax(jnp.where(news, gidx, 0))

    # group fields in (pos, arrival)-sorted order
    sgc = g_contig[gsort]
    sgf = g_coff[gsort]
    sgc0 = g_contig0[gsort]
    sgf0 = g_coff0[gsort]
    sgg0 = g_gpos0[gsort]
    sgw = g_weight[gsort]
    sgv = g_votes[gsort]                               # [G_cap, 5]
    sgsp = g_spack[gsort]
    sgsl = g_slen[gsort]
    posc_s = jnp.clip(pos_rs, 0, n_pos - 1)

    NONE = I32(-1)

    def unpk(a):
        return jnp.where(a == jnp.uint32(NONE32).astype(I32), -1, a)

    def enc(a):
        return jnp.where(a == -1, jnp.uint32(NONE32).astype(I32), a)

    def round_step(_, carry):
        (contig, coff, contig0, coff0, mate_, cov, votes, spk, sln,
         cnt, pending, slot_s, dslots) = carry
        # (a) per-group compat against the K slots at its position
        kc = cnt[posc_s]
        comp = []
        for s in range(K_KM):
            c = (s < kc) & _compat_jit(
                sgc, sgf, sgc0, sgf0, sgg0,
                unpk(contig[posc_s, s]), coff[posc_s, s],
                unpk(contig0[posc_s, s]), coff0[posc_s, s],
                unpk(mate_[posc_s, s]), win)
            comp.append(c)
        comp = jnp.stack(comp, axis=-1)                # [G_cap, K]
        has = comp.any(axis=-1)
        first = jnp.argmax(comp, axis=-1).astype(I32)
        assign = pending & has
        mpos = jnp.where(assign, posc_s, n_pos)
        cov = cov.at[mpos, first].add(jnp.where(assign, sgw, 0),
                                      mode="drop")
        votes = votes.at[mpos, first].add(
            jnp.where(assign[:, None], sgv, 0), mode="drop")
        slot_s = jnp.where(assign, first, slot_s)
        pending = pending & ~has
        # drop all pending at capped positions
        at_cap = kc >= K_KM
        dslots = dslots + jnp.sum((pending & at_cap).astype(I32))
        pending = pending & ~at_cap
        # (b) earliest pending group per position creates one slot
        S = jnp.cumsum(pending.astype(I32))
        base = S[run_start] - pending[run_start].astype(I32)
        creator = pending & ((S - base) == 1)
        ac = cnt[posc_s]
        cpos = jnp.where(creator, posc_s, n_pos)
        acs = jnp.clip(ac, 0, K_KM - 1)
        contig = contig.at[cpos, acs].set(sgc, mode="drop")
        coff = coff.at[cpos, acs].set(sgf, mode="drop")
        contig0 = contig0.at[cpos, acs].set(sgc0, mode="drop")
        coff0 = coff0.at[cpos, acs].set(sgf0, mode="drop")
        mate_ = mate_.at[cpos, acs].set(sgg0, mode="drop")
        cov = cov.at[cpos, acs].set(jnp.where(creator, sgw, 0),
                                    mode="drop")
        votes = votes.at[cpos, acs].set(
            jnp.where(creator[:, None], sgv, 0), mode="drop")
        spk = spk.at[cpos, acs].set(sgsp, mode="drop")
        sln = sln.at[cpos, acs].set(sgsl, mode="drop")
        cnt = cnt.at[cpos].add(1, mode="drop")
        slot_s = jnp.where(creator, ac, slot_s)
        pending = pending & ~creator
        return (contig, coff, contig0, coff0, mate_, cov, votes, spk,
                sln, cnt, pending, slot_s, dslots)

    # anchors stored encoded (NONE32) in the slot state; the creating
    # group's -1 anchors must be encoded on write — pre-encode the
    # sorted fields used for slot writes
    sgc = enc(sgc)
    sgc0 = enc(sgc0)
    sgg0 = enc(sgg0)
    carry0 = (
        state["km_contig"], state["km_coff"], state["km_contig0"],
        state["km_coff0"], state["km_mate"], state["km_cov"],
        state["km_votes"], state["km_s"], state["km_slen"],
        state["km_cnt"], okr, jnp.full(G_cap, -1, I32),
        jnp.zeros((), I32))
    carry = jax.lax.fori_loop(0, K_KM + 2, round_step, carry0)
    (n_contig, n_coff, n_contig0, n_coff0, n_mate, n_cov, n_votes,
     n_spk, n_sln, n_cnt, _pend, slot_sorted, dropped_slots) = carry
    dropped_rank = jnp.zeros((), I32)

    # slot per group (by original gid), then per row
    g_slot = jnp.full(G_cap, -1, I32).at[gsort].set(slot_sorted)
    row_slot_s = jnp.where(valid_s, g_slot[jnp.clip(gid, 0, G_cap - 1)],
                           -1)
    row_slot = jnp.zeros(R_all, I32).at[rowid_s].set(row_slot_s)

    # ---- phase 5: edges ----
    v1 = k1["valid"].reshape(NC, T_all).T              # [T, NC]
    v2 = k2["valid"].reshape(NC, T_all).T
    slot1 = row_slot[:R_all // 2].reshape(NC, T_all).T
    slot2 = row_slot[R_all // 2:].reshape(NC, T_all).T
    rank_a = jnp.cumsum(v1.astype(I32), axis=1) - 1
    rank_b = jnp.cumsum(v2.astype(I32), axis=1) - 1
    p1e = k1["pos"][:T_all]
    p2e = k2["pos"][:T_all]
    maxc = NC
    eparts = {f: [] for f in ("sp", "ss", "dp", "ds", "ea")}
    for a in range(NC):
        for b in range(NC):
            ev = (v1[:, a] & v2[:, b] & (slot1[:, a] >= 0)
                  & (slot2[:, b] >= 0))
            ea = tup["arrival"] * (maxc * maxc) \
                + rank_a[:, a] * maxc + rank_b[:, b]
            eparts["sp"].append(jnp.where(ev, p1e + 1, 1 << 30))
            eparts["ss"].append(slot1[:, a])
            eparts["dp"].append(p2e)
            eparts["ds"].append(slot2[:, b])
            eparts["ea"].append(ea)
    ecat = {f: jnp.concatenate(v) for f, v in eparts.items()}
    sp_s, ss_s, dp_s, ds_s, ea_s = jax.lax.sort(
        (ecat["sp"], ecat["ss"], ecat["dp"], ecat["ds"], ecat["ea"]),
        num_keys=5, is_stable=True)
    ev_s = sp_s < (1 << 30)
    euniq = jnp.ones(sp_s.shape[0], bool)
    euniq = euniq.at[1:].set(
        (sp_s[1:] != sp_s[:-1]) | (ss_s[1:] != ss_s[:-1])
        | (dp_s[1:] != dp_s[:-1]) | (ds_s[1:] != ds_s[:-1]))
    euniq = euniq & ev_s
    E_cap = 2 * T_all
    esel = jnp.argsort(~euniq, stable=True)[:E_cap].astype(I32)
    e_ok = euniq[esel]
    edge_ovf = jnp.sum(euniq.astype(I32)) > E_cap
    sp = (sp_s[esel] & ((1 << 30) - 1)) - 1
    ss = ss_s[esel]
    dp = dp_s[esel]
    ds = ds_s[esel]
    e_arr = ea_s[esel]

    spc = jnp.clip(sp, 0, n_pos - 1)
    dpc = jnp.clip(dp, 0, n_pos - 1)
    a_c = unpk(n_contig[spc, ss])
    a_f = n_coff[spc, ss]
    a_c0 = unpk(n_contig0[spc, ss])
    a_f0 = n_coff0[spc, ss]
    b_c = unpk(n_contig[dpc, ds])
    b_f = n_coff[dpc, ds]
    b_c0 = unpk(n_contig0[dpc, ds])
    b_f0 = n_coff0[dpc, ds]
    bad1 = (a_c >= 0) & (b_c >= 0) & (a_c == b_c) & \
        (jnp.abs(a_f - b_f) > 5 * EP)
    bad2 = (a_c0 >= 0) & (b_c0 >= 0) & (a_c0 == b_c0) & \
        (jnp.abs(a_f0 - b_f0) > win)
    e_ok = e_ok & ~(bad1 | bad2)

    # existing-edge check against prior chunks
    exists = jnp.zeros(E_cap, bool)
    for e in range(E_ED):
        exists |= (e < state["ed_cnt"][spc, ss]) & \
            (state["ed_pos"][spc, ss, e] == dp.astype(I32)) & \
            (state["ed_item"][spc, ss, e] == ds)
    e_ok = e_ok & ~exists

    # append in (sp, ss, arrival) order with per-(pos, slot) run ranks
    wF = jnp.where(e_ok, sp + 1, 1 << 30)
    wF_s, ss_f, ea_f, sp_f, dp_f, ds_f = jax.lax.sort(
        (wF, ss, e_arr, sp, dp, ds), num_keys=3, is_stable=True)
    f_ok = wF_s < (1 << 30)
    newr = jnp.ones(E_cap, bool)
    newr = newr.at[1:].set((wF_s[1:] != wF_s[:-1])
                           | (ss_f[1:] != ss_f[:-1]))
    eidx2 = jnp.arange(E_cap, dtype=I32)
    rstart = jnp.where(newr & f_ok, eidx2, 0)
    rrank = eidx2 - jax.lax.cummax(rstart)
    base_cnt = state["ed_cnt"][jnp.clip(sp_f, 0, n_pos - 1), ss_f] \
        .astype(I32)
    tgt_e = base_cnt + rrank
    can = f_ok & (tgt_e < E_ED)
    dropped_edges = jnp.sum((f_ok & ~can).astype(I32))
    spfc = jnp.where(can, sp_f, n_pos)
    ed_pos = state["ed_pos"].at[spfc, ss_f, jnp.clip(tgt_e, 0, E_ED - 1)] \
        .set(dp_f, mode="drop")
    ed_item = state["ed_item"].at[
        spfc, ss_f, jnp.clip(tgt_e, 0, E_ED - 1)].set(ds_f, mode="drop")
    # per-(pos, slot) appended count = run length capped at available
    inc = jnp.zeros((n_pos, K_KM), I32).at[spfc, ss_f].add(
        can.astype(I32), mode="drop")
    ed_cnt = state["ed_cnt"] + inc

    new_state = dict(
        km_contig=n_contig, km_coff=n_coff, km_contig0=n_contig0,
        km_coff0=n_coff0, km_mate=n_mate, km_cov=n_cov, km_votes=n_votes,
        km_s=n_spk, km_slen=n_sln, km_cnt=n_cnt,
        ed_cnt=ed_cnt, ed_pos=ed_pos, ed_item=ed_item)
    # a capacity overflow means this chunk's results are untrustworthy:
    # return the INPUT state unchanged so the host can replay the chunk
    # through the oracle (state is not donated for exactly this reason)
    ovf = bridge_ovf | group_ovf | edge_ovf
    new_state = {key: jnp.where(ovf, state[key], v)
                 for key, v in new_state.items()}
    info = dict(
        tuples=jnp.sum(tup["valid"].astype(I32)),
        rows=jnp.sum(rows["valid"].astype(I32)),
        groups=G_real,
        dropped_rank=dropped_rank,
        dropped_slots=dropped_slots,
        dropped_edges=dropped_edges,
        overflow=bridge_ovf | group_ovf | edge_ovf,
    )
    return new_state, info


# ----------------------------------------------------------------------
# host driver
# ----------------------------------------------------------------------

def _state_from_graph(g: GraphTensors, device=None):
    def put(a, dtype=None):
        arr = jnp.asarray(a if dtype is None else a.astype(dtype))
        return jax.device_put(arr, device) if device is not None else arr

    return dict(
        km_contig=put(g.km_contig.view(np.int32)),
        km_coff=put(g.km_coff.view(np.int32)),
        km_contig0=put(g.km_contig0.view(np.int32)),
        km_coff0=put(g.km_coff0.view(np.int32)),
        km_mate=put(g.km_mate.view(np.int32)),
        km_cov=put(g.km_cov),
        km_votes=put(g.km_votes),
        km_s=put(g.km_s.view(np.int32)),
        km_slen=put(g.km_slen, np.int32),
        km_cnt=put(g.km_cnt, np.int32),
        ed_cnt=put(g.ed_cnt, np.int32),
        ed_pos=put(g.ed_pos.view(np.int32)),
        ed_item=put(g.ed_item, np.int32),
    )


def _state_to_graph(state, g: GraphTensors) -> None:
    # np.array (copy), not np.asarray: device views are read-only and the
    # host oracle (overflow fallback) mutates these in place
    g.km_contig = np.array(state["km_contig"]).view(np.uint32)
    g.km_coff = np.array(state["km_coff"]).view(np.uint32)
    g.km_contig0 = np.array(state["km_contig0"]).view(np.uint32)
    g.km_coff0 = np.array(state["km_coff0"]).view(np.uint32)
    g.km_mate = np.array(state["km_mate"]).view(np.uint32)
    g.km_cov = np.array(state["km_cov"])
    g.km_votes = np.array(state["km_votes"])
    g.km_s = np.array(state["km_s"]).view(np.uint32)
    g.km_slen = np.array(state["km_slen"]).astype(np.int8)
    g.km_cnt = np.array(state["km_cnt"]).astype(np.int8)
    g.ed_cnt = np.array(state["ed_cnt"]).astype(np.int8)
    g.ed_pos = np.array(state["ed_pos"]).view(np.uint32)
    g.ed_item = np.array(state["ed_item"]).astype(np.uint8)


def build_kmer_layer_device(g: GraphTensors, pairs, reads, k: int,
                            insert_variation: int, part_offset: int = 0,
                            chunk_records: int = 16384,
                            stats: Optional[KmerBuildStats] = None,
                            device=None) -> KmerBuildStats:
    """Drop-in for kmer_layer.build_kmer_layer with the merge on device.

    chunk_records matches the host oracle's default — KmerBuildStats
    (groups, dropped_*) are chunk-boundary dependent, so the pipeline's
    reported kmer_stats stay comparable when toggling cfg.graph_build.

    Chunks whose capacity bounds overflow (bridge rows / groups / edges)
    fall back to the host oracle for that chunk — results stay identical,
    deterministically.
    """
    from aligngraph_tpu.graph.kmer_layer import _merge_chunk, emit_tuples

    st = stats or KmerBuildStats()
    if pairs.n == 0:
        return st
    p1, p2, s1, lens, keep = normalize_records(
        pairs, reads, k, part_offset, g.part_len)
    # state arrays span part_len + overflow_cap (record positions are
    # always < part_len, but the array axes must agree)
    n_pos = int(g.km_cnt.shape[0])
    assert n_pos < (1 << 30)
    cmpack = np.concatenate([
        g.cm_cnt[:, None].astype(np.int32),
        np.where(g.cm_contig[:, :CPO] == NONE32, -1,
                 g.cm_contig[:, :CPO].astype(np.int64)).astype(np.int32),
        np.where(g.cm_coff[:, :CPO] == NONE32, -1,
                 g.cm_coff[:, :CPO].astype(np.int64)).astype(np.int32),
    ], axis=1)
    cmpack_d = jnp.asarray(cmpack)
    if device is not None:
        cmpack_d = jax.device_put(cmpack_d, device)
    state = _state_from_graph(g, device)
    win = 2 * insert_variation + 5 * EP
    L = p1.shape[1]
    M = chunk_records
    pending_host = []
    for s in range(0, pairs.n, chunk_records):
        e = min(s + chunk_records, pairs.n)
        p1c = np.full((M, L), -1, np.int64)
        p2c = np.full((M, L), -1, np.int64)
        s1c = np.full((M, L), 4, np.int8)
        lensc = np.zeros(M, np.int64)
        keepc = np.zeros(M, bool)
        p1c[:e - s] = p1[s:e]
        p2c[:e - s] = p2[s:e]
        s1c[:e - s] = s1[s:e]
        lensc[:e - s] = lens[s:e]
        keepc[:e - s] = keep[s:e]
        Lk = L - k
        if Lk <= 0:
            continue
        B_cap = max(4096, (M * Lk) // 8)
        # groups are in practice ~0.3 per cell; T_all is a 3x safety
        # margin and the overflow fallback guards the rest
        G_cap = 2 * M * Lk + B_cap
        args = [jnp.asarray(a) for a in
                (p1c.astype(np.int32), p2c.astype(np.int32), s1c,
                 lensc.astype(np.int32), keepc)]
        if device is not None:
            args = [jax.device_put(a, device) for a in args]
        state, info = _chunk_update(
            state, cmpack_d, *args, k=k, win=win, n_pos=n_pos,
            B_cap=B_cap, G_cap=G_cap)
        if bool(info["overflow"]):
            # deterministic fallback: rerun this chunk via the host oracle
            # on a synced copy of the state
            _state_to_graph(state, g)
            tupn = emit_tuples(p1[s:e], p2[s:e], s1[s:e], lens[s:e],
                               keep[s:e], k)
            if tupn is not None:
                _merge_chunk(g, tupn, insert_variation, st)
            state = _state_from_graph(g, device)
            continue
        pending_host.append(info)
    for info in pending_host:
        st.tuples += int(info["tuples"])
        st.rows += int(info["rows"])
        st.groups += int(info["groups"])
        st.dropped_rank += int(info["dropped_rank"])
        st.dropped_slots += int(info["dropped_slots"])
        st.dropped_edges += int(info["dropped_edges"])
    _state_to_graph(state, g)
    return st

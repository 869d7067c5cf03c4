"""Position-sharded k-mer graph build — D2/D3 completion (SURVEY §2.4).

The device generalization of the reference's `--part` memory
sharding (AlignGraph.cpp:3347-3418): instead of sequential per-part
files, the km_*/ed_* graph tensors live SHARDED over a device mesh's
position axis and the build's merge traffic rides collectives:

  1. records stay data-parallel (each shard emits tuples/rows for its
     record slice — the same phases 1-2 as kmer_layer_jit)
  2. rows route to the shard OWNING their genome position via
     `all_to_all` (fixed-capacity buckets); the owner runs the exact
     grouping + assign/create first-fit rounds over the union of rows
     it receives, so per-position merge decisions see every row in
     global arrival order — bit-identical to the sequential reference
     scan for ANY sharding (first-fit is stable: slots append-only,
     anchors immutable)
  3. chosen slot ids + slot anchors return to each row's producer
     (reverse `all_to_all`), which assembles edge candidates per tuple
     and routes them to the shard owning the edge's SOURCE position
  4. owners dedup/gate/append edges in global (pos, slot, arrival)
     order against their local ed_* state

Reads whose emission span crosses a shard cut need no special casing:
each row routes independently by position, and edges across the cut
carry the remote slot id + anchors in their payload.

cmpack (the read-only contig-layer anchor table) is replicated; the
slotted k-mer/edge state — 430 of the 497 B/position — is sharded.

Validated bit-identical to the host oracle in tests/test_kmer_shard.py
on an 8-device CPU mesh, including span-crossing reads; exercised by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aligngraph_tpu.config import EP
from aligngraph_tpu.graph.kmer_layer import (
    CPM, CPO, KmerBuildStats, normalize_records,
)
from aligngraph_tpu.graph.kmer_layer_jit import (
    _compat_jit, _emit_tuples_jit, _expand_jit, _state_from_graph,
    _state_to_graph,
)
from aligngraph_tpu.graph.model import E_ED, K_KM, GraphTensors, NONE32

I32 = jnp.int32
NC = CPO * CPM

# row payload fields routed to position owners (int32 each)
_ROW_F = ("pos", "arrival", "weight", "contig", "coff", "contig0",
          "coff0", "gpos0", "s_pack", "s_len", "s0")
# give-back payload: slot id + the CHOSEN slot's anchors (for edge gate)
_RET_F = ("slot", "sc", "sf", "sc0", "sf0")
# edge-candidate payload routed to source-position owners
_EDG_F = ("sp", "ss", "dp", "ds", "dc", "df", "dc0", "df0", "ea")


def _route(vals, owner, valid, S: int, cap: int, axis: str):
    """Scatter rows into [S, cap] buckets by owner and all_to_all them.

    Returns (received dict of [S*cap] arrays, valid [S*cap], overflow).
    Rows keep global arrival order within each (producer, owner) bucket;
    the owner's later joint sort restores full global order."""
    n = owner.shape[0]
    own = jnp.where(valid, owner, S)
    # rank within destination bucket via sort by (owner, index)
    idx = jnp.arange(n, dtype=I32)
    own_s, idx_s = jax.lax.sort((own, idx), num_keys=1, is_stable=True)
    newb = jnp.ones(n, bool).at[1:].set(own_s[1:] != own_s[:-1])
    bstart = jax.lax.cummax(jnp.where(newb, idx, 0))
    rank = idx - bstart
    overflow = jnp.any((own_s < S) & (rank >= cap))
    slot = jnp.where((own_s < S) & (rank < cap), own_s * cap + rank,
                     S * cap)
    out = {}
    for f in vals:
        buf = jnp.zeros(S * cap, I32).at[slot].set(vals[f][idx_s],
                                                   mode="drop")
        out[f] = buf
    vbuf = jnp.zeros(S * cap, I32).at[slot].set(1, mode="drop")
    # all_to_all: [S, cap] -> swap shard/bucket axes
    rec = {f: jax.lax.all_to_all(out[f].reshape(S, cap), axis, 0, 0,
                                 tiled=False).reshape(S * cap)
           for f in out}
    rv = jax.lax.all_to_all(vbuf.reshape(S, cap), axis, 0, 0,
                            tiled=False).reshape(S * cap)
    return rec, rv > 0, overflow


def _route_back(vals, axis: str, S: int, cap: int):
    """Reverse of _route's all_to_all on already-bucketed [S*cap] data."""
    return {f: jax.lax.all_to_all(vals[f].reshape(S, cap), axis, 0, 0,
                                  tiled=False).reshape(S * cap)
            for f in vals}


def _merge_local(state, rows, rvalid, n_local: int, lo, win: int,
                 G_cap: int):
    """Grouping + assign/create rounds over owner-local rows.

    rows: dict of [R] int32 (global positions); returns (new state,
    row_slot [R], row slot anchors for give-back, info)."""
    R = rows["pos"].shape[0]
    pos_l = rows["pos"] - lo
    valid = rvalid & (pos_l >= 0) & (pos_l < n_local)

    # ---- grouping by exact signature (kmer_layer_jit phase 3) ----
    w0 = jnp.where(valid, pos_l + 1, 1 << 30)
    misc = (rows["s0"] | (rows["s_len"] << 3)
            | (rows["weight"] << 8)).astype(I32)
    rowid = jnp.arange(R, dtype=I32)
    (w0_s, w1_s, w2_s, w3_s, w4_s, w5_s, arr_s, spack_s, misc_s,
     rowid_s) = jax.lax.sort(
        (w0, rows["contig"], rows["coff"], rows["contig0"],
         rows["coff0"], rows["gpos0"], rows["arrival"],
         rows["s_pack"], misc, rowid),
        num_keys=7, is_stable=True)
    valid_s = w0_s < (1 << 30)
    newg = jnp.ones(R, bool)
    newg = newg.at[1:].set(
        (w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
        | (w2_s[1:] != w2_s[:-1]) | (w3_s[1:] != w3_s[:-1])
        | (w4_s[1:] != w4_s[:-1]) | (w5_s[1:] != w5_s[:-1]))
    gstart = newg & valid_s
    gid = jnp.cumsum(gstart.astype(I32)) - 1
    G_real = jnp.sum(gstart.astype(I32))
    group_ovf = G_real > G_cap
    NV = jnp.sum(valid_s.astype(I32))

    starts = jnp.argsort(~gstart, stable=True)[:G_cap].astype(I32)
    g_ok = gstart[starts]
    g_pos = (w0_s[starts] & ((1 << 30) - 1)) - 1
    g_contig = w1_s[starts]
    g_coff = w2_s[starts]
    g_contig0 = w3_s[starts]
    g_coff0 = w4_s[starts]
    g_gpos0 = w5_s[starts]
    g_first = arr_s[starts]
    g_spack = spack_s[starts]
    g_slen = (misc_s[starts] >> 3) & 31

    ends = jnp.concatenate([starts[1:], jnp.full(1, R, I32)])
    ends = jnp.minimum(jnp.where(
        jnp.arange(G_cap) + 1 < G_real, ends, NV), R)
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
    g_votes = jnp.stack(votes_cols, axis=-1)

    # ---- assign/create rounds (kmer_layer_jit phase 4) ----
    wR = jnp.where(g_ok, g_pos + 1, 1 << 30)
    gidx = jnp.arange(G_cap, dtype=I32)
    wR_s, _, gsort = jax.lax.sort((wR, g_first, gidx), num_keys=2,
                                  is_stable=True)
    pos_rs = (wR_s & ((1 << 30) - 1)) - 1
    okr = wR_s < (1 << 30)
    news = jnp.ones(G_cap, bool)
    news = news.at[1:].set(pos_rs[1:] != pos_rs[:-1])
    run_start = jax.lax.cummax(jnp.where(news, gidx, 0))

    sgc = g_contig[gsort]
    sgf = g_coff[gsort]
    sgc0 = g_contig0[gsort]
    sgf0 = g_coff0[gsort]
    sgg0 = g_gpos0[gsort]
    sgw = g_weight[gsort]
    sgv = g_votes[gsort]
    sgsp = g_spack[gsort]
    sgsl = g_slen[gsort]
    posc_s = jnp.clip(pos_rs, 0, n_local - 1)

    def unpk(a):
        return jnp.where(a == jnp.uint32(NONE32).astype(I32), -1, a)

    def round_step(_, carry):
        (contig, coff, contig0, coff0, mate_, cov, votes, spk, sln,
         cnt, pending, slot_s, dslots) = carry
        kc = cnt[posc_s]
        comp = []
        for s in range(K_KM):
            c = (s < kc) & _compat_jit(
                sgc, sgf, sgc0, sgf0, sgg0,
                unpk(contig[posc_s, s]), coff[posc_s, s],
                unpk(contig0[posc_s, s]), coff0[posc_s, s],
                unpk(mate_[posc_s, s]), win)
            comp.append(c)
        comp = jnp.stack(comp, axis=-1)
        has = comp.any(axis=-1)
        first = jnp.argmax(comp, axis=-1).astype(I32)
        assign = pending & has
        mpos = jnp.where(assign, posc_s, n_local)
        cov = cov.at[mpos, first].add(jnp.where(assign, sgw, 0),
                                      mode="drop")
        votes = votes.at[mpos, first].add(
            jnp.where(assign[:, None], sgv, 0), mode="drop")
        slot_s = jnp.where(assign, first, slot_s)
        pending = pending & ~has
        at_cap = kc >= K_KM
        dslots = dslots + jnp.sum((pending & at_cap).astype(I32))
        pending = pending & ~at_cap
        S_ = jnp.cumsum(pending.astype(I32))
        base = S_[run_start] - pending[run_start].astype(I32)
        creator = pending & ((S_ - base) == 1)
        ac = cnt[posc_s]
        cpos = jnp.where(creator, posc_s, n_local)
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

    carry0 = (
        state["km_contig"], state["km_coff"], state["km_contig0"],
        state["km_coff0"], state["km_mate"], state["km_cov"],
        state["km_votes"], state["km_s"], state["km_slen"],
        state["km_cnt"], okr, jnp.full(G_cap, -1, I32),
        jnp.zeros((), I32))
    carry = jax.lax.fori_loop(0, K_KM + 2, round_step, carry0)
    (n_contig, n_coff, n_contig0, n_coff0, n_mate, n_cov, n_votes,
     n_spk, n_sln, n_cnt, _pend, slot_sorted, dropped_slots) = carry

    g_slot = jnp.full(G_cap, -1, I32).at[gsort].set(slot_sorted)
    row_slot_s = jnp.where(valid_s, g_slot[jnp.clip(gid, 0, G_cap - 1)],
                           -1)
    row_slot = jnp.full(R, -1, I32).at[rowid_s].set(row_slot_s)

    # give-back anchors: the chosen SLOT's stored anchors (creator's)
    pos_c = jnp.clip(pos_l, 0, n_local - 1)
    slot_c = jnp.clip(row_slot, 0, K_KM - 1)
    got = row_slot >= 0
    ret = dict(
        slot=row_slot,
        sc=jnp.where(got, n_contig[pos_c, slot_c], -1),
        sf=jnp.where(got, n_coff[pos_c, slot_c], -1),
        sc0=jnp.where(got, n_contig0[pos_c, slot_c], -1),
        sf0=jnp.where(got, n_coff0[pos_c, slot_c], -1),
    )
    new_state = dict(state)
    new_state.update(
        km_contig=n_contig, km_coff=n_coff, km_contig0=n_contig0,
        km_coff0=n_coff0, km_mate=n_mate, km_cov=n_cov, km_votes=n_votes,
        km_s=n_spk, km_slen=n_sln, km_cnt=n_cnt)
    info = dict(groups=G_real, dropped_slots=dropped_slots,
                group_ovf=group_ovf)
    return new_state, row_slot, ret, info


def _edges_local(state, ed, evalid, n_local: int, lo, win: int,
                 E_cap: int):
    """Dedup + gate + append edge candidates with local source position
    (kmer_layer_jit phase 5 semantics, jointly ordered)."""
    sp_l = ed["sp"] - lo
    ok = evalid & (ed["ss"] >= 0) & (ed["ds"] >= 0) \
        & (sp_l >= 0) & (sp_l < n_local)
    R = sp_l.shape[0]
    w = jnp.where(ok, sp_l + 1, 1 << 30)
    sp_s, ss_s, dp_s, ds_s, ea_s, dc_s, df_s, dc0_s, df0_s = jax.lax.sort(
        (w, ed["ss"], ed["dp"], ed["ds"], ed["ea"],
         ed["dc"], ed["df"], ed["dc0"], ed["df0"]),
        num_keys=5, is_stable=True)
    ev_s = sp_s < (1 << 30)
    euniq = jnp.ones(R, bool)
    euniq = euniq.at[1:].set(
        (sp_s[1:] != sp_s[:-1]) | (ss_s[1:] != ss_s[:-1])
        | (dp_s[1:] != dp_s[:-1]) | (ds_s[1:] != ds_s[:-1]))
    euniq = euniq & ev_s
    esel = jnp.argsort(~euniq, stable=True)[:E_cap].astype(I32)
    e_ok = euniq[esel]
    edge_ovf = jnp.sum(euniq.astype(I32)) > E_cap
    sp = (sp_s[esel] & ((1 << 30) - 1)) - 1
    ss = ss_s[esel]
    dp = dp_s[esel]
    ds = ds_s[esel]
    e_arr = ea_s[esel]
    b_c, b_f, b_c0, b_f0 = (dc_s[esel], df_s[esel], dc0_s[esel],
                            df0_s[esel])

    def unpk(a):
        return jnp.where(a == jnp.uint32(NONE32).astype(I32), -1, a)

    spc = jnp.clip(sp, 0, n_local - 1)
    a_c = unpk(state["km_contig"][spc, ss])
    a_f = state["km_coff"][spc, ss]
    a_c0 = unpk(state["km_contig0"][spc, ss])
    a_f0 = state["km_coff0"][spc, ss]
    bad1 = (a_c >= 0) & (unpk(b_c) >= 0) & (a_c == unpk(b_c)) & \
        (jnp.abs(a_f - b_f) > 5 * EP)
    bad2 = (a_c0 >= 0) & (unpk(b_c0) >= 0) & (a_c0 == unpk(b_c0)) & \
        (jnp.abs(a_f0 - b_f0) > win)
    e_ok = e_ok & ~(bad1 | bad2)

    exists = jnp.zeros(E_cap, bool)
    for e in range(E_ED):
        exists |= (e < state["ed_cnt"][spc, ss]) & \
            (state["ed_pos"][spc, ss, e] == dp) & \
            (state["ed_item"][spc, ss, e] == ds)
    e_ok = e_ok & ~exists

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
    base_cnt = state["ed_cnt"][jnp.clip(sp_f, 0, n_local - 1), ss_f] \
        .astype(I32)
    tgt_e = base_cnt + rrank
    can = f_ok & (tgt_e < E_ED)
    dropped_edges = jnp.sum((f_ok & ~can).astype(I32))
    spfc = jnp.where(can, sp_f, n_local)
    ed_pos = state["ed_pos"].at[
        spfc, ss_f, jnp.clip(tgt_e, 0, E_ED - 1)].set(dp_f, mode="drop")
    ed_item = state["ed_item"].at[
        spfc, ss_f, jnp.clip(tgt_e, 0, E_ED - 1)].set(ds_f, mode="drop")
    inc = jnp.zeros((n_local, K_KM), I32).at[spfc, ss_f].add(
        can.astype(I32), mode="drop")
    new_state = dict(state)
    new_state.update(ed_pos=ed_pos, ed_item=ed_item,
                     ed_cnt=state["ed_cnt"] + inc)
    return new_state, dict(dropped_edges=dropped_edges,
                           edge_ovf=edge_ovf)


def build_kmer_layer_sharded(g: GraphTensors, pairs, reads, k: int,
                             insert_variation: int, mesh: Mesh,
                             axis: str = "pos", part_offset: int = 0,
                             stats: Optional[KmerBuildStats] = None,
                             put=None, get=None) -> KmerBuildStats:
    """Drop-in for build_kmer_layer with the merge position-sharded over
    `mesh` (bit-identical results; see module docstring).

    The whole record set is processed in ONE sharded step (records split
    data-parallel across shards); capacity overflows raise (callers fall
    back to the host oracle).

    put(host_array, PartitionSpec) -> global array and
    get(global_array) -> host array default to jax.device_put /
    np.asarray (single-process); multi-process callers
    (jax.distributed) pass multihost_utils-based versions —
    tests/distributed_worker.py."""
    if put is None:
        put = lambda a, spec: jax.device_put(  # noqa: E731
            jnp.asarray(a), NamedSharding(mesh, spec))
    if get is None:
        get = np.asarray
    st = stats or KmerBuildStats()
    if pairs.n == 0:
        return st
    S = mesh.devices.size
    p1, p2, s1, lens, keep = normalize_records(
        pairs, reads, k, part_offset, g.part_len)
    M, L = p1.shape
    Ms = -(-M // S)
    pad = S * Ms - M
    if pad:
        p1 = np.concatenate([p1, np.full((pad, L), -1, p1.dtype)])
        p2 = np.concatenate([p2, np.full((pad, L), -1, p2.dtype)])
        s1 = np.concatenate([s1, np.full((pad, L), 4, s1.dtype)])
        lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        keep = np.concatenate([keep, np.zeros(pad, bool)])

    n_pos = int(g.km_cnt.shape[0])
    n_local = -(-n_pos // S)
    n_pos_pad = S * n_local
    state = _state_from_graph(g)
    state = {f: jnp.concatenate(
        [v, jnp.zeros((n_pos_pad - n_pos,) + v.shape[1:], v.dtype)])
        for f, v in state.items()}

    cmpack = np.concatenate([
        g.cm_cnt[:, None].astype(np.int32),
        np.where(g.cm_contig[:, :CPO] == NONE32, -1,
                 g.cm_contig[:, :CPO].astype(np.int64)).astype(np.int32),
        np.where(g.cm_coff[:, :CPO] == NONE32, -1,
                 g.cm_coff[:, :CPO].astype(np.int64)).astype(np.int32),
    ], axis=1)

    Lk = L - k
    B_cap = max(4096, (Ms * Lk) // 8)
    T_all = 2 * Ms * Lk + B_cap
    R_all = 2 * T_all * NC
    capR = max(1024, (R_all // S) * 2 // 128 * 128)
    G_cap = S * capR
    capE = max(1024, (2 * T_all * NC * NC // S) // 128 * 128)
    E_cap = S * capE
    win = 2 * insert_variation + 5 * EP

    @partial(jax.jit,
             static_argnames=("k_", "win_", "S_", "n_local_", "capR_",
                              "G_cap_", "capE_", "E_cap_", "B_cap_"))
    def step(state, cmpack_d, p1d, p2d, s1d, lensd, keepd, *, k_, win_,
             S_, n_local_, capR_, G_cap_, capE_, E_cap_, B_cap_):

        def shard_fn(state_l, cm, p1s, p2s, s1s, lenss, keeps):
            sid = jax.lax.axis_index(axis).astype(I32)
            tup, bridge_ovf = _emit_tuples_jit(
                p1s, p2s, s1s, lenss, keeps, k_, B_cap_)
            # globalize arrival: record index offset for this shard
            tup = dict(tup)
            tup["arrival"] = tup["arrival"] + sid * (Ms * L * 4)
            k1 = _expand_jit(cm, n_pos_pad, tup["cur"], tup["mate_cur"],
                             tup["arrival"], 0, tup["s_pack"],
                             tup["s_len"], tup["s0"], tup["valid"])
            k2 = _expand_jit(cm, n_pos_pad, tup["nxt"], tup["mate_nxt"],
                             tup["arrival"], 1, tup["ns_pack"],
                             tup["ns_len"], tup["ns0"], tup["valid"])
            rows = {f: jnp.concatenate([k1[f], k2[f]])
                    for f in ("valid", "pos", "arrival", "weight",
                              "contig", "coff", "contig0", "coff0",
                              "gpos0", "s_pack", "s_len", "s0")}
            Rl = rows["pos"].shape[0]
            owner = jnp.clip(rows["pos"], 0, n_pos_pad - 1) // n_local_
            vals = {f: rows[f] for f in _ROW_F}
            vals["src"] = jnp.arange(Rl, dtype=I32)   # producer row id
            recv, rvalid, route_ovf = _route(
                vals, owner.astype(I32), rows["valid"], S_, capR_, axis)
            lo = sid * n_local_
            state_l, row_slot, ret, minfo = _merge_local(
                state_l, recv, rvalid, n_local_, lo, win_, G_cap_)
            ret = dict(ret)
            ret["src"] = recv["src"]
            back = _route_back(ret, axis, S_, capR_)
            # scatter give-back to producer row order
            bsrc = jnp.clip(back["src"], 0, Rl - 1)
            bok = back["slot"] >= 0
            def unbucket(fv):
                return jnp.full(Rl, -1, I32).at[
                    jnp.where(bok, bsrc, Rl)].set(fv, mode="drop")
            r_slot = unbucket(back["slot"])
            r_sc = unbucket(back["sc"])
            r_sf = unbucket(back["sf"])
            r_sc0 = unbucket(back["sc0"])
            r_sf0 = unbucket(back["sf0"])

            # edge candidates (kmer_layer_jit phase 5 pre-dedup)
            T_ = tup["cur"].shape[0]
            v1 = k1["valid"].reshape(NC, T_).T
            v2 = k2["valid"].reshape(NC, T_).T
            slot1 = r_slot[:Rl // 2].reshape(NC, T_).T
            slot2 = r_slot[Rl // 2:].reshape(NC, T_).T
            rank_a = jnp.cumsum(v1.astype(I32), axis=1) - 1
            rank_b = jnp.cumsum(v2.astype(I32), axis=1) - 1
            p1e = k1["pos"][:T_]
            p2e = k2["pos"][:T_]
            dc2 = r_sc[Rl // 2:].reshape(NC, T_).T
            df2 = r_sf[Rl // 2:].reshape(NC, T_).T
            dc02 = r_sc0[Rl // 2:].reshape(NC, T_).T
            df02 = r_sf0[Rl // 2:].reshape(NC, T_).T
            parts = {f: [] for f in _EDG_F + ("val",)}
            for a in range(NC):
                for b in range(NC):
                    ev = (v1[:, a] & v2[:, b] & (slot1[:, a] >= 0)
                          & (slot2[:, b] >= 0))
                    parts["val"].append(ev.astype(I32))
                    parts["sp"].append(p1e)
                    parts["ss"].append(slot1[:, a])
                    parts["dp"].append(p2e)
                    parts["ds"].append(slot2[:, b])
                    parts["dc"].append(dc2[:, b])
                    parts["df"].append(df2[:, b])
                    parts["dc0"].append(dc02[:, b])
                    parts["df0"].append(df02[:, b])
                    parts["ea"].append(tup["arrival"] * (NC * NC)
                                       + rank_a[:, a] * NC
                                       + rank_b[:, b])
            ecat = {f: jnp.concatenate(v) for f, v in parts.items()}
            eowner = jnp.clip(ecat["sp"], 0, n_pos_pad - 1) // n_local_
            erecv, vvalid, eroute_ovf = _route(
                {f: ecat[f] for f in _EDG_F}, eowner.astype(I32),
                ecat["val"] > 0, S_, capE_, axis)
            state_l, einfo = _edges_local(
                state_l, erecv, vvalid, n_local_, lo, win_, E_cap_)

            ovf = (bridge_ovf | route_ovf | minfo["group_ovf"]
                   | eroute_ovf | einfo["edge_ovf"])
            info = dict(
                tuples=jax.lax.psum(
                    jnp.sum(tup["valid"].astype(I32)), axis),
                rows=jax.lax.psum(
                    jnp.sum(rows["valid"].astype(I32)), axis),
                groups=jax.lax.psum(minfo["groups"], axis),
                dropped_slots=jax.lax.psum(minfo["dropped_slots"], axis),
                dropped_edges=jax.lax.psum(einfo["dropped_edges"], axis),
                overflow=jax.lax.pmax(ovf.astype(I32), axis),
            )
            return state_l, info

        from jax import shard_map
        state_specs = {f: P(axis) for f in state}
        fn = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(state_specs, P(), P(axis), P(axis), P(axis),
                      P(axis), P(axis)),
            out_specs=({f: P(axis) for f in state},
                       {f: P() for f in ("tuples", "rows", "groups",
                                         "dropped_slots",
                                         "dropped_edges", "overflow")}),
            check_vma=False)
        return fn(state, cmpack_d, p1d, p2d, s1d, lensd, keepd)

    args = [put(a.astype(np.int32) if a.dtype != np.bool_ else a,
                P(axis))
            for a in (p1, p2, s1.astype(np.int32), lens, keep)]
    state = {f: put(np.asarray(v), P(axis)) for f, v in state.items()}
    cmpack_d = put(cmpack, P())
    state, info = step(state, cmpack_d, *args, k_=k, win_=win, S_=S,
                       n_local_=n_local, capR_=capR, G_cap_=G_cap,
                       capE_=capE, E_cap_=E_cap, B_cap_=B_cap)
    if bool(info["overflow"]):
        raise RuntimeError(
            "sharded k-mer build capacity overflow — raise caps or use "
            "the host oracle for this workload")
    # unshard into g (trim the position padding)
    full = {f: np.asarray(get(v))[:n_pos] for f, v in state.items()}
    _state_to_graph(full, g)
    st.tuples += int(info["tuples"])
    st.rows += int(info["rows"])
    st.groups += int(info["groups"])
    st.dropped_slots += int(info["dropped_slots"])
    st.dropped_edges += int(info["dropped_edges"])
    return st

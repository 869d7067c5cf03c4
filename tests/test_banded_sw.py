"""Banded SW kernel vs brute-force full affine local SW oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from aligngraph_tpu.ops.banded_sw import (
    GAP_EXT, GAP_OPEN, MATCH, MISMATCH, N_PEN, banded_sw, sw_traceback,
)

NEGI = -(10**7)


def full_sw_score(read, window):
    """Full (unbanded) local affine SW, numpy oracle. Returns best score."""
    L, Wn = len(read), len(window)
    H = np.zeros((L + 1, Wn + 1), np.int64)
    E = np.full((L + 1, Wn + 1), NEGI, np.int64)  # gap consuming read base
    F = np.full((L + 1, Wn + 1), NEGI, np.int64)  # gap consuming window base
    for i in range(1, L + 1):
        for j in range(1, Wn + 1):
            r, w = read[i - 1], window[j - 1]
            if r < 4 and r == w:
                s = MATCH
            elif r >= 4 or w >= 4:
                s = N_PEN
            else:
                s = MISMATCH
            E[i][j] = max(H[i - 1][j] - GAP_OPEN - GAP_EXT,
                          E[i - 1][j] - GAP_EXT)
            F[i][j] = max(H[i][j - 1] - GAP_OPEN - GAP_EXT,
                          F[i][j - 1] - GAP_EXT)
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
    return int(H.max())


def make_case(rng, L, pad, n_mut=3, indel=True):
    """Read sampled from a genome window with mutations; returns
    (read, window, g0_offset_in_window)."""
    W = 2 * pad
    g = rng.integers(0, 4, size=L + 2 * W).astype(np.int8)
    start = W  # read corresponds to window position W .. W+L
    read = g[start:start + L].copy()
    for _ in range(n_mut):
        k = rng.integers(0, len(read))
        op = rng.integers(0, 3 if indel else 1)
        if op == 0:
            read[k] = (read[k] + rng.integers(1, 4)) % 4
        elif op == 1 and len(read) > 10:
            read = np.delete(read, k)
        else:
            read = np.insert(read, k, rng.integers(0, 4))
    read = read[:L]
    rlen = len(read)
    padded = np.full(L, 4, np.int8)
    padded[:rlen] = read
    # window for the DP: windows[x] = genome[g0 - pad + x], x in [0, L+W)
    # with g0 = start (read base 0 ~ genome[start])
    win = g[start - pad:start - pad + L + W].astype(np.int8)
    return padded, rlen, win


def score_from_pos_map(read, rlen, pos_map, genome_at):
    """Recompute alignment score from the traceback position map."""
    aligned = [(i, int(pos_map[i])) for i in range(rlen) if pos_map[i] >= 0]
    if not aligned:
        return 0
    score = 0
    prev_i, prev_g = None, None
    for i, g in aligned:
        r, w = int(read[i]), int(genome_at(g))
        if r < 4 and r == w:
            score += MATCH
        elif r >= 4 or w >= 4:
            score += N_PEN
        else:
            score += MISMATCH
        if prev_i is not None:
            di, dg = i - prev_i, g - prev_g
            assert di >= 1 and dg >= 1, "pos_map not monotone"
            if di > 1:  # read gap (unaligned read bases)
                score -= GAP_OPEN + GAP_EXT * (di - 1)
            if dg > 1:  # genome gap (deleted genome bases)
                score -= GAP_OPEN + GAP_EXT * (dg - 1)
        prev_i, prev_g = i, g
    return score


@pytest.mark.parametrize("seed", range(8))
def test_banded_matches_full_sw(seed):
    rng = np.random.default_rng(seed)
    L, pad = 64, 16
    B = 16
    reads, rlens, wins = [], [], []
    for _ in range(B):
        r, rl, w = make_case(rng, L, pad, n_mut=int(rng.integers(0, 6)))
        reads.append(r)
        rlens.append(rl)
        wins.append(w)
    reads = jnp.asarray(np.stack(reads))
    rlens_a = jnp.asarray(np.array(rlens, np.int32))
    wins_a = jnp.asarray(np.stack(wins))
    res = banded_sw(reads, rlens_a, wins_a, pad=pad)
    for k in range(B):
        oracle = full_sw_score(np.asarray(reads[k])[: rlens[k]],
                               np.asarray(wins_a[k]))
        assert int(res.score[k]) == oracle, f"case {k}"


@pytest.mark.parametrize("seed", range(6))
def test_traceback_score_consistency(seed):
    rng = np.random.default_rng(100 + seed)
    L, pad = 80, 16
    B = 12
    reads, rlens, wins = [], [], []
    for _ in range(B):
        r, rl, w = make_case(rng, L, pad, n_mut=int(rng.integers(0, 8)))
        reads.append(r)
        rlens.append(rl)
        wins.append(w)
    reads_a = jnp.asarray(np.stack(reads))
    rlens_a = jnp.asarray(np.array(rlens, np.int32))
    wins_a = jnp.asarray(np.stack(wins))
    res = banded_sw(reads_a, rlens_a, wins_a, pad=pad)
    g0 = jnp.zeros(B, jnp.int32)  # window-local coordinates
    pos_map = np.asarray(sw_traceback(res.tb, res.best_i, res.best_b,
                                      g0, pad=pad))
    for k in range(B):
        win = np.asarray(wins_a[k])

        def genome_at(g, win=win):
            x = g + pad  # window[x] = genome[g0 - pad + x], g0 = 0
            return win[x] if 0 <= x < len(win) else 4

        s = score_from_pos_map(np.asarray(reads_a[k]), rlens[k],
                               pos_map[k], genome_at)
        assert s == int(res.score[k]), f"case {k}: {s} != {int(res.score[k])}"


def test_perfect_match_score():
    rng = np.random.default_rng(42)
    L, pad = 50, 8
    g = rng.integers(0, 4, size=L + 4 * pad).astype(np.int8)
    read = g[pad:pad + L]
    win = g[0:L + 2 * pad]
    res = banded_sw(jnp.asarray(read[None, :]),
                    jnp.asarray(np.array([L], np.int32)),
                    jnp.asarray(win[None, :]), pad=pad)
    assert int(res.score[0]) == MATCH * L
    pos_map = np.asarray(sw_traceback(
        res.tb, res.best_i, res.best_b, jnp.asarray([pad], jnp.int32),
        pad=pad))[0]
    # read base i aligns genome pos pad + i (g0 = pad)
    np.testing.assert_array_equal(pos_map, np.arange(pad, pad + L))


def test_no_alignment_scores_zero():
    # all-N read vs genome: only N penalties -> local best 0
    read = np.full((1, 30), 4, np.int8)
    win = np.zeros((1, 30 + 16), np.int8)
    res = banded_sw(jnp.asarray(read), jnp.asarray([30], jnp.int32),
                    jnp.asarray(win), pad=8)
    assert int(res.score[0]) == 0


# (B, L): the read path's width (L=100) and the contig tile width (L=512),
# with small batches for the CPU
SHAPES = {"read": (256, 100), "contig": (48, 512)}
PAD = 16


def _reference_posmap(c, use_smin):
    """banded_sw + sw_traceback + the gapless select, spelled out."""
    from aligngraph_tpu.ops.banded_sw import gapless_diag

    reads, rlens = jnp.asarray(c["reads"]), jnp.asarray(c["rlens"])
    windows, g0 = jnp.asarray(c["windows"]), c["g0"]
    res = banded_sw(reads, rlens, windows, pad=PAD)
    pm_tb = np.asarray(sw_traceback(res.tb, res.best_i, res.best_b,
                                    jnp.asarray(g0), pad=PAD))
    gb, gs, ge = (np.asarray(a) for a in
                  gapless_diag(reads, rlens, windows, PAD))
    score = np.asarray(res.score)
    need = score > gb
    if use_smin:
        need &= score >= c["smin"]
    j = np.arange(reads.shape[1])
    syn_on = (~need[:, None]) & (score > 0)[:, None] \
        & (j[None, :] >= gs[:, None]) & (j[None, :] <= ge[:, None])
    pm = np.where(need[:, None], pm_tb,
                  np.where(syn_on, g0[:, None] + j[None, :], -1))
    return score, pm, need


def _posmap_args(c, use_smin):
    return ((jnp.asarray(c["reads"]), jnp.asarray(c["rlens"]),
             jnp.asarray(c["windows"]), jnp.asarray(c["g0"])),
            dict(pad=PAD, smin=jnp.asarray(c["smin"]) if use_smin else None))


@pytest.mark.parametrize("use_smin", [True, False], ids=["smin", "nosmin"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_posmap_auto_cpu_equals_reference(shape, use_smin):
    """The CPU path of banded_sw_posmap_auto (the reference the GPU kernel
    is held to) on indel, gapless, junk and zero-length lanes."""
    from aligngraph_tpu.ops.banded_sw import banded_sw_posmap_auto
    from simdata import dp_batch

    B, L = SHAPES[shape]
    c = dp_batch(7, B, L, PAD)
    score_ref, pm_ref, need = _reference_posmap(c, use_smin)
    # every lane kind is present: walked, synthesized, unaligned
    assert need.any() and (~need & (score_ref > 0)).any()
    assert (c["rlens"] == 0).any()
    args, kw = _posmap_args(c, use_smin)
    score, pm = banded_sw_posmap_auto(*args, **kw)
    np.testing.assert_array_equal(np.asarray(score), score_ref)
    np.testing.assert_array_equal(np.asarray(pm), pm_ref)


def test_auto_on_gpu_backend_runs_xla_path(monkeypatch):
    """backend "gpu" takes the same XLA path as the CPU."""
    import jax

    from aligngraph_tpu.ops.banded_sw import banded_sw_posmap_auto
    from simdata import dp_batch

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    c = dp_batch(5, 40, 100, PAD)
    args, kw = _posmap_args(c, True)
    score, pm = banded_sw_posmap_auto(*args, **kw)
    score_ref, pm_ref, _ = _reference_posmap(c, True)
    np.testing.assert_array_equal(np.asarray(score), score_ref)
    np.testing.assert_array_equal(np.asarray(pm), pm_ref)


def test_auto_unknown_backend_raises(monkeypatch):
    import jax

    from aligngraph_tpu.ops.banded_sw import banded_sw_posmap_auto
    from simdata import dp_batch

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    args, kw = _posmap_args(dp_batch(1, 8, 100, PAD), False)
    with pytest.raises(NotImplementedError, match="rocm"):
        banded_sw_posmap_auto(*args, **kw)


@pytest.fixture
def gpu_device():
    """The first CUDA device; the test skips where there is none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` "
                    "on the card")


# the production widths: the read path's DP (L = 100, band 32; a read
# batch has 98,304 lanes, cut here to keep the CPU reference short) and
# one contig tile batch (DP_BATCH = 2,048 tiles of TILE = 512)
GPU_SHAPES = {"read": (16_384, 100), "contig": (2_048, 512)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(GPU_SHAPES))
def test_gpu_dp_equals_cpu_reference(gpu_device, shape):
    """The DP compiled for the GPU against the reference on the CPU
    device, bit for bit, at the production widths."""
    import jax

    from aligngraph_tpu.ops.banded_sw import banded_sw_posmap_xla
    from simdata import dp_batch

    B, L = GPU_SHAPES[shape]
    c = dp_batch(11, B, L, PAD)
    fn = jax.jit(banded_sw_posmap_xla, static_argnames=("pad",))
    for use_smin in (True, False):
        args, kw = _posmap_args(c, use_smin)
        on_gpu = fn(*jax.device_put(args, gpu_device), pad=PAD,
                    smin=jax.device_put(kw["smin"], gpu_device))
        cpu = jax.devices("cpu")[0]
        on_cpu = fn(*jax.device_put(args, cpu), pad=PAD,
                    smin=jax.device_put(kw["smin"], cpu))
        for got, want in zip(on_gpu, on_cpu):
            assert got.devices() == {gpu_device}
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

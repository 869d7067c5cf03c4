"""Smoke run of the reassembly engine on one NVIDIA GPU.

    python chip_smoke.py [--phases 1,2,3,4,5] [--work DIR]

One process holds the card and runs, in order:

  1. device: JAX must see a GPU (never falls back to the CPU); prints the
     card (nvidia-smi name and power limit) and builds the native libs;
  2. the banded DP at real widths: compiled for the GPU (memory
     analysis), against the plain reference on the CPU device, bit for
     bit, at the read-batch shape (98,304 x 100, band 32) and the
     contig-tile shape (2,048 x 512, band 32), then timed;
  3. the pipeline through the CLI (aligngraph_tpu.__main__.main) on an
     E. coli-scale simulation written as FASTA (4.6 Mb, 25x PE 100 bp at
     a 500 bp insert, ~1,424 drafts), evaluated against the true genome;
     one read batch and one contig tile batch are also aligned on the
     GPU and on the CPU device and must agree exactly;
  4. the device k-mer graph build on the pipeline's own records, field
     by field against the host build;
  5. the GPU-marked tests.

Any failed phase exits non-zero.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
--phases runs a subset (phase 4 needs phase 3's records, so it implies
it).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
# the tests' data generators (tests/simdata.py), by path: a site package
# may own the top-level name "tests"
sys.path.insert(1, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

import jax  # noqa: E402

import aligngraph_tpu  # noqa: E402,F401  (sets the compile cache)
from aligngraph_tpu.utils.device import card_line  # noqa: E402

T0 = time.time()
COMPILE_S = [0.0]


def _on_event(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        COMPILE_S[0] += duration


jax.monitoring.register_event_duration_secs_listener(_on_event)


class PhaseFailed(RuntimeError):
    pass


def say(*a):
    print(f"[{time.time() - T0:7.1f}s]", *a, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def timed(fn, args, kw, runs=7):
    """Median and spread of `runs` calls after one warmup, each ending in
    block_until_ready."""
    jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(runs):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t)
    return statistics.median(ts), min(ts), max(ts)


# ---------------------------------------------------------------- phase 1
def phase_device():
    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu",
          f"JAX's first device is {dev.platform!r}, not a GPU")
    say(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    say(f"nvidia-smi: {card_line()}")
    from aligngraph_tpu import native

    libs = {"traverse.cpp": native.get_lib(),
            "fastaio.cpp": native.get_fasta_lib()}
    for src, lib in libs.items():
        say(f"native {src}: {'built and loaded' if lib else 'NOT LOADED'}")
    check(all(libs.values()), "a native library failed to build or load")
    return dev


# ---------------------------------------------------------------- phase 2
# (lanes, L, the read path's smin floor): one read batch of 32,768 pairs
# (TOP = 98,304 candidate lanes of 100 bp) and one contig tile batch
# (DP_BATCH = 2,048 tiles of 512 bp); band 32 (band_pad 16) for both
SHAPES = {"read": (98_304, 100, True), "contig": (2_048, 512, False)}


def phase_dp(dev, cpu):
    from aligngraph_tpu.ops.banded_sw import (
        banded_sw, banded_sw_posmap_xla, gapless_diag, gapless_select,
        sw_traceback)
    from simdata import dp_batch

    pad = 16
    fn = jax.jit(banded_sw_posmap_xla, static_argnames=("pad",))
    for name, (B, L, prod_smin) in SHAPES.items():
        c = dp_batch(101, B, L, pad)
        host = (c["reads"], c["rlens"], c["windows"], c["g0"])
        a_gpu = jax.device_put(host, dev)
        a_cpu = jax.device_put(host, cpu)
        smin_gpu = jax.device_put(c["smin"], dev)
        smin_cpu = jax.device_put(c["smin"], cpu)

        # the plain reference on the CPU device: DP, traceback, select
        res = banded_sw(*a_cpu[:3], pad=pad)
        pm_tb = sw_traceback(res.tb, res.best_i, res.best_b, a_cpu[3],
                             pad=pad)
        gb, gs, ge = gapless_diag(*a_cpu[:3], pad)
        ref_score = np.asarray(res.score)
        for use_smin in (True, False):
            smin = smin_gpu if use_smin else None
            compiled = fn.lower(*a_gpu, pad=pad, smin=smin).compile()
            if use_smin == prod_smin:
                say(f"{name}: GPU DP memory_analysis: "
                    f"{compiled.memory_analysis()}")
            score, pm = compiled(*a_gpu, smin=smin)
            ref_pm = np.asarray(gapless_select(
                res.score, pm_tb, gb, gs, ge, a_cpu[3],
                smin_cpu if use_smin else None))
            same_s = np.array_equal(np.asarray(score), ref_score)
            same_p = np.array_equal(np.asarray(pm), ref_pm)
            n_walk = int(np.sum((ref_score > np.asarray(gb)) & (
                (ref_score >= c["smin"]) if use_smin else True)))
            say(f"{name} B={B} L={L} W=32 smin={use_smin}: score equal="
                f"{same_s} pos_map equal={same_p} (walked lanes {n_walk}, "
                f"zero-length {int(np.sum(c['rlens'] == 0))})")
            check(same_s and same_p,
                  f"{name}: the GPU DP differs from the CPU reference")
        kw = dict(pad=pad, smin=smin_gpu if prod_smin else None)
        med, lo, hi = timed(fn, a_gpu, kw)
        say(f"{name}: GPU DP (XLA) median {med * 1e3:.3f} ms "
            f"[{lo * 1e3:.3f}, {hi * 1e3:.3f}] over 7 runs")
        del res, pm_tb


# ---------------------------------------------------------------- phase 3
GENOME_LEN = 4_600_000
DEPTH = 25
READ_LEN = 100


def _write_reads(path, rows):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    seqs = lut[rows.astype(np.int64)]
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, s.tobytes())
                         for i, s in enumerate(seqs)))


def make_inputs(work):
    from bench_pipeline import cut_contigs, mutate_fast, simulate_pe_reads
    from aligngraph_tpu.io.fasta import decode, write_fasta

    n_pairs = int(DEPTH * GENOME_LEN / (2 * READ_LEN))
    rng = np.random.default_rng(7)
    target = rng.integers(0, 4, GENOME_LEN).astype(np.int8)
    ref = mutate_fast(rng, target)
    data, _ = simulate_pe_reads(rng, target, n_pairs, read_len=READ_LEN)
    drafts = cut_contigs(rng, target)
    os.makedirs(work, exist_ok=True)
    write_fasta(f"{work}/genome.fa", ["chr"], [decode(ref)])
    write_fasta(f"{work}/target.fa", ["chr"], [decode(target)])
    write_fasta(f"{work}/contigs.fa", [f"c{i}" for i in range(len(drafts))],
                [decode(c) for c in drafts])
    _write_reads(f"{work}/reads_1.fa", data[0::2])
    _write_reads(f"{work}/reads_2.fa", data[1::2])
    say(f"inputs: genome {GENOME_LEN} bp, {n_pairs} pairs of {READ_LEN} bp "
        f"({DEPTH}x), {len(drafts)} drafts -> {work}")
    return ref, drafts


def phase_pipeline(dev, cpu, work):
    from aligngraph_tpu import __main__ as cli
    from aligngraph_tpu.pipeline import driver

    ref, drafts = make_inputs(work)
    captured = {}
    run_pipeline, build_host = driver.run_pipeline, driver.build_kmer_layer

    def keep_result(*a, **k):
        captured["result"] = run_pipeline(*a, **k)
        return captured["result"]

    def keep_build(g, pairs, reads, k, iv, part_offset=0, stats=None):
        # the graph before and after the host k-mer build, for phase 4
        captured.setdefault("kmer", []).append(dict(
            before=copy.deepcopy(g), pairs=pairs, reads=reads, k=k, iv=iv,
            part_offset=part_offset))
        out = build_host(g, pairs, reads, k, iv, part_offset=part_offset,
                         stats=stats)
        captured["kmer"][-1]["after"] = {
            f: np.array(v) for f, v in vars(g).items()
            if f.startswith(("km_", "ed_"))}
        captured["kmer"][-1]["stats"] = copy.deepcopy(out)
        return out

    driver.run_pipeline, driver.build_kmer_layer = keep_result, keep_build
    c0 = COMPILE_S[0]
    t = time.time()
    try:
        rc = cli.main([
            "--read1", f"{work}/reads_1.fa", "--read2", f"{work}/reads_2.fa",
            "--contig", f"{work}/contigs.fa", "--genome", f"{work}/genome.fa",
            "--distanceLow", "300", "--distanceHigh", "700",
            "--extendedContig", f"{work}/extended.fa",
            "--remainingContig", f"{work}/remaining.fa"])
    finally:
        driver.run_pipeline, driver.build_kmer_layer = (run_pipeline,
                                                        build_host)
    wall = time.time() - t
    check(rc == 0, f"CLI exited {rc}")
    res = captured["result"]
    st = res.stats
    say(f"pipeline wall {wall:.2f}s; stage_seconds "
        + json.dumps({k: round(v, 2) for k, v in
                      st["stage_seconds"].items()}))
    rps = st["aligned_reads"] / st["read_align_seconds"]
    say(f"read alignment: {st['aligned_reads']} aligned reads of "
        f"{2 * st['n_pairs']} in {st['read_align_seconds']:.2f}s -> "
        f"{rps:.0f} aligned reads/s (beside the contig aligner); "
        f"contig placements {st['contig_placements']}")
    say(f"compile seconds in the pipeline: {COMPILE_S[0] - c0:.1f}; "
        f"peak_bytes_in_use {peak_bytes(dev)}")
    say(f"kmer build stats: {json.dumps(st['kmer_build'])}")

    from aligngraph_tpu.evaluate.evaluate import evaluate
    n_ext = len(res.extended_ids)
    check(n_ext > 0, "the pipeline extended no contig")
    m = evaluate(f"{work}/target.fa", f"{work}/extended.fa")
    ev = {k: (float(v) if isinstance(v, float) else int(v))
          for k, v in m.items() if isinstance(v, (int, float, np.number))}
    say(f"extended {n_ext} contigs; Eval: {json.dumps(ev)}")
    check(ev["n_true_contigs"] == ev["n_contigs"],
          "an extended contig is not a true contig")

    _batch_equality(dev, cpu, ref, drafts, captured["kmer"][0]["reads"],
                    work)
    return captured


def _batch_equality(dev, cpu, ref, drafts, reads, work):
    """One 32,768-pair read batch and one contig tile batch, aligned on the
    GPU and on the CPU device, must agree exactly."""
    import dataclasses

    from aligngraph_tpu.align.contig_aligner import (
        DP_BATCH, TILE, ContigAligner)
    from aligngraph_tpu.align.read_aligner import ReadAligner
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.io.fasta import decode, write_fasta
    from aligngraph_tpu.io.formalize import Reads, formalize_contigs

    cfg = Config(distance_low=300, distance_high=700)
    n = min(32_768, reads.n_pairs)
    batch = Reads(n, reads.max_len, np.asarray(reads.data[:2 * n]),
                  np.asarray(reads.lengths[:n]))
    out = []
    for d in (dev, cpu):
        t = time.time()
        with jax.default_device(d):
            out.append(ReadAligner.build(ref, cfg).align(batch))
        say(f"read batch of {n} pairs on {d.platform}: {out[-1].n} "
            f"records ({time.time() - t:.1f}s)")
    for f in dataclasses.fields(out[0]):
        check(np.array_equal(getattr(out[0], f.name),
                             getattr(out[1], f.name)),
              f"read batch: {f.name} differs between GPU and CPU")
    say("read batch: PairAlignments equal on GPU and CPU")

    tiles, k = 0, 0
    while tiles < DP_BATCH and k < len(drafts):
        tiles += -(-len(drafts[k]) // TILE)
        k += 1
    path = f"{work}/contigs_batch.fa"
    write_fasta(path, [f"c{i}" for i in range(k)],
                [decode(c) for c in drafts[:k]])
    contigs = formalize_contigs(path)
    cout = []
    for d in (dev, cpu):
        t = time.time()
        with jax.default_device(d):
            cout.append(ContigAligner(ref, cfg).align(contigs))
        say(f"contig batch ({k} drafts, {tiles} forward tiles) on "
            f"{d.platform}: {cout[-1].n} placements "
            f"({time.time() - t:.1f}s)")
    a, b = cout
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        same = (len(va) == len(vb) and all(
            np.array_equal(x, y) for x, y in zip(va, vb))
            if f.name == "pos_map" else np.array_equal(va, vb))
        check(same, f"contig batch: {f.name} differs between GPU and CPU")
    say("contig batch: ContigAlignments equal on GPU and CPU")


# ---------------------------------------------------------------- phase 4
def phase_kmer_device(dev, captured):
    from aligngraph_tpu.graph.kmer_layer import KmerBuildStats
    from aligngraph_tpu.graph.kmer_layer_jit import build_kmer_layer_device

    for p, cap in enumerate(captured["kmer"][:1]):
        g = cap["before"]
        c0 = COMPILE_S[0]
        t = time.time()
        st = build_kmer_layer_device(g, cap["pairs"], cap["reads"], cap["k"],
                                     cap["iv"], part_offset=cap["part_offset"],
                                     stats=KmerBuildStats())
        say(f"device k-mer build, part {p}: {cap['pairs'].n} records over "
            f"{g.part_len} positions in {time.time() - t:.1f}s (compile "
            f"{COMPILE_S[0] - c0:.1f}s); peak_bytes_in_use "
            f"{peak_bytes(dev)}")
        say(f"device stats {json.dumps(vars(st))}; host stats "
            f"{json.dumps(vars(cap['stats']))}")
        for f, want in cap["after"].items():
            check(np.array_equal(getattr(g, f), want),
                  f"device k-mer build differs from the host on {f}")
        say(f"device k-mer build equals the host build on "
            f"{len(cap['after'])} km_*/ed_* fields")


# ---------------------------------------------------------------- phase 5
def phase_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_banded_sw.py")],
                     plugins=[counter])
    say(f"GPU-marked tests: exit {int(rc)}, {counter.passed} passed")
    check(int(rc) == 0 and counter.passed == 2, "GPU-marked tests failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    ap.add_argument("--work", default=os.path.join(ROOT, ".chip_smoke"))
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if 4 in phases:
        phases |= {3}
    dev = phase_device()
    cpu = jax.devices("cpu")[0]
    if 2 in phases:
        phase_dp(dev, cpu)
    captured = None
    if 3 in phases:
        captured = phase_pipeline(dev, cpu, args.work)
    if 4 in phases:
        phase_kmer_device(dev, captured)
    if 5 in phases:
        phase_tests()
    shutil.rmtree(args.work, ignore_errors=True)
    say(f"compile seconds (backend compiles, whole run): {COMPILE_S[0]:.1f}")
    say(f"peak_bytes_in_use {peak_bytes(dev)}; wall {time.time() - T0:.1f}s")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)

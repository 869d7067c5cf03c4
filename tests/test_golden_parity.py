"""Golden parity vs the prebuilt reference binary.

Drives `/root/reference/AlignGraph/AlignGraph` with PATH shims that route
its bowtie2 / pblat subprocess calls to our in-engine aligners
(scripts/shims/*, compat/*_cli.py), then runs our pipeline on the same
inputs and compares outputs.  Because both sides consume byte-identical
alignments, any diff isolates the graph / extension / refinement core
(C16-C24).

Compared artifacts:
  - tmp/_initial_contigs.0.fa      (contig-layer build, C17)
  - tmp/_pre_extended_contigs.0.fa (traversal pass 1, C21)
  - tmp/_extended_contigs.0.fa     (merge + scaffold, C22/C23)
  - final --extendedContig / --remainingContig (refinement, C24)
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from aligngraph_tpu.io.fasta import decode, write_fasta
from tests.simdata import make_simdata

REF_BIN = "/root/reference/AlignGraph/AlignGraph"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIMS = os.path.join(REPO, "scripts", "shims")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BIN), reason="reference binary not present")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Simulated inputs + one reference-binary run (shared by the tests)."""
    wd = tmp_path_factory.mktemp("golden")
    sim = make_simdata(seed=42, genome_len=30_000, n_pairs=1500,
                       read_len=100, insert=500, snp_rate=0.01)
    write_fasta(wd / "genome.fa", ["chr0"], [decode(sim.reference)])
    write_fasta(wd / "reads_1.fa",
                [f"r{i}" for i in range(len(sim.reads1))],
                [decode(s) for s in sim.reads1])
    write_fasta(wd / "reads_2.fa",
                [f"r{i}" for i in range(len(sim.reads2))],
                [decode(s) for s in sim.reads2])
    write_fasta(wd / "contigs.fa",
                [f"c{i}" for i in range(len(sim.contigs))],
                [decode(s) for s in sim.contigs])

    env = dict(os.environ)
    env["PATH"] = SHIMS + os.pathsep + env.get("PATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [REF_BIN,
         "--read1", "reads_1.fa", "--read2", "reads_2.fa",
         "--contig", "contigs.fa", "--genome", "genome.fa",
         "--distanceLow", "200", "--distanceHigh", "800",
         "--extendedContig", "ref_extended.fa",
         "--remainingContig", "ref_remaining.fa"],
        cwd=wd, env=env, capture_output=True, text=True, timeout=1200)
    sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-2000:])
    assert proc.returncode == 0, f"reference binary failed: {proc.stderr}"
    assert (wd / "ref_extended.fa").exists()
    return wd


def _run_ours(wd):
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.pipeline.driver import run_pipeline

    cfg = Config(
        read1=str(wd / "reads_1.fa"), read2=str(wd / "reads_2.fa"),
        contig=str(wd / "contigs.fa"), genome=str(wd / "genome.fa"),
        distance_low=200, distance_high=800,
        extended_contig=str(wd / "our_extended.fa"),
        remaining_contig=str(wd / "our_remaining.fa"),
        work_dir=str(wd / "our_tmp"))
    return run_pipeline(cfg)


@pytest.fixture(scope="module")
def ours(workdir):
    return _run_ours(workdir)


def _fasta_map(path):
    """id -> sequence string (ignores line wrapping)."""
    from aligngraph_tpu.io.fasta import read_fasta
    ids, seqs = read_fasta(path)
    return dict(zip(ids, [s.decode() for s in seqs]))


def test_extended_contigs_match(workdir, ours):
    ref = _fasta_map(workdir / "ref_extended.fa")
    got = _fasta_map(workdir / "our_extended.fa")
    assert set(ref.keys()) == set(got.keys())
    for k in ref:
        assert got[k] == ref[k], f"extended contig {k} differs"


def test_remaining_contigs_match(workdir, ours):
    ref = _fasta_map(workdir / "ref_remaining.fa")
    got = _fasta_map(workdir / "our_remaining.fa")
    assert ref == got


def test_intermediate_stage_files(workdir, ours):
    """Stage-by-stage byte parity of the per-chromosome artifacts."""
    for name, attr in [("_initial_contigs.0.fa", "initial_fa"),
                       ("_pre_extended_contigs.0.fa", "pre_extended_fa"),
                       ("_extended_contigs.0.fa", "extended_fa")]:
        ref_p = workdir / "tmp" / name
        our_p = workdir / "our_tmp" / name
        assert ref_p.exists(), f"reference did not write {name}"
        assert our_p.exists(), f"our pipeline did not write {name}"
        assert our_p.read_bytes() == ref_p.read_bytes(), f"{name} differs"


# ---------------------------------------------------------------------------
# flag matrix vs the live binary (r03 verdict item 4)
# ---------------------------------------------------------------------------

MATRIX = [
    # (name, extra reference argv, Config overrides, n_chromosomes)
    ("uniqueExtension", ["--uniqueExtension"],
     dict(unique_extension=True), 1),
    # part2's contigs are confined to the FIRST part: the reference binary
    # has genuine UB when a part index >= #chromosomes emits an extended
    # contig (`genomeIds[i]` OOB, AlignGraph.cpp:3102 — verified by
    # instrumented source build, see PARITY.md), so the golden workload
    # must keep refinement emissions in part 0.  Reads still cover the
    # whole genome, so the --part demux + boundary cut stay exercised.
    ("part2", ["--part", "2"], dict(part=2), 1),
    ("multichrom_iterativeMap", ["--iterativeMap"],
     dict(iterative_map=True), 3),
    ("fastMap", ["--fastMap"], dict(fast_map=True), 1),
    ("misassemblyRemoval", ["--misassemblyRemoval"],
     dict(misassembly_removal=True), 1),
]


def _write_matrix_inputs(wd, name, n_chrom):
    sim = make_simdata(seed=7 + n_chrom, genome_len=12_000 * n_chrom,
                       n_pairs=600 * n_chrom, read_len=100, insert=500,
                       snp_rate=0.01)
    if n_chrom > 1:
        # split the reference genome into chromosomes at fixed cuts
        cuts = np.linspace(0, len(sim.reference), n_chrom + 1).astype(int)
        chroms = [sim.reference[cuts[i]:cuts[i + 1]]
                  for i in range(n_chrom)]
        write_fasta(wd / "genome.fa", [f"chr{i}" for i in range(n_chrom)],
                    [decode(c) for c in chroms])
    else:
        write_fasta(wd / "genome.fa", ["chr0"], [decode(sim.reference)])
    write_fasta(wd / "reads_1.fa",
                [f"r{i}" for i in range(len(sim.reads1))],
                [decode(s) for s in sim.reads1])
    write_fasta(wd / "reads_2.fa",
                [f"r{i}" for i in range(len(sim.reads2))],
                [decode(s) for s in sim.reads2])
    contigs = sim.contigs
    if name == "part2":
        half = len(sim.reference) // 2
        contigs = [c for c, (s, e) in zip(sim.contigs, sim.contig_pos)
                   if e < half - 600]
        assert contigs, "part2 workload needs first-part contigs"
    write_fasta(wd / "contigs.fa",
                [f"c{i}" for i in range(len(contigs))],
                [decode(s) for s in contigs])


def _run_reference(wd, ref_args, timeout=1200):
    env = dict(os.environ)
    env["PATH"] = SHIMS + os.pathsep + env.get("PATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [REF_BIN,
         "--read1", "reads_1.fa", "--read2", "reads_2.fa",
         "--contig", "contigs.fa", "--genome", "genome.fa",
         "--distanceLow", "200", "--distanceHigh", "800",
         "--extendedContig", "ref_extended.fa",
         "--remainingContig", "ref_remaining.fa"] + ref_args,
        cwd=wd, env=env, capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(proc.stdout[-1500:] + proc.stderr[-1500:])
    assert proc.returncode == 0, f"reference binary failed: {proc.stderr}"


def _assert_outputs_match(wd, ref_names=("ref_extended.fa",
                                         "ref_remaining.fa"),
                          our_names=("our_extended.fa",
                                     "our_remaining.fa")):
    for rn, on in zip(ref_names, our_names):
        ref = _fasta_map(wd / rn)
        got = _fasta_map(wd / on)
        assert set(ref.keys()) == set(got.keys()), f"{rn} ids differ"
        for k in ref:
            assert got[k] == ref[k], f"{rn}: sequence {k} differs"


@pytest.mark.parametrize("name,ref_args,overrides,n_chrom",
                         MATRIX, ids=[m[0] for m in MATRIX])
def test_golden_flag_matrix(tmp_path, name, ref_args, overrides, n_chrom):
    """Reference binary (via shims) vs our pipeline under non-default
    flags: final outputs must match id-for-id and base-for-base."""
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.pipeline.driver import run_pipeline

    wd = tmp_path
    _write_matrix_inputs(wd, name, n_chrom)
    _run_reference(wd, ref_args)

    cfg = Config(
        read1=str(wd / "reads_1.fa"), read2=str(wd / "reads_2.fa"),
        contig=str(wd / "contigs.fa"), genome=str(wd / "genome.fa"),
        distance_low=200, distance_high=800,
        extended_contig=str(wd / "our_extended.fa"),
        remaining_contig=str(wd / "our_remaining.fa"),
        work_dir=str(wd / "our_tmp"), **overrides)
    run_pipeline(cfg)

    _assert_outputs_match(wd)
    if name == "misassemblyRemoval":
        # the post-pass writes corrected_<file> next to each output
        _assert_outputs_match(
            wd,
            ref_names=("corrected_ref_extended.fa",
                       "corrected_ref_remaining.fa"),
            our_names=("corrected_our_extended.fa",
                       "corrected_our_remaining.fa"))


def test_golden_ecoli_scale(tmp_path):
    """One >=1 Mb golden run (E. coli-class config 1 shape): reference
    binary via shims vs our pipeline, byte-for-byte outputs.  Depth ~7x
    with --coverage 6 keeps the read layer live without needing 100k+
    pairs on the CPU shim path."""
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.pipeline.driver import run_pipeline

    wd = tmp_path
    sim = make_simdata(seed=31, genome_len=1_000_000, n_pairs=35_000,
                       read_len=100, insert=500, snp_rate=0.01,
                       n_contigs=120)
    write_fasta(wd / "genome.fa", ["chr0"], [decode(sim.reference)])
    write_fasta(wd / "reads_1.fa",
                [f"r{i}" for i in range(len(sim.reads1))],
                [decode(s) for s in sim.reads1])
    write_fasta(wd / "reads_2.fa",
                [f"r{i}" for i in range(len(sim.reads2))],
                [decode(s) for s in sim.reads2])
    write_fasta(wd / "contigs.fa",
                [f"c{i}" for i in range(len(sim.contigs))],
                [decode(s) for s in sim.contigs])
    _run_reference(wd, ["--coverage", "6"], timeout=2400)

    cfg = Config(
        read1=str(wd / "reads_1.fa"), read2=str(wd / "reads_2.fa"),
        contig=str(wd / "contigs.fa"), genome=str(wd / "genome.fa"),
        distance_low=200, distance_high=800, coverage=6,
        extended_contig=str(wd / "our_extended.fa"),
        remaining_contig=str(wd / "our_remaining.fa"),
        work_dir=str(wd / "our_tmp"))
    run_pipeline(cfg)
    _assert_outputs_match(wd)


def test_golden_resume(tmp_path):
    """--resume golden parity: our pipeline, interrupted after the
    alignment checkpoint and resumed with --resume as the only logical
    flag, must still byte-match the reference binary's single run."""
    from aligngraph_tpu.config import Config
    from aligngraph_tpu.pipeline.checkpoint import Checkpoint
    from aligngraph_tpu.pipeline.driver import run_pipeline

    wd = tmp_path
    _write_matrix_inputs(wd, "resume", 1)
    _run_reference(wd, [])

    cfg = Config(
        read1=str(wd / "reads_1.fa"), read2=str(wd / "reads_2.fa"),
        contig=str(wd / "contigs.fa"), genome=str(wd / "genome.fa"),
        distance_low=200, distance_high=800,
        extended_contig=str(wd / "our_extended.fa"),
        remaining_contig=str(wd / "our_remaining.fa"),
        work_dir=str(wd / "our_tmp"))
    ckpt = Checkpoint(cfg.work_dir)
    run_pipeline(cfg, checkpoint=ckpt)
    assert ckpt.get() >= 0
    # wipe the outputs, resume from the saved state only
    os.remove(wd / "our_extended.fa")
    os.remove(wd / "our_remaining.fa")
    cfg2 = Config(resume=True, work_dir=str(wd / "our_tmp"))
    run_pipeline(cfg2)
    _assert_outputs_match(wd)

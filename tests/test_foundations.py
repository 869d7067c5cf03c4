"""Unit tests for config, FASTA I/O, and input formalization (C1-C4)."""

import io

import numpy as np
import pytest

from aligngraph_tpu.config import Config, ConfigError, LARGE_CHUNK
from aligngraph_tpu.io.fasta import (
    decode, encode, fasta_bytes, read_fasta, revcomp, write_fasta,
)
from aligngraph_tpu.io.formalize import (
    _chunk_boundaries, formalize_contigs, formalize_genome, formalize_reads,
)


# ---------------- config (C1) ----------------

def test_config_parse_roundtrip():
    argv = ["--read1", "r1.fa", "--read2", "r2.fa", "--contig", "c.fa",
            "--genome", "g.fa", "--distanceLow", "300", "--distanceHigh",
            "700", "--extendedContig", "e.fa", "--remainingContig", "rm.fa",
            "--kMer", "5", "--coverage", "10", "--fastMap"]
    cfg = Config.from_argv(argv)
    assert cfg.distance_low == 300 and cfg.distance_high == 700
    assert cfg.fast_map and not cfg.ratio_check
    cfg.validate(max_read_length=100)
    cfg2 = Config.from_argv(cfg.to_argv())
    assert cfg2 == cfg


def test_config_duplicate_flag_rejected():
    with pytest.raises(ConfigError):
        Config.from_argv(["--kMer", "5", "--kMer", "6"])


def test_config_validation():
    cfg = Config(read1="a", read2="b", contig="c", genome="d",
                 extended_contig="e", remaining_contig="f", part=11)
    with pytest.raises(ConfigError):
        cfg.validate()
    cfg.part = 5
    cfg.validate()
    cfg.distance_low, cfg.distance_high = 10, 5
    with pytest.raises(ConfigError):
        cfg.validate()


def test_config_resume_must_be_alone():
    with pytest.raises(ConfigError):
        Config.from_argv(["--resume", "--kMer", "5"])
    assert Config.from_argv(["--resume"]).resume


def test_config_command_file_roundtrip(tmp_path):
    cfg = Config(read1="r1", read2="r2", contig="c", genome="g",
                 extended_contig="e", remaining_contig="r",
                 distance_low=100, distance_high=900, iterative_map=True)
    p = tmp_path / "command.txt"
    cfg.save_command(str(p))
    assert Config.load_command(str(p)) == cfg


# ---------------- fasta ----------------

def test_encode_decode_roundtrip():
    s = b"ACGTNacgtnXY"
    codes = encode(s)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4, 4]
    assert decode(codes) == b"ACGTNACGTNNN"


def test_revcomp():
    assert decode(revcomp(encode(b"AACGTN"))) == b"NACGTT"


def test_fasta_roundtrip():
    data = b">a desc\nACGT\nACGT\n>b\nTTTT\n"
    ids, seqs = read_fasta(io.BytesIO(data))
    assert ids == ["a desc", "b"]
    assert seqs == [b"ACGTACGT", b"TTTT"]
    out = fasta_bytes(ids, seqs)
    ids2, seqs2 = read_fasta(io.BytesIO(out))
    assert (ids2, seqs2) == (ids, seqs)


def test_fasta_60col_wrap():
    seq = b"A" * 130
    out = fasta_bytes(["x"], [seq])
    lines = out.decode().strip().split("\n")
    assert lines[0] == ">x"
    assert [len(l) for l in lines[1:]] == [60, 60, 10]


# ---------------- formalize reads (C2) ----------------

def test_formalize_reads_truncation_and_interleave():
    r1 = io.BytesIO(b">p0\nACGTACGTAC\n>p1\nAAAA\n")
    r2 = io.BytesIO(b">p0\nTTTTTT\n>p1\nCCCCCC\n")
    reads = formalize_reads(r1, r2)
    assert reads.n_pairs == 2
    # pair 0 truncated to min(10, 6) = 6
    assert list(reads.lengths) == [6, 4]
    assert decode(reads.data[0][:6]) == b"ACGTAC"
    assert decode(reads.data[1][:6]) == b"TTTTTT"
    assert decode(reads.data[2][:4]) == b"AAAA"
    assert decode(reads.data[3][:4]) == b"CCCC"
    assert reads.max_read_length == 6


def test_formalize_reads_inconsistent():
    r1 = io.BytesIO(b">a\nACGT\n>b\nACGT\n")
    r2 = io.BytesIO(b">a\nACGT\n")
    with pytest.raises(Exception):
        formalize_reads(r1, r2)


# ---------------- formalize contigs (C3) ----------------

def test_formalize_contigs_chaff_cut():
    small = b"A" * 200       # == 200 -> chaff (strict >200 keeps)
    big = b"C" * 201
    data = fasta_bytes(["s", "b"], [small, big])
    c = formalize_contigs(io.BytesIO(data))
    assert c.ids == ["b"]
    assert c.chaff_ids == ["s"]
    assert c.chaff_seqs == [small]
    assert c.n_chunks == 1 and c.chunk_len[0] == 201


def test_chunk_boundaries_tail_merge():
    # exactly 1Mb -> one chunk
    assert _chunk_boundaries(LARGE_CHUNK) == [(0, LARGE_CHUNK)]
    # 1Mb + 60 -> tail merged into single chunk (ref guard cpp < size-1-60)
    assert _chunk_boundaries(LARGE_CHUNK + 60) == [(0, LARGE_CHUNK + 60)]
    # 1Mb + 61 -> split into 1Mb + 61
    assert _chunk_boundaries(LARGE_CHUNK + 61) == [
        (0, LARGE_CHUNK), (LARGE_CHUNK, 61)]
    # 2.5Mb -> 3 chunks
    assert _chunk_boundaries(2 * LARGE_CHUNK + 500_000) == [
        (0, LARGE_CHUNK), (LARGE_CHUNK, LARGE_CHUNK),
        (2 * LARGE_CHUNK, 500_000)]


def test_formalize_contigs_chunking(tmp_path):
    big = bytes(np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(0).integers(0, 4, LARGE_CHUNK + 1000)])
    data = fasta_bytes(["big"], [big])
    c = formalize_contigs(io.BytesIO(data))
    assert c.n_real == 1
    assert c.n_chunks == 2
    assert list(c.chunk_real) == [0, 0]
    assert list(c.chunk_start) == [0, LARGE_CHUNK]
    assert list(c.chunk_len) == [LARGE_CHUNK, 1000]
    np.testing.assert_array_equal(
        np.concatenate([c.chunk_seq(0), c.chunk_seq(1)]), c.seqs[0])


# ---------------- formalize genome (C4) ----------------

def test_formalize_genome_single_part():
    data = fasta_bytes(["chr1", "chr2"], [b"ACGT" * 25, b"TTTT" * 10])
    g = formalize_genome(io.BytesIO(data), part=1)
    assert g.ids == ["chr1", "chr2"]
    assert g.n_parts == 2
    assert list(g.part_len) == [100, 40]
    assert g.total_len == 140
    assert decode(g.part_seq(0)) == b"ACGT" * 25


def test_formalize_genome_parts():
    data = fasta_bytes(["chr1"], [b"A" * 103])
    g = formalize_genome(io.BytesIO(data), part=4)
    # floor(103/4)=25 -> parts 25,25,25,28
    assert list(g.part_len) == [25, 25, 25, 28]
    assert list(g.part_start) == [0, 25, 50, 75]
    assert g.n_parts == 4


def test_formalize_genome_part_larger_than_len():
    # degenerate: part > len -> step 0, single part (no infinite loop)
    data = fasta_bytes(["c"], [b"ACG"])
    g = formalize_genome(io.BytesIO(data), part=10)
    assert g.n_parts == 1
    assert int(g.part_len.sum()) == 3
def test_memmap_reads_equal(tmp_path):
    import numpy as np
    from aligngraph_tpu.io.formalize import formalize_reads
    from aligngraph_tpu.io.fasta import write_fasta, decode
    rng = np.random.default_rng(4)
    seqs1 = [rng.integers(0, 4, rng.integers(60, 100)).astype(np.int8)
             for _ in range(40)]
    seqs2 = [rng.integers(0, 4, rng.integers(60, 100)).astype(np.int8)
             for _ in range(40)]
    write_fasta(tmp_path / "r1.fa", [f"a{i}" for i in range(40)],
                [decode(s) for s in seqs1])
    write_fasta(tmp_path / "r2.fa", [f"b{i}" for i in range(40)],
                [decode(s) for s in seqs2])
    a = formalize_reads(tmp_path / "r1.fa", tmp_path / "r2.fa")
    b = formalize_reads(tmp_path / "r1.fa", tmp_path / "r2.fa",
                        memmap_path=tmp_path / "mm.npy")
    assert isinstance(b.data, np.memmap)
    np.testing.assert_array_equal(np.asarray(b.data), a.data)
    np.testing.assert_array_equal(b.lengths, a.lengths)
    assert b.n_pairs == a.n_pairs and b.max_len == a.max_len


@pytest.mark.parametrize("env_dir", [None, "custom_cache"],
                         ids=["unset", "env"])
def test_compile_cache_location(tmp_path, env_dir):
    """The compile cache goes where JAX_COMPILATION_CACHE_DIR says, else to
    <checkout>/.jax_cache; the package sets it nowhere else."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = root
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import aligngraph_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300, check=True)
    want = (os.path.join(root, ".jax_cache") if env_dir is None
            else str(tmp_path / env_dir))
    assert out.stdout.strip().splitlines()[-1] == want

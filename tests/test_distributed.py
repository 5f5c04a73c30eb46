"""2-process distributed search (jax.distributed over local CPU
workers): the CLI-launched sharded search across two processes must
produce output identical to a single-process host-engine run.

This is the multi-host configuration of BASELINE.md's scaling points
scaled down to CPU: process 0 is the coordinator, the bins axis spans
the two processes (the fingerprint matrix is split across their
"HBM"), per-bin counts allgather across processes, and only process 0
writes the report.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from taxor_jax.apps.build import BuildConfig, run_build
from taxor_jax.hixf.index import save_index
from taxor_jax.search.pipeline import SearchConfig, run_search

from .util import make_reads, make_ref_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.default_rng(5)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=8,
                                      genome_len=6000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=4,
                       read_len=900, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True,
        layout_mode="flat", layout_file="",
    ))
    idx_file = os.path.join(tmp, "idx.taxor.npz")
    save_index(idx_file, index)
    # single-process host-engine expectation
    expect_tsv = os.path.join(tmp, "expect.tsv")
    run_search(SearchConfig(index_file=idx_file, query_file=reads,
                            report_file=expect_tsv, engine="host"))
    return tmp, idx_file, reads, expect_tsv


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_search_matches(problem):
    tmp, idx_file, reads, expect_tsv = problem
    port = _free_port()
    out_tsv = os.path.join(tmp, "dist.tsv")
    procs = []
    for pid in (0, 1):
        env = dict(os.environ)
        # child processes run on the CPU with 2 virtual devices each, so
        # they stay off any accelerator the host has
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env["JAX_NUM_CPU_DEVICES"] = "2"
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "taxor_jax.cli", "search",
             "--index-file", idx_file, "--query-file", reads,
             "--output-file", out_tsv, "--engine", "sharded",
             "--distributed",
             "--coordinator-address", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--mesh-reads", "2", "--mesh-bins", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    with open(out_tsv) as fh, open(expect_tsv) as eh:
        assert fh.read() == eh.read()

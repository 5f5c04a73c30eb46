"""The native CPU baseline (reference worker loop in C++) must agree with
the host oracle traversal exactly — it is the stand-in for the reference
binary that bench.py measures against, so its correctness is part of the
benchmark's honesty."""

import numpy as np
import pytest

from taxor_jax.apps.build import BuildConfig, run_build
from taxor_jax.hash.schemes import search_hashes
from taxor_jax.native import get_lib
from taxor_jax.native.baseline import baseline_search
from taxor_jax.search.thresholds import Thresholder

from .util import make_reads, make_ref_set

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib unavailable")


@pytest.fixture(scope="module", params=["flat", "auto"])
def built(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bl"))
    rng = np.random.default_rng(7)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=12,
                                      genome_len=12000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=4,
                       read_len=1100, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True,
        layout_mode=request.param,
        tmax=4 if request.param == "auto" else 0,
        layout_file="", threads=2,
    ))
    from taxor_jax.io.fastx import read_all
    seqs = [r.seq for r in read_all(reads)]
    return index, seqs


def _oracle(index, seqs, thresholder):
    hash_lists = search_hashes(seqs, index.scheme)
    best_u, best_c, npass = [], [], []
    for h in hash_lists:
        thr = thresholder.get(h.shape[0], 0.0)
        pairs = (index.hixf.membership(h, thr)
                 if h.shape[0] and thr < (1 << 63) else [])
        if pairs:
            mx = max(c for _, c in pairs)
            bu = next(u for u, c in pairs if c == mx)
            np_ = sum(1 for _, c in pairs if c >= 0.8 * mx)
        else:
            bu, mx, np_ = -1, 0, 0
        best_u.append(bu)
        best_c.append(mx)
        npass.append(np_)
    return (np.array(best_u, dtype=np.int32),
            np.array(best_c, dtype=np.int32),
            np.array(npass, dtype=np.int32))


@pytest.mark.parametrize("threads", [1, 4])
def test_baseline_matches_host_oracle(built, threads):
    index, seqs = built
    th = Thresholder.make(index.scheme.kmer_size, index.scheme.window_size,
                          0.04, -1.0, index.scheme.use_syncmer)
    got_u, got_c, got_n = baseline_search(index.hixf, seqs, index.scheme,
                                          th, threads=threads)
    want_u, want_c, want_n = _oracle(index, seqs, th)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_n, want_n)


def test_baseline_impossible_threshold(built):
    index, seqs = built
    # percentage > 1 is not representable; use an impossible-threshold
    # table by forcing a kmer model at 50% error rate: every threshold
    # wraps to >= 2^63 and no read may classify
    th = Thresholder(kmer_size=index.scheme.kmer_size, error_rate=0.5,
                     kind="kmer_model")
    got_u, got_c, got_n = baseline_search(index.hixf, seqs, index.scheme,
                                          th, threads=2)
    assert (got_u == -1).all() and (got_n == 0).all()

"""End-to-end coverage of the non-default hash schemes: plain k-mer
(window == k), true minimizers (window > k), and FracMinHash scaling."""

import os

import numpy as np
import pytest

from taxor_jax.apps.build import BuildConfig, run_build
from taxor_jax.search.pipeline import SearchConfig, run_search

from .util import make_reads, make_ref_set


@pytest.fixture(scope="module")
def ref_set(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("schemes"))
    rng = np.random.default_rng(77)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=5,
                                      genome_len=12000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=3,
                       read_len=1000, error_rate=0.02)
    return tmp, tsv, gdir, genomes, reads


def _accuracy(report):
    rows = [l.split("\t") for l in open(report).read().splitlines()[1:]]
    hits = [r for r in rows if r[1] != "-"]
    if not hits:
        return 0.0, 0
    correct = sum(1 for r in hits if r[1] == r[0].split("_", 1)[1])
    return correct / len(hits), len(hits)


def _build_and_search(tmp, tsv, gdir, reads, name, **kw):
    out = os.path.join(tmp, f"{name}.npz")
    search_kw = kw.pop("search", {})
    run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename=out,
        layout_mode="flat", layout_file="", **kw,
    ))
    report = os.path.join(tmp, f"{name}.tsv")
    run_search(SearchConfig(index_file=out, query_file=reads,
                            report_file=report, engine="host",
                            **search_kw))
    return report


class TestPlainKmer:
    def test_kmer_model_threshold(self, ref_set):
        tmp, tsv, gdir, genomes, reads = ref_set
        # window == k: plain canonical k-mers + kmer CI threshold model
        report = _build_and_search(tmp, tsv, gdir, reads, "kmer",
                                   kmer_size=18, use_syncmer=False,
                                   search={"error_rate": 0.04})
        acc, n = _accuracy(report)
        assert n >= 10
        assert acc > 0.9


class TestMinimizer:
    def test_window_minimizers(self, ref_set):
        tmp, tsv, gdir, genomes, reads = ref_set
        # hidden --window-size flag: w > k engages the minimizer scheme
        # and the fracminhash threshold model
        report = _build_and_search(tmp, tsv, gdir, reads, "minim",
                                   kmer_size=18, window_size=24,
                                   use_syncmer=False,
                                   search={"percentage": 0.3})
        acc, n = _accuracy(report)
        assert n >= 10
        assert acc > 0.9


class TestScaling:
    def test_fracminhash_scaling(self, ref_set):
        tmp, tsv, gdir, genomes, reads = ref_set
        report = _build_and_search(tmp, tsv, gdir, reads, "scaled",
                                   kmer_size=16, syncmer_size=8,
                                   use_syncmer=True, scaling=10,
                                   search={"percentage": 0.2})
        acc, n = _accuracy(report)
        assert n >= 8
        assert acc > 0.85

    def test_scaling_shrinks_hash_counts(self, ref_set):
        tmp, tsv, gdir, genomes, reads = ref_set
        full = _build_and_search(tmp, tsv, gdir, reads, "full16",
                                 kmer_size=16, syncmer_size=8,
                                 use_syncmer=True,
                                 search={"percentage": 0.2})
        scaled = os.path.join(tmp, "scaled.tsv")
        rows_f = [l.split("\t") for l in open(full).read().splitlines()[1:]]
        rows_s = [l.split("\t") for l in open(scaled).read().splitlines()[1:]]
        hc_f = np.mean([int(r[6]) for r in rows_f if r[1] != "-"])
        hc_s = np.mean([int(r[6]) for r in rows_s if r[1] != "-"])
        # scaling 10 keeps ~10% of hashes
        assert hc_s < 0.25 * hc_f


class TestDeviceScaling:
    def test_scaling_threshold_is_exact_integer_form(self):
        """v <= T (integer) must equal double(v) <= double(UINT64_MAX)/s
        for every v — the reference's comparison (taxor_search.cpp:229)."""
        from taxor_jax.hash.schemes import scaling_threshold_u64

        rng = np.random.default_rng(3)
        for s in (2, 3, 7, 100, 1000):
            T = scaling_threshold_u64(s)
            limit = np.float64(np.uint64(2**64 - 1)) / np.float64(s)
            vs = np.concatenate([
                rng.integers(0, 2**63, 2000, dtype=np.uint64) * 2 + 1,
                np.array([T - 1, T, min(T + 1, 2**64 - 1)],
                         dtype=np.uint64),
            ])
            want = vs.astype(np.float64) <= limit
            got = vs <= np.uint64(T)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("use_syncmer", [True, False])
    def test_scaled_fused_matches_host(self, tmp_path, use_syncmer):
        """Device FracMinHash downsampling must reproduce the host
        engine's emissions exactly (flat fused path)."""
        import os

        from taxor_jax.apps.build import BuildConfig, run_build
        from taxor_jax.device.hixf_search import DeviceHIXF
        from taxor_jax.hash import device_syncmer as dsync
        from taxor_jax.io.fastx import read_all
        from taxor_jax.hash.schemes import search_hashes
        from taxor_jax.search.pipeline import (_pairs_from_e2e,
                                               _read_threshold)
        from taxor_jax.search.thresholds import Thresholder

        from .util import make_reads, make_ref_set

        tmp = str(tmp_path)
        rng = np.random.default_rng(8)
        tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=12,
                                          genome_len=8000)
        reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=4,
                                read_len=1500, error_rate=0.02)
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=18, syncmer_size=8, use_syncmer=use_syncmer,
            window_size=0 if use_syncmer else 24,
            scaling=3, layout_mode="flat", layout_file="",
        ))
        scheme = index.scheme
        assert scheme.scaling == 3
        assert (dsync.supports(scheme) if use_syncmer
                else dsync.supports_minimizer(scheme))
        thresholder = Thresholder.make(scheme.kmer_size,
                                       scheme.window_size, 0.04, -1.0,
                                       scheme.use_syncmer)
        dhixf = DeviceHIXF(index.hixf)
        reads = [r.seq for r in read_all(reads_file)]
        L = dsync.pad_len_bucket(max(len(r) for r in reads))
        packed, lengths = dsync.pack_reads(reads, L)
        vals, users, counts, n_emit, hcap = dhixf.e2e_async(
            packed, lengths, scheme, thresholder)()
        dfs_rank = index.hixf.user_bin_dfs_order()
        pairs, hash_counts = _pairs_from_e2e(
            vals, users, counts, n_emit, reads, index, scheme,
            thresholder, dfs_rank, hcap)
        host_hl = search_hashes(reads, scheme)
        for r, seq in enumerate(reads):
            hl = host_hl[r]
            assert hash_counts[r] == hl.shape[0], r
            thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                                  scheme.kmer_size)
            expect = index.hixf.membership(hl, thr)

            def final(prs):
                if not prs:
                    return []
                mx = max(c for _, c in prs)
                return sorted((u, c) for u, c in prs
                              if not float(c) < float(mx) * 0.8)

            assert final(pairs[r]) == final(expect), r

"""HLL sketch + hierarchical binning DP + hierarchical end-to-end build."""

import os

import numpy as np
import pytest

from taxor_jax.hixf.binning import (
    _dp_layout,
    _Bin,
    compute_layout_from_hashes,
    make_sketch,
    next_multiple_of_64,
)
from taxor_jax.hixf.hll import HyperLogLog, union_estimate


class TestHLL:
    @pytest.mark.parametrize("n", [100, 5000, 200000])
    def test_estimate_accuracy(self, n):
        rng = np.random.default_rng(n)
        sk = HyperLogLog(12)
        sk.add_many(rng.integers(0, 2**64, n, dtype=np.uint64))
        est = sk.estimate()
        assert abs(est - n) / n < 0.1

    def test_duplicates_ignored(self):
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 2**64, 1000, dtype=np.uint64)
        a = HyperLogLog(12)
        a.add_many(vals)
        b = HyperLogLog(12)
        b.add_many(np.concatenate([vals, vals, vals]))
        assert a.estimate() == b.estimate()

    def test_union(self):
        rng = np.random.default_rng(1)
        x = rng.integers(0, 2**64, 5000, dtype=np.uint64)
        y = rng.integers(0, 2**64, 5000, dtype=np.uint64)
        a = HyperLogLog(12)
        a.add_many(x)
        b = HyperLogLog(12)
        b.add_many(y)
        u = union_estimate(a, b)
        assert abs(u - 10000) / 10000 < 0.1


def _mk_bins(rng, counts):
    bins = []
    for i, c in enumerate(counts):
        h = rng.integers(0, 2**64, c, dtype=np.uint64)
        bins.append(_Bin([f"f{i}"], float(c), make_sketch(h)))
    return bins


class TestDP:
    def test_few_bins_fit_without_merging(self):
        rng = np.random.default_rng(0)
        bins = _mk_bins(rng, [1000] * 8)
        max_size, placements = _dp_layout(bins, 64)
        # plenty of bins: every user bin can split; no merges required
        kinds = {p[0] for p in placements}
        merged_multi = [p for p in placements
                       if p[0] == "merge" and p[1] != p[2]]
        assert not merged_multi
        assert max_size <= 1100

    def test_merging_forced(self):
        rng = np.random.default_rng(1)
        bins = _mk_bins(rng, [500] * 40)
        max_size, placements = _dp_layout(bins, 8)
        # 40 bins into 8 technical bins: merging must happen
        merged_multi = [p for p in placements
                       if p[0] == "merge" and p[1] != p[2]]
        assert merged_multi

    def test_big_bin_splits(self):
        rng = np.random.default_rng(2)
        bins = _mk_bins(rng, [50000] + [100] * 4)
        max_size, placements = _dp_layout(bins, 64)
        split = [p for p in placements if p[0] == "split" and p[3] > 1]
        assert split  # the giant bin is split across technical bins
        assert max_size < 50000

    def test_placements_cover_all_bins(self):
        rng = np.random.default_rng(3)
        bins = _mk_bins(rng, list(rng.integers(50, 5000, 30)))
        _, placements = _dp_layout(bins, 16)
        covered = []
        for p in placements:
            if p[0] == "split":
                covered.append(p[1])
            else:
                covered.extend(range(p[1], p[2] + 1))
        assert sorted(covered) == list(range(30))


class TestNativeDP:
    """The C++ layout kernels (native/layout_dp.cpp) against the numpy
    oracle: same band in, identical placements out."""

    def _bins(self, rng, n):
        counts = rng.integers(100, 20000, n)
        return _mk_bins(rng, list(counts))

    @pytest.mark.parametrize("n,tmax", [(30, 16), (100, 64), (257, 64),
                                        (64, 256)])
    def test_dp_matches_numpy_oracle(self, n, tmax):
        from taxor_jax.hixf.binning import (_dp_layout_native,
                                            _dp_layout_numpy,
                                            _union_band, MAX_MERGE)
        from taxor_jax.native import get_lib

        lib = get_lib()
        if lib is None or not hasattr(lib, "layout_dp"):
            pytest.skip("native lib unavailable")
        rng = np.random.default_rng(n * 31 + tmax)
        bins = self._bins(rng, n)
        W = min(MAX_MERGE, n)
        ubT = _union_band(bins, W)
        counts = np.array([b.count for b in bins])
        ms_n, pl_n = _dp_layout_numpy(counts, ubT, tmax)
        ms_c, pl_c = _dp_layout_native(lib, counts, ubT, tmax)
        assert ms_c == ms_n
        assert pl_c == pl_n

    def test_band_matches_numpy(self):
        from taxor_jax.hixf import binning as B
        from taxor_jax.native import get_lib

        if get_lib() is None:
            pytest.skip("native lib unavailable")
        rng = np.random.default_rng(7)
        bins = self._bins(rng, 40)
        native = B._union_band(bins, 32)
        # numpy fallback path
        P = B._POW2[np.stack([b.sketch.registers for b in bins])]
        ref = np.full((40, 32), np.inf)
        for j in range(40):
            acc = P[j].copy()
            prev = max(bins[j].count, B._est_from_pow(acc, P.shape[1]))
            ref[j, 0] = prev
            for d in range(1, min(31, j) + 1):
                np.minimum(acc, P[j - d], out=acc)
                e = max(prev, B._est_from_pow(acc, P.shape[1]))
                ref[j, d] = e
                prev = e
        assert np.allclose(native, ref, rtol=1e-9)
        # band is monotone along d where finite
        fin = np.isfinite(native)
        for j in range(40):
            row = native[j][fin[j]]
            assert (np.diff(row) >= 0).all()

    def test_rearrange_matches_numpy(self, monkeypatch):
        from taxor_jax.hixf import binning as B
        from taxor_jax.native import get_lib

        if get_lib() is None or not hasattr(get_lib(), "rearrange_chain"):
            pytest.skip("native lib unavailable")
        rng = np.random.default_rng(11)
        # overlapping hash sets so similarities are non-trivial
        pool = rng.integers(0, 2**64, 40000, dtype=np.uint64)
        bins = []
        for i in range(60):
            take = rng.choice(pool.shape[0], rng.integers(500, 4000),
                              replace=False)
            h = pool[take]
            bins.append(_Bin([f"f{i}"], float(h.shape[0]),
                             make_sketch(h)))
        native_order = [b.filenames[0]
                        for b in B.rearrange_bins(list(bins))]
        monkeypatch.setattr(B, "get_lib", lambda: None, raising=False)
        import taxor_jax.native as N

        monkeypatch.setattr(N, "get_lib", lambda: None)
        numpy_order = [b.filenames[0]
                       for b in B.rearrange_bins(list(bins))]
        assert native_order == numpy_order


class TestComputeLayout:
    def test_hierarchical_layout(self):
        rng = np.random.default_rng(4)
        file_hashes = {}
        clusters = {}
        for i in range(150):
            f = f"g{i}.fna"
            file_hashes[f] = rng.integers(0, 2**64,
                                          int(rng.integers(200, 2000)),
                                          dtype=np.uint64)
            clusters[f"ACC_{i:04d}"] = [f]
        node = compute_layout_from_hashes(file_hashes, clusters, tmax=64)
        assert node.num_technical_bins <= 64
        # all 150 genomes present in the tree
        assert sorted(node.all_filenames()) == sorted(file_hashes)
        # with 150 bins and tmax 64 there must be merged children
        assert len(node.children) > 0

    def test_next_multiple(self):
        assert next_multiple_of_64(1) == 64
        assert next_multiple_of_64(64) == 64
        assert next_multiple_of_64(65) == 128


class TestHierarchicalEndToEnd:
    def test_build_and_search_hierarchical(self, tmp_path):
        from taxor_jax.apps.build import BuildConfig, run_build
        from taxor_jax.search.pipeline import SearchConfig, run_search

        from .util import make_reads, make_ref_set

        tmp = str(tmp_path)
        rng = np.random.default_rng(99)
        tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                          genome_len=3000)
        reads = make_reads(tmp, rng, genomes, n_reads_per_genome=1,
                           read_len=800, error_rate=0.02)
        out = os.path.join(tmp, "h.taxor.npz")
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename=out,
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="auto", tmax=64,
            layout_file=os.path.join(tmp, "binning.out"),
        ))
        # multi-level index
        assert len(index.hixf.ixfs) > 1

        host = os.path.join(tmp, "host.tsv")
        dev = os.path.join(tmp, "dev.tsv")
        run_search(SearchConfig(index_file=out, query_file=reads,
                                report_file=host, engine="host",
                                percentage=0.4))
        run_search(SearchConfig(index_file=out, query_file=reads,
                                report_file=dev, engine="device",
                                percentage=0.4))
        assert open(host).read() == open(dev).read()

        rows = [l.split("\t") for l in open(dev).read().splitlines()[1:]]
        hits = [r for r in rows if r[1] != "-"]
        correct = sum(1 for r in hits if r[1] == r[0].split("_", 1)[1])
        assert len(hits) >= 60
        assert correct / len(hits) > 0.9


def test_layout_invariance_of_classification(tmp_path):
    """Scaled-down DIVERGENCES.md #6 waiver experiment: radically
    different layouts of the same reference set must agree on the top
    accession for (nearly) every read — differences are bounded by the
    filter's intrinsic false-positive noise."""
    import os
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.layout_invariance import classify_rows

    from taxor_jax.apps.build import BuildConfig, run_build

    from .util import make_reads, make_ref_set

    tmp = str(tmp_path)
    rng = np.random.default_rng(123)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=40,
                                      genome_len=2500)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=3,
                       read_len=800, error_rate=0.03)
    results = {}
    for name, mode, tmax in (("flat", "flat", 0), ("t64", "auto", 64)):
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode=mode, tmax=tmax,
            layout_file=os.path.join(tmp, f"{name}.out")))
        results[name] = classify_rows(index, reads)
    base, other = results["flat"], results["t64"]
    agree = 0
    for r in base:
        a = max(base[r], key=lambda t: t[1], default=None)
        b = max(other[r], key=lambda t: t[1], default=None)
        agree += (a is None) == (b is None) and (a is None or a[0] == b[0])
    assert agree >= 0.97 * len(base), f"{agree}/{len(base)}"

"""Hierarchical fused device search step (make_hixf_e2e_grouped_fn) vs the host
oracle on a multi-level HIXF."""

import os

import numpy as np
import pytest

from taxor_jax.apps.build import BuildConfig, run_build
from taxor_jax.device.hixf_search import DeviceHIXF
from taxor_jax.hash import device_syncmer as dsync
from taxor_jax.hash.schemes import search_hashes
from taxor_jax.search.pipeline import _pairs_from_e2e, _read_threshold
from taxor_jax.search.thresholds import Thresholder

from .util import make_reads, make_ref_set


@pytest.fixture(scope="module")
def hier_setup(tmp_path_factory):
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp("hier_dev"))
    rng = np.random.default_rng(21)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                            read_len=800, error_rate=0.02)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True,
        layout_mode="auto", tmax=64,
        layout_file=os.path.join(tmp, "b.out"),
    ))
    assert len(index.hixf.ixfs) > 1  # genuinely hierarchical
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


@pytest.mark.parametrize("percentage", [-1.0, 0.3])
def test_hier_fused_matches_host(hier_setup, percentage):
    index, reads = hier_setup
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, percentage, scheme.use_syncmer)
    dhixf = DeviceHIXF(index.hixf)
    assert dhixf.e2e_capable(thresholder)
    assert len(dhixf.ixfs) > 1

    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    vals, users, counts, n_emit, hcap = dhixf.e2e_async(
        packed, lengths, scheme, thresholder)()
    dfs_rank = index.hixf.user_bin_dfs_order()
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap
    )
    def final_rows(prs):
        """The reference's emission after the 0.8*max filter
        (taxor_search.cpp:285) — the product-visible result."""
        if not prs:
            return []
        mx = max(c for _, c in prs)
        return sorted((u, c) for u, c in prs
                      if not float(c) < float(mx) * 0.8)

    host_hl = search_hashes(reads, scheme)
    n_hits = 0
    for r, seq in enumerate(reads):
        hl = host_hl[r]
        assert hash_counts[r] == hl.shape[0]
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        expect = index.hixf.membership(hl, thr)
        got = final_rows(pairs[r])
        want = final_rows(expect)
        assert got == want, f"read {r}: {got} vs {want}"
        n_hits += bool(expect)
    assert n_hits >= len(reads) // 2


def test_thr_table_matches_host(hier_setup):
    index, _ = hier_setup
    scheme = index.scheme
    for pct in (-1.0, 0.25, 1.0):
        th = Thresholder.make(scheme.kmer_size, scheme.window_size,
                              0.04, pct, scheme.use_syncmer)
        dhixf = DeviceHIXF(index.hixf)
        tbl = dhixf._thr_table(th, 512)
        for c in (0, 1, 7, 100, 511, 512):
            assert tbl[c] == min(th.get(c, 0.0), 2**31 - 1)


@pytest.fixture(scope="module", params=[1, 3])
def hier_fracminhash_setup(request, tmp_path_factory):
    """Multi-level HIXF under the minimizer scheme (window > k), whose
    default threshold model is fracminhash — length-dependent, so the
    fused descent runs in descend-all chain-min mode
    (e2e.make_hixf_e2e_grouped_fn docstring).  params: scaling factor."""
    from taxor_jax.io.fastx import read_all

    scaling = request.param
    tmp = str(tmp_path_factory.mktemp("hier_fmh"))
    rng = np.random.default_rng(55)
    # the tmax sweep's smallest candidate is 64 technical bins, so a
    # genuinely hierarchical layout needs > 64 user bins
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=3000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                            read_len=800, error_rate=0.02)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, window_size=22, use_syncmer=False,
        scaling=scaling, layout_mode="auto", tmax=64,
        layout_file=os.path.join(tmp, "fmh.out"),
    ))
    assert len(index.hixf.ixfs) > 1
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_hier_fracminhash_descend_all_matches_host(hier_fracminhash_setup):
    """VERDICT r3 item 5: scaled / length-dependent-threshold searches on
    hierarchical trees must dispatch fused (no silent synchronous
    fallback) and reproduce the host oracle exactly."""
    index, reads = hier_fracminhash_setup
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    assert thresholder.kind == "fracminhash"
    dhixf = DeviceHIXF(index.hixf)
    assert dhixf.e2e_capable(thresholder)
    assert len(dhixf.ixfs) > 1

    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    res = dhixf.e2e_async(packed, lengths, scheme, thresholder, k=16)()
    assert len(res) == 6  # chain-min mode: (..., hcap, leaf sums)
    vals, users, counts, n_emit, hcap, sums = res
    dfs_rank = index.hixf.user_bin_dfs_order()
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap, sums=sums)

    def final(prs):
        if not prs:
            return []
        mx = max(c for _, c in prs)
        return sorted((u, c) for u, c in prs
                      if not float(c) < float(mx) * 0.8)

    host_hl = search_hashes(reads, scheme)
    n_hits = 0
    for r, seq in enumerate(reads):
        hl = host_hl[r]
        assert hash_counts[r] == hl.shape[0], r
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        expect = index.hixf.membership(hl, thr)
        assert final(pairs[r]) == final(expect), r
        n_hits += bool(expect)
    # scaling=3 on 800 b reads leaves few hashes vs the CI threshold —
    # classification is sparse by design; the parity loop above is the
    # test, the floor only guards against a degenerate all-empty run
    assert n_hits >= (10 if scheme.scaling > 1 else len(reads) // 2)


@pytest.fixture(scope="module", params=[(20, 20), (18, 26)])
def kmer_setup(request, tmp_path_factory):
    """Plain-k-mer (window == k, the reference default scheme) and
    windowed-minimizer indexes."""
    from taxor_jax.io.fastx import read_all

    k, window = request.param
    tmp = str(tmp_path_factory.mktemp("kmer_dev"))
    rng = np.random.default_rng(33)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=30,
                                      genome_len=3000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=3,
                            read_len=700, error_rate=0.02)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=k, window_size=window, use_syncmer=False,
        layout_mode="flat", layout_file="",
    ))
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_minimizer_fused_matches_host(kmer_setup):
    """The minimizer/plain-k-mer device extraction feeding the flat fused
    step must reproduce the host engine's final emissions exactly."""
    index, reads = kmer_setup
    scheme = index.scheme
    assert dsync.supports_minimizer(scheme)
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    dhixf = DeviceHIXF(index.hixf)
    assert dhixf.e2e_capable(thresholder)

    L = dsync.pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = dsync.pack_reads(reads, L)
    vals, users, counts, n_emit, hcap = dhixf.e2e_async(
        packed, lengths, scheme, thresholder)()
    dfs_rank = index.hixf.user_bin_dfs_order()
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap)

    host_hl = search_hashes(reads, scheme)
    n_hits = 0
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
        n_hits += bool(expect)
    assert n_hits >= len(reads) // 2


def _final(prs):
    """The reference's emission after the 0.8*max filter."""
    if not prs:
        return []
    mx = max(c for _, c in prs)
    return sorted((u, c) for u, c in prs if not float(c) < float(mx) * 0.8)


def _check_hashes_route(index, reads, thresholder, mesh_shape):
    """hashes_async (host-extracted hashes through the tree step, on one
    device or a reads x bins mesh) decoded like the pipeline does, vs
    the host oracle."""
    from taxor_jax.device.probe import pack_hash_lists
    from taxor_jax.device.sharding import make_mesh

    scheme = index.scheme
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
    host_hl = search_hashes(reads, scheme)
    H = max(h.shape[0] for h in host_hl)
    batch = pack_hash_lists(host_hl, 1 << (H - 1).bit_length())
    res = dhixf.hashes_async(batch, len(reads), scheme, thresholder)()
    sums = res[5] if len(res) == 6 else None
    vals, users, counts, n_emit, hcap = res[:5]
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        index.hixf.user_bin_dfs_order(), hcap, sums=sums)
    n_hits = 0
    for r, seq in enumerate(reads):
        hl = host_hl[r]
        assert hash_counts[r] == hl.shape[0], r
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        expect = index.hixf.membership(hl, thr)
        assert _final(pairs[r]) == _final(expect), r
        n_hits += bool(expect)
    return n_hits


@pytest.mark.parametrize("mesh_shape", [None, (2, 4)])
@pytest.mark.parametrize("percentage", [-1.0, 0.3])
def test_hier_hashes_route_matches_host(hier_setup, percentage,
                                        mesh_shape):
    """The host-extraction route on a tree (reads beyond the device
    extractor's cap): host hashes descend through the same grouped tree
    step, on one device and bin-sharded over a mesh."""
    index, reads = hier_setup
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, percentage, scheme.use_syncmer)
    reads = reads[:60]
    assert _check_hashes_route(index, reads, thresholder,
                               mesh_shape) >= len(reads) // 2


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_hier_hashes_route_descend_all_matches_host(hier_fracminhash_setup,
                                                    mesh_shape):
    """The host-hash tree step in descend-all chain-min mode
    (fracminhash thresholds), one device and a mesh."""
    index, reads = hier_fracminhash_setup
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    assert thresholder.kind == "fracminhash"
    _check_hashes_route(index, reads[:60], thresholder, mesh_shape)


def test_flat_hashes_route_on_mesh_matches_host(kmer_setup):
    """A flat index over a mesh also takes host-extracted hashes through
    the tree step (one group, every run a leaf)."""
    index, reads = kmer_setup
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    assert len(index.hixf.ixfs) == 1
    assert _check_hashes_route(index, reads[:48], thresholder,
                               (2, 4)) >= 24

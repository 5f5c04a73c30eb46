"""Full fused search step under shard_map (reads x bins mesh) must be
bit-identical to the single-device fused step — the multi-chip
configuration for indexes larger than one card's memory (SURVEY.md §2.3
mapping; BASELINE.md scaling points)."""

import numpy as np
import pytest

from taxor_jax.device.e2e import fused_e2e_step
from taxor_jax.device.probe import LANE, pad_fingerprints
from taxor_jax.device.sharding import make_mesh, sharded_e2e_fn
from taxor_jax.hash.device_syncmer import (
    hash_cap,
    pack_reads,
    pad_len_bucket,
)

from .util import make_reads, make_ref_set


@pytest.fixture(scope="module")
def flat_index(tmp_path_factory):
    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp("sharded_e2e"))
    rng = np.random.default_rng(3)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=8,
                                      genome_len=5000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=8,
                            read_len=800, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True,
        layout_mode="flat", layout_file="",
    ))
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_sharded_e2e_matches_single_device(flat_index):
    import jax
    import jax.numpy as jnp

    index, reads = flat_index
    scheme = index.scheme
    ixf = index.hixf.ixfs[0]
    n_bin_shards, n_read_shards = 4, 2
    mesh = make_mesh(n_read_shards, n_bin_shards)

    # pad bins so the bins axis splits into whole LANE tiles per shard
    fp = pad_fingerprints(ixf.fingerprints, LANE * n_bin_shards)
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1], starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    run_users = users.astype(np.int32)

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    R0 = len(reads)
    Rpad = -R0 % (n_read_shards * n_bin_shards * 16)
    packed = np.pad(packed, ((0, Rpad), (0, 0)))
    lengths = np.pad(lengths, (0, Rpad)).astype(np.int32)
    hcap = hash_cap(L)
    args = (
        jnp.asarray(fp), jnp.asarray(packed), jnp.asarray(lengths),
        jnp.asarray(onehot), jnp.asarray(run_users),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
    )

    expect = np.asarray(fused_e2e_step(
        *args, k=scheme.kmer_size, s=scheme.syncmer_size,
        t=scheme.t_syncmer, hcap=hcap, topk=16,
    ))

    step = sharded_e2e_fn(mesh, k=scheme.kmer_size,
                          s=scheme.syncmer_size, t=scheme.t_syncmer,
                          hcap=hcap, topk=16)
    got = np.asarray(jax.block_until_ready(step(*args)))

    assert got.shape == expect.shape
    assert (got == expect).all()


def test_device_hixf_sharded_dispatch(flat_index):
    """DeviceHIXF.e2e_async with a mesh routes through the shard_map
    step (padding, state caching, collector contract) and agrees with
    the single-device fused step."""
    import jax.numpy as jnp

    from taxor_jax.device.hixf_search import DeviceHIXF

    index, reads = flat_index
    scheme = index.scheme
    mesh = make_mesh(2, 4)
    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
    assert dhixf.e2e_capable()

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    vals, users, counts, n_emit, hcap = dhixf.e2e_async(
        packed, lengths, scheme)()

    # single-device expectation via the fused step directly
    ixf = index.hixf.ixfs[0]
    fp = pad_fingerprints(ixf.fingerprints)
    starts, ends, ub = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1], starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    R0 = len(reads)
    expect = np.asarray(fused_e2e_step(
        jnp.asarray(fp), jnp.asarray(packed),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(onehot), jnp.asarray(ub.astype(np.int32)),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
        k=scheme.kmer_size, s=scheme.syncmer_size, t=scheme.t_syncmer,
        hcap=hcap, topk=16,
    ))[:R0]
    assert (vals == expect[:, :16]).all()
    assert (users == expect[:, 16:32]).all()
    assert (counts == expect[:, 32]).all()
    assert (n_emit == expect[:, 33]).all()


@pytest.fixture(scope="module")
def hier_index(tmp_path_factory):
    import os

    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp("sharded_hixf"))
    rng = np.random.default_rng(11)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=2500)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=1,
                            read_len=700, error_rate=0.03)
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
def test_sharded_hixf_matches_single_device(hier_index, percentage):
    """Hierarchical bin-sharded fused search (every level's bins sharded
    over the 'bins' axis, descent sums psum'd) must be bit-identical to
    the single-device hierarchical fused step."""
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.search.thresholds import Thresholder

    index, reads = hier_index
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, percentage, scheme.use_syncmer)

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)

    # single-device hierarchical fused step
    ref = DeviceHIXF(index.hixf)
    assert ref.e2e_capable(thresholder)
    e_vals, e_users, e_counts, e_nemit, e_hcap = ref.e2e_async(
        packed, lengths, scheme, thresholder)()

    # bin-sharded over a (2 reads x 4 bins) mesh
    mesh = make_mesh(2, 4)
    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
    assert dhixf.e2e_capable(thresholder)
    vals, users, counts, n_emit, hcap = dhixf.e2e_async(
        packed, lengths, scheme, thresholder)()

    assert hcap == e_hcap
    np.testing.assert_array_equal(counts, e_counts)
    np.testing.assert_array_equal(n_emit, e_nemit)
    np.testing.assert_array_equal(vals, e_vals)
    np.testing.assert_array_equal(users, e_users)


@pytest.fixture(scope="module")
def hier_fmh_index(tmp_path_factory):
    """Hierarchical index under the minimizer scheme with scaling —
    the fracminhash (length-dependent) threshold model, which the fused
    paths serve in descend-all chain-min mode."""
    import os

    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp("sharded_fmh"))
    rng = np.random.default_rng(13)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=100,
                                      genome_len=2500)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=1,
                            read_len=700, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, window_size=22, use_syncmer=False, scaling=2,
        layout_mode="auto", tmax=64,
        layout_file=os.path.join(tmp, "b.out"),
    ))
    assert len(index.hixf.ixfs) > 1
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_sharded_hixf_descend_all_matches_single_device(hier_fmh_index):
    """VERDICT r3 item 5 (sharded half): scaled hierarchical searches
    must dispatch fused under the mesh, bit-equal to the single-device
    chain-min step."""
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.search.thresholds import Thresholder

    index, reads = hier_fmh_index
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    assert thresholder.kind == "fracminhash"

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)

    ref = DeviceHIXF(index.hixf)
    assert ref.e2e_capable(thresholder)
    e_res = ref.e2e_async(packed, lengths, scheme, thresholder)()
    assert len(e_res) == 6  # chain-min mode

    mesh = make_mesh(2, 4)
    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
    assert dhixf.e2e_capable(thresholder)
    res = dhixf.e2e_async(packed, lengths, scheme, thresholder)()
    assert len(res) == 6

    for got, want, name in zip(res, e_res,
                               ("minv", "users", "counts", "n_emit",
                                "hcap", "sums")):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)


@pytest.fixture(scope="module", params=["kmer", "scaled"])
def scheme_index(request, tmp_path_factory):
    """Non-default schemes under a mesh: plain k-mers (the reference's
    DEFAULT scheme, taxor_search.cpp:242-259) and FracMinHash-scaled
    syncmers — both must run the fused sharded path bit-identically."""
    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp(f"sharded_{request.param}"))
    rng = np.random.default_rng(5)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=6,
                                      genome_len=4000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=6,
                            read_len=600, error_rate=0.03)
    kw = (dict(use_syncmer=False, kmer_size=18)
          if request.param == "kmer"
          else dict(use_syncmer=True, kmer_size=16, syncmer_size=8,
                    scaling=4))
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        layout_mode="flat", layout_file="", **kw))
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_sharded_e2e_nondefault_schemes(scheme_index):
    """Mesh fused step == single-device fused step for plain k-mers and
    scaled syncmers (VERDICT r2 missing #2)."""
    import jax
    import jax.numpy as jnp

    from taxor_jax.device.e2e import fused_e2e_step
    from taxor_jax.device.hixf_search import _scale_thresh

    index, reads = scheme_index
    scheme = index.scheme
    ixf = index.hixf.ixfs[0]
    n_read_shards, n_bin_shards = 2, 4
    mesh = make_mesh(n_read_shards, n_bin_shards)

    fp = pad_fingerprints(ixf.fingerprints, LANE * n_bin_shards)
    starts, ends, users = index.hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1], starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    run_users = users.astype(np.int32)

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    R0 = len(reads)
    Rpad = -R0 % (n_read_shards * n_bin_shards * 16)
    packed = np.pad(packed, ((0, Rpad), (0, 0)))
    lengths = np.pad(lengths, (0, Rpad)).astype(np.int32)
    hcap = hash_cap(L) if scheme.use_syncmer else L
    scheme_kind = "syncmer" if scheme.use_syncmer else "minimizer"
    args = (
        jnp.asarray(fp), jnp.asarray(packed), jnp.asarray(lengths),
        jnp.asarray(onehot), jnp.asarray(run_users),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
    )
    kw = dict(k=scheme.kmer_size, s=scheme.syncmer_size,
              t=scheme.t_syncmer, hcap=hcap, topk=16,
              scheme_kind=scheme_kind, window=scheme.window_size,
              scale_thresh=_scale_thresh(scheme))
    expect = np.asarray(fused_e2e_step(*args, **kw))
    step = sharded_e2e_fn(mesh, **kw)
    got = np.asarray(jax.block_until_ready(step(*args)))
    assert got.shape == expect.shape
    assert (got == expect).all()


def test_pipeline_uses_fused_path_under_mesh_for_kmers(scheme_index):
    """The CLI pipeline must keep the fused engine for the reference's
    default plain-k-mer scheme under a mesh (was gated to the slow
    synchronous traversal)."""
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.hash import device_syncmer as dsync
    from taxor_jax.search.thresholds import Thresholder

    index, reads = scheme_index
    scheme = index.scheme
    mesh = make_mesh(2, 4)
    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    assert dhixf.e2e_capable(thresholder)
    assert dsync.supports(scheme) or dsync.supports_minimizer(scheme)

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    vals, users, counts, n_emit, hcap = dhixf.e2e_async(
        packed, lengths, scheme, thresholder)()
    assert vals.shape[0] == len(reads)
    # every read comes from a reference genome; most should hit
    assert (vals[:, 0] > 0).mean() > 0.8


@pytest.mark.parametrize("engine,mesh_shape", [("device", None),
                                               ("sharded", (1, 4)),
                                               ("sharded", (2, 2))])
def test_pipeline_host_extraction_route_on_tree(hier_index, tmp_path,
                                                monkeypatch, engine,
                                                mesh_shape):
    """Reads beyond the device extractor's length cap (lowered here to
    512 b) take host extraction and descend through the tree step from
    hashes, next to fused reads in the same batch; the TSV matches the
    host engine byte for byte, on one device and over a mesh."""
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.hash import device_syncmer as dsync
    from taxor_jax.search.pipeline import SearchConfig, search_single

    from .util import write_fasta

    index, reads = hier_index
    q = str(tmp_path / "q.fasta")
    write_fasta(q, [(f"r{i}", seq[:400] if i % 2 else seq)
                    for i, seq in enumerate(reads[:48])])
    monkeypatch.setattr(dsync, "L_CAP", 512)

    def search(eng, dhixf):
        rep = str(tmp_path / f"{eng}.tsv")
        with open(rep, "w") as out:
            t = search_single(index, q, out, SearchConfig(engine=eng),
                              dhixf)
        return open(rep).read(), t.get("routes")

    want, _ = search("host", None)
    mesh = make_mesh(*mesh_shape) if mesh_shape else None
    got, routes = search(engine, DeviceHIXF(index.hixf, mesh=mesh))
    assert routes["host_extraction"] == 24 and routes["fused"] == 24
    assert got == want

"""Fused on-device search step (device/e2e.py) vs the host oracle."""

import numpy as np
import pytest

from taxor_jax.device.e2e import fused_e2e_step
from taxor_jax.device.probe import pad_fingerprints
from taxor_jax.hash.device_syncmer import hash_cap, pack_reads, \
    pad_len_bucket
from taxor_jax.hash.schemes import search_hashes
from taxor_jax.search.pipeline import _pairs_from_e2e, _read_threshold
from taxor_jax.search.thresholds import Thresholder

from .util import make_reads, make_ref_set


@pytest.fixture(scope="module")
def flat_setup(tmp_path_factory):
    import os

    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.io.fastx import read_all

    tmp = str(tmp_path_factory.mktemp("e2e_dev"))
    rng = np.random.default_rng(11)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=8,
                                      genome_len=6000)
    reads_file = make_reads(tmp, rng, genomes, n_reads_per_genome=3,
                            read_len=900, error_rate=0.03)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=16, syncmer_size=8, use_syncmer=True,
        layout_mode="flat", layout_file=os.path.join(tmp, "b.out"),
    ))
    reads = [r.seq for r in read_all(reads_file)]
    return index, reads


def test_fused_step_matches_host_oracle(flat_setup):
    import jax.numpy as jnp

    index, reads = flat_setup
    scheme = index.scheme
    hixf = index.hixf
    ixf = hixf.ixfs[0]
    fp = pad_fingerprints(ixf.fingerprints)
    starts, ends, users = hixf.runs_of_ixf(0)
    n_runs = starts.shape[0]
    onehot = np.zeros((fp.shape[1], n_runs), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    rpad = (-len(reads)) % 16
    packed = np.pad(packed, ((0, rpad), (0, 0)))
    lengths = np.pad(lengths, (0, rpad))
    hcap = hash_cap(L)
    out = np.asarray(fused_e2e_step(
        jnp.asarray(fp),
        jnp.asarray(packed),
        jnp.asarray(lengths),
        jnp.asarray(onehot),
        jnp.asarray(users.astype(np.int32)),
        jnp.uint32(ixf.seed >> 32),
        jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
        k=scheme.kmer_size, s=scheme.syncmer_size, t=scheme.t_syncmer,
        hcap=hcap, topk=16,
    ))[: len(reads)]
    vals, ubs, counts, n_emit = (out[:, :16], out[:, 16:32],
                                 out[:, 32], out[:, 33])

    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    dfs_rank = hixf.user_bin_dfs_order()
    pairs, hash_counts = _pairs_from_e2e(
        vals, ubs, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap
    )

    host_hl = search_hashes(reads, scheme)
    n_hits = 0
    for r, seq in enumerate(reads):
        hl = host_hl[r]
        assert hash_counts[r] == hl.shape[0]
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        expect = hixf.membership(hl, thr)
        assert pairs[r] == expect, f"read {r}"
        n_hits += bool(expect)
    assert n_hits >= len(reads) * 3 // 4  # sanity: most reads classified


def test_hcap_overflow_triggers_host_fallback(flat_setup):
    """If unique hashes exceed the device hash capacity, the decode must
    detect it via the device-reported count and use the host oracle —
    counts computed from a truncated hash set must never be emitted
    (regression: a dispatch/decode hcap mismatch silently undercounted)."""
    import jax.numpy as jnp

    index, reads = flat_setup
    scheme = index.scheme
    hixf = index.hixf
    ixf = hixf.ixfs[0]
    fp = pad_fingerprints(ixf.fingerprints)
    starts, ends, users = hixf.runs_of_ixf(0)
    onehot = np.zeros((fp.shape[1], starts.shape[0]), dtype=np.float32)
    for i, (a, b) in enumerate(zip(starts, ends)):
        onehot[a:b, i] = 1.0
    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    rpad = (-len(reads)) % 16
    packed = np.pad(packed, ((0, rpad), (0, 0)))
    lengths = np.pad(lengths, (0, rpad))
    hcap = 8  # artificially tiny: every read overflows
    out = np.asarray(fused_e2e_step(
        jnp.asarray(fp), jnp.asarray(packed), jnp.asarray(lengths),
        jnp.asarray(onehot), jnp.asarray(users.astype(np.int32)),
        jnp.uint32(ixf.seed >> 32), jnp.uint32(ixf.seed & 0xFFFFFFFF),
        jnp.uint32(ixf.block_length),
        k=scheme.kmer_size, s=scheme.syncmer_size, t=scheme.t_syncmer,
        hcap=hcap, topk=16,
    ))[: len(reads)]
    vals, ubs, counts, n_emit = (out[:, :16], out[:, 16:32],
                                 out[:, 32], out[:, 33])
    assert (n_emit > hcap).all()  # device reports the TRUE emission count

    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    dfs_rank = hixf.user_bin_dfs_order()
    pairs, hash_counts = _pairs_from_e2e(
        vals, ubs, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap
    )
    host_hl = search_hashes(reads, scheme)
    for r, seq in enumerate(reads):
        hl = host_hl[r]
        assert hash_counts[r] == hl.shape[0]
        thr = _read_threshold(thresholder, hl.shape[0], len(seq),
                              scheme.kmer_size)
        assert pairs[r] == hixf.membership(hl, thr)


def test_decode_ignores_batch_padding(flat_setup):
    """The pipeline pads the final chunk to the batch size; the decoder
    must slice device rows down to the real read count (regression: the
    vectorized decode broadcast [Rpad, k] against [R] thresholds)."""
    index, reads = flat_setup
    scheme = index.scheme
    hixf = index.hixf
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)
    dfs_rank = hixf.user_bin_dfs_order()
    R, kk, hcap = len(reads), 16, 512
    pad = 7
    vals = -np.ones((R + pad, kk), dtype=np.int32)
    users = -np.ones((R + pad, kk), dtype=np.int32)
    counts = np.zeros(R + pad, dtype=np.int32)
    n_emit = np.zeros(R + pad, dtype=np.int32)
    pairs, hash_counts = _pairs_from_e2e(
        vals, users, counts, n_emit, reads, index, scheme, thresholder,
        dfs_rank, hcap)
    assert len(pairs) == R and len(hash_counts) == R
    assert all(p == [] for p in pairs)


def test_tie_rescue_on_device():
    """Homopolymer-rich reads produce tied window minima.  The device
    extractor runs the exact stateful tracker, so tied reads need no
    rescue and no host fallback: every read's hash set, unique count and
    emission count must equal the host oracle's."""
    import jax.numpy as jnp

    from taxor_jax.device.e2e import extract_hashes
    from taxor_jax.hash.schemes import HashScheme, search_hashes

    rng = np.random.default_rng(99)
    k, s, t = 22, 12, 5
    L = 1024
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = []
    for i in range(64):
        arr = bases[rng.integers(0, 4, 900)]
        if i % 4 == 0:  # every 4th read is homopolymer-salted
            for _ in range(2):
                off = int(rng.integers(0, 860))
                arr[off : off + 16] = bases[int(rng.integers(0, 4))]
        seqs.append(arr.tobytes())
    packed, lengths = pack_reads(seqs, L)
    hcap = hash_cap(L)
    hi, lo, valid, n_unique, n_emit = extract_hashes(
        jnp.asarray(packed), jnp.asarray(lengths), k, s, t, hcap,
        "syncmer", 0, 0)
    n_emit = np.asarray(n_emit)
    assert (n_emit <= hcap).all()
    scheme = HashScheme(kmer_size=k, syncmer_size=s, t_syncmer=t,
                        use_syncmer=True)
    host = search_hashes(seqs, scheme)
    hi, lo, valid = np.asarray(hi), np.asarray(lo), np.asarray(valid)
    for r in range(len(seqs)):
        want = np.sort(host[r])
        n = want.shape[0]
        assert int(np.asarray(n_unique)[r]) == n, r
        got = (hi[r][valid[r]].astype(np.uint64) << np.uint64(32)) \
            | lo[r][valid[r]].astype(np.uint64)
        # columns are sorted in canonical-k-mer space, not hash space
        np.testing.assert_array_equal(np.sort(got), want,
                                      err_msg=f"read {r}")

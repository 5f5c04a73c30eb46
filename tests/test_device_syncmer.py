"""Device syncmer extractor vs the (parity-tested) host scanner.

The search path uses dna4 codes (N -> A, no resets,
src/main/taxor_search.cpp:181); the device extractor must reproduce the
host scanner's emitted hash SET bit-for-bit on that alphabet."""

import numpy as np
import pytest

from taxor_jax.hash.device_syncmer import (
    dedup_kmers,
    dedup_sorted,
    hash_cap,
    pack_reads,
    pad_len_bucket,
    supports,
    syncmer_emit,
    syncmer_kmers,
)
from taxor_jax.hash.schemes import HashScheme
from taxor_jax.hash.syncmer import syncmer_hashes_batch

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_reads(rng, n, lo, hi, with_n=False):
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        arr = BASES[rng.integers(0, 4, ln)]
        if with_n and ln > 10:
            pos = rng.integers(0, ln, max(1, ln // 50))
            arr = arr.copy()
            arr[pos] = ord("N")
        reads.append(arr.tobytes())
    return reads


def _host_sets(reads, k, s, t):
    from taxor_jax.hash.encode import encode_dna4

    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, dtype=np.uint8)
    lengths = np.zeros(len(reads), dtype=np.int64)
    for i, r in enumerate(reads):
        c = encode_dna4(r)
        codes[i, : c.shape[0]] = c
        lengths[i] = c.shape[0]
    h, v = syncmer_hashes_batch(codes, lengths, k, s, t)
    return [np.unique(h[i][v[i]]) for i in range(len(reads))]


def _device_sets(reads, k, s, t):
    import jax.numpy as jnp

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    h_hi, h_lo, emit = syncmer_emit(
        jnp.asarray(packed), jnp.asarray(lengths), k, s, t
    )
    hcap = hash_cap(L)
    hi, lo, valid, n_unique = dedup_sorted(h_hi, h_lo, emit, hcap)
    hi, lo = np.asarray(hi), np.asarray(lo)
    valid, n_unique = np.asarray(valid), np.asarray(n_unique)
    out = []
    for r in range(len(reads)):
        assert n_unique[r] <= hcap
        h = (hi[r, valid[r]].astype(np.uint64) << np.uint64(32)) | \
            lo[r, valid[r]].astype(np.uint64)
        assert h.shape[0] == n_unique[r]
        out.append(h)
    return out


def _device_sets_kmer_dedup(reads, k, s, t):
    """The production fused-step path: dedup raw k-mers (with the
    min-gap block compaction), hash the compacted slice (device/e2e.py
    order of operations)."""
    import jax.numpy as jnp

    from taxor_jax.hash.device_syncmer import emission_min_gap
    from taxor_jax.utils.u64jnp import wyhash64

    L = pad_len_bucket(max(len(r) for r in reads))
    packed, lengths = pack_reads(reads, L)
    khi, klo, emit = syncmer_kmers(
        jnp.asarray(packed), jnp.asarray(lengths), k, s, t
    )
    hcap = hash_cap(L)
    chi, clo, valid, n_unique, n_emit = dedup_kmers(
        khi, klo, emit, hcap, emission_min_gap(k, s, t))
    hi, lo = wyhash64(chi, clo)
    hi, lo = np.asarray(hi), np.asarray(lo)
    valid = np.asarray(valid)
    n_unique, n_emit = np.asarray(n_unique), np.asarray(n_emit)
    out = []
    for r in range(len(reads)):
        if n_emit[r] > hcap:  # production: host-oracle fallback
            out.append(None)
            continue
        assert n_unique[r] <= n_emit[r]
        h = (hi[r, valid[r]].astype(np.uint64) << np.uint64(32)) | \
            lo[r, valid[r]].astype(np.uint64)
        assert h.shape[0] == n_unique[r]
        out.append(np.sort(h))
    return out


@pytest.mark.parametrize("k,s", [(16, 8), (22, 12), (30, 14), (20, 4)])
def test_matches_host_scanner(k, s):
    rng = np.random.default_rng(k * 100 + s)
    t = (k - s + 1) // 2
    reads = _random_reads(rng, 24, k - 1, 700)  # incl. too-short reads
    host = _host_sets(reads, k, s, t)
    dev = _device_sets(reads, k, s, t)
    for r, (a, b) in enumerate(zip(host, dev)):
        assert a.shape == b.shape, f"read {r}: {a.shape} vs {b.shape}"
        assert (a == b).all(), f"read {r}"
    dev2 = _device_sets_kmer_dedup(reads, k, s, t)
    for r, (a, b) in enumerate(zip(host, dev2)):
        assert b is not None, f"read {r}: unexpected overflow fallback"
        assert a.shape == b.shape, f"read {r}: {a.shape} vs {b.shape}"
        assert (a == b).all(), f"read {r}"


def test_n_bases_become_a():
    rng = np.random.default_rng(5)
    k, s = 16, 8
    t = (k - s + 1) // 2
    reads = _random_reads(rng, 8, 100, 400, with_n=True)
    host = _host_sets(reads, k, s, t)  # dna4: N -> A before scanning
    dev = _device_sets(reads, k, s, t)
    for a, b in zip(host, dev):
        assert (a == b).all()


def test_repeat_heavy_read_dedups():
    k, s = 16, 8
    t = (k - s + 1) // 2
    read = (b"ACGTACGGTTAACCGG" * 40)  # heavy duplication
    host = _host_sets([read], k, s, t)
    dev = _device_sets([read], k, s, t)
    assert (host[0] == dev[0]).all()


def test_supports_gating():
    assert supports(HashScheme.make(22, 12, None, True))
    assert not supports(HashScheme.make(22, 12, None, False))  # kmer path
    assert not supports(HashScheme.make(22, 16, None, True))  # s too big
    # FracMinHash scaling is supported on device (round 2): the double
    # keep-test becomes an exact integer threshold compare
    assert supports(HashScheme.make(22, 12, None, True, scaling=2))


@pytest.mark.parametrize("k,s", [(16, 8), (22, 12), (17, 14), (15, 13)])
def test_min_gap_compaction_adversarial(k, s):
    """The pre-sort block compaction relies on the emission min-gap
    theorem (emission_min_gap): verify the device set still matches the
    host scanner on emission-dense adversarial inputs — homopolymers,
    short-period repeats (the densest emitters), and near-repeats.
    (17,14): w=4, t=2 -> gap bound 2 (tightest compacting case);
    (15,13): w=3, t=1 -> gap 1, compaction disabled, and dense reads
    legitimately overflow hcap into the host fallback (None).  All
    combos satisfy supports() (s <= 15: s-mers must fit uint32)."""
    t = (k - s + 1) // 2
    rng = np.random.default_rng(k + s)
    reads = []
    for period in (1, 2, 3, 5, 7, 11):
        unit = BASES[rng.integers(0, 4, period)].tobytes()
        reads.append((unit * (600 // period + 1))[:600])
    # near-repeats: periodic with sparse random substitutions
    for period in (2, 5):
        unit = BASES[rng.integers(0, 4, period)].tobytes()
        arr = np.frombuffer((unit * (600 // period + 1))[:600],
                            dtype=np.uint8).copy()
        pos = rng.integers(0, 600, 20)
        arr[pos] = BASES[rng.integers(0, 4, 20)]
        reads.append(arr.tobytes())
    # strictly decreasing s-mer chains can't be constructed directly,
    # but descending random blocks stress the 'newer' event path
    reads.extend(_random_reads(rng, 8, 500, 700))
    host = _host_sets(reads, k, s, t)
    dev = _device_sets_kmer_dedup(reads, k, s, t)
    verified = 0
    for r, (a, b) in enumerate(zip(host, dev)):
        if b is None:  # hcap overflow -> host fallback in production
            continue
        assert a.shape == b.shape, f"read {r}: {a.shape} vs {b.shape}"
        assert (a == b).all(), f"read {r}"
        verified += 1
    assert verified >= len(reads) // 2


class TestDeviceMinimizer:
    """Device minimiser/plain-k-mer extraction must reproduce the host
    oracle's emitted value SEQUENCE exactly (duplicates kept, vector
    semantics — taxor_search.cpp:242-259)."""

    @pytest.mark.parametrize("k,window", [(20, 20), (22, 22), (16, 24),
                                          (22, 30), (31, 41)])
    def test_matches_host_oracle(self, k, window):
        import jax

        from taxor_jax.hash.device_syncmer import (minimizer_kmers,
                                                   pack_reads,
                                                   pad_len_bucket)
        from taxor_jax.hash.encode import encode_dna4
        from taxor_jax.hash.minimizer import minimiser_hashes

        rng = np.random.default_rng(17)
        seqs = [
            rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
            for n in (k - 1, k, window, window + 1, 173, 500, 1000)
        ] + [b"A" * 300, b"ACGT" * 100]
        L = pad_len_bucket(max(len(s) for s in seqs))
        packed, lengths = pack_reads(seqs, L)
        vhi, vlo, emit, n_emit = jax.block_until_ready(
            minimizer_kmers(packed, lengths.astype(np.int32), k, window))
        vhi, vlo = np.asarray(vhi), np.asarray(vlo)
        emit, n_emit = np.asarray(emit), np.asarray(n_emit)
        for r, s in enumerate(seqs):
            want = minimiser_hashes(encode_dna4(s), k, window)
            got = (vhi[r][emit[r]].astype(np.uint64) << np.uint64(32)) \
                | vlo[r][emit[r]].astype(np.uint64)
            assert n_emit[r] == want.shape[0], (r, n_emit[r], want.shape)
            np.testing.assert_array_equal(got, want)

"""The device extractor (e2e.extract_hashes: syncmer_kmers, dedup_kmers,
wyhash64) vs the host syncmer oracle (hash/schemes.search_hashes).

The device tracker is the reference's stateful window minimum
(src/hashing/syncmer.cpp:109-146), so every read — tied window minima
included — must give exactly the host hash set, unique count and
emission count, across schemes and the 8-32 kb length buckets.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from taxor_jax.device.e2e import extract_hashes
from taxor_jax.hash import device_syncmer as dsync
from taxor_jax.hash.schemes import HashScheme, search_hashes

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def randseq(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes()


def check(seqs, L, k, s, t):
    """Device == host for every read; returns the device n_emit."""
    hcap = dsync.hash_cap(L)
    packed, lengths = dsync.pack_reads(seqs, L)
    hi, lo, valid, n_unique, n_emit = map(np.asarray, extract_hashes(
        jnp.asarray(packed), jnp.asarray(lengths), k, s, t, hcap,
        "syncmer", 0, 0))
    scheme = HashScheme(kmer_size=k, syncmer_size=s, t_syncmer=t,
                        use_syncmer=True)
    host = search_hashes(seqs, scheme)
    for r, want in enumerate(host):
        assert n_emit[r] <= hcap, r
        assert n_unique[r] == want.shape[0], r
        got = (hi[r][valid[r]].astype(np.uint64) << np.uint64(32)) \
            | lo[r][valid[r]].astype(np.uint64)
        np.testing.assert_array_equal(np.sort(got), np.sort(want),
                                      err_msg=f"read {r}")
    return n_emit


def test_default_scheme_random_reads():
    rng = np.random.default_rng(7)
    L = 512
    seqs = [randseq(rng, int(rng.integers(25, L))) for _ in range(48)]
    seqs += [randseq(rng, L)]  # exactly bucket-length
    check(seqs, L, 22, 12, 6)


@pytest.mark.parametrize("k,s", [(16, 8), (30, 14), (20, 10), (32, 15),
                                 (14, 12)])
def test_other_schemes(k, s):
    rng = np.random.default_rng(k * s)
    t = (k - s + 1 + 1) // 2
    L = 256
    seqs = [randseq(rng, int(rng.integers(20, L))) for _ in range(32)]
    check(seqs, L, k, s, t)


def test_edge_reads():
    rng = np.random.default_rng(5)
    L = 256
    seqs = [b"", randseq(rng, 5), randseq(rng, 21), randseq(rng, 22),
            randseq(rng, 23), b"N" * 200, b"NNAG" * 50]
    n_emit = check(seqs, L, 22, 12, 6)
    # reads shorter than k emit nothing
    assert (n_emit[:3] == 0).all()


def test_homopolymer_ties_exact():
    # a poly-A run makes the all-A s-mer the (tied) window minimum at
    # every offset, including the emission offset t
    rng = np.random.default_rng(8)
    L = 256
    seqs = [b"A" * 60 + randseq(rng, 120), randseq(rng, 80) + b"T" * 40,
            b"C" * 200, (b"AC" * 60) + randseq(rng, 50)]
    check(seqs, L, 22, 12, 6)


@pytest.mark.parametrize("L", [8192, 16384, 32768])
def test_long_read_buckets(L):
    """The 8-32 kb buckets: reads filling the bucket and reads just
    above the next-smaller bucket, with homopolymer salt."""
    rng = np.random.default_rng(L)
    seqs = []
    for n in (L, L // 2 + 1):
        arr = ACGT[rng.integers(0, 4, n)]
        off = int(rng.integers(0, n - 40))
        arr[off : off + 30] = ACGT[0]
        seqs.append(arr.tobytes())
    assert dsync.pad_len_bucket(max(len(x) for x in seqs)) == L
    check(seqs, L, 22, 12, 6)


def test_emission_irrelevant_ties_still_exact():
    # many random reads across two configs: exact even when windows tie
    # at non-emission offsets
    rng = np.random.default_rng(9)
    L = 1024
    seqs = [randseq(rng, int(rng.integers(200, L))) for _ in range(24)]
    check(seqs, L, 22, 12, 6)
    check(seqs, L, 18, 12, 4)

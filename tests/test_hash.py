"""Hash layer: wyhash/murmur primitives, syncmer scanner (oracle vs batch),
minimizer semantics, scaling filter, N-handling quirks."""

import numpy as np
import pytest

from taxor_jax.hash.encode import (
    build_record_seq,
    cut_out_n_stretches,
    encode_dna4,
    encode_dna5,
)
from taxor_jax.hash.minimizer import (
    adjust_seed,
    canonical_kmer_values,
    minimiser_emissions,
    minimiser_hashes,
)
from taxor_jax.hash.schemes import HashScheme, scaling_filter, search_hashes
from taxor_jax.hash.syncmer import (
    syncmer_hash_set,
    syncmer_hashes_batch,
    syncmer_hashes_scalar,
    t_syncmer_default,
)
from taxor_jax.utils.u64np import (
    fingerprint8,
    mix_split,
    mul_hi_lo,
    murmur64,
    probe_positions,
    reduce32,
    rotl64,
    wyhash64,
)


def ref_wyhash(x: int) -> int:
    """Independent big-int model of ankerl wyhash(uint64)."""
    prod = (x % (1 << 64)) * 0x9E3779B97F4A7C15
    return ((prod >> 64) ^ (prod & ((1 << 64) - 1))) % (1 << 64)


def ref_murmur(h: int) -> int:
    m = (1 << 64) - 1
    h &= m
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & m
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & m
    h ^= h >> 33
    return h


class TestU64:
    def test_wyhash_matches_bigint(self):
        keys = [0, 1, 2, 12345, 2**63, 2**64 - 1, 0xDEADBEEFCAFEBABE]
        got = wyhash64(np.array(keys, dtype=np.uint64))
        for k, g in zip(keys, got):
            assert int(g) == ref_wyhash(k)

    def test_murmur_matches_bigint(self):
        keys = [0, 1, 77, 2**64 - 1, 13572355802537770549]
        got = murmur64(np.array(keys, dtype=np.uint64))
        for k, g in zip(keys, got):
            assert int(g) == ref_murmur(k)

    def test_mix_split(self):
        seed = 13572355802537770549
        key = 42
        assert int(mix_split(np.uint64(key), seed)) == ref_murmur(
            (key + seed) % (1 << 64)
        )

    def test_mul_hi_lo(self):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 2**64, 100, dtype=np.uint64)
        b = rng.integers(0, 2**64, 100, dtype=np.uint64)
        hi, lo = mul_hi_lo(a, b)
        for x, y, h, l in zip(a, b, hi, lo):
            p = int(x) * int(y)
            assert int(h) == p >> 64 and int(l) == p % (1 << 64)

    def test_rotl_reduce_positions(self):
        h = np.uint64(0x0123456789ABCDEF)
        assert int(rotl64(h, 21)) == ((int(h) << 21) | (int(h) >> 43)) % (1 << 64)
        bl = 1000
        pos = probe_positions(h, bl)
        assert pos.shape == (3,)
        for i in range(3):
            r = ((int(h) << (21 * i)) | (int(h) >> (64 - 21 * i))) % (1 << 64) if i else int(h)
            expect = ((r & 0xFFFFFFFF) * bl >> 32) + i * bl
            assert int(pos[i]) == expect
        assert int(reduce32(np.uint64(0xFFFFFFFF), 77)) == (0xFFFFFFFF * 77) >> 32

    def test_fingerprint(self):
        h = np.uint64(0x1122334455667788)
        assert int(fingerprint8(h)) == ((0x55667788 ^ 0x11223344) & 0xFF)


class TestEncode:
    def test_dna4_ambiguity_to_a(self):
        codes = encode_dna4(b"ACGTUacgtuNRYX")
        assert list(codes) == [0, 1, 2, 3, 3, 0, 1, 2, 3, 3, 0, 0, 0, 0]

    def test_dna5_keeps_n(self):
        codes = encode_dna5(b"ACGTN x")
        assert list(codes) == [0, 1, 2, 3, 4, 4, 4]

    def test_cutout_quirk_drops_last_base(self):
        assert cut_out_n_stretches(b"ACGT") == b"ACG"
        assert cut_out_n_stretches(b"ACNGT") == b"ACG"  # AC + G(T dropped)
        assert cut_out_n_stretches(b"ACGTN") == b"ACGT"
        assert cut_out_n_stretches(b"NNACGNN") == b"ACG"
        assert build_record_seq(b"ACGT") == b"ACG"


class TestSyncmer:
    @pytest.mark.parametrize("k,s", [(8, 4), (10, 6), (22, 12)])
    def test_batch_matches_scalar(self, k, s):
        t = t_syncmer_default(k, s)
        rng = np.random.default_rng(7)
        seqs = []
        for _ in range(20):
            n = int(rng.integers(k, 400))
            seq = rng.integers(0, 4, n).astype(np.uint8)
            # sprinkle Ns
            nn = rng.integers(0, max(1, n // 20))
            idx = rng.integers(0, n, nn)
            seq[idx] = 4
            seqs.append(seq)
        L = max(s.shape[0] for s in seqs)
        batch = np.full((len(seqs), L), 4, dtype=np.uint8)
        lengths = np.array([x.shape[0] for x in seqs])
        for i, x in enumerate(seqs):
            batch[i, : x.shape[0]] = x
        bh, bv = syncmer_hashes_batch(batch, lengths, k, s, t)
        for i, x in enumerate(seqs):
            expect = syncmer_hashes_scalar(x, k, s, t)
            got = [int(v) for v in bh[i][bv[i]]]
            assert got == expect, f"seq {i} mismatch"

    def test_homopolymer_ties(self):
        # poly-A exercises the tie-breaking paths heavily
        k, s = 8, 4
        t = t_syncmer_default(k, s)
        seq = np.zeros(50, dtype=np.uint8)
        expect = syncmer_hashes_scalar(seq, k, s, t)
        bh, bv = syncmer_hashes_batch(seq[None], np.array([50]), k, s, t)
        assert [int(v) for v in bh[0][bv[0]]] == expect

    def test_revcomp_overlap_with_centered_t(self):
        # The emission offset is t-1 (0-based); selection is strand
        # symmetric only when t-1 == w-1-(t-1).  With w=7, t=4 the offset
        # is centered, so seq and its reverse complement select the same
        # canonical k-mers (up to stateful tie-breaking).
        k, s, t = 10, 4, 4
        rng = np.random.default_rng(3)
        seq = rng.integers(0, 4, 300).astype(np.uint8)
        rc = (3 - seq)[::-1].astype(np.uint8)
        a = set(syncmer_hash_set(seq, k, s, t).tolist())
        b = set(syncmer_hash_set(rc, k, s, t).tolist())
        assert len(a & b) > 0.8 * min(len(a), len(b))

    def test_default_t_selection_is_strand_asymmetric(self):
        # Reference quirk: t = floor((k-s+1)/2) puts the emission offset
        # off-center, so RC strands select different syncmer sets even
        # though the hash values themselves are canonical.
        k, s = 10, 4
        t = t_syncmer_default(k, s)
        assert t - 1 != (k - s + 1) - 1 - (t - 1)

    def test_n_resets(self):
        k, s = 8, 4
        t = t_syncmer_default(k, s)
        rng = np.random.default_rng(5)
        left = rng.integers(0, 4, 60).astype(np.uint8)
        right = rng.integers(0, 4, 60).astype(np.uint8)
        joined = np.concatenate([left, np.array([4], np.uint8), right])
        hj = set(syncmer_hash_set(joined, k, s, t).tolist())
        hl = set(syncmer_hash_set(left, k, s, t).tolist())
        hr = set(syncmer_hash_set(right, k, s, t).tolist())
        assert hj == (hl | hr)

    def test_t_default_integer_division(self):
        assert t_syncmer_default(22, 12) == 5  # (22-12+1)/2 = 5 (floor)
        assert t_syncmer_default(20, 10) == 5


class TestMinimizer:
    def test_adjust_seed(self):
        assert adjust_seed(20) == 0x8F3F73B5CF1C9ADE >> 24

    def test_plain_kmer_path_w_eq_k(self):
        codes = encode_dna4(b"ACGTACGTACGT")
        k = 4
        vals = minimiser_hashes(codes, k, k)
        assert vals.shape[0] == len(codes) - k + 1
        # independently compute canonical value at position 0: ACGT
        seed = adjust_seed(k)
        fwd = (0 << 6) | (1 << 4) | (2 << 2) | 3
        # rc of ACGT is ACGT
        assert int(vals[0]) == min(fwd ^ seed, fwd ^ seed)

    def test_canonical_is_strand_symmetric(self):
        rng = np.random.default_rng(11)
        seq = rng.integers(0, 4, 100).astype(np.uint8)
        rc = (3 - seq)[::-1].astype(np.uint8)
        k = 9
        a = canonical_kmer_values(seq, k)
        b = canonical_kmer_values(rc, k)
        assert set(a.tolist()) == set(b.tolist())

    def test_minimiser_emission_rule(self):
        vals = np.array([5, 3, 4, 3, 2, 9, 9], dtype=np.uint64)
        # w'=3: windows [5,3,4]->3(idx1), [3,4,3]-> idx1 still in, no emit;
        # [4,3,2]-> old min idx1 slid out? window start=2, idx1<2 ->
        # recompute leftmost min of [4,3,2] -> 2 (idx4). window [3,2,9]:
        # idx4 in window, 9 not smaller -> no emit. [2,9,9]: idx4 in window.
        out = minimiser_emissions(vals, 3)
        assert out.tolist() == [3, 2]

    def test_duplicates_kept_in_search(self):
        scheme = HashScheme.make(4, 2, 4, use_syncmer=False)
        res = search_hashes([b"AAAAAAAA"], scheme)
        assert res[0].shape[0] == 5  # every position emits, duplicates kept


class TestScaling:
    def test_scaling_filter_fraction(self):
        rng = np.random.default_rng(13)
        h = rng.integers(0, 2**63, 200000, dtype=np.uint64)
        kept = scaling_filter(h, 10)
        frac = kept.shape[0] / h.shape[0]
        assert 0.08 < frac < 0.12

    def test_scaling_one_is_identity(self):
        h = np.arange(10, dtype=np.uint64)
        assert scaling_filter(h, 1) is h

"""Device 32-bit-pair hash math vs the numpy uint64 reference."""

import numpy as np
import jax.numpy as jnp

from taxor_jax.utils import u64jnp, u64np


def split(x):
    x = np.asarray(x, dtype=np.uint64)
    return (
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def join(hi, lo):
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )


def rand(n=500, seed=0):
    return np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64)


def test_umul32_full():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, 500, dtype=np.uint32)
    b = rng.integers(0, 2**32, 500, dtype=np.uint32)
    hi, lo = u64jnp.umul32_full(jnp.asarray(a), jnp.asarray(b))
    prod = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(np.asarray(hi), (prod >> 32).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), (prod & 0xFFFFFFFF).astype(np.uint32))


def test_murmur64_pair():
    x = rand()
    hi, lo = u64jnp.murmur64(*split(x))
    np.testing.assert_array_equal(join(hi, lo), u64np.murmur64(x))


def test_mix_split_pair():
    x = rand(seed=3)
    seed = u64np.XOR_SEED0
    shi, slo = split(np.uint64(seed))
    hi, lo = u64jnp.mix_split(*split(x), shi, slo)
    np.testing.assert_array_equal(join(hi, lo), u64np.mix_split(x, seed))


def test_rotl_shift():
    x = rand(seed=4)
    for s in [1, 21, 31, 32, 42, 63]:
        hi, lo = u64jnp.rotl64(*split(x), s)
        np.testing.assert_array_equal(join(hi, lo), u64np.rotl64(x, s))
    for s in [0, 1, 33, 63]:
        hi, lo = u64jnp.shr64(*split(x), s)
        np.testing.assert_array_equal(join(hi, lo), x >> np.uint64(s))


def test_probe_positions_match_host():
    keys = rand(seed=5)
    for bl in [313, 1240, 99999]:
        expect_pos = u64np.probe_positions(
            u64np.mix_split(keys, u64np.XOR_SEED0), bl
        )
        expect_f = u64np.fingerprint8(u64np.mix_split(keys, u64np.XOR_SEED0))
        shi, slo = split(np.uint64(u64np.XOR_SEED0))
        pos, fpr = u64jnp.probe_positions_and_fprint(
            *split(keys), shi, slo, jnp.uint32(bl)
        )
        np.testing.assert_array_equal(np.asarray(pos), expect_pos)
        assert np.asarray(fpr).dtype == np.uint8
        np.testing.assert_array_equal(
            np.asarray(fpr), expect_f.astype(np.uint8)
        )

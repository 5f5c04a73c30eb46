"""Per-read k-mer dedup on device (dedup_kmers, XLA sort) and the exact
min-gap block compaction (_block_compact) vs numpy oracles, on every
shape class the fused step uses."""

import jax.numpy as jnp
import numpy as np
import pytest

from taxor_jax.hash.device_syncmer import _block_compact, dedup_kmers

SENT = np.uint32(0xFFFFFFFF)


def _oracle(khi, klo, emit, hcap):
    """Per read: the sorted set of emitted (hi, lo) pairs, its size, and
    the emission count."""
    out = []
    for r in range(khi.shape[0]):
        m = emit[r]
        pairs = sorted(set(zip(khi[r][m].tolist(), klo[r][m].tolist())))
        out.append((pairs, len(pairs), int(m.sum())))
    return out


def _check(khi, klo, emit, hcap, min_gap=1):
    hi, lo, valid, n_unique, n_emit = map(np.asarray, dedup_kmers(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), hcap,
        min_gap))
    assert hi.shape == (khi.shape[0], hcap) and valid.shape == hi.shape
    for r, (pairs, nu, ne) in enumerate(_oracle(khi, klo, emit, hcap)):
        assert n_emit[r] == ne and n_unique[r] == nu, r
        got = list(zip(hi[r][valid[r]].tolist(), lo[r][valid[r]].tolist()))
        # valid columns: the unique pairs in ascending order (duplicates
        # stay interleaved as invalid columns)
        assert got == pairs[: len(got)], r
        if ne <= hcap:
            assert len(got) == nu, r


@pytest.mark.parametrize("R,W", [(8, 128), (16, 256), (8, 512)])
def test_random_pairs(R, W):
    rng = np.random.default_rng(R * W)
    khi = rng.integers(0, 1 << 12, (R, W), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (R, W), dtype=np.uint32)
    emit = rng.random((R, W)) < 0.2
    _check(khi, klo, emit, W // 4)


def test_non_pow2_width():
    rng = np.random.default_rng(7)
    khi = rng.integers(0, 1 << 8, (8, 384), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (8, 384), dtype=np.uint32)
    _check(khi, klo, rng.random((8, 384)) < 0.25, 128)


def test_row_count_not_a_tile_multiple():
    rng = np.random.default_rng(3)
    khi = rng.integers(0, 4, (9, 128), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (9, 128), dtype=np.uint32)
    _check(khi, klo, rng.random((9, 128)) < 0.2, 32)


def test_duplicates_and_sentinel_values():
    # heavy duplication, and emitted values equal to the all-ones
    # sentinel in one half: duplicates collapse, the pair sorts last
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 8, (8, 256), dtype=np.uint32)
    khi = np.where(vals < 6, vals, SENT)
    klo = np.where(vals < 6, vals * 3, np.uint32(5))
    _check(khi, klo, rng.random((8, 256)) < 0.3, 64)


def test_hi_dominates_order():
    khi = np.array([[2, 1, 1, 0] + [0] * 124], dtype=np.uint32)
    klo = np.array([[0, 5, 1, 9] + [0] * 124], dtype=np.uint32)
    emit = np.zeros((1, 128), bool)
    emit[0, :4] = True
    hi, lo, valid, n_unique, _ = map(np.asarray, dedup_kmers(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), 32))
    assert n_unique[0] == 4
    np.testing.assert_array_equal(hi[0][valid[0]], [0, 1, 1, 2])
    np.testing.assert_array_equal(lo[0][valid[0]], [9, 1, 5, 0])


@pytest.mark.parametrize("R,L,hcap", [(16, 256, 128), (8, 512, 512),
                                      (12, 384, 512)])
def test_hcap_shapes(R, L, hcap):
    # hcap below, equal to and above the padded width
    rng = np.random.default_rng(R + L)
    khi = rng.integers(0, 1 << 12, (R, L), dtype=np.uint32)
    klo = rng.integers(0, 8, (R, L), dtype=np.uint32)  # many dups
    _check(khi, klo, rng.random((R, L)) < 0.2, hcap)


def test_hcap_overflow_reports_true_emission_count():
    rng = np.random.default_rng(2)
    khi = rng.integers(0, 1 << 20, (4, 256), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (4, 256), dtype=np.uint32)
    emit = np.ones((4, 256), bool)
    _, _, valid, _, n_emit = map(np.asarray, dedup_kmers(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), 64))
    assert (n_emit == 256).all() and valid.sum(axis=1).max() <= 64


def _gap_emit(rng, R, L, gap):
    """Emission masks whose set bits are at least `gap` apart."""
    emit = np.zeros((R, L), bool)
    for r in range(R):
        i = int(rng.integers(0, gap))
        while i < L:
            if rng.random() < 0.8:
                emit[r, i] = True
                i += gap + int(rng.integers(0, 3))
            else:
                i += 1
    return emit


@pytest.mark.parametrize("gap", [2, 3, 4, 6])
def test_block_compact_keeps_every_emission(gap):
    rng = np.random.default_rng(gap)
    R, L = 6, 256
    khi = rng.integers(0, 1 << 30, (R, L), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (R, L), dtype=np.uint32)
    emit = _gap_emit(rng, R, L, gap)
    chi, clo, overflow = map(np.asarray, _block_compact(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), gap))
    assert not overflow.any()
    assert chi.shape[1] < L  # the gap buys a narrower sort
    for r in range(R):
        keep = ~((chi[r] == SENT) & (clo[r] == SENT))
        # block order is position order: the compacted slots list the
        # emitted k-mers in read order
        np.testing.assert_array_equal(chi[r][keep], khi[r][emit[r]])
        np.testing.assert_array_equal(clo[r][keep], klo[r][emit[r]])
    # dedup through the compaction equals dedup without it
    _check(khi, klo, emit, 64, min_gap=gap)


def test_block_compact_flags_gap_violation():
    rng = np.random.default_rng(1)
    khi = rng.integers(0, 1 << 30, (2, 64), dtype=np.uint32)
    klo = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint32)
    emit = np.zeros((2, 64), bool)
    emit[0, ::4] = True
    emit[1, :6] = True  # six adjacent emissions in one 16-base block
    _, _, overflow = map(np.asarray, _block_compact(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(emit), 4))
    assert overflow.tolist() == [False, True]
    # the dedup tail routes the violating read to the host fallback
    *_, n_emit = dedup_kmers(jnp.asarray(khi), jnp.asarray(klo),
                             jnp.asarray(emit), 32, 4)
    assert int(np.asarray(n_emit)[1]) > 32


def test_block_compact_declines_without_gap():
    z = jnp.zeros((2, 64), jnp.uint32)
    assert _block_compact(z, z, jnp.zeros((2, 64), bool), 1) is None

"""The one IXF probe (device/probe.py) and the steps around it vs the
numpy oracle: table layout, masking, inactive reads, packing and the
per-IXF step."""

import jax.numpy as jnp
import numpy as np
import pytest

from taxor_jax.device.probe import (
    LANE,
    count_xla,
    pack_hash_lists,
    pad_fingerprints,
    probe_counts,
    probe_step,
    segment_runs,
)
from taxor_jax.device.probe_triton import count_triton
from taxor_jax.ixf.xor_filter import build_ixf, compute_probes


def _problem(seed, n_bins, R, H, keys_per_bin=60):
    """An IXF plus per-read probe inputs: each read holds some keys of
    'its' bin (hits) and random keys (misses)."""
    rng = np.random.default_rng(seed)
    bins = [rng.integers(0, 2**63, keys_per_bin, dtype=np.uint64)
            for _ in range(n_bins)]
    ixf = build_ixf(bins, max_elements_per_bin=2 * keys_per_bin)
    pos = np.zeros((R, H, 3), np.int32)
    fpr = np.zeros((R, H), np.uint8)
    mask = np.zeros((R, H), bool)
    keys_of = []
    for r in range(R):
        keys = np.unique(np.concatenate([
            bins[r % n_bins][: H // 4],
            rng.integers(0, 2**63, H // 2, dtype=np.uint64),
        ]))[:H]
        p, f, _ = compute_probes(keys, ixf.seed, ixf.block_length)
        n = keys.shape[0]
        pos[r, :n] = p
        fpr[r, :n] = f
        mask[r, :n] = True
        keys_of.append(keys)
    return ixf, pos, fpr, mask, keys_of


def _upload(keys_of, H):
    """pack_hash_lists of the reads' keys at hash width H (rows pad to
    16)."""
    return jnp.asarray(pack_hash_lists(keys_of, H))


def _oracle(ixf, pos, fpr, mask):
    out = np.zeros((pos.shape[0], ixf.fingerprints.shape[1]), np.int64)
    for r in range(pos.shape[0]):
        m = mask[r]
        rows = ixf.fingerprints[pos[r][m]]
        x = rows[:, 0] ^ rows[:, 1] ^ rows[:, 2] ^ fpr[r][m][:, None]
        out[r] = (x == 0).sum(axis=0)
    return out


def test_padded_table_layout():
    fp = np.arange(12, dtype=np.uint8).reshape(3, 4)
    padded = pad_fingerprints(fp)
    assert padded.shape == (3, LANE) and padded.dtype == np.uint8
    np.testing.assert_array_equal(padded[:, :4], fp)
    assert (padded[:, 4:] == 0).all()
    # already lane-aligned tables pass through; mesh multiples pad wider
    assert pad_fingerprints(padded) is padded
    assert pad_fingerprints(fp, LANE * 4).shape == (3, 4 * LANE)


@pytest.mark.parametrize("n_bins,R,H", [(20, 4, 48), (300, 5, 70),
                                        (4100, 3, 40)])
def test_count_xla_matches_oracle(n_bins, R, H):
    ixf, pos, fpr, mask, _ = _problem(n_bins + R, n_bins, R, H)
    mask[0, 3] = False  # interior invalid slot
    fp = pad_fingerprints(ixf.fingerprints)
    out = np.asarray(count_xla(fp, pos, fpr, mask))
    np.testing.assert_array_equal(out[:, :n_bins],
                                  _oracle(ixf, pos, fpr, mask))


@pytest.mark.parametrize("n_bins,lane,R,H", [
    (20, LANE, 4, 48), (300, LANE, 5, 70), (600, LANE, 3, 33),
    (500, LANE, 3, 40), (4100, LANE, 2, 40), (64, 64, 4, 40)])
def test_triton_probe_interpret_matches_xla(n_bins, lane, R, H):
    """The Triton-route kernel in interpret mode: hash widths that are
    not a chunk multiple, interior invalid slots, an inactive read (all
    slots masked) and bin tiles of 128, 256 and 64 (a 64-bin mesh
    shard)."""
    ixf, pos, fpr, mask, _ = _problem(7 * n_bins, n_bins, R, H)
    mask[0, 5] = False
    mask[R - 1] = False  # inactive read: zero trip count
    fp = pad_fingerprints(ixf.fingerprints, lane)
    want = np.asarray(count_xla(fp, pos, fpr, mask))
    got = np.asarray(count_triton(jnp.asarray(fp), jnp.asarray(pos),
                                  jnp.asarray(fpr), jnp.asarray(mask),
                                  interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[R - 1] == 0).all()


def test_probe_counts_bounds_gather_on_wide_tables(monkeypatch):
    """probe_counts shrinks count_xla's hash chunk for wide tables; the
    result must not depend on the chunk."""
    from taxor_jax.device import probe as probe_mod

    ixf, pos, fpr, mask, _ = _problem(3, 300, 6, 64)
    fp = pad_fingerprints(ixf.fingerprints)
    want = np.asarray(count_xla(fp, pos, fpr, mask))
    monkeypatch.setattr(probe_mod, "_GATHER_BUDGET", 6 * 3 * 384 * 8)
    got = np.asarray(probe_counts(jnp.asarray(fp), jnp.asarray(pos),
                                  jnp.asarray(fpr), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)


def test_probe_step_matches_oracle():
    """Per-IXF step from packed host hashes: on-device probe math,
    probe, segmentation — including invalid-slot masking and an
    inactive read."""
    ixf, _, _, _, keys_of = _problem(9, 10, 16, 32, keys_per_bin=150)
    R, H = 16, 32
    active = np.ones(R, bool)
    active[3] = False
    fp = pad_fingerprints(ixf.fingerprints)
    onehot = np.eye(fp.shape[1], dtype=np.float32)
    sums = np.asarray(probe_step(
        jnp.asarray(fp), _upload(keys_of, H),
        jnp.asarray(active), jnp.asarray(onehot),
        np.uint32(ixf.seed >> 32), np.uint32(ixf.seed & 0xFFFFFFFF),
        np.uint32(ixf.block_length)))
    for r in range(R):
        if not active[r]:
            assert (sums[r] == 0).all()
            continue
        np.testing.assert_array_equal(sums[r, :10],
                                      ixf.bulk_count(keys_of[r]))


def test_probe_step_prefix_runs_is_column_slice():
    ixf, _, _, _, keys_of = _problem(5, 12, 4, 40)
    fp = jnp.asarray(pad_fingerprints(ixf.fingerprints))
    onehot = np.zeros((fp.shape[1], 12), np.float32)
    onehot[np.arange(12), np.arange(12)] = 1.0
    args = (fp, _upload(keys_of, 40),
            jnp.ones(16, bool), jnp.asarray(onehot),
            np.uint32(ixf.seed >> 32), np.uint32(ixf.seed & 0xFFFFFFFF),
            np.uint32(ixf.block_length))
    np.testing.assert_array_equal(
        np.asarray(probe_step(*args, prefix_runs=12)),
        np.asarray(probe_step(*args)))


def test_segment_runs_exact_above_tf32_range():
    """Run sums of counts far above 2^11 stay exact (HIGHEST precision;
    a TF32 product would round them)."""
    counts = jnp.asarray(np.array([[4095, 4097, 65537, 1]], np.int32))
    onehot = jnp.asarray(np.array([[1, 0], [1, 0], [0, 1], [0, 1]],
                                  np.float32))
    np.testing.assert_array_equal(np.asarray(segment_runs(counts, onehot)),
                                  [[8192, 65538]])


def test_pack_hash_lists_layout():
    """[h_hi | h_lo | mask] per row, rows padded to 16, and unpack_batch
    recovers the hashes."""
    from taxor_jax.device.probe import unpack_batch

    rng = np.random.default_rng(4)
    lists = [rng.integers(0, 2**63, n, dtype=np.uint64)
             for n in (5, 0, 17, 3)]
    Hpad = 32
    packed = pack_hash_lists(lists, Hpad)
    assert packed.shape == (16, 3 * Hpad) and packed.dtype == np.uint32
    hi, lo, valid = (np.asarray(x) for x in unpack_batch(packed))
    for r, h in enumerate(lists):
        n = h.shape[0]
        want = np.zeros(Hpad, np.uint64)
        want[:n] = h
        got = (hi[r].astype(np.uint64) << np.uint64(32)) | lo[r]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(valid[r], np.arange(Hpad) < n)
    assert (packed[4:] == 0).all()


@pytest.mark.gpu
def test_probe_on_gpu_matches_oracle(gpu):
    """The product probe compiled for the card, at a real table width,
    against the numpy oracle (skips off the card)."""
    ixf, pos, fpr, mask, _ = _problem(21, 2048, 64, 256, keys_per_bin=40)
    fp = pad_fingerprints(ixf.fingerprints)
    got = np.asarray(probe_counts(jnp.asarray(fp), jnp.asarray(pos),
                                  jnp.asarray(fpr), jnp.asarray(mask)))
    np.testing.assert_array_equal(got[:, :2048],
                                  _oracle(ixf, pos, fpr, mask))

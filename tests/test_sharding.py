"""Multi-device sharding: bin-sharded counts equal single-device counts
(the shard-vs-replicated equality stand-in for distributed tests)."""

import jax
import numpy as np
import pytest

from taxor_jax.device.probe import count_xla, pad_fingerprints
from taxor_jax.device.sharding import (
    make_mesh,
    shard_ixf,
    sharded_count_fn,
    sharded_search_step_fn,
)
from taxor_jax.ixf.xor_filter import build_ixf, compute_probes


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n_bins = 256  # pads to 256 columns; divisible by 4 bin shards
    bins = [rng.integers(0, 2**63, 50, dtype=np.uint64)
            for _ in range(n_bins)]
    ixf = build_ixf(bins, max_elements_per_bin=1000)
    fp = pad_fingerprints(ixf.fingerprints)
    R, H = 8, 64
    pos = np.zeros((R, H, 3), dtype=np.int32)
    fpr = np.zeros((R, H), dtype=np.uint8)
    mask = np.zeros((R, H), dtype=bool)
    for r in range(R):
        keys = np.unique(np.concatenate([
            bins[r][:20], rng.integers(0, 2**63, 40, dtype=np.uint64)
        ]))[:H]
        p, f, _ = compute_probes(keys, ixf.seed, ixf.block_length)
        pos[r, : keys.shape[0]] = p
        fpr[r, : keys.shape[0]] = f
        mask[r, : keys.shape[0]] = True
    return fp, pos, fpr, mask


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_bin_sharded_equals_single_device(problem):
    fp, pos, fpr, mask = problem
    expect = np.asarray(count_xla(fp, pos, fpr, mask))

    mesh = make_mesh(2, 4)
    fp_sharded = shard_ixf(mesh, fp)
    counts = sharded_count_fn(mesh)(fp_sharded, pos, fpr, mask)
    np.testing.assert_array_equal(np.asarray(counts), expect)


def test_full_sharded_step(problem):
    fp, pos, fpr, mask = problem
    mesh = make_mesh(2, 4)
    onehot = np.eye(fp.shape[1], dtype=np.float32)
    thresholds = np.full(pos.shape[0], 5, dtype=np.int32)
    step = sharded_search_step_fn(mesh)
    sums, emitted = step(shard_ixf(mesh, fp), pos, fpr, mask, onehot,
                         thresholds)
    expect = np.asarray(count_xla(fp, pos, fpr, mask))
    np.testing.assert_array_equal(np.asarray(sums), expect)
    np.testing.assert_array_equal(np.asarray(emitted), expect >= 5)


def test_graft_entry_single():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    sums, emitted = jax.jit(fn)(*args)
    assert sums.shape[0] == 8


def test_graft_entry_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)

"""Device-side top-k emission compaction (finalize_topk) and the host
decode (_pairs_from_topk): must reproduce the exact host-oracle pairs,
including the truncation fallback when > k bins qualify."""

import numpy as np

from taxor_jax.device.probe import finalize_topk
from taxor_jax.search.pipeline import _pairs_from_topk


def _decode(sums, thresholds, run_users, k):
    import jax.numpy as jnp

    packed = np.asarray(
        finalize_topk(
            jnp.asarray(sums.astype(np.int32)),
            jnp.asarray(thresholds.astype(np.int32)),
            jnp.asarray(run_users.astype(np.int32)),
            k,
        )
    )
    return packed[:, :k], packed[:, k:]


def test_topk_threshold_and_order():
    sums = np.array([[5, 9, 2, 9, 0, 7]], dtype=np.int32)
    thr = np.array([5], dtype=np.int32)
    users = np.arange(6, dtype=np.int32)
    vals, ubs = _decode(sums, thr, users, k=4)
    # descending counts, ties by lower run index first
    assert vals[0].tolist() == [9, 9, 7, 5]
    assert ubs[0].tolist() == [1, 3, 5, 0]


def test_topk_masks_merged_runs_and_below_threshold():
    sums = np.array([[8, 8, 8]], dtype=np.int32)
    thr = np.array([9], dtype=np.int32)
    users = np.array([0, -1, 2], dtype=np.int32)
    vals, ubs = _decode(sums, thr, users, k=3)
    assert (vals[0] == -1).all()
    assert (ubs[0] == -1).all()
    thr = np.array([8], dtype=np.int32)
    vals, ubs = _decode(sums, thr, users, k=3)
    assert vals[0].tolist() == [8, 8, -1]  # merged run excluded
    assert sorted(ubs[0][:2].tolist()) == [0, 2]


def test_topk_pads_when_fewer_runs_than_k():
    sums = np.array([[3, 4]], dtype=np.int32)
    thr = np.array([1], dtype=np.int32)
    users = np.array([0, 1], dtype=np.int32)
    vals, ubs = _decode(sums, thr, users, k=8)
    assert vals.shape == (1, 8)
    assert vals[0, :2].tolist() == [4, 3]
    assert (vals[0, 2:] == -1).all()


class _FakeHixf:
    def __init__(self, pairs):
        self._pairs = pairs
        self.calls = 0

    def membership(self, hashes, threshold):
        self.calls += 1
        return self._pairs


class _FakeIndex:
    def __init__(self, pairs):
        self.hixf = _FakeHixf(pairs)


def test_pairs_from_topk_sorted_by_dfs_and_fallback():
    k = 3
    # read 0: 2 candidates, no truncation risk; emitted in dfs order
    vals = np.array([[10, 9, -1], [10, 9, 8]], dtype=np.int32)
    users = np.array([[4, 2, -1], [0, 1, 2]], dtype=np.int32)
    thresholds = np.array([5, 5], dtype=np.int64)
    dfs_rank = np.array([0, 1, 2, 3, 4], dtype=np.int64)
    oracle_pairs = [(0, 10), (1, 9), (2, 8), (3, 8)]
    index = _FakeIndex(oracle_pairs)
    hash_lists = [np.zeros(1, np.uint64), np.zeros(1, np.uint64)]
    pairs = _pairs_from_topk(vals, users, thresholds, hash_lists, index,
                             dfs_rank)
    # read 0: dfs order (user 2 before user 4)
    assert pairs[0] == [(2, 9), (4, 10)]
    # read 1: all k slots filled and k-th val 8 >= 0.8*10 -> fallback
    assert pairs[1] == oracle_pairs
    assert index.hixf.calls == 1


def test_pairs_from_topk_full_k_but_no_truncation_risk():
    k = 3
    vals = np.array([[10, 9, 7]], dtype=np.int32)  # 7 < 0.8*10
    users = np.array([[2, 1, 0]], dtype=np.int32)
    thresholds = np.array([5], dtype=np.int64)
    dfs_rank = np.arange(3, dtype=np.int64)
    index = _FakeIndex([("should", "not_be_used")])
    pairs = _pairs_from_topk(vals, users, thresholds,
                             [np.zeros(1, np.uint64)], index, dfs_rank)
    assert pairs[0] == [(0, 7), (1, 9), (2, 10)]
    assert index.hixf.calls == 0

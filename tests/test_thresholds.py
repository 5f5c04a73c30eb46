"""Threshold models: inverse normal CDF, kmer CI, syncmer table lookup,
fracminhash CI, model selection, size_t-wrap semantics."""

import math

import pytest

from taxor_jax.search.thresholds import (
    INF_THRESHOLD,
    Thresholder,
    containment_index_ci,
    nmut_kmer_ci,
    normal_cdf_inverse,
    syncmer_match_ratio,
)


class TestGaussianInverse:
    def test_known_z_values(self):
        # Abramowitz-Stegun 26.2.23 is accurate to ~4.5e-4
        assert abs(normal_cdf_inverse(0.975) - 1.959964) < 1e-3
        assert abs(normal_cdf_inverse(0.5 + 1e-12)) < 1e-2
        assert abs(normal_cdf_inverse(0.025) + 1.959964) < 1e-3

    def test_symmetry(self):
        assert normal_cdf_inverse(0.3) == -normal_cdf_inverse(0.7)

    def test_invalid_raises(self):
        with pytest.raises(ValueError):
            normal_cdf_inverse(0.0)
        with pytest.raises(ValueError):
            normal_cdf_inverse(1.0)


class TestKmerModel:
    def test_ci_reasonable(self):
        low, high = nmut_kmer_ci(0.04, 20, 1000, 0.95)
        q = 1.0 - (1.0 - 0.04) ** 20
        assert low < 1000 * q < high
        assert 0 < low and high < 1000

    def test_threshold_value(self):
        th = Thresholder.make(20, 20, 0.04, -1.0, use_syncmer=False)
        assert th.kind == "kmer_model"
        count = 1000
        _, hi = nmut_kmer_ci(0.04, 20, count, 0.95)
        expect = count - hi - int(count * 0.0039)
        assert th.get(count, 0.5) == expect

    def test_negative_wraps_to_inf(self):
        th = Thresholder.make(20, 20, 0.5, -1.0, use_syncmer=False)
        # 50% error rate: every kmer mutated, CI_high > count -> the size_t
        # subtraction wraps to a value >= 2^63 ("no count can ever pass"),
        # exactly as the reference's threshold.hpp:64-65 computes it
        assert th.get(100, 0.5) >= INF_THRESHOLD


class TestSyncmerModel:
    def test_table_corners(self):
        # k=12 col 0, accuracy 80% row 0
        assert syncmer_match_ratio(12, 0.20) == 0.552077
        # accuracy 100% row 20
        assert syncmer_match_ratio(12, 0.0) == 1.0
        # k=30 -> col 9
        assert syncmer_match_ratio(30, 0.20) == 0.0252911

    def test_col_formula(self):
        # col = k-10 - (k-10)//2 - 1: k=22 -> 12-6-1=5
        assert syncmer_match_ratio(22, 0.20) == 0.0797244

    def test_threshold(self):
        th = Thresholder.make(22, 22, 0.04, -1.0, use_syncmer=True)
        assert th.kind == "syncmer_model"
        ratio = syncmer_match_ratio(22, 0.04)
        assert th.get(500, 0.1) == int(500 * ratio)


class TestFracMinHash:
    def test_ci_brackets_expectation(self):
        lo, hi = containment_index_ci(0.04, 20, 1000, 0.1, 0.95)
        exp = (1.0 - 0.04) ** 20
        assert lo < exp < hi

    def test_selection(self):
        th = Thresholder.make(20, 30, 0.04, -1.0, use_syncmer=False)
        assert th.kind == "fracminhash"

    def test_zero_count_is_impossible_not_a_crash(self):
        # count==0 (read shorter than k): the reference's C double math
        # divides by 0.0 -> inf/NaN -> size_t sentinel; the Python port
        # must not raise ZeroDivisionError (fracminhash_model.cpp:23-33)
        th = Thresholder.make(20, 30, 0.04, -1.0, use_syncmer=False)
        assert th.get(0, float("nan")) >= INF_THRESHOLD


class TestPipelineThresholdClamp:
    def test_wrapped_threshold_fits_int64_batch(self):
        # kmer_model get() for short reads size_t-wraps to >= 2^63; the
        # pipeline batches thresholds into an int64 array and must clamp
        # instead of raising OverflowError (ADVICE r2 #1)
        import numpy as np

        th = Thresholder.make(16, 16, 0.04, -1.0, use_syncmer=False)
        v = th.get(10, 0.5)
        assert v >= INF_THRESHOLD
        arr = np.array([min(v, 2**62)], dtype=np.int64)
        assert arr[0] == 2**62


class TestSelection:
    def test_percentage_wins(self):
        th = Thresholder.make(20, 20, 0.04, 0.5, use_syncmer=True)
        assert th.kind == "percentage"
        assert th.get(101, 0.1) == 50  # truncation

    def test_percentage_out_of_range_ignored(self):
        th = Thresholder.make(20, 20, 0.04, -1.0, use_syncmer=True)
        assert th.kind == "syncmer_model"

"""Golden-parity tests against fixtures generated by the REFERENCE's own code.

The fixtures under tests/golden/ are produced by tools/golden/gen_golden.cpp,
which compiles the reference's in-tree STL-only sources in place from
/root/reference (src/hashing/syncmer.cpp, src/main/xorfilter.hpp,
src/hixf/search/*.cpp) — see tools/golden/generate.py.  These tests therefore
check this framework against values computed by reference code, not against
our own oracles:

  - syncmer.json     — hash sets from the reference scanner
                       (syncmer.cpp:80-166), incl. N-resets, IUPAC->N,
                       lowercase, short/empty sequences;
  - xorfilter.json   — fingerprint tables built by the reference XOR filter
                       (xorfilter.hpp:142-334) probed by OUR host and device
                       query paths, bit-for-bit on present AND absent keys
                       (the absent-key false-positive pattern pins down
                       rotl/Lemire-reduce/fingerprint math exactly);
  - thresholds.json  — threshold-model values on a parameter grid
                       (kmer_model.cpp, syncmer_model.hpp,
                       fracminhash_model.cpp, gaussian_inverse.cpp).

Device paths are covered transitively as well: every device kernel has a
device==host-oracle equality test elsewhere in the suite, and the host oracle
is pinned to the reference here.
"""

import json
import os

import numpy as np
import pytest

from taxor_jax.hash.encode import encode_dna5
from taxor_jax.hash.syncmer import syncmer_hash_set, t_syncmer_default
from taxor_jax.ixf.xor_filter import IXF, compute_probes
from taxor_jax.search import thresholds as th

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        return json.load(fh)


# ---------------------------------------------------------------- syncmer --
SYNCMER_CASES = _load("syncmer.json")


@pytest.mark.parametrize("case", SYNCMER_CASES, ids=[c["name"] for c in SYNCMER_CASES])
def test_syncmer_matches_reference(case):
    codes = encode_dna5(case["seq"].encode())
    got = syncmer_hash_set(codes, case["k"], case["s"], case["t"])
    want = np.array(sorted(case["hashes"]), dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_syncmer_t_default_matches_fixture_grid():
    # the fixture grid was generated with t = (k-s+1)/2 in C++ int division
    for case in SYNCMER_CASES:
        assert case["t"] == t_syncmer_default(case["k"], case["s"])


def test_syncmer_native_matches_reference():
    from taxor_jax.hash.schemes import HashScheme, _syncmer_sets_native
    from taxor_jax.native import get_lib

    lib = get_lib()
    if lib is None:
        pytest.skip("native lib unavailable")
    for case in SYNCMER_CASES:
        scheme = HashScheme(kmer_size=case["k"], syncmer_size=case["s"],
                            t_syncmer=case["t"])
        got = _syncmer_sets_native([case["seq"].encode()], scheme, True, lib)[0]
        np.testing.assert_array_equal(
            got, np.array(sorted(case["hashes"]), dtype=np.uint64))


# -------------------------------------------------------------- xorfilter --
XOR_CASES = _load("xorfilter.json")


def _ref_table_as_ixf(case) -> IXF:
    fp = np.frombuffer(bytes.fromhex(case["fingerprints"]), dtype=np.uint8)
    assert fp.shape[0] == case["array_length"]
    bl = case["block_length"]
    # probes only ever touch slots [0, 3*block_length); the reference
    # allocates arrayLength >= 3*blockLength and leaves the tail unused
    return IXF(fingerprints=fp[: 3 * bl].copy()[:, None],
               block_length=bl, seed=case["seed"])


@pytest.mark.parametrize("case", XOR_CASES, ids=[f"n{c['n']}" for c in XOR_CASES])
def test_host_probe_matches_reference_membership(case):
    ixf = _ref_table_as_ixf(case)
    keys = np.array(case["keys"], dtype=np.uint64)
    assert all(case["present_ok"]), "reference filter must contain its keys"
    present = ixf.bulk_membership(keys)[:, 0]
    np.testing.assert_array_equal(present, np.ones(len(keys), dtype=bool))
    absent = np.array(case["absent"], dtype=np.uint64)
    got = ixf.bulk_membership(absent)[:, 0]
    want = np.array(case["absent_ok"], dtype=bool)
    # exact bit-pattern equality, including reference false positives
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", XOR_CASES[:2], ids=[f"n{c['n']}" for c in XOR_CASES[:2]])
def test_device_probe_matches_reference_membership(case):
    import jax.numpy as jnp

    from taxor_jax.device.probe import count_xla, pad_fingerprints

    ixf = _ref_table_as_ixf(case)
    absent = np.array(case["absent"], dtype=np.uint64)
    pos, fpr, _ = compute_probes(absent, ixf.seed, ixf.block_length)
    fp_pad = pad_fingerprints(ixf.fingerprints)
    counts = count_xla(
        jnp.asarray(fp_pad),
        jnp.asarray(pos[:, None, :].astype(np.int32)),
        jnp.asarray(fpr[:, None]),
        jnp.ones((absent.shape[0], 1), dtype=bool),
    )
    got = np.asarray(counts)[:, 0] > 0
    want = np.array(case["absent_ok"], dtype=bool)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- thresholds --
THRESH_CASES = _load("thresholds.json")
_SIZE_T_HUGE = 1 << 63  # wrapped size_t values encode "impossible"


def test_kmer_model_matches_reference():
    cases = [c for c in THRESH_CASES if c["model"] == "kmer"]
    assert cases
    for c in cases:
        lo, hi = th.nmut_kmer_ci(c["r"], c["k"], c["count"], 0.95)
        assert (lo, hi) == (c["ci_low"], c["ci_high"]), c
        t = th.Thresholder(kmer_size=c["k"], error_rate=c["r"],
                           kind="kmer_model").get(c["count"], 1.0)
        assert t == c["threshold"], c


def test_syncmer_model_matches_reference():
    cases = [c for c in THRESH_CASES if c["model"] == "syncmer"]
    assert cases
    for c in cases:
        ratio = th.syncmer_match_ratio(c["k"], c["r"])
        assert ratio == c["ratio"], c
        t = th.Thresholder(kmer_size=c["k"], error_rate=c["r"],
                           kind="syncmer_model").get(c["count"], 1.0)
        assert t == c["threshold"], c


def test_fracminhash_model_matches_reference():
    cases = [c for c in THRESH_CASES if c["model"] == "fracminhash"]
    assert cases
    for c in cases:
        clow, chigh = th.containment_index_ci(c["r"], c["k"], c["count"],
                                              c["scaling"], 0.95)
        assert clow == pytest.approx(c["ci_low"], rel=1e-12, abs=1e-300), c
        assert chigh == pytest.approx(c["ci_high"], rel=1e-12, abs=1e-300), c
        t = th.Thresholder(kmer_size=c["k"], error_rate=c["r"],
                           kind="fracminhash").get(c["count"], c["scaling"])
        assert t == c["threshold"], c


def test_gaussian_inverse_matches_reference():
    cases = [c for c in THRESH_CASES if c["model"] == "gaussian_inverse"]
    assert cases
    for c in cases:
        assert th.normal_cdf_inverse(c["p"]) == pytest.approx(c["z"], rel=1e-14), c

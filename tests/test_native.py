"""Native C++ scanner vs numpy implementations."""

import numpy as np
import pytest

from taxor_jax.hash.encode import encode_dna4
from taxor_jax.hash.schemes import HashScheme, _syncmer_sets_native
from taxor_jax.hash.syncmer import syncmer_hashes_scalar
from taxor_jax.native import get_lib

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

lib = get_lib()
pytestmark = pytest.mark.skipif(lib is None,
                                reason="no C++ toolchain available")


def _rand_seq(rng, n, with_n=False):
    seq = bytearray(BASES[rng.integers(0, 4, n)].tobytes())
    if with_n:
        for i in rng.integers(0, n, max(1, n // 50)):
            seq[i] = ord("N")
    return bytes(seq)


@pytest.mark.parametrize("k,s", [(16, 8), (22, 12), (30, 14)])
def test_native_matches_scalar_oracle(k, s):
    scheme = HashScheme.make(k, s, None, True)
    rng = np.random.default_rng(k * 100 + s)
    seqs = [_rand_seq(rng, int(rng.integers(k, 2000)), with_n=(i % 3 == 0))
            for i in range(30)]
    got = _syncmer_sets_native(seqs, scheme, False, lib)
    for seq, g in zip(seqs, got):
        expect = np.unique(np.array(
            syncmer_hashes_scalar(encode_dna4(seq), k, s,
                                  scheme.t_syncmer),
            dtype=np.uint64,
        ))
        np.testing.assert_array_equal(g, expect)


def test_short_and_empty_sequences():
    scheme = HashScheme.make(22, 12, None, True)
    got = _syncmer_sets_native([b"", b"ACGT", b"A" * 21], scheme, False, lib)
    for g in got:
        assert g.shape[0] == 0


def test_long_sequence():
    scheme = HashScheme.make(22, 12, None, True)
    rng = np.random.default_rng(7)
    seq = _rand_seq(rng, 500_000)
    got = _syncmer_sets_native([seq], scheme, False, lib)[0]
    # open syncmer density ~ 1/(k-s+1) = 1/11 before dedup
    density = got.shape[0] / len(seq)
    assert 0.06 < density < 0.12

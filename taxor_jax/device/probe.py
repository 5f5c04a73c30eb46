"""Device-side IXF probe/count — the throughput-critical primitive.

The classification hot loop (reference hot loop 2, SURVEY.md §3.2) is:
for every query hash, read 3 fingerprint rows of an HBM-resident
``[slots, bins]`` uint8 table, XOR them against the hash's fingerprint
byte and count zero bytes per bin.  Slot positions and fingerprints come
from the uint64 hash values as uint32 pairs (utils/u64jnp.py).

Every search path probes through ``probe_counts`` over ONE table layout:
uint8 ``[slots, bins_padded]`` with bins padded to a ``LANE`` multiple
(padded columns stay 0 and behave like the reference's unused bins).
Invalid hash slots are masked, not redirected.  On the GPU the probe is
a Triton-route Pallas kernel (probe_triton.py); ``count_xla`` is the
plain-XLA gather formulation, the reference the tests pin and the probe
on every other platform.

This module also holds the host packers and the small jitted steps that
sit around the probe: ``pack_hash_lists`` (host hash lists -> one
uint32 upload), ``probe_step`` (positions + probe + run segmentation for
one IXF), ``segment_runs`` and ``finalize_topk``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

LANE = 128


def pad_bins(n_bins: int, lane: int = LANE) -> int:
    return max(lane, ((n_bins + lane - 1) // lane) * lane)


def pad_fingerprints(fp: np.ndarray, lane: int = LANE) -> np.ndarray:
    """Pad the bins axis to a lane multiple (padded columns stay 0 and are
    sliced off the counts)."""
    slots, bins = fp.shape
    padded = pad_bins(bins, lane)
    if padded == bins:
        return fp
    out = np.zeros((slots, padded), dtype=fp.dtype)
    out[:, :bins] = fp
    return out


@functools.partial(jax.jit, static_argnames=("hash_chunk",))
def count_xla(
    fingerprints: jax.Array,  # uint8 [slots, bins_padded]
    positions: jax.Array,  # int32 [R, H, 3]
    fprints: jax.Array,  # uint8 [R, H]
    mask: jax.Array,  # bool [R, H]
    hash_chunk: int = 128,
) -> jax.Array:
    """int32 [R, bins_padded] per-bin hit counts for a batch of reads."""
    R, H, _ = positions.shape
    pad = (-H) % hash_chunk
    if pad:
        positions = jnp.pad(positions, ((0, 0), (0, pad), (0, 0)))
        fprints = jnp.pad(fprints, ((0, 0), (0, pad)))
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
    n_chunks = positions.shape[1] // hash_chunk
    positions = positions.reshape(R, n_chunks, hash_chunk, 3)
    fprints = fprints.reshape(R, n_chunks, hash_chunk)
    mask = mask.reshape(R, n_chunks, hash_chunk)

    bins = fingerprints.shape[1]

    def chunk_body(acc, args):
        pos, fpr, msk = args  # [R, C, 3], [R, C], [R, C]
        rows = fingerprints[pos]  # [R, C, 3, bins]
        x = rows[:, :, 0] ^ rows[:, :, 1] ^ rows[:, :, 2] ^ fpr[..., None]
        hit = (x == 0) & msk[..., None]
        return acc + hit.sum(axis=1, dtype=jnp.int32), None

    # derive the carry from the inputs so its varying-axes type matches
    # inside shard_map (a literal zeros carry is "unvarying" and scan
    # rejects the mismatch)
    init = (
        jnp.zeros((R, bins), dtype=jnp.int32)
        + (mask[:, 0, 0].astype(jnp.int32) * 0)[:, None]
        + (fingerprints[0, :].astype(jnp.int32) * 0)[None, :]
    )
    acc, _ = jax.lax.scan(
        chunk_body,
        init,
        (
            jnp.moveaxis(positions, 1, 0),
            jnp.moveaxis(fprints, 1, 0),
            jnp.moveaxis(mask, 1, 0),
        ),
    )
    return acc


# bytes of the gathered [R, chunk, 3, bins] block count_xla may hold per
# scan step: wide tables (thousands of bins) shrink the hash chunk
_GATHER_BUDGET = 128 << 20


def _count_xla_bounded(fp, pos, fpr, mask):
    R = pos.shape[0]
    bins = fp.shape[1]
    hc = max(8, min(128, _GATHER_BUDGET // max(1, R * 3 * bins)))
    return count_xla(fp, pos, fpr, mask, hash_chunk=hc)


def probe_counts(fp, pos, fpr, mask):
    """The probe every search path runs: int32 [R, bins_padded] hit counts.

    fp uint8 [S, bins_padded]; pos int32 [R, H, 3]; fpr uint8 [R, H];
    mask bool [R, H] (False slots never count — padding, duplicates and
    reads inactive at this tree level).

    Compiled for an NVIDIA GPU it is the Triton-route Pallas kernel
    (device/probe_triton.py), which skips masked slots and inactive
    reads; lowered for any other platform it is count_xla, the plain
    reference with the same contract.  The choice is made by lowering
    (lax.platform_dependent), so one traced graph serves both."""
    from .probe_triton import count_triton

    return jax.lax.platform_dependent(
        fp, pos, fpr, mask, cuda=count_triton, default=_count_xla_bounded)


def segment_runs(counts, onehot):
    """Per-bin counts -> per-run sums via the one-hot [bins, runs] matmul.

    HIGHEST precision keeps the float32 product exact: a default-precision
    matmul may round operands to TF32 (11 significant bits), which would
    corrupt any count above 2048.  One-hot sums of integers < 2^24 are
    exact in float32."""
    return jnp.dot(
        counts.astype(jnp.float32), onehot,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)


def pack_hash_lists(hash_lists, Hpad: int, row_multiple: int = 16
                    ) -> np.ndarray:
    """Host hash lists -> ONE uint32 [Rpad, 3*Hpad] upload
    [h_hi | h_lo | mask], built from the ragged per-read hash arrays in
    one pass (no [R, H] uint64 intermediate).  Rows pad to
    `row_multiple` to bound the number of compiled shapes."""
    R = len(hash_lists)
    Rp = R + ((-R) % row_multiple)
    out = np.zeros((Rp, 3 * Hpad), dtype=np.uint32)
    for r, h in enumerate(hash_lists):
        n = h.shape[0]
        lo_hi = h.view(np.uint32).reshape(n, 2)  # little-endian: [lo, hi]
        out[r, :n] = lo_hi[:, 1]
        out[r, Hpad : Hpad + n] = lo_hi[:, 0]
        out[r, 2 * Hpad : 2 * Hpad + n] = 1
    return out


def unpack_batch(batch):
    """(h_hi, h_lo, valid) of a pack_hash_lists upload."""
    H = batch.shape[1] // 3
    return batch[:, :H], batch[:, H : 2 * H], batch[:, 2 * H :] != 0


@functools.partial(jax.jit, static_argnames=("prefix_runs",))
def probe_step(fp, batch, active, onehot, seed_hi, seed_lo, block_length,
               prefix_runs: int = 0):
    """Per-IXF search step from host-extracted hashes: probe positions,
    probe_counts, then run segmentation (onehot float32
    [bins_padded, n_runs]).  batch: the pack_hash_lists upload; active
    bool [R]; geometry scalars are traced, so one compilation covers
    every IXF that shares shapes.
    prefix_runs (static, flat indexes): when every run is ONE technical
    bin at its own index, the segmentation is a column slice.
    Returns int32 [R, n_runs] run sums."""
    from ..utils.u64jnp import probe_positions_and_fprint

    hi, lo, valid = unpack_batch(batch)
    pos, fpr = probe_positions_and_fprint(hi, lo, seed_hi, seed_lo,
                                          block_length)
    counts = probe_counts(fp, pos, fpr, valid & active[:, None])
    if prefix_runs:
        return counts[:, :prefix_runs]
    return segment_runs(counts, onehot)


@functools.partial(jax.jit, static_argnames=("k",))
def finalize_topk(sums, thresholds, run_users, k: int):
    """Device-side emission compaction for single-level (flat) indexes.

    Applies the per-read threshold on device, takes the top-k candidate
    bins, and ships one packed [R, 2k] int32 array (counts | user bins)
    instead of the dense [R, n_runs] matrix.  The host applies the exact
    float64 ``count >= 0.8*max`` rule (taxor_search.cpp:285) to the
    candidates and falls back to the host oracle for the (rare) reads
    where k candidates all survive — i.e. truncation was possible.

    sums:       int32 [R, n_runs] run sums (runs = user bins when flat)
    thresholds: int32 [R]
    run_users:  int32 [n_runs], -1 for merged runs (excluded)
    Returns packed int32 [R, 2k]: [:, :k] counts desc (-1 = below
    threshold / padding), [:, k:] their user bins.
    """
    n_runs = sums.shape[1]
    valid = (sums >= thresholds[:, None]) & (run_users >= 0)[None, :]
    vs = jnp.where(valid, sums, jnp.int32(-1))
    kk = min(k, n_runs)
    vals, idx = jax.lax.top_k(vs, kk)
    users = run_users[idx]
    users = jnp.where(vals >= 0, users, jnp.int32(-1))
    if kk < k:
        pad = ((0, 0), (0, k - kk))
        vals = jnp.pad(vals, pad, constant_values=-1)
        users = jnp.pad(users, pad, constant_values=-1)
    return jnp.concatenate([vals, users], axis=1)

"""IXF probe/count as one Pallas kernel through Triton.

Same contract as ``probe.count_xla``.  One program covers one read and a
tile of ``bin_tile`` bins.  It loops over the read's hash slots in chunks
of ``_CHUNK``: per chunk it gathers the 3 probe rows of every hash
([_CHUNK, bin_tile] uint8 each), XORs them, compares with the hash's
fingerprint byte and adds the hits to a register accumulator.  The loop
stops after the read's last valid slot and runs zero times for a read
that is inactive at this tree level, so masked work costs no table
bytes.  Invalid slots inside the valid prefix get fingerprint 256, which
no XOR of bytes can equal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_CHUNK = 32  # hash slots per loop iteration


def _probe_kernel(nc_ref, p0_ref, p1_ref, p2_ref, f_ref, fp_ref, out_ref):
    """nc_ref int32 [1] chunk trip count of this read; p*_ref int32 [H]
    probe rows; f_ref int32 [H] fingerprint (256 = never hits); fp_ref
    uint8 [S, BT] table column tile; out_ref int32 [BT]."""
    bt = out_ref.shape[0]

    def body(c, acc):
        sl = pl.ds(c * _CHUNK, _CHUNK)
        r0 = fp_ref[p0_ref[sl], :]
        r1 = fp_ref[p1_ref[sl], :]
        r2 = fp_ref[p2_ref[sl], :]
        x = (r0 ^ r1 ^ r2).astype(jnp.int32)
        hit = x == f_ref[sl][:, None]
        return acc + jnp.sum(hit.astype(jnp.int32), axis=0)

    acc = jax.lax.fori_loop(0, nc_ref[0], body,
                            jnp.zeros((bt,), jnp.int32))
    out_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("interpret",))
def count_triton(fp, pos, fpr, mask, interpret: bool = False):
    """int32 [R, bins_padded] per-bin hit counts (probe.count_xla
    contract).  Bin tiles are the largest power of two <= 256 dividing
    the table width: 128 or 256 for the LANE-padded tables every search
    path uploads."""
    S, B = fp.shape
    R, H, _ = pos.shape
    bt = min(256, B & -B)
    hpad = (-H) % _CHUNK
    if hpad:
        pos = jnp.pad(pos, ((0, 0), (0, hpad), (0, 0)))
        fpr = jnp.pad(fpr, ((0, 0), (0, hpad)))
        mask = jnp.pad(mask, ((0, 0), (0, hpad)))
        H += hpad
    pos = jnp.where(mask[..., None], pos, 0)
    f = jnp.where(mask, fpr.astype(jnp.int32), 256)
    last = H - jnp.argmax(mask[:, ::-1], axis=1)
    n_valid = jnp.where(mask.any(axis=1), last, 0)
    nc = ((n_valid + _CHUNK - 1) // _CHUNK).astype(jnp.int32)
    row = pl.BlockSpec((None, H), lambda r, j: (r, 0))
    return pl.pallas_call(
        _probe_kernel,
        grid=(R, B // bt),
        in_specs=[
            pl.BlockSpec((1,), lambda r, j: (r,)),
            row, row, row, row,
            pl.BlockSpec((S, bt), lambda r, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((None, bt), lambda r, j: (r, j)),
        out_shape=jax.ShapeDtypeStruct((R, B), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4,
                                                num_stages=2),
        interpret=interpret,
        name="ixf_probe",
    )(nc, pos[..., 0], pos[..., 1], pos[..., 2], f, fp)

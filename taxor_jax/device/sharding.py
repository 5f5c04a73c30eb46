"""Multi-card sharding of the classification step.

The reference is single-process shared-memory (SURVEY.md §2.3); its only
parallelism is thread fan-out over reads.  Device mapping:

  - ``reads`` mesh axis (data parallel): read batches shard across cards;
    the analog of ``do_parallel`` chunking (src/hixf/search/do_parallel.hpp).
  - ``bins`` mesh axis (index parallel): each IXF's fingerprint matrix
    [slots, bins] shards column-wise, so a 113 GB GTDB-scale index spreads
    across the memory of several cards.  Every card probes its bin slice
    with the full (replicated) hash batch, then per-bin partial sums are
    combined with one collective — the distributed analog of the
    interleaved count (SURVEY.md §2.3 mapping).

Both axes compose in one 2-D mesh.  Probe positions index the UNsharded
slots axis, so sharding bins requires no communication during the gather
itself; the only collective is the tiny [R, bins] count exchange.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .probe import probe_counts, segment_runs


def host_view(x) -> np.ndarray:
    """Materialize a (possibly multi-process, globally sharded) device
    array on THIS host.  Single-process: plain np.asarray.  Multi-process
    (jax.distributed): an allgather over processes so every host sees the
    full result — the device->host boundary of the distributed search."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def make_mesh(n_reads_shards: int, n_bin_shards: int,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_reads_shards * n_bin_shards
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices, have {len(devices)}"
        )
    arr = np.array(devices[:n]).reshape(n_reads_shards, n_bin_shards)
    return Mesh(arr, ("reads", "bins"))


def shard_ixf(mesh: Mesh, fingerprints: np.ndarray) -> jax.Array:
    """Place a [slots, bins] fingerprint matrix column-sharded over the
    'bins' axis (replicated over 'reads')."""
    return jax.device_put(
        fingerprints, NamedSharding(mesh, P(None, "bins"))
    )


def sharded_count_fn(mesh: Mesh):
    """Build the jitted sharded count step.

    Inputs: fp [S, B] (bins-sharded), positions [R, H, 3], fprints [R, H],
    mask [R, H] (reads-sharded).  Output: counts [R, B] sharded over
    (reads, bins) — downstream jitted ops reshard as needed (XLA inserts
    the all_gather only where the consumer requires it).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "bins"), P("reads", None, None),
                  P("reads", None), P("reads", None)),
        out_specs=P("reads", "bins"),
        check_vma=False,
    )
    def step(fp_local, pos_local, fpr_local, mask_local):
        return probe_counts(fp_local, pos_local, fpr_local, mask_local)

    return jax.jit(step)


def sharded_e2e_fn(mesh: Mesh, k: int, s: int, t: int, hcap: int,
                   topk: int, scheme_kind: str = "syncmer", window: int = 0,
                   scale_thresh: int = 0):
    """The FULL fused search step (device/e2e.py) over the 2-D mesh —
    the multi-card configuration for flat indexes too large for one
    card's memory:

      1. extraction/dedup/wyhash shard over ALL devices (reads split
         across both mesh axes — every card extracts a distinct slice),
      2. one tiled ``all_gather`` over the 'bins' axis re-collects each
         reads-row group's hashes (hashes are ~50x smaller than the
         per-bin count matrix would be),
      3. every card probes its OWN bin shard of the fingerprint table,
      4. run sums contract over the sharded bins axis via ``psum``,
      5. top-k runs replicated within each reads row.

    Returns a jitted fn(fp, packed_reads, lengths, onehot, run_users,
    seed_hi, seed_lo, block_length) -> packed int32 [R, 2*topk+2] with
    the same layout as fused_e2e_step.  Caller pads: R to a reads*bins
    multiple, bins of fp/onehot to a LANE*bins multiple.
    """
    from ..utils.u64jnp import probe_positions_and_fprint
    from .e2e import extract_hashes, pack_topk

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, "bins"),          # fp [S, B]
            P(("reads", "bins"), None),  # packed reads [R, L/4]
            P(("reads", "bins")),     # lengths [R]
            P("bins", None),          # onehot [B, n_runs]
            P(),                      # run_users [n_runs] replicated
            P(), P(), P(),            # seed_hi, seed_lo, block_length
        ),
        out_specs=P("reads", None),
        check_vma=False,
    )
    def step(fp_local, packed_local, len_local, onehot_local, run_users,
             seed_hi, seed_lo, block_length):
        hi, lo, valid, n_unique, n_emit = extract_hashes(
            packed_local, len_local, k, s, t, hcap, scheme_kind, window,
            scale_thresh)
        # re-collect the reads row of this bins group (tiled: concat)
        gather = lambda x: jax.lax.all_gather(  # noqa: E731
            x, "bins", axis=0, tiled=True)
        hi, lo, valid = gather(hi), gather(lo), gather(valid)
        n_unique, n_emit = gather(n_unique), gather(n_emit)
        pos, fpr = probe_positions_and_fprint(hi, lo, seed_hi, seed_lo,
                                              block_length)
        counts = probe_counts(fp_local, pos, fpr, valid)
        sums = jax.lax.psum(segment_runs(counts, onehot_local), "bins")
        vs = jnp.where((run_users >= 0)[None, :], sums, jnp.int32(-1))
        return pack_topk(vs, run_users, topk, n_unique, n_emit)

    return jax.jit(step)


def sharded_hixf_e2e_fn(mesh: Mesh, groups_meta, k: int, s: int,
                        t: int, hcap: int, topk: int,
                        scheme_kind: str = "syncmer", window: int = 0,
                        scale_thresh: int = 0,
                        descend_all: bool = False,
                        from_hashes: bool = False):
    """HIERARCHICAL fused search over the (reads x bins) mesh with
    LEVEL-GROUPED probing — the multi-card configuration for multi-level
    indexes too large for one card's memory (SURVEY.md §7 "shard within
    levels").

    Sharding every level's bins evenly over the 'bins' axis is the
    slot-count-balanced layout: each card holds 1/nb of every level's
    fingerprint volume.  IXFs sharing (depth, seed, block_length) probe
    as one call per card (see e2e.make_hixf_e2e_grouped_fn); the
    per-group partial run sums contract over 'bins' with one psum,
    descent masks derive from the (replicated) merged-run sums —
    bit-identical to the single-device grouped step.

    groups_meta: ordered list (ancestors before descendants) of member
    lists [(bfs_pos, run_off, n_runs, children [(local_run, child_pos)],
    leaf_sel np.int32 of group-run indices)].

    Returns a jitted fn(fps, onehots, packed_reads, lengths, thr_table,
    leaf_users, seeds_hi, seeds_lo, bls) -> packed int32 [R, 2*topk+2]
    (fused_e2e_step layout).  fps/onehots are per-GROUP tuples of
    bins-sharded arrays; seeds/bls are [n_groups] replicated vectors.
    With from_hashes the fn takes host-extracted hashes instead of
    (packed_reads, lengths): fn(fps, onehots, batch, thr_table, ...)
    with batch the replicated probe.pack_hash_lists upload.

    descend_all: the length-dependent-threshold mode (fracminhash) —
    probe every level unconditionally and return
    [R, 3*topk+2] = [chain-min | leaf sums | users | n_unique | n_emit];
    see e2e.make_hixf_e2e_grouped_fn for the emission equivalence.
    """
    from ..utils.u64jnp import probe_positions_and_fprint
    from .e2e import (descend, descent_tables, extract_hashes,
                      init_descent, n_tree_nodes, pack_topk)
    from .probe import unpack_batch

    n_groups = len(groups_meta)
    tables = [descent_tables(members) for members in groups_meta]
    n_nodes = n_tree_nodes(tables)

    def tree(fps, onehots, hi, lo, valid, n_unique, n_emit, thr_table,
             leaf_users, seeds_hi, seeds_lo, bls):
        thr = thr_table[jnp.clip(n_unique, 0, thr_table.shape[0] - 1)]
        act, chain = init_descent(hi.shape[0], n_nodes)
        leaf_vals = []
        leaf_sums = []
        for gi, tab in enumerate(tables):
            mask = valid
            if not descend_all:
                mask = mask & act[:, tab["mpos"]].any(axis=1)[:, None]
            pos, fpr = probe_positions_and_fprint(
                hi, lo, seeds_hi[gi], seeds_lo[gi], bls[gi])
            counts = probe_counts(fps[gi], pos, fpr, mask)
            sums = jax.lax.psum(segment_runs(counts, onehots[gi]), "bins")
            act, chain = descend(tab, sums, descend_all, act, chain, thr,
                                 leaf_vals, leaf_sums)
        allv = jnp.concatenate(leaf_vals, axis=1)
        alls = jnp.concatenate(leaf_sums, axis=1) if descend_all else None
        return pack_topk(allv, leaf_users, topk, n_unique, n_emit, alls)

    tables_specs = (tuple(P(None, "bins") for _ in range(n_groups)),  # fps
                    tuple(P("bins", None) for _ in range(n_groups)))
    # thr_table, leaf_users, seeds_hi/seeds_lo/bls [n_groups]: replicated
    tail_specs = (P(), P(), P(), P(), P())

    if from_hashes:
        # the batch is replicated: every card probes its bins shard for
        # all reads, and the result comes out replicated
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=tables_specs + (P(),) + tail_specs,
            out_specs=P(), check_vma=False)
        def step_hashes(fps, onehots, batch, *tail):
            hi, lo, valid = unpack_batch(batch)
            n = valid.sum(axis=1, dtype=jnp.int32)
            return tree(fps, onehots, hi, lo, valid, n, n, *tail)

        return jax.jit(step_hashes)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=tables_specs + (
            P(("reads", "bins"), None),  # packed reads [R, L/4]
            P(("reads", "bins")),        # lengths [R]
        ) + tail_specs,
        out_specs=P("reads", None),
        check_vma=False,
    )
    def step(fps, onehots, packed_local, len_local, *tail):
        hi, lo, valid, n_unique, n_emit = extract_hashes(
            packed_local, len_local, k, s, t, hcap, scheme_kind, window,
            scale_thresh)
        gather = lambda x: jax.lax.all_gather(  # noqa: E731
            x, "bins", axis=0, tiled=True)
        return tree(fps, onehots, gather(hi), gather(lo), gather(valid),
                    gather(n_unique), gather(n_emit), *tail)

    return jax.jit(step)


def sharded_search_step_fn(mesh: Mesh):
    """Full classification step over the mesh: probe (bins-sharded) ->
    all_gather counts -> user-bin run sums (one-hot matmul) -> threshold
    compare.  Returns (run_sums [R, n_runs], emitted [R, n_runs])."""

    count = sharded_count_fn(mesh)

    @jax.jit
    def step(fp, pos, fpr, mask, run_onehot, thresholds):
        sums = segment_runs(count(fp, pos, fpr, mask), run_onehot)
        emitted = sums >= thresholds[:, None]
        return sums, emitted

    return step

"""Fully-fused on-device search step: packed reads in, top-k bins out.

One jitted graph per (R, L, hcap) shape bucket:

    2-bit packed reads --> hash extraction (extract_hashes)
      --> probe positions (u64 limb math) --> probe_counts
      --> run segmentation --> top-k raw sums + per-read unique-hash count

The host uploads ~L/4 bytes per read and downloads 2k+2 int32 per read;
thresholds and the exact float64 0.8*max rule stay on the host (decode),
so no device float math can perturb output parity.  Top-k is taken on RAW
sums — the thresholded candidate set is always a subset, so host-side
filtering plus the truncation fallback reproduces the reference emission
set exactly (see search/pipeline._pairs_from_e2e).

The single-device steps here and the mesh steps in sharding.py share
extract_hashes, probe_counts, the descent bookkeeping (descent_tables,
init_descent, descend) and pack_topk.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..hash.device_syncmer import (dedup_kmers, emission_min_gap,
                                   minimizer_kmers, syncmer_kmers)
from ..utils.u64jnp import probe_positions_and_fprint, wyhash64
from .probe import probe_counts, segment_runs, unpack_batch


def _scaling_keep(hi, lo, scale_thresh: int):
    """keep mask for FracMinHash scaling: wyhash64(h) <= T as a uint32
    pair compare (T = schemes.scaling_threshold_u64, the exact integer
    form of the reference's double comparison)."""
    vhi, vlo = wyhash64(hi, lo)
    thi = jnp.uint32(scale_thresh >> 32)
    tlo = jnp.uint32(scale_thresh & 0xFFFFFFFF)
    return (vhi < thi) | ((vhi == thi) & (vlo <= tlo))


def extract_hashes(packed_reads, lengths, k: int, s: int, t: int,
                   hcap: int, scheme_kind: str, window: int,
                   scale_thresh: int):
    """The device extractor: (hi, lo, valid, n_unique, n_emit).

    syncmer: open-syncmer k-mers (exact stateful tracker), sort-dedup on
    raw k-mers, wyhash64 of the [R, hcap] slice; n_emit is the pre-dedup
    emission count (> hcap => host fallback).  minimizer / plain k-mer:
    values probe directly, no wyhash, duplicates kept (vector semantics).
    scale_thresh > 0 applies the exact-integer FracMinHash filter."""
    if scheme_kind == "syncmer":
        k_hi, k_lo, emit = syncmer_kmers(packed_reads, lengths, k, s, t)
        khi_c, klo_c, valid, n_unique, n_emit = dedup_kmers(
            k_hi, k_lo, emit, hcap, emission_min_gap(k, s, t))
        hi, lo = wyhash64(khi_c, klo_c)
    else:
        hi, lo, valid, n_emit = minimizer_kmers(packed_reads, lengths, k,
                                                window)
        n_unique = n_emit
    if scale_thresh:
        valid = valid & _scaling_keep(hi, lo, scale_thresh)
        n_unique = valid.sum(axis=1, dtype=jnp.int32)
    return hi, lo, valid, n_unique, n_emit


def descent_tables(members) -> dict:
    """Index arrays (host numpy) that turn one probe group's member list
    [(bfs_pos, run_off, n_runs, children [(local_run, child_pos)],
    leaf_sel)] into a few gathers over the whole group: the graph then
    grows with the number of groups, not with the number of IXFs."""
    kids = [(run_off + local_run, m, child_pos)
            for m, (_, run_off, _, children, _) in enumerate(members)
            for local_run, child_pos in children]
    leaves = [(col, m) for m, member in enumerate(members)
              for col in member[4].tolist()]
    i32 = lambda xs: np.array(xs, dtype=np.int32).reshape(-1)  # noqa: E731
    return dict(
        mpos=i32([m[0] for m in members]),
        kid_cols=i32([c for c, _, _ in kids]),
        kid_member=i32([m for _, m, _ in kids]),
        kid_pos=i32([p for _, _, p in kids]),
        leaf_cols=i32([c for c, _ in leaves]),
        leaf_member=i32([m for _, m in leaves]))


def n_tree_nodes(tables) -> int:
    """Columns of the descent state: one per IXF (BFS position)."""
    return 1 + max(int(x.max()) for tab in tables
                   for x in (tab["mpos"], tab["kid_pos"]) if x.size)


def init_descent(R: int, n_nodes: int):
    """(act, chain): act bool [R, n_nodes + 1], True for the root and
    False in the last column (the padding target of stacked subgroups);
    chain int32 [R, n_nodes], the ancestor minimum of descend-all mode."""
    act = jnp.zeros((R, n_nodes + 1), dtype=bool).at[:, 0].set(True)
    chain = jnp.full((R, n_nodes), jnp.int32(2**30))
    return act, chain


def descend(tab, sums, descend_all, act, chain, thr, leaf_vals,
            leaf_sums):
    """Descent bookkeeping for one probe group from its run sums: child
    activation (or chain-min propagation in descend-all mode) and
    leaf-run emission.  Returns the updated (act, chain)."""
    kids = tab["kid_cols"].size > 0
    leaves = tab["leaf_cols"].size > 0
    if descend_all:
        ch = chain[:, tab["mpos"]]
        if kids:
            chain = chain.at[:, tab["kid_pos"]].set(
                jnp.minimum(ch[:, tab["kid_member"]],
                            sums[:, tab["kid_cols"]]),
                unique_indices=True)
        if leaves:
            ls = sums[:, tab["leaf_cols"]]
            leaf_sums.append(ls)
            leaf_vals.append(jnp.minimum(ch[:, tab["leaf_member"]], ls))
        return act, chain
    am = act[:, tab["mpos"]]
    if kids:
        act = act.at[:, tab["kid_pos"]].set(
            am[:, tab["kid_member"]]
            & (sums[:, tab["kid_cols"]] >= thr[:, None]),
            unique_indices=True)
    if leaves:
        leaf_vals.append(jnp.where(am[:, tab["leaf_member"]],
                                   sums[:, tab["leaf_cols"]],
                                   jnp.int32(-1)))
    return act, chain


def pack_topk(allv, col_users, topk: int, n_unique, n_emit, alls=None):
    """Top-k of the candidate columns -> packed int32
    [R, 2*topk + 2] = [vals | users | n_unique | n_emit], or with alls
    (descend-all mode) [R, 3*topk + 2] = [vals | their alls | users |
    n_unique | n_emit].  Columns with vals < 0 and padding report -1."""
    kk = min(topk, allv.shape[1])
    vals, idx = jax.lax.top_k(allv, kk)
    users = jnp.asarray(col_users)[idx]
    users = jnp.where(vals >= 0, users, jnp.int32(-1))
    parts = [vals]
    if alls is not None:
        parts.append(jnp.take_along_axis(alls, idx, axis=1))
    parts.append(users)
    if kk < topk:
        pad = ((0, 0), (0, topk - kk))
        parts = [jnp.pad(p, pad, constant_values=-1) for p in parts]
    return jnp.concatenate(
        parts + [n_unique[:, None], n_emit[:, None]], axis=1)


def make_hixf_e2e_grouped_fn(groups, leaf_users, k: int, s: int, t: int,
                             topk: int, scheme_kind: str = "syncmer",
                             window: int = 0,
                             scale_thresh: int = 0,
                             descend_all: bool = False,
                             from_hashes: bool = False):
    """Fused hierarchical search with LEVEL-GROUPED probing.

    The returned jitted fn takes 2-bit packed reads,
    run(packed_reads, lengths, thr_table, fps, onehots, hcap=...), or
    with from_hashes host-extracted hashes (reads beyond the device
    extractor's length cap, schemes it does not cover),
    run(batch, thr_table, fps, onehots) with batch the uint32
    [R, 3H] probe.pack_hash_lists upload; n_unique = n_emit = the valid
    slots, and the extraction arguments are unused.  Either way the
    whole tree is one graph per input shape.

    IXFs sharing (seed, block_length) — which the builder's uniform level
    geometry guarantees per tree depth (hixf/build.py) — concatenate
    their fingerprint tables column-wise and probe as ONE probe call:
    probe positions are a function of (hash, seed, block_length) only,
    so one [R, H] position set covers the whole group.  A read is
    probe-active for the group when active in ANY member; the per-member
    active masks still gate descent and leaf emission, so the result is
    bit-identical to per-IXF probing.

    groups: ordered list (ancestors strictly before descendants) of
      dicts with keys seed_hi/seed_lo/bl (NUMPY u32 scalars), poskey,
      stacked/runs_max/sub_members (stacked subgroups, see
      DeviceHIXF._stack_host_groups), members: list of
      (bfs_pos, run_off, n_runs, children [(local_run, child_bfs_pos)],
       leaf_sel NUMPY int32 array of GLOBAL run indices within the
       group's sums).
    leaf_users: NUMPY int32, user bin per concatenated leaf column in
      group/member order.  Small metadata stays host numpy: numpy
      constants embed in the HLO with no device traffic.

    The per-group fingerprint tables and one-hots are ARGUMENTS of the
    returned fn (tuples `fps` / `onehots`), NOT closure captures: a
    captured table would be lowered into the HLO as a constant.

    descend_all: length-dependent threshold models (fracminhash,
      taxor_search.cpp:263 + fracminhash_model.cpp:23-33) cannot use the
      count-indexed descent table.  But the reference's descent and
      emission thresholds are the SAME per-read value tau, so
      ``emit(leaf) <=> min(leaf_sum, ancestor merged sums) >= tau``.
      With descend_all the step probes every level unconditionally,
      carries that chain-min per leaf, and returns packed
      [R, 3*topk + 2]: [minv_k desc | their leaf sums | user bins |
      n_unique | n_emit].  The host applies the exact float64 tau to
      minv and reports the leaf sums — bit-identical emissions with no
      device float math (thr_table is ignored in this mode).
    """

    tables = [descent_tables(g["members"]) for g in groups]
    n_nodes = n_tree_nodes(tables)
    # stacked subgroups: [G, max members] BFS positions, padded with the
    # always-False column n_nodes
    sub_idx = {}
    for gi, g in enumerate(groups):
        if g.get("stacked"):
            subs = g["sub_members"]
            width = max(len(m) for m in subs)
            sub_idx[gi] = np.array(
                [list(m) + [n_nodes] * (width - len(m)) for m in subs],
                dtype=np.int32)

    def tree(hi, lo, valid, n_unique, n_emit, thr_table, fps, onehots):
        R = hi.shape[0]
        thr = thr_table[jnp.clip(n_unique, 0, thr_table.shape[0] - 1)]
        act, chain = init_descent(R, n_nodes)
        leaf_vals = []
        leaf_sums = []
        poscache: dict = {}  # (seed, bl) -> (pos, fpr): subgroups of
        # one level share the position set (trace-time reuse)
        for gi, (g, tab) in enumerate(zip(groups, tables)):
            cached = poscache.get(g["poskey"])
            if cached is None:
                cached = poscache[g["poskey"]] = probe_positions_and_fprint(
                    hi, lo, g["seed_hi"], g["seed_lo"], g["bl"])
            pos, fpr = cached
            if g.get("stacked"):
                # same-geometry subgroups (a split level) probe as ONE
                # lax.scan over the stacked [G, S, B] tables: one
                # compiled probe per level geometry, not per subgroup.
                # Each scan step keeps its own subgroup's member-OR
                # activity mask, so results are bit-identical to the
                # unstacked per-group calls.
                G = g["stacked"]
                if descend_all:
                    act_mat = jnp.ones((G, R), dtype=bool)
                else:
                    act_mat = act[:, sub_idx[gi]].any(axis=2).T

                def body(carry, xs):
                    fp_g, oh_g, act_g = xs
                    counts = probe_counts(fp_g, pos, fpr,
                                          valid & act_g[:, None])
                    return carry, segment_runs(counts, oh_g)

                _, sums_stack = jax.lax.scan(
                    body, 0, (fps[gi], onehots[gi], act_mat))
                # [G, R, runs_max] -> [R, G*runs_max]: member run
                # offsets were re-based to g*runs_max at stacking time
                sums = sums_stack.transpose(1, 0, 2).reshape(
                    R, G * g["runs_max"])
            else:
                mask = valid
                if not descend_all:
                    mask = mask & act[:, tab["mpos"]].any(axis=1)[:, None]
                counts = probe_counts(fps[gi], pos, fpr, mask)
                sums = segment_runs(counts, onehots[gi])
            act, chain = descend(tab, sums, descend_all, act, chain, thr,
                                 leaf_vals, leaf_sums)
        allv = jnp.concatenate(leaf_vals, axis=1)
        alls = jnp.concatenate(leaf_sums, axis=1) if descend_all else None
        return pack_topk(allv, leaf_users, topk, n_unique, n_emit, alls)

    if from_hashes:
        @jax.jit
        def run_hashes(batch, thr_table, fps, onehots):
            hi, lo, valid = unpack_batch(batch)
            n = valid.sum(axis=1, dtype=jnp.int32)
            return tree(hi, lo, valid, n, n, thr_table, fps, onehots)

        return run_hashes

    @functools.partial(jax.jit, static_argnames=("hcap",))
    def run(packed_reads, lengths, thr_table, fps, onehots, hcap: int):
        return tree(*extract_hashes(packed_reads, lengths, k, s, t, hcap,
                                    scheme_kind, window, scale_thresh),
                    thr_table, fps, onehots)

    return run


@functools.partial(
    jax.jit,
    static_argnames=("k", "s", "t", "hcap", "topk", "scheme_kind",
                     "window", "scale_thresh", "prefix_runs"),
)
def fused_e2e_step(
    fp,  # uint8 [S, bins_padded] (probe.pad_fingerprints)
    raw_reads,  # uint8 [R, L/4] 2-bit packed (pack_reads)
    lengths,  # int32 [R]
    onehot,  # float32 [bins_padded, n_runs]
    run_users,  # int32 [n_runs], -1 for merged runs
    seed_hi,  # uint32 scalar
    seed_lo,  # uint32 scalar
    block_length,  # uint32 scalar
    *,
    k: int,
    s: int,
    t: int,
    hcap: int,
    topk: int,
    scheme_kind: str = "syncmer",
    window: int = 0,
    scale_thresh: int = 0,
    prefix_runs: int = 0,
):
    """Returns packed int32 [R, 2*topk + 2]:
    [:, :topk] descending raw run sums, [:, topk:2*topk] their user bins
    (-1 for merged/padding), [:, -2] the per-read hash count (unique for
    syncmers, emitted-vector size for minimizers/k-mers), [:, -1] the
    pre-dedup emission count (> hcap => host fallback; the minimizer
    path never truncates — its hash width IS the read length).
    prefix_runs (static): unit runs at identity positions — the
    segmentation is a column slice."""
    hi, lo, valid, n_unique, n_emit = extract_hashes(
        raw_reads, lengths, k, s, t, hcap, scheme_kind, window,
        scale_thresh)
    pos, fpr = probe_positions_and_fprint(hi, lo, seed_hi, seed_lo,
                                          block_length)
    counts = probe_counts(fp, pos, fpr, valid)
    if prefix_runs:
        sums = counts[:, :prefix_runs]
    else:
        sums = segment_runs(counts, onehot)
    vs = jnp.where((run_users >= 0)[None, :], sums, jnp.int32(-1))
    return pack_topk(vs, run_users, topk, n_unique, n_emit)

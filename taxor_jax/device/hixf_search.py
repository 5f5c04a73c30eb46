"""Level-synchronous HIXF traversal on device.

The reference recurses per read through the IXF tree
(bulk_contains_impl, hierarchical_interleaved_xor_filter.hpp:304-340).
Device formulation: evaluate the tree breadth-first; for each level run
ONE batched probe over all reads, masked by a per-read "active" vector
derived from the parent merged-bin sums.  Per-bin counts are
segment-summed into user-bin runs with a one-hot matmul; descent
decisions and final per-user-bin assembly are cheap [R, runs]
reductions.

Dispatch routes, all over the one probe (device/probe.py):
  - e2e_async: the fused step, 2-bit packed reads in, top-k out, on one
    device or over a (reads x bins) mesh;
  - hashes_async: the same tree step from host-extracted hashes (reads
    beyond the device extractor's length cap, schemes it does not
    cover);
  - topk_async_packed: host-extracted hashes on a flat index on one
    device.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..hixf.container import HIXF
from .probe import (LANE, finalize_topk, pad_bins, pad_fingerprints,
                    probe_step)

# packed width (bins) a probe group of one tree level may span before it
# splits at member boundaries: each subgroup probes with ITS members'
# activity OR, so a read descending one subtree skips the others
MAX_GROUP_BINS = 512


@dataclass
class _DeviceIXF:
    """Per-IXF device state.  The table and one-hot upload lazily on
    first touch: the fused hierarchical step builds its own level-grouped
    tables from the host arrays."""

    fingerprints: np.ndarray  # uint8 [S, bins] host table
    seed: int
    block_length: int
    onehot_host: np.ndarray  # float32 [bins_padded, n_runs]
    run_users: np.ndarray  # int64 [n_runs], -1 for merged runs
    run_children: np.ndarray  # int64 [n_runs], child ixf id for merged runs
    lane: int = LANE
    # n_runs when every run is one technical bin at its own index
    # (flat indexes): the segmentation matmul is then a column slice
    prefix_runs: int = 0
    # geometry scalars (numpy: they embed as literals when traced)
    seed_hi: np.uint32 | None = None
    seed_lo: np.uint32 | None = None
    bl_u32: np.uint32 | None = None
    mesh: object | None = None
    _fp_dev: object | None = None
    _onehot_dev: object | None = None
    _run_users_dev: object | None = None

    def _put(self, x, spec):
        if self.mesh is None:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding

        return jax.device_put(x, NamedSharding(self.mesh, spec))

    @property
    def fp(self):
        if self._fp_dev is None:
            from jax.sharding import PartitionSpec as P

            self._fp_dev = self._put(
                pad_fingerprints(self.fingerprints, self.lane),
                P(None, "bins"))
        return self._fp_dev

    @property
    def run_onehot(self):
        if self._onehot_dev is None:
            from jax.sharding import PartitionSpec as P

            self._onehot_dev = self._put(self.onehot_host, P("bins", None))
        return self._onehot_dev

    @property
    def run_users_dev(self):
        if self._run_users_dev is None:
            self._run_users_dev = jnp.asarray(
                self.run_users.astype(np.int32))
        return self._run_users_dev


def _scale_thresh(scheme) -> int:
    """Static FracMinHash keep-threshold for the device filter; 0 means
    no downsampling (see schemes.scaling_threshold_u64)."""
    if scheme.scaling <= 1:
        return 0
    from ..hash.schemes import scaling_threshold_u64

    return scaling_threshold_u64(scheme.scaling)


def _extract_kwargs(scheme) -> dict:
    """Static extraction arguments of the fused steps for a scheme."""
    return dict(k=scheme.kmer_size, s=scheme.syncmer_size,
                t=scheme.t_syncmer,
                scheme_kind="syncmer" if scheme.use_syncmer else "minimizer",
                window=scheme.window_size,
                scale_thresh=_scale_thresh(scheme))


# threshold models that depend on the hash count only — these descend
# with the exact count-indexed device table.  Everything else
# (fracminhash: count AND read length, taxor_search.cpp:263) uses the
# descend-all chain-min mode (e2e.make_hixf_e2e_grouped_fn docstring).
COUNT_ONLY_KINDS = ("percentage", "syncmer_model", "kmer_model")


def _descend_all(thresholder) -> bool:
    return thresholder is not None and \
        thresholder.kind not in COUNT_ONLY_KINDS


def _collector(packed_dev, n_reads: int, k: int, hcap: int,
               descend_all: bool):
    """Start the device->host copy now, decode the packed top-k result
    when the collector is called: (vals, users, counts, n_emit, hcap)
    plus the leaf sums in descend-all mode."""
    packed_dev.copy_to_host_async()

    def collect():
        from .sharding import host_view

        packed = host_view(packed_dev)[:n_reads]
        if descend_all:  # [minv | leaf sums | users | n_unique | n_emit]
            return (packed[:, :k], packed[:, 2 * k : 3 * k],
                    packed[:, 3 * k], packed[:, 3 * k + 1],
                    hcap, packed[:, k : 2 * k])
        return (packed[:, :k], packed[:, k : 2 * k], packed[:, 2 * k],
                packed[:, 2 * k + 1], hcap)

    return collect


class DeviceHIXF:
    """Device-resident HIXF with BFS traversal metadata."""

    def __init__(self, hixf: HIXF, mesh=None):
        """mesh: optional jax.sharding.Mesh with axes ('reads', 'bins').
        When given, fingerprint tables are placed bin-sharded (bins
        padded to whole LANE tiles per shard) and the fused steps run
        under shard_map (device/sharding.py)."""
        self.mesh = mesh
        self.hixf = hixf
        self.num_user_bins = hixf.num_user_bins
        lane = LANE * (mesh.shape["bins"] if mesh is not None else 1)
        self.ixfs: list[_DeviceIXF] = []
        for i, ixf in enumerate(hixf.ixfs):
            starts, ends, users = hixf.runs_of_ixf(i)
            bins_padded = pad_bins(ixf.fingerprints.shape[1], lane)
            n_runs = starts.shape[0]
            prefix_runs = (
                n_runs if (np.array_equal(starts, np.arange(n_runs))
                           and np.array_equal(ends, starts + 1)) else 0)
            onehot = np.zeros((bins_padded, n_runs), dtype=np.float32)
            for r, (s, e) in enumerate(zip(starts, ends)):
                onehot[s:e, r] = 1.0
            children = np.array(
                [
                    int(hixf.next_ixf_id[i][int(s)]) if u < 0 else -1
                    for s, u in zip(starts, users)
                ],
                dtype=np.int64,
            )
            self.ixfs.append(
                _DeviceIXF(
                    fingerprints=ixf.fingerprints,
                    seed=ixf.seed,
                    block_length=ixf.block_length,
                    onehot_host=onehot,
                    run_users=users,
                    run_children=children,
                    lane=lane,
                    prefix_runs=prefix_runs,
                    seed_hi=np.uint32(ixf.seed >> 32),
                    seed_lo=np.uint32(ixf.seed & 0xFFFFFFFF),
                    bl_u32=np.uint32(ixf.block_length),
                    mesh=mesh,
                )
            )
        # BFS order from root (index 0); children discovered via run_children
        order: list[int] = [0]
        seen = {0}
        q = [0]
        while q:
            cur = q.pop(0)
            for child in self.ixfs[cur].run_children:
                c = int(child)
                if c >= 0 and c not in seen:
                    seen.add(c)
                    order.append(c)
                    q.append(c)
        self.bfs_order = order
        # parent link: (parent_ixf, run_index_in_parent) per ixf
        self.parent: dict[int, tuple[int, int]] = {}
        for i in order:
            for r, c in enumerate(self.ixfs[i].run_children):
                if int(c) >= 0:
                    self.parent[int(c)] = (i, r)
        self._fns: dict = {}
        self._thr_tables: dict = {}
        self._groups = None

    def _all_active(self, n: int):
        """Cached all-ones active mask (saves one upload per batch)."""
        key = ("active", n)
        if key not in self._fns:
            self._fns[key] = jnp.asarray(np.ones(n, dtype=bool))
        return self._fns[key]

    @property
    def flat_fast_path(self) -> bool:
        """True when the compact top-k dispatch applies: one IXF, no
        mesh."""
        return len(self.ixfs) == 1 and self.mesh is None

    def topk_async_packed(self, batch: np.ndarray, n_reads: int,
                          thresholds, k: int = 16):
        """Compact dispatch for flat single-IXF indexes from the packed
        [Rpad, 3*Hpad] uint32 batch (pack_hash_lists):
        device-side threshold + top-k bin compaction (finalize_topk), so
        only [R, 2k] int32 return.  Returns a zero-arg collector yielding
        (vals, users) int32 [R, k]."""
        dixf = self.ixfs[0]
        Rp = batch.shape[0]
        thr = np.zeros(Rp, dtype=np.int32)
        thr[: len(thresholds)] = np.minimum(
            np.asarray(thresholds, dtype=np.int64), 2**31 - 1)
        sums_dev = probe_step(
            dixf.fp, jnp.asarray(batch), self._all_active(Rp),
            dixf.run_onehot, dixf.seed_hi, dixf.seed_lo, dixf.bl_u32,
            prefix_runs=dixf.prefix_runs)
        packed_dev = finalize_topk(sums_dev, jnp.asarray(thr),
                                   dixf.run_users_dev, k)
        packed_dev.copy_to_host_async()

        def collect():
            packed = np.asarray(packed_dev)[:n_reads]
            return packed[:, :k], packed[:, k:]

        return collect

    def e2e_capable(self, thresholder=None) -> bool:
        """Whether the fused reads->top-k dispatch covers this index, on
        one device or over a mesh: flat always qualifies (thresholds
        applied on host); hierarchical needs a thresholder — count-only
        models (percentage / syncmer / kmer) descend with the exact
        per-count device table, length-dependent models (fracminhash)
        use the descend-all chain-min mode.  The caller also checks that
        the device extractor covers the scheme."""
        return len(self.ixfs) == 1 or thresholder is not None

    def _thr_table(self, thresholder, hcap: int) -> np.ndarray:
        """Exact per-hash-count descent thresholds, computed on host with
        the reference's float64 semantics and uploaded once.  Count-only
        models (percentage / syncmer) ignore the scaling argument."""
        tbl = np.empty(hcap + 1, dtype=np.int64)
        for c in range(hcap + 1):
            # clamp before the int64 store: size_t-wrapped "impossible"
            # thresholds are >= 2^63 and overflow np.int64
            tbl[c] = min(thresholder.get(c, 0.0), 2**31 - 1)
        return np.clip(tbl, 0, 2**31 - 1).astype(np.int32)

    def _thr_table_dev(self, thresholder, hcap: int, descend_all: bool):
        # descend-all ignores the table; an all-zero placeholder keeps
        # the fn signature (and avoids evaluating the length-dependent
        # model at a meaningless fixed length)
        key = ("zeros", hcap) if descend_all else (id(thresholder), hcap)
        if key not in self._thr_tables:
            self._thr_tables[key] = jnp.asarray(
                np.zeros(hcap + 1, dtype=np.int32) if descend_all
                else self._thr_table(thresholder, hcap))
        return self._thr_tables[key]

    def _depths(self) -> dict[int, int]:
        """ixf id -> tree depth (root = 0) via the parent links."""
        depths = {0: 0}
        for i in self.bfs_order[1:]:
            depths[i] = depths[self.parent[i][0]] + 1
        return depths

    @staticmethod
    def _stack_host_groups(host_groups):
        """Stack runs of consecutive probe groups that share
        (poskey, fp shape) into ONE group with fp [G, S, B] /
        onehot [G, B, runs_max] and members re-offset to run index
        g*runs_max + r.  The fused step lax.scans the probe over the G
        axis, so the executable holds ONE probe per level geometry
        instead of one per subgroup.  Bit-equality: each scan step probes
        with its own subgroup's member-OR activity mask, exactly like
        the unstacked calls."""
        out = []
        i = 0
        while i < len(host_groups):
            g = host_groups[i]
            key = (g["poskey"], g["fp"].shape)
            j = i + 1
            while (j < len(host_groups)
                   and (host_groups[j]["poskey"],
                        host_groups[j]["fp"].shape) == key):
                j += 1
            if j - i > 1:
                sub = host_groups[i:j]
                G = len(sub)
                runs_max = max(s["onehot"].shape[1] for s in sub)
                fp = np.stack([s["fp"] for s in sub])
                onehot = np.zeros((G, fp.shape[2], runs_max),
                                  dtype=np.float32)
                members = []
                sub_members = []
                for gi, s in enumerate(sub):
                    onehot[gi, :, : s["onehot"].shape[1]] = s["onehot"]
                    adj = gi * runs_max
                    for (bfs, run_off, n_runs, kids, leaf_sel) \
                            in s["members"]:
                        members.append((bfs, run_off + adj, n_runs, kids,
                                        leaf_sel + adj))
                    sub_members.append([m[0] for m in s["members"]])
                out.append(dict(
                    fp=fp, onehot=onehot, seed=g["seed"], bl=g["bl"],
                    poskey=g["poskey"], members=members,
                    stacked=G, runs_max=runs_max,
                    sub_members=sub_members))
                i = j
            else:
                out.append(g)
                i += 1
        return out

    def _build_probe_groups(self, col_multiple: int = LANE,
                            max_group_bins: int | None = None):
        """Assemble the level-grouped probe structure on the host.

        Groups IXFs by (depth, seed, block_length); member tables
        concatenate column-wise with no per-member padding and only the
        GROUP pads its bins to `col_multiple` (the mesh needs whole LANE
        tiles per bins shard).

        max_group_bins: split multi-member groups at member boundaries so
        each subgroup spans <= this many bins.  Each subgroup is probed
        with ITS members' activity OR — since a descending read is
        typically active in one subtree, it pays probe-row bytes for one
        narrow subgroup instead of the whole level.  Probe positions
        depend only on (seed, block_length), so subgroups share one
        position set — callers dedup via the `poskey` field.

        Returns (groups, leaf_users): groups are dicts of numpy
        fp uint8 [S, Bg], onehot float32 [Bg, runs], seed, bl, poskey,
        members [(bfs_pos, run_off, n_runs, children [(local_run,
        child_bfs_pos)], leaf_sel int32)].
        """
        bfs_pos = {ixf_id: p for p, ixf_id in enumerate(self.bfs_order)}
        depths = self._depths()
        group_key_order: list[tuple] = []
        group_members: dict[tuple, list[int]] = {}
        for i in self.bfs_order:
            ixf = self.hixf.ixfs[i]
            gk = (depths[i], ixf.seed, ixf.block_length)
            if gk not in group_members:
                group_members[gk] = []
                group_key_order.append(gk)
            group_members[gk].append(i)
        group_key_order.sort(key=lambda gk: gk[0])

        if max_group_bins is not None:
            # split member lists greedily by cumulative width
            split_order: list[tuple] = []
            split_members: dict[tuple, list[int]] = {}
            for gk in group_key_order:
                part: list[int] = []
                width = 0
                sub = 0
                for i in group_members[gk]:
                    b_i = self.hixf.ixfs[i].fingerprints.shape[1]
                    if part and width + b_i > max_group_bins:
                        k2 = gk + (sub,)
                        split_order.append(k2)
                        split_members[k2] = part
                        part, width, sub = [], 0, sub + 1
                    part.append(i)
                    width += b_i
                k2 = gk + (sub,)
                split_order.append(k2)
                split_members[k2] = part
            group_key_order = split_order
            group_members = split_members

        groups = []
        leaf_users_parts = []
        for gk in group_key_order:
            members_meta = []
            tables = []
            onehot_parts = []
            run_off = 0
            b_off = 0
            for i in group_members[gk]:
                fp = self.hixf.ixfs[i].fingerprints
                d = self.ixfs[i]
                tables.append((b_off, fp))
                starts, ends, users = self.hixf.runs_of_ixf(i)
                n_runs = starts.shape[0]
                onehot_parts.append((b_off, starts, ends))
                kids = []
                leaves = []
                for r, c in enumerate(d.run_children):
                    if int(c) >= 0:
                        kids.append((r, bfs_pos[int(c)]))
                    else:
                        leaves.append(run_off + r)
                leaf_users_parts.append(
                    users[users >= 0] if leaves else
                    np.zeros(0, dtype=np.int64))
                members_meta.append(
                    (bfs_pos[i], run_off, n_runs, kids,
                     np.array(leaves, dtype=np.int32)))
                run_off += n_runs
                b_off += fp.shape[1]
            # members share the level geometry, so slot counts agree;
            # the max is defensive (zero rows never match a probe)
            S = max(fp.shape[0] for _, fp in tables)
            width = pad_bins(b_off, col_multiple)
            # assemble into ONE preallocated buffer: member slot and
            # column padding fall out of the zero fill
            fp_group = np.zeros((S, width), dtype=np.uint8)
            for off, fp in tables:
                fp_group[: fp.shape[0], off : off + fp.shape[1]] = fp
            onehot = np.zeros((width, run_off), dtype=np.float32)
            roff = 0
            for off, starts, ends in onehot_parts:
                for r, (a, b) in enumerate(zip(starts, ends)):
                    onehot[off + a : off + b, roff + r] = 1.0
                roff += starts.shape[0]
            groups.append(dict(
                fp=fp_group, onehot=onehot, seed=gk[1], bl=gk[2],
                poskey=(gk[1], gk[2]), members=members_meta,
            ))
        leaf_users = np.concatenate(leaf_users_parts)
        return groups, leaf_users

    def _device_groups(self):
        """The level-grouped tables on device, built and uploaded once per
        index: (group metadata, fps, onehots, leaf_users).  On one device
        split levels stack (one probe per level geometry); on a mesh each
        group's bins shard over 'bins'."""
        if self._groups is not None:
            return self._groups
        if self.mesh is None:
            host_groups, leaf_users = self._build_probe_groups(
                max_group_bins=MAX_GROUP_BINS)
            host_groups = self._stack_host_groups(host_groups)
            fps = tuple(jnp.asarray(g["fp"]) for g in host_groups)
            onehots = tuple(jnp.asarray(g["onehot"]) for g in host_groups)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            host_groups, leaf_users = self._build_probe_groups(
                col_multiple=LANE * self.mesh.shape["bins"])
            fps = tuple(jax.device_put(
                g["fp"], NamedSharding(self.mesh, P(None, "bins")))
                for g in host_groups)
            onehots = tuple(jax.device_put(
                g["onehot"], NamedSharding(self.mesh, P("bins", None)))
                for g in host_groups)
        for g in host_groups:
            # the big arrays travel as fn ARGUMENTS (above); the small
            # per-member metadata stays numpy, which embeds as literals
            g.pop("fp")
            g.pop("onehot")
            g["seed_hi"] = np.uint32(g["seed"] >> 32)
            g["seed_lo"] = np.uint32(g["seed"] & 0xFFFFFFFF)
            g["bl"] = np.uint32(g["bl"])
        self._groups = (host_groups, fps, onehots,
                        leaf_users.astype(np.int32))
        return self._groups

    def _step_fn(self, scheme, k: int, hcap: int, descend_all: bool,
                 from_hashes: bool = False):
        """The cached fused step for this index, scheme, top-k width,
        input kind and (on a mesh, from reads) hash capacity."""
        kw = _extract_kwargs(scheme)
        key = ("e2e", tuple(sorted(kw.items())), k, descend_all,
               hcap if self.mesh is not None and not from_hashes else None,
               from_hashes)
        if key in self._fns:
            return self._fns[key]
        if self.mesh is not None:
            from .sharding import sharded_e2e_fn, sharded_hixf_e2e_fn

            if len(self.ixfs) == 1 and not from_hashes:
                fn = sharded_e2e_fn(self.mesh, hcap=hcap, topk=k, **kw)
            else:
                groups = self._device_groups()[0]
                fn = sharded_hixf_e2e_fn(
                    self.mesh, [g["members"] for g in groups], hcap=hcap,
                    topk=k, descend_all=descend_all,
                    from_hashes=from_hashes, **kw)
        else:
            from .e2e import make_hixf_e2e_grouped_fn

            groups, _, _, leaf_users = self._device_groups()
            fn = make_hixf_e2e_grouped_fn(groups, leaf_users, topk=k,
                                          descend_all=descend_all,
                                          from_hashes=from_hashes, **kw)
        self._fns[key] = fn
        return fn

    def _mesh_tail(self, leaf_users):
        """The replicated trailing arguments of the sharded tree steps."""
        groups = self._device_groups()[0]
        return (jnp.asarray(leaf_users),
                jnp.asarray(np.array([g["seed_hi"] for g in groups])),
                jnp.asarray(np.array([g["seed_lo"] for g in groups])),
                jnp.asarray(np.array([g["bl"] for g in groups])))

    def hashes_async(self, batch: np.ndarray, n_reads: int, scheme,
                     thresholder, k: int = 16):
        """The tree step from host-extracted hashes, on every index but a
        flat one on one device (topk_async_packed): reads beyond the
        device extractor's length cap and schemes it does not cover
        descend on device exactly like fused reads, in one graph per
        batch shape.

        batch: uint32 [Rpad, 3*Hpad] (probe.pack_hash_lists).  Returns
        the e2e_async collector; its hash capacity is Hpad, which no
        read exceeds, so only top-k truncation falls back to the host."""
        hcap = batch.shape[1] // 3
        # a flat index is a one-node tree here: descend-all (chain-min)
        # mode serves length-dependent thresholds on it too
        da = _descend_all(thresholder)
        _, fps, onehots, leaf_users = self._device_groups()
        fn = self._step_fn(scheme, k, hcap, da, from_hashes=True)
        thr = self._thr_table_dev(thresholder, hcap, da)
        b = jnp.asarray(batch)
        if self.mesh is None:
            packed_dev = fn(b, thr, fps, onehots)
        else:
            packed_dev = fn(fps, onehots, b, thr,
                            *self._mesh_tail(leaf_users))
        return _collector(packed_dev, n_reads, k, hcap, da)

    def e2e_async(self, raw_reads: np.ndarray, lengths: np.ndarray,
                  scheme, thresholder=None, k: int = 16):
        """Whole-search dispatch from 2-bit packed reads (device/e2e.py):
        extraction, dedup, probe, (hierarchical descent) and top-k all in
        one device graph, on one device or over the mesh.

        raw_reads: uint8 [R, L/4] 2-bit packed (device_syncmer.pack_reads)
        lengths:      int32 [R]
        Returns a collector -> (vals [R,k], users [R,k], counts [R],
        n_emit [R], hcap) — plus the leaf sums in descend-all mode;
        counts = unique hashes (threshold input), n_emit = pre-dedup
        emissions (n_emit > hcap => host fallback).
        Caller guarantees e2e_capable() and device_syncmer.supports()
        or supports_minimizer()."""
        from ..hash.device_syncmer import hash_cap
        from .e2e import fused_e2e_step

        R = raw_reads.shape[0]
        if self.mesh is not None:
            rows = self.mesh.shape["reads"] * self.mesh.shape["bins"]
            rpad = (-R) % rows
            if rpad:
                raw_reads = np.pad(raw_reads, ((0, rpad), (0, 0)))
                lengths = np.pad(lengths, (0, rpad))
        L = raw_reads.shape[1] * 4  # bases: 4 per packed byte
        hcap = hash_cap(L) if scheme.use_syncmer else L
        da = len(self.ixfs) > 1 and _descend_all(thresholder)
        reads = jnp.asarray(raw_reads)
        lens = jnp.asarray(lengths.astype(np.int32))
        if len(self.ixfs) > 1:
            _, fps, onehots, leaf_users = self._device_groups()
            fn = self._step_fn(scheme, k, hcap, da)
            thr = self._thr_table_dev(thresholder, hcap, da)
            if self.mesh is None:
                packed_dev = fn(reads, lens, thr, fps, onehots, hcap=hcap)
            else:
                packed_dev = fn(fps, onehots, reads, lens, thr,
                                *self._mesh_tail(leaf_users))
            return _collector(packed_dev, R, k, hcap, da)
        dixf = self.ixfs[0]
        args = (dixf.fp, reads, lens, dixf.run_onehot, dixf.run_users_dev,
                dixf.seed_hi, dixf.seed_lo, dixf.bl_u32)
        if self.mesh is None:
            packed_dev = fused_e2e_step(
                *args, hcap=hcap, topk=k, prefix_runs=dixf.prefix_runs,
                **_extract_kwargs(scheme))
        else:
            packed_dev = self._step_fn(scheme, k, hcap, False)(*args)
        return _collector(packed_dev, R, k, hcap, False)

"""The taxor-search pipeline: query reads against a TaxorIndex.

Replicates taxor::search (src/main/taxor_search.cpp:153-360):
  - reads processed in 1024-record chunks,
  - per read: hash extraction -> per-read threshold -> HIXF membership ->
    keep hits >= 0.8 * max count -> TSV rows,
  - output columns (taxor_search.cpp:268-307):
      #QUERY_NAME ACCESSION REFERENCE_NAME TAXID REF_LEN QUERY_LEN
      QHASH_COUNT QHASH_MATCH TAX_STR TAX_ID_STR
    no-hit rows are 6 columns: id, -, -, -, -, query_len,
  - multi query files x multi index files share one output + header
    (taxor_search.cpp:340-360).

Engines:
  - 'device': the fused device path on the JAX default backend (an
    NVIDIA GPU in production, the CPU in tests),
  - 'sharded': the same path over a (reads x bins) device mesh,
  - 'host': the numpy oracle recursion (bit-equal reference semantics,
    used for cross-checks).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..device.probe import pack_hash_lists
from ..hash.schemes import search_hashes
from ..hixf.index import TaxorIndex, load_index
from ..io.fastx import iter_fastx_chunks
from .thresholds import Thresholder


@dataclass
class SearchConfig:
    index_file: str = ""
    query_file: str = ""
    report_file: str = "search.out"
    threads: int = 1  # accepted for CLI parity; batching replaces threads
    percentage: float = -1.0
    error_rate: float = 0.04
    engine: str = "device"  # 'device' | 'host' | 'sharded'
    batch_size: int = 1024
    # batches in flight on worker threads, so host stages (pack, decode,
    # TSV formatting) of one batch overlap device work of another
    pipeline_depth: int = 4
    write_time: bool = False
    # sharded engine mesh ('reads' x 'bins'); 0 = auto over all devices
    mesh_reads: int = 0
    mesh_bins: int = 0
    topk: int = 16  # device candidate slots; auto-escalates on truncation
    profile_trace: str = ""  # jax.profiler trace directory


HEADER = (
    "#QUERY_NAME\tACCESSION\tREFERENCE_NAME\tTAXID\tREF_LEN\tQUERY_LEN\t"
    "QHASH_COUNT\tQHASH_MATCH\tTAX_STR\tTAX_ID_STR\n"
)


def _format_rows(
    rec_id: str,
    seq_len: int,
    hash_count: int,
    pairs: list[tuple[int, int]],
    index: TaxorIndex,
    ub2sp: dict[int, int],
) -> str:
    if not pairs:
        return f"{rec_id}\t-\t-\t-\t-\t{seq_len}\n"
    max_count = max(c for _, c in pairs)
    out = []
    for user_bin, count in pairs:
        if float(count) < float(max_count) * 0.8:
            continue
        sp = index.species[ub2sp[user_bin]]
        out.append(
            f"{rec_id}\t{sp.accession_id}\t{sp.organism_name}\t{sp.taxid}\t"
            f"{sp.seq_len}\t{seq_len}\t{hash_count}\t{count}\t"
            f"{sp.taxnames_string}\t{sp.taxid_string}\n"
        )
    return "".join(out)


def search_single(
    index: TaxorIndex,
    query_file: str,
    out_handle,
    config: SearchConfig,
    device_hixf=None,
) -> dict:
    """Search one query file against one loaded index; returns phase
    timings (the <out>.time analog, taxor_search.cpp:328-336)."""
    scheme = index.scheme
    thresholder = Thresholder.make(
        kmer_size=scheme.kmer_size,
        window_size=scheme.window_size,
        error_rate=config.error_rate,
        percentage=config.percentage,
        use_syncmer=scheme.use_syncmer,
    )
    ub2sp = index.user_bin_to_species()
    dfs_rank = index.hixf.user_bin_dfs_order()

    from ..hash import device_syncmer as dsync

    # every device-extractable scheme (syncmer, minimizer/plain-k-mer,
    # FracMinHash scaling) runs fused both single-device and under a
    # mesh — the sharded steps thread scheme_kind/window/scale_thresh
    # exactly like the single-device dispatch (device/sharding.py
    # _extract_hashes)
    use_e2e = (
        config.engine in ("device", "sharded")
        and device_hixf is not None
        and hasattr(device_hixf, "e2e_capable")
        and device_hixf.e2e_capable(thresholder)
        and (dsync.supports(scheme) or dsync.supports_minimizer(scheme))
    )

    def _hash_thresholds(hash_counts, seqs):
        # size_t-wrapped "impossible" thresholds are >= 2^63 and would
        # overflow the int64 array; any value above every possible count
        # is equivalent downstream (mirrors _pairs_from_e2e's clamp)
        return np.array(
            [
                min(thresholder.get(
                    hc, _scaling_ratio(hc, len(s), scheme.kmer_size)),
                    2**62)
                for hc, s in zip(hash_counts, seqs)
            ],
            dtype=np.int64,
        )

    def prepare(chunk):
        """Host extraction + thresholds for the host engine (and the
        device hash fallback path)."""
        seqs = [rec.seq for rec in chunk]
        hash_lists = search_hashes(seqs, scheme)
        hash_counts = [h.shape[0] for h in hash_lists]
        thresholds = _hash_thresholds(hash_counts, seqs)
        return ("hash", chunk, hash_lists, hash_counts, thresholds)

    def prefetched():
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            fut = None
            for chunk in iter_fastx_chunks(query_file, config.batch_size):
                nfut = ex.submit(prepare, chunk)
                if fut is not None:
                    yield fut.result()
                fut = nfut
            if fut is not None:
                yield fut.result()

    def write_rows(chunk, hash_counts, all_pairs):
        rows = []
        for rec, hc, pairs in zip(chunk, hash_counts, all_pairs):
            rows.append(
                _format_rows(rec.id, len(rec.seq), hc, pairs, index, ub2sp)
            )
        out_handle.write("".join(rows))

    reads_io = 0.0
    compute = 0.0

    if config.engine == "host":
        t_io = time.perf_counter()
        for prepared in prefetched():
            reads_io += time.perf_counter() - t_io
            t0 = time.perf_counter()
            _, chunk, hash_lists, hash_counts, thresholds = prepared
            all_pairs = [
                index.hixf.membership(h, int(t))
                for h, t in zip(hash_lists, thresholds)
            ]
            write_rows(chunk, hash_counts, all_pairs)
            compute += time.perf_counter() - t0
            t_io = time.perf_counter()
        return {"reads_io": reads_io, "compute": compute}

    # Device engines: P batches in flight on worker threads, so one
    # batch's host work (pack, threshold decode, host fallback, TSV rows)
    # overlaps another's device work.  Each worker owns its batch
    # end-to-end (pack -> upload+dispatch -> download -> decode to rows);
    # the main thread writes results in submission order, which keeps
    # the output deterministic (sync_out analog,
    # hixf/search/sync_out.hpp).
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    # positions per e2e dispatch: bounds the [R, L] device intermediates
    # (~16M uint32 elements = 64 MB each) while keeping sub-batches big
    POS_BUDGET = 2048 * 2048

    # device top-k candidate slots, shared across batches: escalated when
    # a batch shows a non-trivial truncation-fallback fraction.  Workers
    # race on it, so escalation is a locked compare-and-step from the k
    # the batch actually ran at (prevents double-stepping the ladder).
    import threading

    # the index pre-seeds the ladder from build-time homology
    # (hixf/index.py suggested_topk): near-identical reference sets
    # start at the rung they would escalate to anyway, so the first
    # batches skip the truncation-fallback + recompile warmup
    topk_state = {"k": max(1, int(config.topk),
                           int(getattr(index, "suggested_topk", 16))),
                  "lock": threading.Lock()}

    def _escalate_topk(ran_at_k: int):
        with topk_state["lock"]:
            if topk_state["k"] == ran_at_k and ran_at_k < 256:
                topk_state["k"] = min(256, ran_at_k * 4)

    def decode(res, gseqs, topk: int, routes: dict):
        """Pairs and hash counts of one tree-step result (e2e_async /
        hashes_async collector), counting the reads the host oracle
        re-ran."""
        if len(res) == 6:  # descend-all chain-min mode
            # (hierarchical + length-dependent thresholds):
            # vals = min(leaf sum, ancestor merged sums),
            # sums = the leaf sums to report
            vals, users, counts, n_emit, hcap, minv_sums = res
        else:
            vals, users, counts, n_emit, hcap = res
            minv_sums = None
        # truncation-driven escalation: if a noticeable fraction of reads
        # hit the device top-k ceiling (falling back to the host oracle),
        # widen k for subsequent batches — one recompile per step of the
        # bounded 16->64->256 ladder.  The trigger is the decoder's own
        # threshold-aware trunc set (all k slots >= the exact per-read
        # tau): a proxy that ignored tau was trivially true in
        # descend-all mode (chain-min slots are never masked to -1), so
        # any tree with >= k leaves ratcheted the ladder to 256
        trunc_out: list = []
        prs, hcs = _pairs_from_e2e(
            vals, users, counts, n_emit, gseqs, index, scheme,
            thresholder, dfs_rank, hcap, sums=minv_sums,
            trunc_out=trunc_out)
        if trunc_out[0].mean() > 0.02:
            _escalate_topk(topk)
        routes["hcap_overflow"] += int(
            (np.asarray(n_emit)[: len(gseqs)] > hcap).sum())
        routes["topk_truncation"] += int(trunc_out[0].sum())
        return prs, hcs

    def _pad_rows(n: int) -> int:
        return max(16, 1 << (n - 1).bit_length())

    def process(chunk):
        """One whole batch: per-read LENGTH BUCKETING routes each read
        to the fused on-device path at its (power-of-two) length bucket
        — ONT batches mix 500 b and 30 kb reads, and one long read must
        not push the whole chunk onto the host scanner.  Sub-batches
        cap at POS_BUDGET/L reads; reads beyond L_CAP have their hashes
        extracted on the host and probed on the device."""
        seqs = [rec.seq for rec in chunk]
        n = len(seqs)
        routes = dict.fromkeys(ROUTES, 0)
        all_pairs: list = [None] * n
        hash_counts: list = [None] * n
        hash_idx: list[int] = []
        topk = topk_state["k"]
        if use_e2e:
            buckets: dict[int, list[int]] = {}
            for i, s in enumerate(seqs):
                if 0 < len(s) <= dsync.L_CAP:
                    L = dsync.pad_len_bucket(len(s))
                    buckets.setdefault(L, []).append(i)
                else:
                    hash_idx.append(i)
            pend = []
            for L in sorted(buckets):
                idxs = buckets[L]
                sub = max(16, min(config.batch_size,
                                  POS_BUDGET // max(L, 1)))
                for off in range(0, len(idxs), sub):
                    part = idxs[off : off + sub]
                    gseqs = [seqs[i] for i in part]
                    packed, lengths = dsync.pack_reads(gseqs, L)
                    rpad = min(sub, _pad_rows(len(part))) - len(part)
                    if rpad:  # power-of-two row buckets bound the
                        # number of compiled (R, L) shapes
                        packed = np.pad(packed, ((0, rpad), (0, 0)))
                        lengths = np.pad(lengths, (0, rpad))
                    pend.append((part, gseqs, device_hixf.e2e_async(
                        packed, lengths, scheme, thresholder, k=topk)))
            for part, gseqs, collect in pend:
                prs, hcs = decode(collect(), gseqs, topk, routes)
                routes["fused"] += len(part)
                for j, i in enumerate(part):
                    all_pairs[i] = prs[j]
                    hash_counts[i] = hcs[j]
        else:
            hash_idx = list(range(n))
        if hash_idx:
            routes["host_extraction"] += len(hash_idx)
            hseqs = [seqs[i] for i in hash_idx]
            hash_lists = search_hashes(hseqs, scheme)
            H = max(1, max((h.shape[0] for h in hash_lists), default=1))
            # bucket H to limit recompilation
            batch = pack_hash_lists(hash_lists, 1 << (H - 1).bit_length())
            if device_hixf.flat_fast_path:
                hcs = [h.shape[0] for h in hash_lists]
                thresholds = _hash_thresholds(hcs, hseqs)
                vals, users = device_hixf.topk_async_packed(
                    batch, len(hseqs), thresholds)()
                prs = _pairs_from_topk(
                    vals, users, thresholds, hash_lists, index, dfs_rank)
            else:
                prs, hcs = decode(device_hixf.hashes_async(
                    batch, len(hseqs), scheme, thresholder, k=topk)(),
                    hseqs, topk, routes)
            for j, i in enumerate(hash_idx):
                all_pairs[i] = prs[j]
                hash_counts[i] = hcs[j]
        rows = []
        for rec, hc, pairs in zip(chunk, hash_counts, all_pairs):
            rows.append(
                _format_rows(rec.id, len(rec.seq), hc, pairs, index, ub2sp)
            )
        routes["reads"] += n
        return "".join(rows), routes

    depth = max(1, config.pipeline_depth)
    totals = dict.fromkeys(ROUTES, 0)

    def drain(fut):
        rows, routes = fut.result()
        out_handle.write(rows)
        for key, v in routes.items():
            totals[key] += v

    t_start = time.perf_counter()
    with ThreadPoolExecutor(depth) as ex:
        q: deque = deque()
        t_io = time.perf_counter()
        for chunk in iter_fastx_chunks(query_file, config.batch_size):
            reads_io += time.perf_counter() - t_io
            q.append(ex.submit(process, chunk))
            if len(q) >= depth:
                drain(q.popleft())
            t_io = time.perf_counter()
        while q:
            drain(q.popleft())
    compute = (time.perf_counter() - t_start) - reads_io
    return {"reads_io": reads_io, "compute": compute, "routes": totals}


# per-read routes of a device search, counted by search_single and logged
# by run_search: reads on the fused device path, reads whose hashes the
# host extracted (longer than device_syncmer.L_CAP, or a scheme the
# device extractor does not cover), and reads re-run on the host oracle
# (emissions beyond the hash capacity, top-k truncation)
ROUTES = ("reads", "fused", "host_extraction", "hcap_overflow",
          "topk_truncation")


def _pairs_from_e2e(vals, users, counts, n_emit, seqs, index, scheme,
                    thresholder, dfs_rank, hcap, sums=None,
                    trunc_out: list | None = None):
    """Decode the fused end-to-end device result (device/e2e.py).

    Device returns top-k RAW run sums; this applies the per-read
    threshold (exact host float64 — no device float math in the parity
    path) and detects the two truncation cases that need the host
    oracle: raw emissions overflowing the device hash capacity (n_emit
    counts pre-dedup emissions — duplicates can push unique k-mers past
    the hcap slice even when counts <= hcap; hcap is the capacity the
    device step actually used, passed through the collector so the two
    can never disagree), and all k candidate slots surviving the
    threshold + 0.8*max pre-filter.

    sums (descend-all chain-min mode): vals are then
    min(leaf sum, ancestor merged sums) — the emission test value — and
    sums are the leaf sums to REPORT.  The 0.8 shortcut is unsound there
    (a dropped slot's SUM may exceed the kept maximum), so truncation
    falls back whenever all k slots pass the threshold."""
    from ..hash.schemes import search_hashes

    k_sch = scheme.kmer_size
    kk = vals.shape[1]

    def host_fallback(seq):
        hl = search_hashes([seq], scheme)[0]
        hc = hl.shape[0]
        thr = _read_threshold(thresholder, hc, len(seq), k_sch)
        return index.hixf.membership(hl, int(thr)), hc

    # Vectorized decode: per-read numpy scalar ops cost ~15us/read in
    # Python (GIL-bound — it throttled every pipeline worker at once),
    # so everything batch-wide runs as whole-array numpy here and the
    # residual Python loop only assembles output tuples.
    Rs = len(seqs)  # device rows may include batch padding — drop it
    counts = np.asarray(counts, dtype=np.int64)[:Rs]
    n_emit = np.asarray(n_emit, dtype=np.int64)[:Rs]
    vals = np.asarray(vals, dtype=np.int64)[:Rs]
    users = np.asarray(users, dtype=np.int64)[:Rs]
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                       count=len(seqs))
    # threshold per read, memoized on (hash_count, read_len) — the only
    # inputs the models consume; exact host float64 math
    thr_cache = getattr(thresholder, "_e2e_thr_cache", None)
    if thr_cache is None:
        thr_cache = thresholder._e2e_thr_cache = {}
    thr = np.empty(len(seqs), dtype=np.int64)
    for r, key in enumerate(zip(counts.tolist(), lens.tolist())):
        t = thr_cache.get(key)
        if t is None:
            t = thr_cache[key] = _read_threshold(
                thresholder, key[0], key[1], k_sch)
        # size_t-wrapped "impossible" thresholds are >= 2^63 and would
        # overflow int64; any value above every possible count is
        # equivalent for the comparisons below
        thr[r] = min(t, 2**62)
    ok = (vals >= thr[:, None]) & (users >= 0)
    n = ok.sum(axis=1)  # vals descending => ok is a prefix
    f64 = np.float64
    if sums is not None:
        sums = np.asarray(sums, dtype=np.int64)[:Rs]
        trunc = n == kk  # no 0.8 shortcut on chain-min candidates
        vals = sums  # report the leaf sums, not the emission-test minv
    else:
        trunc = (n == kk) & (
            vals[:, kk - 1].astype(f64) >= vals[:, 0].astype(f64) * 0.8)
    if trunc_out is not None:
        # the k-ceiling truncation set (exact, threshold-aware) — the
        # pipeline's top-k escalation trigger.  hcap overflow is
        # deliberately excluded: a larger k cannot fix a hash-capacity
        # fallback, so it must not ratchet the ladder
        trunc_out.append(trunc)
    need_fallback = (n_emit > hcap) | trunc
    # dfs ordering of the candidate slots (argsort only for multi-hit
    # reads; single-hit reads — the common case — skip it)
    vals_l = vals.tolist()
    users_l = users.tolist()
    n_l = n.tolist()
    counts_l = counts.tolist()
    fb_l = need_fallback.tolist()
    pairs_per_read = []
    hash_counts = []
    for r, seq in enumerate(seqs):
        if fb_l[r]:
            pairs, hc = host_fallback(seq)
            pairs_per_read.append(pairs)
            hash_counts.append(hc)
            continue
        nn = n_l[r]
        if nn == 0:
            pairs_per_read.append([])
        elif nn == 1:
            pairs_per_read.append([(users_l[r][0], vals_l[r][0])])
        else:
            u = users[r, :nn]
            order = np.argsort(dfs_rank[u], kind="stable")
            vr, ur = vals_l[r], users_l[r]
            pairs_per_read.append([(ur[i], vr[i]) for i in order])
        hash_counts.append(counts_l[r])
    return pairs_per_read, hash_counts


def _scaling_ratio(hash_count: int, seq_len: int, kmer_size: int) -> float:
    """(double)hash_count / ((double)len - k + 1.0) with C double
    semantics (taxor_search.cpp:263): seq_len == k-1 yields 0/0 = NaN
    (hash_count is always 0 for such reads), which the fracminhash model
    propagates to the size_t sentinel — 'no read can pass', exactly as
    the reference binary computes it.  Only that model consumes the
    ratio."""
    denom = float(seq_len) - float(kmer_size) + 1.0
    if denom == 0.0:
        return float("nan") if hash_count == 0 else float("inf")
    return float(hash_count) / denom


def _read_threshold(thresholder, hash_count, seq_len, kmer_size):
    """The per-read threshold exactly as the host prepare computes it."""
    return int(thresholder.get(
        hash_count, _scaling_ratio(hash_count, seq_len, kmer_size)))


def _pairs_from_topk(vals, users, thresholds, hash_lists, index, dfs_rank):
    """Per-read pairs from the compact device result.  A read whose k-th
    candidate still passes the 0.8*max rule may have lost qualifying bins
    to truncation — re-run the exact host oracle for it (rare)."""
    k = vals.shape[1]
    pairs_per_read = []
    for r in range(vals.shape[0]):
        n = int((vals[r] >= 0).sum())
        if n == k and float(vals[r, k - 1]) >= float(vals[r, 0]) * 0.8:
            pairs_per_read.append(
                index.hixf.membership(hash_lists[r], int(thresholds[r]))
            )
            continue
        u = users[r, :n]
        order = np.argsort(dfs_rank[u], kind="stable")
        pairs_per_read.append(
            [(int(u[i]), int(vals[r, i])) for i in order]
        )
    return pairs_per_read


def run_search(config: SearchConfig) -> None:
    """Outer product over comma-separated query and index lists
    (taxor_search.cpp:340-360)."""
    from ..device.hixf_search import DeviceHIXF
    from ..hash import schemes as _schemes

    _schemes.NUM_THREADS = max(1, int(config.threads))
    index_files = config.index_file.split(",")
    query_files = config.query_file.split(",")

    # scheme-consistency check across indexes (taxor_search.cpp:110-137)
    loaded = [load_index(f) for f in index_files]
    schemes = {
        (
            ix.scheme.kmer_size,
            ix.scheme.window_size,
            ix.scheme.scaling,
            ix.scheme.syncmer_size,
            ix.scheme.t_syncmer,
            ix.scheme.use_syncmer,
        )
        for ix in loaded
    }
    if len(schemes) > 1:
        raise ValueError(
            "At least two index files have been created with different "
            "kmer selection schemes"
        )

    from ..utils.logging import logger, maybe_profile

    report_file = config.report_file
    if config.engine == "sharded":
        import jax

        if jax.process_count() > 1 and jax.process_index() != 0:
            # multi-host: every process computes the full result (counts
            # are allgathered); only process 0 writes the report
            import os

            report_file = os.devnull

    with open(report_file, "w") as out, \
            maybe_profile(config.profile_trace):
        out.write(HEADER)
        timings = {"index_io": 0.0, "reads_io": 0.0, "compute": 0.0}
        for query in query_files:
            for index in loaded:
                dhixf = None
                if config.engine == "device":
                    t0 = time.perf_counter()
                    dhixf = DeviceHIXF(index.hixf)
                    timings["index_io"] += time.perf_counter() - t0
                elif config.engine == "sharded":
                    import jax

                    from ..device.sharding import make_mesh

                    t0 = time.perf_counter()
                    n_dev = len(jax.devices())
                    if jax.process_count() > 1:
                        # multi-host: bins shard across hosts (each
                        # host's HBM holds an index slice), reads across
                        # the devices within each host
                        from ..device.distributed import global_mesh

                        mesh = global_mesh(config.mesh_reads or None,
                                           config.mesh_bins or None)
                    else:
                        bins = config.mesh_bins or (2 if n_dev >= 2 else 1)
                        reads = config.mesh_reads or max(1, n_dev // bins)
                        mesh = make_mesh(reads, bins)
                    dhixf = DeviceHIXF(index.hixf, mesh=mesh)
                    timings["index_io"] += time.perf_counter() - t0
                t = search_single(index, query, out, config, dhixf)
                timings["reads_io"] += t["reads_io"]
                timings["compute"] += t["compute"]
                if "routes" in t:
                    logger.info("search routes: %s", " ".join(
                        f"{k}={v}" for k, v in t["routes"].items()))

    if config.write_time and report_file == config.report_file:
        with open(config.report_file + ".time", "w") as fh:
            fh.write("Index I/O\tReads I/O\tCompute\n")
            fh.write(
                f"{timings['index_io']:.2f}\t{timings['reads_io']:.2f}\t"
                f"{timings['compute']:.2f}"
            )

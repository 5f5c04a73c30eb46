#!/usr/bin/env python3
"""End-to-end check of `taxor build / search / profile` on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--genomes N] [--reads N]
    python3 chip_smoke.py --chips 4     # the four-card sharded path only

Drives the normal CLI entry points (taxor_jax.cli.main) in one process:

  1. device   the card's name and power limit, jax.devices(); exits
              non-zero unless JAX's platform is "gpu"
  2. data     a seeded reference set shaped like the GenBank viral index
              (k=22, s=12 open syncmers, hierarchical layout, log-normal
              genome lengths), cut from its 12,000 genomes to 4,000 so
              the build fits the time limit (never under 100 MB of
              fingerprint tables), 16,384 ONT-like reads (500 b - 32 kb,
              ~4 % substitutions, a share of random reads that hit
              nothing) and 16 reads longer than the device extractor's
              cap; `taxor build`
  kernels     the probe as compiled for the card (the Triton-route
              kernel) against count_xla on the index's widest table, and
              the XLA extractor's time per read-length bucket
  3. search   `search --engine device --write-time` cold and warm (the
              warm run must reproduce the cold TSV; each prints the time
              its threads spent tracing, lowering and compiling); the
              whole-tree device step with each probe on 1,024 reads of
              1-2 kb (outputs must agree); then `search --engine host` on
              a 512-read subset, diffed byte for byte against the device
              rows of those reads
  4. profile  `profile` on the device TSV; the CAMI files must exist
  5. report   walls, reads/s, the share of reads on each host route and
              peak device memory, each with the card's name and limit

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed phase raises, so the script exits non-zero and prints no
such line.  --chips 4 builds the same index, then runs only
`search --engine sharded --mesh-reads 1 --mesh-bins 4` and the one-card
device search it must match byte for byte, on 240 reads of 1-2 kb plus
the 16 long reads (one length bucket, so few compiled shapes).

Working files go to <checkout>/.smoke_work (removed at the end).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")

# the GenBank viral deployment (reference README.md:50): ~12k genomes,
# heavy-tailed lengths, ~373 MB of k=22/s=12 fingerprint tables.  On the
# card's 16-core host its full 12,000-genome build took 535 s (457 MB of
# tables), too long for the smoke's limit with the cold compile after it,
# so the smoke cuts the genome count and keeps the genome lengths.
GENOMES = 12000
SMOKE_GENOMES = 4000
GENOME_MEDIAN = 60000
GENOME_SIGMA = 1.0
MIN_TABLE_MB = 100  # twice the H100's 50 MB L2: the probe reads HBM
READS = 16384
# --chips 4: one length bucket, and 240 + 16 long reads fill one batch
# whose one-card graphs have the row counts the one-card smoke compiles
MESH_READS, MESH_LENS = 240, (1025, 2048)
LONG_READS = 16
RANDOM_SHARE = 0.1
ERROR_RATE = 0.04
PARITY_READS = 512


def say(msg: str) -> None:
    print(msg, flush=True)


def taxor(*argv: str) -> float:
    """One CLI call from the work directory; returns its wall seconds."""
    from taxor_jax.cli import main

    cwd = os.getcwd()
    os.chdir(WORK)
    t0 = time.perf_counter()
    try:
        rc = main(list(argv))
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"taxor {argv[0]} exited {rc}")
    return wall


def phase_device(n_chips: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < n_chips:
        raise SystemExit(f"chip_smoke: needs {n_chips} cards, JAX sees "
                         f"{len(devs)}")
    from taxor_jax.utils.gpu import card_info

    card = card_info().splitlines()[0]
    say(f"[device] {card}")
    say(f"[device] jax {jax.__version__}: {devs}")
    return devs, card


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (or loading
    from the compile cache), summed over threads, since the last
    reset()."""

    EVENTS = {"/jax/core/compile/jaxpr_trace_duration": "trace",
              "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
              "/jax/core/compile/backend_compile_duration": "compile"}

    def __init__(self):
        import jax

        self.sec = dict.fromkeys(self.EVENTS.values(), 0.0)
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        key = self.EVENTS.get(event)
        if key is not None:
            self.sec[key] += duration
            self.n += key == "compile"

    def reset(self):
        self.sec = dict.fromkeys(self.sec, 0.0)
        self.n = 0

    def __str__(self):
        return (f"{self.n} compiles: tracing {self.sec['trace']:.1f} s, "
                f"lowering {self.sec['lower']:.1f} s, XLA compile or "
                f"cache load {self.sec['compile']:.1f} s (summed over "
                f"threads)")


def make_dataset(seed: int, n_genomes: int, n_reads: int,
                 read_range: tuple[int, int] | None = None):
    """Seeded reference genomes + taxonomy, the read file and the parity
    subset.  Returns (taxonomy_tsv, genome_dir, reads_fasta,
    subset_fasta, subset_ids, long_ids)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import make_ref_set, random_genome, simulate_read, write_fasta

    from taxor_jax.hash.device_syncmer import L_CAP

    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(np.log(GENOME_MEDIAN), GENOME_SIGMA,
                                 n_genomes), 2000, 2_500_000).astype(int)
    tsv, gdir, genomes = make_ref_set(WORK, rng, n_species=n_genomes,
                                      genome_lens=lens)
    accs = sorted(genomes, key=lambda a: len(genomes[a]))
    glen = np.array([len(genomes[a]) for a in accs])

    def from_genome(i, read_len):
        # a genome at least as long as the read keeps the length spread
        lo = min(int(np.searchsorted(glen, read_len)), len(accs) - 1)
        j = int(rng.integers(lo, len(accs)))
        acc = accs[j]
        return (f"r{i}_{acc}",
                simulate_read(rng, genomes[acc], read_len, ERROR_RATE))

    records = []
    lo, hi = read_range or (500, L_CAP)
    read_lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n_reads))
    for i, ln in enumerate(read_lens.astype(int)):
        if rng.random() < RANDOM_SHARE:  # hits nothing
            records.append((f"r{i}_random", random_genome(rng, int(ln))))
        else:
            records.append(from_genome(i, int(ln)))
    long_ids = []
    for i in range(n_reads, n_reads + LONG_READS):
        rid, seq = from_genome(i, int(rng.integers(L_CAP + 1, 2 * L_CAP)))
        records.append((rid, seq))
        long_ids.append(rid)
    order = rng.permutation(len(records))
    records = [records[i] for i in order]
    reads = os.path.join(WORK, "reads.fasta")
    write_fasta(reads, records)
    # parity subset: every long read plus random others, in file order
    long_set = set(long_ids)
    others = [i for i, r in enumerate(records) if r[0] not in long_set]
    pick = long_set | {records[i][0] for i in rng.choice(
        others, min(len(others), PARITY_READS - len(long_ids)),
        replace=False)}
    subset = [r for r in records if r[0] in pick]
    subset_fa = os.path.join(WORK, "subset.fasta")
    write_fasta(subset_fa, subset)
    return tsv, gdir, reads, subset_fa, [r[0] for r in subset], long_ids


def _best_time(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels(table, tag: str) -> None:
    """The probe kernel as compiled for the card vs the plain reference
    on the index's widest table, and the extractor per length bucket."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from taxor_jax.device.e2e import extract_hashes
    from taxor_jax.device.probe import count_xla, pad_fingerprints
    from taxor_jax.device.probe_triton import count_triton
    from taxor_jax.hash import device_syncmer as dsync
    from taxor_jax.hash.syncmer import t_syncmer_default

    rng = np.random.default_rng(7)
    fp = jnp.asarray(pad_fingerprints(table))
    S, B = fp.shape
    R, H = 1024, 512
    pos = jnp.asarray(rng.integers(0, S, (R, H, 3)).astype(np.int32))
    fpr = jnp.asarray(rng.integers(0, 256, (R, H)).astype(np.uint8))
    mask = jnp.asarray(np.arange(H)[None, :]
                       < rng.integers(0, H + 1, R)[:, None])
    hc = max(8, min(128, (128 << 20) // (R * 3 * B)))
    want = np.asarray(count_xla(fp, pos, fpr, mask, hash_chunk=hc))
    got = np.asarray(count_triton(fp, pos, fpr, mask))
    if not np.array_equal(got, want):
        raise RuntimeError("Triton probe differs from count_xla")
    tk = _best_time(lambda: count_triton(fp, pos, fpr, mask))
    tx = _best_time(lambda: count_xla(fp, pos, fpr, mask, hash_chunk=hc))
    say(f"[kernels] probe on the widest table [{S}, {B}], {R} reads x "
        f"{H} hash slots: Triton kernel == count_xla; kernel "
        f"{tk * 1e3:.3f} ms, count_xla {tx * 1e3:.3f} ms {tag}")
    extract = jax.jit(extract_hashes, static_argnums=(2, 3, 4, 5, 6, 7, 8))
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    for L in (512, 1024, 2048, 4096, 8192, 16384, 32768):
        n = min(1024, (2048 * 2048) // L)  # the pipeline's rows per L
        packed, lengths = dsync.pack_reads(
            [acgt[rng.integers(0, 4, L)].tobytes() for _ in range(n)], L)
        p, ln = jnp.asarray(packed), jnp.asarray(lengths)
        t = _best_time(lambda: extract(p, ln, 22, 12,
                                       t_syncmer_default(22, 12),
                                       dsync.hash_cap(L), "syncmer", 0, 0))
        say(f"[kernels] extraction L={L}, {n} reads: {t * 1e3:.3f} ms "
            f"per batch {tag}")


def phase_tree_ab(idx_path: str, reads_path: str, tag: str) -> None:
    """The whole-tree fused device step at the smoke index, once with
    the product probe (the kernel, as compiled for the card) and once
    with count_xla in its place: 1,024 reads of 1-2 kb, warm, best of
    3, packed outputs equal."""
    import numpy as np

    from taxor_jax.device import e2e, probe
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.hash import device_syncmer as dsync
    from taxor_jax.hixf.index import load_index
    from taxor_jax.io.fastx import read_all
    from taxor_jax.search.pipeline import SearchConfig
    from taxor_jax.search.thresholds import Thresholder

    index = load_index(idx_path)
    sch = index.scheme
    cfg = SearchConfig()
    th = Thresholder.make(sch.kmer_size, sch.window_size, cfg.error_rate,
                          cfg.percentage, sch.use_syncmer)
    seqs = [r.seq for r in read_all(reads_path) if 1024 < len(r.seq) <= 2048]
    packed, lengths = dsync.pack_reads(seqs[:1024], 2048)
    results, times = [], []
    for name, fn in (("kernel", probe.probe_counts),
                     ("count_xla", probe._count_xla_bounded)):
        e2e.probe_counts = fn  # the tree step looks it up when traced
        try:
            dhixf = DeviceHIXF(index.hixf)
            step = lambda: dhixf.e2e_async(  # noqa: E731
                packed, lengths, sch, th)()
            results.append(step())
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                step()
                best = min(best, time.perf_counter() - t0)
            times.append(best)
            del dhixf
        finally:
            e2e.probe_counts = probe.probe_counts
    for a, b in zip(results[0], results[1]):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise RuntimeError("tree step: kernel and count_xla differ")
    n_ixf = len(index.hixf.ixfs)
    say(f"[kernels] whole-tree device step ({n_ixf} IXFs), "
        f"{packed.shape[0]} reads of 1-2 kb: kernel {times[0] * 1e3:.3f} "
        f"ms, count_xla {times[1] * 1e3:.3f} ms, outputs equal {tag}")


def rows_by_read(tsv_path: str) -> dict[str, list[str]]:
    rows: dict[str, list[str]] = {}
    with open(tsv_path) as fh:
        for line in fh:
            if not line.startswith("#"):
                rows.setdefault(line.split("\t", 1)[0], []).append(line)
    return rows


class _Routes(logging.Handler):
    """Keeps the pipeline's per-search route counts (search routes: ...)."""

    def __init__(self):
        super().__init__()
        self.last: dict[str, int] = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("search routes: "):
            self.last = {k: int(v) for k, v in (
                kv.split("=") for kv in msg[15:].split())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=SMOKE_GENOMES,
                    help="reference genomes (the deployment has "
                         f"{GENOMES}; cut to fit the time limit)")
    ap.add_argument("--reads", type=int, default=None,
                    help=f"reads (default {READS}, {MESH_READS} with "
                         "--chips 4)")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    if args.reads is None:
        args.reads = READS if args.chips == 1 else MESH_READS

    devs, card = phase_device(args.chips)
    tag = f"[{card}]"

    from taxor_jax.hixf.index import load_index
    from taxor_jax.utils.logging import logger, setup_logging

    setup_logging()
    clock = CompileClock()
    routes = _Routes()
    logger.addHandler(routes)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        # ---- data + build ------------------------------------------------
        if args.genomes < GENOMES:
            say(f"[data] cut: {args.genomes} of the deployment's {GENOMES} "
                f"genomes, lengths kept, so the build fits the time limit")
        t0 = time.perf_counter()
        tsv, gdir, reads, subset_fa, subset_ids, long_ids = make_dataset(
            args.seed, args.genomes, args.reads,
            None if args.chips == 1 else MESH_LENS)
        say(f"[data] generated {args.genomes} genomes and "
            f"{args.reads + LONG_READS} reads in "
            f"{time.perf_counter() - t0:.1f} s")
        idx = os.path.join(WORK, "index.taxor.npz")
        build_wall = taxor(
            "build", "--input-file", tsv, "--input-sequence-dir", gdir,
            "--output-filename", idx, "--kmer-size", "22",
            "--syncmer-size", "12", "--use-syncmer",
            "--threads", str(os.cpu_count() or 1),
            "--count-output-prefix", "")
        index = load_index(idx)
        table_mb = sum(x.fingerprints.nbytes
                       for x in index.hixf.ixfs) / 1e6
        n_ixfs = len(index.hixf.ixfs)
        widest = max((x.fingerprints for x in index.hixf.ixfs),
                     key=lambda f: f.nbytes)
        del index
        say(f"[build] wall {build_wall:.1f} s, {n_ixfs} IXFs, "
            f"{table_mb:.1f} MB of fingerprint tables {tag}")
        if args.chips == 1 and table_mb < MIN_TABLE_MB:
            raise RuntimeError(f"tables {table_mb:.1f} MB < "
                               f"{MIN_TABLE_MB} MB")
        if n_ixfs < 2:
            raise RuntimeError("expected a hierarchical layout")
        n_total = args.reads + LONG_READS
        if args.chips == 1:
            phase_kernels(widest, tag)
        del widest

        dev_tsv = os.path.join(WORK, "device.tsv")
        if args.chips == 4:
            clock.reset()
            wall1 = taxor("search", "--index-file", idx, "--query-file",
                          reads, "--output-file", dev_tsv,
                          "--engine", "device")
            say(f"[sharded] one-card search routes {routes.last}; {clock}")
            clock.reset()
            sh_tsv = os.path.join(WORK, "sharded.tsv")
            wall4 = taxor("search", "--index-file", idx, "--query-file",
                          reads, "--output-file", sh_tsv,
                          "--engine", "sharded", "--mesh-reads", "1",
                          "--mesh-bins", "4")
            r = routes.last
            say(f"[sharded] 4-card search routes {r}; {clock}")
            if r.get("fused", 0) == 0 or r.get("host_extraction") != len(
                    long_ids):
                raise RuntimeError(f"sharded routes {r}")
            with open(dev_tsv, "rb") as a, open(sh_tsv, "rb") as b:
                same = a.read() == b.read()
            say(f"[sharded] one-card device search {wall1:.1f} s, "
                f"4-card sharded search {wall4:.1f} s (cold walls) {tag}")
            if not same:
                raise RuntimeError("sharded TSV differs from the one-card "
                                   "device TSV")
            say(f"[sharded] {n_total} reads: sharded TSV == one-card "
                f"device TSV byte for byte")
        else:
            # ---- search -------------------------------------------------
            clock.reset()
            cold = taxor("search", "--index-file", idx, "--query-file",
                         reads, "--output-file", dev_tsv,
                         "--engine", "device", "--write-time")
            r = routes.last
            if r.get("reads") != n_total or r.get("fused", 0) == 0:
                raise RuntimeError(f"fused path not taken: {r}")
            if r.get("host_extraction") != len(long_ids):
                raise RuntimeError(f"host extraction {r} != the "
                                   f"{len(long_ids)} long reads")
            say(f"[search] fused device path: {r['fused']} of {n_total} "
                f"reads")
            say(f"[search] cold search: {clock}")
            for key in ("host_extraction", "hcap_overflow",
                        "topk_truncation"):
                say(f"[search] host route {key}: {r[key]} reads "
                    f"({100.0 * r[key] / n_total:.3f} %)")
            warm_tsv = os.path.join(WORK, "device_warm.tsv")
            clock.reset()
            warm = taxor("search", "--index-file", idx, "--query-file",
                         reads, "--output-file", warm_tsv,
                         "--engine", "device", "--write-time")
            with open(dev_tsv, "rb") as a, open(warm_tsv, "rb") as b:
                if a.read() != b.read():
                    raise RuntimeError("warm device TSV differs from cold")
            with open(warm_tsv + ".time") as fh:
                io_s, reads_s, compute_s = map(
                    float, fh.read().splitlines()[1].split("\t"))
            say(f"[search] warm search (a second CLI call in this "
                f"process: it traces again and loads the compile cache): "
                f"{clock}")
            say(f"[search] cold wall {cold:.1f} s, warm wall {warm:.1f} s "
                f"(index I/O {io_s:.2f} s, reads I/O {reads_s:.2f} s, "
                f"compute {compute_s:.2f} s) {tag}")
            say(f"[search] warm call {n_total / warm:.1f} reads/s end to "
                f"end, {n_total / compute_s:.1f} reads/s in its compute "
                f"phase {tag}")
            # after the searches, so its compiles cannot warm the cold one
            phase_tree_ab(idx, reads, tag)
            host_tsv = os.path.join(WORK, "host.tsv")
            host_wall = taxor("search", "--index-file", idx,
                              "--query-file", subset_fa, "--output-file",
                              host_tsv, "--engine", "host")
            dev_rows = rows_by_read(dev_tsv)
            want = "".join("".join(dev_rows[i]) for i in subset_ids)
            with open(host_tsv) as fh:
                got = "".join(l for l in fh if not l.startswith("#"))
            if got != want:
                raise RuntimeError("host TSV differs from the device rows")
            say(f"[search] parity: {len(subset_ids)} reads (incl. "
                f"{len(long_ids)} beyond the cap), host TSV == device TSV "
                f"byte for byte (host engine {host_wall:.1f} s)")
            # ---- profile ------------------------------------------------
            cami = os.path.join(WORK, "profile.tsv")
            binning = os.path.join(WORK, "binning.tsv")
            prof_wall = taxor("profile", "--search-file", dev_tsv,
                              "--cami-report-file", cami,
                              "--binning-file", binning,
                              "--sample-id", "smoke")
            for f in (cami, binning):
                if not os.path.getsize(f):
                    raise RuntimeError(f"profile wrote no {f}")
            say(f"[profile] wall {prof_wall:.1f} s, CAMI profile "
                f"{os.path.getsize(cami)} B, binning "
                f"{os.path.getsize(binning)} B {tag}")
        # ---- report -------------------------------------------------------
        for d in devs[: args.chips]:
            peak = d.memory_stats()["peak_bytes_in_use"]
            say(f"[report] {d}: peak device memory {peak / 2**30:.2f} GiB "
                f"{tag}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    say(card)
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs[: args.chips])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

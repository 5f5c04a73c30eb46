"""taxor command line: build / search / profile subcommands with the
reference's flag names and defaults (src/main/main.cpp:54-77 and the three
set_up_subparser_layout functions)."""

from __future__ import annotations

import argparse
import resource
import sys
import time


def _add_build(sub):
    p = sub.add_parser("build", help="Creates an HIXF index of a given set "
                                     "of fasta files")
    p.add_argument("--input-file", required=True,
                   help="tab-separated-value file containing taxonomy "
                        "information and reference file names")
    p.add_argument("--input-sequence-dir", default=".",
                   help="directory containing the fasta reference files")
    p.add_argument("--output-filename", default=".",
                   help="A file name for the resulting index.")
    p.add_argument("--kmer-size", type=int, default=20)
    p.add_argument("--syncmer-size", type=int, default=10)
    p.add_argument("--window-size", type=int, default=0,
                   help="window size of minimizer scheme (hidden flag)")
    p.add_argument("--scaling", type=int, default=1,
                   help="factor for scaling down syncmer/minimizer sketches")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--use-syncmer", action="store_true")
    p.add_argument("--layout", default="auto", choices=["auto", "flat"],
                   help="layout algorithm (auto = hierarchical DP)")
    p.add_argument("--tmax", type=int, default=4096)
    p.add_argument("--spill-dir", default="",
                   help="spill per-genome hash sets to this directory to "
                        "bound peak RAM (GTDB-scale builds)")
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="Enable verbose statistics to be printed")
    p.add_argument("--count-output-prefix", default="chopper",
                   help="prefix for the counting-stage artifacts "
                        "(<prefix>.count + <prefix>_sketches/); '' "
                        "disables them")
    p.add_argument("--resume", action="store_true",
                   help="reuse an existing layout file (binning.out) "
                        "instead of recounting + re-running the layout DP")
    return p


def _add_search(sub):
    p = sub.add_parser("search", help="Queries files of DNA sequences "
                                      "against a list of HIXF index files")
    p.add_argument("--index-file", required=True)
    p.add_argument("--query-file", required=True)
    p.add_argument("--output-file", required=True)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--percentage", type=float, default=-1.0,
                   help="if set, used instead of the k-mer/syncmer models")
    p.add_argument("--error-rate", type=float, default=0.04)
    p.add_argument("--engine", default="device",
                   choices=["device", "host", "sharded"])
    p.add_argument("--mesh-reads", type=int, default=0,
                   help="reads-axis size of the sharded engine's mesh "
                        "(0 = all devices / --mesh-bins)")
    p.add_argument("--mesh-bins", type=int, default=0,
                   help="bins-axis size of the sharded engine's mesh "
                        "(0 = one shard per host)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize the multi-host JAX runtime "
                        "(jax.distributed) before searching; every host "
                        "runs the same command")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (e.g. localhost:1234 "
                        "on one host)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="Enable verbose statistics to be printed "
                        "(accepted for parity; unused, as in the "
                        "reference's search path)")
    p.add_argument("--write-time", action="store_true")
    p.add_argument("--profile-trace", default="",
                   help="write a jax.profiler trace of the compute phase "
                        "to this directory")
    return p


def _add_profile(sub):
    p = sub.add_parser("profile", help="Taxonomic profiling of a sample by "
                                       "given read matching results")
    p.add_argument("--search-file", required=True)
    p.add_argument("--cami-report-file", required=True)
    p.add_argument("--seq-abundance-file", default="")
    p.add_argument("--binning-file", required=True)
    p.add_argument("--sample-id", required=True)
    p.add_argument("--min-abundance", type=float, default=0.001)
    p.add_argument("--em-steps", type=int, default=100)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--output-verbose-statistics", action="store_true",
                   help="Enable verbose statistics to be printed "
                        "(accepted for parity; unused, as in the "
                        "reference's profile path)")
    return p


def _add_prewarm(sub):
    p = sub.add_parser(
        "prewarm",
        help="Compile (and persistently cache) the fused search graphs "
             "for an index ahead of time, so the first `taxor search` "
             "starts classifying without compiling (framework extension "
             "— no reference equivalent)")
    p.add_argument("--index-file", required=True)
    p.add_argument("--lengths", default="1024,2048,4096",
                   help="comma-separated read-length buckets to compile")
    p.add_argument("--topk", default="",
                   help="comma-separated top-k rungs (default: the "
                        "index's suggested rung + the escalation ladder "
                        "start)")
    p.add_argument("--percentage", type=float, default=-1.0,
                   help="threshold mode the later search will use — the "
                        "compiled hierarchical graph is keyed on the "
                        "thresholder kind (count-table descent vs "
                        "descend-all), so prewarm must mirror it")
    p.add_argument("--error-rate", type=float, default=0.04)
    return p


def run_prewarm(index_file: str, lengths: str, topk: str,
                percentage: float = -1.0,
                error_rate: float = 0.04) -> None:
    """Drive one tiny batch through every (L-bucket x topk) fused graph;
    compiled executables land in the persistent cache keyed by shape, so
    any later search over the same index geometry is a cache hit."""
    import numpy as np

    from .device.hixf_search import DeviceHIXF
    from .hash import device_syncmer as dsync
    from .hixf.index import load_index
    from .search.thresholds import Thresholder

    index = load_index(index_file)
    scheme = index.scheme
    # mirror search's Thresholder.make inputs: the fused graph is keyed
    # on descend_all (derived from thresholder.kind), so compiling with
    # a hard-coded mode would miss the cache for e.g. --percentage
    # searches on a minimizer index (which use descend-all chain-min)
    thresholder = Thresholder.make(scheme.kmer_size, scheme.window_size,
                                   error_rate, percentage,
                                   scheme.use_syncmer)
    dhixf = DeviceHIXF(index.hixf)
    if not dhixf.e2e_capable(thresholder):
        print("prewarm: index not fused-capable; nothing to compile")
        return
    ls = [int(x) for x in lengths.split(",") if x]
    sugg = int(getattr(index, "suggested_topk", 16))
    ks = ([int(x) for x in topk.split(",") if x]
          or sorted({16, sugg}))
    for L in ls:
        Lb = dsync.pad_len_bucket(L)
        packed, lens = dsync.pack_reads([b"ACGT" * (Lb // 4)], Lb)
        packed = np.repeat(packed, 16, axis=0)
        lens = np.repeat(lens, 16)
        for kk in ks:
            t0 = time.time()
            dhixf.e2e_async(packed, lens, scheme, thresholder, k=kk)()
            print(f"prewarm: L={Lb} topk={kk} compiled+cached in "
                  f"{time.time() - t0:.1f}s", flush=True)


def main(argv: list[str] | None = None) -> int:
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="taxor",
        description="Taxonomic classification of long reads",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_build(sub)
    _add_search(sub)
    _add_profile(sub)
    _add_prewarm(sub)
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="debug logging")
    args = parser.parse_args(argv)

    from .utils.logging import setup_logging

    setup_logging(getattr(args, "verbose", False))

    t0 = time.process_time()
    try:
        if args.command == "build":
            from .apps.build import BuildConfig, run_build

            run_build(BuildConfig(
                input_file=args.input_file,
                input_sequence_dir=args.input_sequence_dir,
                output_filename=args.output_filename,
                kmer_size=args.kmer_size,
                syncmer_size=args.syncmer_size,
                window_size=args.window_size,
                scaling=args.scaling,
                threads=args.threads,
                use_syncmer=args.use_syncmer,
                layout_mode=args.layout,
                tmax=args.tmax,
                spill_dir=args.spill_dir,
                verbose_stats=args.output_verbose_statistics,
                count_output_prefix=args.count_output_prefix,
                resume=args.resume,
            ))
        elif args.command == "search":
            if args.distributed:
                from .device.distributed import initialize

                initialize(coordinator_address=args.coordinator_address,
                           num_processes=args.num_processes,
                           process_id=args.process_id)
            from .search.pipeline import SearchConfig, run_search

            run_search(SearchConfig(
                index_file=args.index_file,
                query_file=args.query_file,
                report_file=args.output_file,
                threads=args.threads,
                percentage=args.percentage,
                error_rate=args.error_rate,
                engine=args.engine,
                mesh_reads=args.mesh_reads,
                mesh_bins=args.mesh_bins,
                write_time=args.write_time,
                profile_trace=args.profile_trace,
            ))
        elif args.command == "prewarm":
            run_prewarm(args.index_file, args.lengths, args.topk,
                        args.percentage, args.error_rate)
        elif args.command == "profile":
            from .profile.profile import ProfileConfig, run_profile

            run_profile(ProfileConfig(
                search_file=args.search_file,
                report_file=args.cami_report_file,
                sequence_abundance_file=args.seq_abundance_file,
                binning_file=args.binning_file,
                sample_id=args.sample_id,
                threshold=args.min_abundance,
                em_steps=args.em_steps,
                threads=args.threads,
            ))
    except Exception as e:  # [TAXOR * ERROR] style, then fail fast
        print(f"[TAXOR {args.command.upper()} ERROR] {e}", file=sys.stderr)
        return 1

    # CPU time + peak RSS, like main.cpp:79-84
    cpu = time.process_time() - t0
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(f"CPU time : {cpu:.2f} seconds")
    print(f"Peak RSS : {peak_mb:.1f} MByte")
    return 0


if __name__ == "__main__":
    sys.exit(main())

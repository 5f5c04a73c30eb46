#!/usr/bin/env python3
"""Seed-invariance control for the layout waiver (DIVERGENCES.md #6/#13).

VERDICT r3 weak #7: the waiver attributes the residual top-accession
flips between different layouts to filter false-positive noise *by
argument*.  This is the direct experiment: rebuild the SAME layout
(identical binning.out, identical bin contents) twice with different
XOR-filter construction seeds — the ONLY thing that changes is the FP
noise roll — and compare the per-read classification-row flip rate with
the cross-layout flip rate measured the same way.  If the two rates
match, layout choice has no observable effect beyond FP noise and the
waiver's causal claim is demonstrated, not argued.

Run: PYTHONPATH=. python tools/seed_invariance.py [n_species n_reads]
"""

import functools
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from layout_invariance import classify_rows  # noqa: E402


def flip_stats(a, b):
    """(identical-row reads, identical-top-accession reads, n)."""
    same = sum(a[r] == b[r] for r in a)
    top_same = 0
    for r in a:
        x = max(a[r], key=lambda t: t[1], default=None)
        y = max(b[r], key=lambda t: t[1], default=None)
        top_same += (x is None and y is None) or (
            x is not None and y is not None and x[0] == y[0])
    return same, top_same, len(a)


def main(n_species=300, n_reads=900):
    from util import make_reads, make_ref_set

    import taxor_jax.hixf.build as hb
    from taxor_jax.apps.build import BuildConfig, run_build
    from taxor_jax.ixf.xor_filter import XOR_SEED0, build_ixf

    tmp = tempfile.mkdtemp(prefix="seed_inv_")
    rng = np.random.default_rng(123)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=n_species,
                                      genome_len=3000)
    reads = make_reads(tmp, rng, genomes,
                       n_reads_per_genome=max(1, n_reads // n_species),
                       read_len=800, error_rate=0.03)

    orig_build_ixf = build_ixf

    def build_with_seed(layout_name, mode, tmax, seed, resume):
        hb.build_ixf = functools.partial(orig_build_ixf, seed=seed)
        try:
            return run_build(BuildConfig(
                input_file=tsv, input_sequence_dir=gdir,
                output_filename="", kmer_size=16, syncmer_size=8,
                use_syncmer=True, layout_mode=mode, tmax=tmax,
                layout_file=os.path.join(tmp, layout_name),
                resume=resume, threads=2))
        finally:
            hb.build_ixf = orig_build_ixf

    seed_b = (XOR_SEED0 * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)

    # same layout file, two seeds (second run resumes from binning.out,
    # so bin contents are byte-identical; only the filter roll differs)
    ix_a = build_with_seed("t64.out", "auto", 64, XOR_SEED0, False)
    ix_b = build_with_seed("t64.out", "auto", 64, seed_b, True)
    # genuinely different layout, reference seed (the waiver's original
    # comparison; flat vs hierarchical is the maximal layout change)
    ix_c = build_with_seed("flat.out", "flat", 0, XOR_SEED0, False)

    rows_a = classify_rows(ix_a, reads)
    rows_b = classify_rows(ix_b, reads)
    rows_c = classify_rows(ix_c, reads)

    print(f"index sizes: t64 {len(ix_a.hixf.ixfs)} IXFs, "
          f"t128 {len(ix_c.hixf.ixfs)} IXFs")
    for label, x, y in (
        ("same layout, seed A vs B (pure FP-noise control)", rows_a,
         rows_b),
        ("different layout (hier t64 vs flat), same seed", rows_a,
         rows_c),
    ):
        same, top, n = flip_stats(x, y)
        print(f"{label}:")
        print(f"  identical rows       {same}/{n}  "
              f"({100.0 * same / n:.2f}%)")
        print(f"  identical top-accession {top}/{n}  "
              f"({100.0 * top / n:.2f}%)")


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:]]
    main(*a)

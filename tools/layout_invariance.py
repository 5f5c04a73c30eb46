#!/usr/bin/env python3
"""Layout-invariance experiment (DIVERGENCES.md #6 waiver evidence).

The layout DP here is a reimplementation of the published HIBF algorithm,
not a byte-port of chopper (which is not in the reference tree), so
layouts differ from the reference's.  Layout choice can influence
classification only through (a) filter false-positive noise (different
bin arrangements hash differently) and (b) merged-bin descent thresholds.
This experiment builds the SAME reference set under deliberately
different layouts and diffs the final classification rows (the
product-visible search TSV) read by read.

Run: PYTHONPATH=. python tools/layout_invariance.py [n_species n_reads]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def classify_rows(index, reads_file):
    """read id -> frozenset of (accession, count) emission rows via the
    host oracle engine (bit-equal reference semantics)."""
    from taxor_jax.io.fastx import read_all
    from taxor_jax.hash.schemes import search_hashes
    from taxor_jax.search.pipeline import _read_threshold
    from taxor_jax.search.thresholds import Thresholder

    scheme = index.scheme
    th = Thresholder.make(scheme.kmer_size, scheme.window_size, 0.04,
                          -1.0, scheme.use_syncmer)
    ub2sp = index.user_bin_to_species()
    recs = read_all(reads_file)
    hls = search_hashes([r.seq for r in recs], scheme)
    out = {}
    for rec, hl in zip(recs, hls):
        thr = _read_threshold(th, hl.shape[0], len(rec.seq),
                              scheme.kmer_size)
        pairs = index.hixf.membership(hl, thr)
        if pairs:
            mx = max(c for _, c in pairs)
            rows = frozenset(
                (index.species[ub2sp[u]].accession_id, c)
                for u, c in pairs if not float(c) < float(mx) * 0.8)
        else:
            rows = frozenset()
        out[rec.id] = rows
    return out


def main(n_species=100, n_reads=400):
    from util import make_reads, make_ref_set

    from taxor_jax.apps.build import BuildConfig, run_build

    tmp = tempfile.mkdtemp(prefix="layout_inv_")
    rng = np.random.default_rng(123)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=n_species,
                                      genome_len=3000)
    reads = make_reads(tmp, rng, genomes,
                       n_reads_per_genome=max(1, n_reads // n_species),
                       read_len=800, error_rate=0.03)

    layouts = [("flat", "flat", 0), ("auto_t64", "auto", 64),
               ("auto_t128", "auto", 128), ("auto_t4096", "auto", 4096)]
    results = {}
    for name, mode, tmax in layouts:
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode=mode, tmax=tmax,
            layout_file=os.path.join(tmp, f"{name}.out")))
        results[name] = (classify_rows(index, reads),
                         len(index.hixf.ixfs))

    base_name = layouts[0][0]
    base, _ = results[base_name]
    print(f"{'layout':<12}{'IXFs':>5}  identical-rows  "
          f"identical-argmax  (vs {base_name})")
    for name, (rows, n_ixfs) in results.items():
        same = sum(rows[r] == base[r] for r in base)
        argmax_same = 0
        for r in base:
            a = max(base[r], key=lambda t: t[1], default=None)
            b = max(rows[r], key=lambda t: t[1], default=None)
            argmax_same += (a is None and b is None) or (
                a is not None and b is not None and a[0] == b[0])
        print(f"{name:<12}{n_ixfs:>5}  {same}/{len(base)}"
              f"{'':<10}{argmax_same}/{len(base)}")
        if name != base_name:
            for r in sorted(base):
                if rows[r] != base[r]:
                    print(f"  diff {r}: {sorted(base[r])} vs "
                          f"{sorted(rows[r])}")


if __name__ == "__main__":
    a = [int(x) for x in sys.argv[1:]]
    main(*a)

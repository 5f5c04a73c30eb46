"""End-to-end slice: build a flat index from synthetic genomes, search
simulated reads, check planted-truth recovery and host/device engine
agreement, index save/load roundtrip, layout file roundtrip."""

import os

import numpy as np
import pytest

from taxor_jax.apps.build import BuildConfig, run_build
from taxor_jax.hixf.index import load_index, save_index
from taxor_jax.hixf.layout import flat_layout, parse_layout, write_layout
from taxor_jax.search.pipeline import SearchConfig, run_search

from .util import make_reads, make_ref_set


@pytest.fixture(scope="module")
def ref_set(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("refs"))
    rng = np.random.default_rng(42)
    tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=6,
                                      genome_len=20000)
    reads = make_reads(tmp, rng, genomes, n_reads_per_genome=4,
                       read_len=1500, error_rate=0.02)
    return tmp, tsv, gdir, genomes, reads


@pytest.fixture(scope="module")
def built_index(ref_set):
    tmp, tsv, gdir, genomes, reads = ref_set
    out = os.path.join(tmp, "index.taxor.npz")
    cfg = BuildConfig(
        input_file=tsv,
        input_sequence_dir=gdir,
        output_filename=out,
        kmer_size=16,
        syncmer_size=8,
        use_syncmer=True,
        layout_mode="flat",
        layout_file=os.path.join(tmp, "binning.out"),
    )
    index = run_build(cfg)
    return out, index


class TestBuild:
    def test_species_bookkeeping(self, built_index):
        _, index = built_index
        assert len(index.species) == 6
        assert sorted(sp.user_bin for sp in index.species) == list(range(6))
        for sp in index.species:
            assert sp.seq_len == 20000

    def test_index_roundtrip(self, built_index, tmp_path):
        out, index = built_index
        loaded = load_index(out)
        assert loaded.scheme == index.scheme
        assert len(loaded.hixf.ixfs) == len(index.hixf.ixfs)
        for a, b in zip(loaded.hixf.ixfs, index.hixf.ixfs):
            assert a.seed == b.seed and a.block_length == b.block_length
            np.testing.assert_array_equal(a.fingerprints, b.fingerprints)
        assert [sp.accession_id for sp in loaded.species] == [
            sp.accession_id for sp in index.species
        ]

    def test_layout_roundtrip(self, built_index, ref_set):
        tmp = ref_set[0]
        layout = parse_layout(os.path.join(tmp, "binning.out"))
        assert len(layout.records) == 6
        assert layout.num_technical_bins == 6
        # re-emit and re-parse: stable
        p2 = os.path.join(tmp, "binning2.out")
        write_layout(layout, p2)
        layout2 = parse_layout(p2)
        assert [r.filenames for r in layout2.records] == [
            r.filenames for r in layout.records
        ]


class TestSpillBuild:
    def test_spill_build_matches_ram_build(self, ref_set, built_index,
                                           tmp_path):
        tmp, tsv, gdir, genomes, reads = ref_set
        out2 = os.path.join(str(tmp_path), "spill.taxor.npz")
        spill = os.path.join(str(tmp_path), "spill_tmp")
        index2 = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir,
            output_filename=out2, kmer_size=16, syncmer_size=8,
            use_syncmer=True, layout_mode="flat", layout_file="",
            spill_dir=spill,
        ))
        _, index1 = built_index
        for a, b in zip(index1.hixf.ixfs, index2.hixf.ixfs):
            np.testing.assert_array_equal(a.fingerprints, b.fingerprints)
        # spill files cleaned up as unions are consumed; per-file hashes
        # remain until process exit (store owns them)
        assert os.path.isdir(spill)


class TestSearch:
    def _run(self, built_index, ref_set, engine, name):
        tmp, tsv, gdir, genomes, reads = ref_set
        out_file, _ = built_index
        report = os.path.join(tmp, f"search_{name}.tsv")
        run_search(SearchConfig(
            index_file=out_file,
            query_file=reads,
            report_file=report,
            engine=engine,
        ))
        return report

    def test_planted_truth_recovered(self, built_index, ref_set):
        report = self._run(built_index, ref_set, "host", "host")
        with open(report) as fh:
            lines = fh.read().splitlines()
        assert lines[0].startswith("#QUERY_NAME")
        rows = [l.split("\t") for l in lines[1:]]
        assert len(rows) >= 24  # every read produces >= 1 row
        correct = 0
        total = 0
        for r in rows:
            if r[1] == "-":
                continue
            total += 1
            true_acc = r[0].split("_", 1)[1]
            if r[1] == true_acc:
                correct += 1
        assert total >= 20
        assert correct / total > 0.9

    def test_host_device_agree(self, built_index, ref_set):
        host = self._run(built_index, ref_set, "host", "h2")
        device = self._run(built_index, ref_set, "device", "d2")
        assert open(host).read() == open(device).read()

    def test_no_hit_row_format(self, built_index, ref_set, tmp_path):
        tmp, *_ = ref_set
        out_file, _ = built_index
        # a read that matches nothing: random unrelated sequence
        rng = np.random.default_rng(999)
        from .util import write_fasta, random_genome

        q = os.path.join(tmp, "nohit.fasta")
        write_fasta(q, [("garbage read", random_genome(rng, 800))])
        report = os.path.join(tmp, "nohit.tsv")
        run_search(SearchConfig(index_file=out_file, query_file=q,
                                report_file=report, engine="host"))
        lines = open(report).read().splitlines()
        assert len(lines) == 2
        cols = lines[1].split("\t")
        assert cols == ["garbage read", "-", "-", "-", "-", "800"]

    def test_sharded_engine_agrees(self, built_index, ref_set):
        # GSPMD bin+read sharded engine over the 8 virtual CPU devices
        host = self._run(built_index, ref_set, "host", "sh_h")
        shard = self._run(built_index, ref_set, "sharded", "sh_s")
        assert open(host).read() == open(shard).read()

    def test_batch_invariance(self, built_index, ref_set):
        # classification independent of batch size (property test, §4)
        tmp, tsv, gdir, genomes, reads = ref_set
        out_file, _ = built_index
        a = os.path.join(tmp, "b1.tsv")
        b = os.path.join(tmp, "b2.tsv")
        run_search(SearchConfig(index_file=out_file, query_file=reads,
                                report_file=a, engine="device",
                                batch_size=3))
        run_search(SearchConfig(index_file=out_file, query_file=reads,
                                report_file=b, engine="device",
                                batch_size=1024))
        assert open(a).read() == open(b).read()


class TestOrderInvariance:
    def test_search_rows_invariant_to_taxonomy_order(self, ref_set,
                                                     tmp_path):
        # SURVEY §4 property test: permuting the taxonomy input rows must
        # not change the classification content (row order per read may
        # follow the layout's DFS order, so compare row sets)
        tmp, tsv, gdir, genomes, reads = ref_set
        lines = open(tsv).read().splitlines()
        tsv2 = os.path.join(str(tmp_path), "tax_rev.tsv")
        open(tsv2, "w").write("\n".join(reversed(lines)) + "\n")

        outs = []
        for name, t in [("fwd", tsv), ("rev", tsv2)]:
            out = os.path.join(str(tmp_path), f"{name}.npz")
            run_build(BuildConfig(
                input_file=t, input_sequence_dir=gdir, output_filename=out,
                kmer_size=16, syncmer_size=8, use_syncmer=True,
                layout_mode="auto", tmax=64, layout_file="",
            ))
            rep = os.path.join(str(tmp_path), f"{name}.tsv")
            run_search(SearchConfig(index_file=out, query_file=reads,
                                    report_file=rep, engine="host",
                                    percentage=0.3))
            outs.append(rep)
        rows_a = set(open(outs[0]).read().splitlines()[1:])
        rows_b = set(open(outs[1]).read().splitlines()[1:])
        assert rows_a == rows_b


class TestMultiIndexMultiQuery:
    """Comma-separated index/query lists share ONE output file + header
    (taxor_search.cpp:97-151,340-360); schemes must agree across
    indexes."""

    def test_outer_product_single_output(self, built_index, ref_set,
                                         tmp_path):
        tmp, tsv, gdir, genomes, reads = ref_set
        out_file, _ = built_index
        # second index: same scheme, different (sub)set handled by the
        # same build path — reuse the same index file for the list
        idx2 = str(tmp_path / "copy.taxor.npz")
        import shutil

        shutil.copy(out_file, idx2)
        q2 = str(tmp_path / "q2.fasta")
        shutil.copy(reads, q2)
        report = str(tmp_path / "multi.tsv")
        run_search(SearchConfig(
            index_file=f"{out_file},{idx2}",
            query_file=f"{reads},{q2}",
            report_file=report, engine="host"))
        lines = open(report).read().splitlines()
        assert sum(1 for l in lines if l.startswith("#QUERY_NAME")) == 1
        single = str(tmp_path / "single.tsv")
        run_search(SearchConfig(index_file=out_file, query_file=reads,
                                report_file=single, engine="host"))
        base_rows = open(single).read().splitlines()[1:]
        # 2 queries x 2 identical indexes -> every base row 4 times
        assert len(lines) - 1 == 4 * len(base_rows)

    def test_scheme_mismatch_rejected(self, built_index, ref_set,
                                      tmp_path):
        tmp, tsv, gdir, genomes, reads = ref_set
        out_file, _ = built_index
        other = str(tmp_path / "otherscheme.taxor.npz")
        run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir,
            output_filename=other, kmer_size=18, syncmer_size=8,
            use_syncmer=True, layout_mode="flat",
            layout_file=str(tmp_path / "b.out")))
        with pytest.raises(ValueError, match="different"):
            run_search(SearchConfig(
                index_file=f"{out_file},{other}", query_file=reads,
                report_file=str(tmp_path / "x.tsv"), engine="host"))


class TestLongReads:
    """ONT batches mix ~500 b and tens-of-kb reads; per-read length
    bucketing must keep every read on a correct path (device fused for
    <= L_CAP at its power-of-two bucket, host-extraction fallback
    beyond) with output identical to the host oracle."""

    def _mixed_query(self, ref_set, tmp_path):
        from .util import write_fasta

        tmp, tsv, gdir, genomes, reads = ref_set
        rng = np.random.default_rng(77)
        gseqs = [genomes[a] for a in sorted(genomes)]
        recs = []
        for i, ln in enumerate([300, 900, 2500, 7000, 12000, 20000]):
            g = gseqs[i % len(gseqs)]
            start = int(rng.integers(0, max(1, len(g) - 100)))
            seq = (g * (ln // len(g) + 2))[start : start + ln]
            recs.append((f"mix{i}_len{ln}", seq))
        q = str(tmp_path / "mixed.fasta")
        write_fasta(q, recs)
        return q

    def test_mixed_lengths_host_device_identical(self, built_index,
                                                 ref_set, tmp_path):
        out_file, _ = built_index
        q = self._mixed_query(ref_set, tmp_path)
        outs = {}
        for engine in ("host", "device"):
            rep = str(tmp_path / f"mixed_{engine}.tsv")
            run_search(SearchConfig(index_file=out_file, query_file=q,
                                    report_file=rep, engine=engine))
            outs[engine] = open(rep).read()
        assert outs["host"] == outs["device"]
        # all six reads present and classified rows exist
        lines = outs["host"].splitlines()[1:]
        ids = {l.split("\t")[0] for l in lines}
        assert len(ids) == 6
        assert any(l.split("\t")[1] != "-" for l in lines)


class TestBuildArtifactsAndResume:
    def test_count_artifacts_and_layout_resume(self, ref_set, tmp_path):
        """Counting-stage artifacts (chopper.count analog,
        taxor_build.cpp:437-442) + resume from an existing layout file."""
        import glob

        from taxor_jax.apps.build import BuildConfig, run_build

        tmp, tsv, gdir, genomes, reads = ref_set
        layout_file = str(tmp_path / "binning.out")
        prefix = str(tmp_path / "chopper")
        cfg = dict(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="auto", tmax=64, layout_file=layout_file,
        )
        idx1 = run_build(BuildConfig(**cfg, count_output_prefix=prefix))
        # artifacts: one count line + one sketch per accession cluster
        with open(prefix + ".count") as fh:
            lines = [ln.split("\t") for ln in fh.read().splitlines()]
        assert len(lines) == len(genomes)
        for parts in lines:
            assert len(parts) == 3 and int(parts[1]) > 0
        assert len(glob.glob(prefix + "_sketches/*.hll.npy")) == len(genomes)

        # resume: reuse the layout file; the rebuilt index must match
        idx2 = run_build(BuildConfig(**cfg, resume=True))
        assert len(idx2.hixf.ixfs) == len(idx1.hixf.ixfs)
        for a, b in zip(idx1.hixf.ixfs, idx2.hixf.ixfs):
            assert (a.fingerprints == b.fingerprints).all()

    def test_verbose_stats_prints_sweep(self, ref_set, tmp_path, capsys):
        from taxor_jax.apps.build import BuildConfig, run_build

        tmp, tsv, gdir, genomes, reads = ref_set
        run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="auto", tmax=64,
            layout_file=str(tmp_path / "b.out"), verbose_stats=True,
        ))
        out = capsys.readouterr().out
        assert "expected query cost" in out and "chosen t_max" in out


class TestSpillHierarchicalBuild:
    def test_spill_hier_build_matches_ram_build(self, ref_set, tmp_path):
        """The two-phase uniform-level-geometry builder must produce
        identical fingerprints with per-bin hash lists spilled to disk
        (the hixf_tmp/ analog) on a genuinely hierarchical layout."""
        tmp, tsv, gdir, genomes, reads = ref_set
        cfg = dict(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="auto", tmax=64,
            layout_file=os.path.join(str(tmp_path), "b.out"),
        )
        idx_ram = run_build(BuildConfig(**cfg))
        spill = os.path.join(str(tmp_path), "spill_tmp")
        idx_spill = run_build(BuildConfig(**cfg, spill_dir=spill))
        assert len(idx_ram.hixf.ixfs) == len(idx_spill.hixf.ixfs)
        for a, b in zip(idx_ram.hixf.ixfs, idx_spill.hixf.ixfs):
            np.testing.assert_array_equal(a.fingerprints, b.fingerprints)
        assert os.path.isdir(spill)


class TestTopkEscalation:
    def test_near_identical_refs_device_matches_host(self, tmp_path,
                                                     monkeypatch):
        """Near-identical reference sets fill every top-k slot with
        co-equal counts; the pipeline escalates the device candidate
        width (16 -> 64 -> 256) across batches and the output must stay
        identical to the host engine either way (truncated reads fall
        back to the exact host oracle)."""
        tmp = str(tmp_path)
        rng = np.random.default_rng(9)
        tsv, gdir, genomes = make_ref_set(tmp, rng, n_species=40,
                                          genome_len=6000)
        # every genome = the first genome with 0.5% point mutations
        base = genomes[sorted(genomes)[0]]
        arr0 = np.frombuffer(base, dtype=np.uint8).copy()
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        for acc in sorted(genomes):
            arr = arr0.copy()
            idx = rng.choice(len(arr), size=len(arr) // 200, replace=False)
            arr[idx] = bases[rng.integers(0, 4, idx.shape[0])]
            genomes[acc] = arr.tobytes()
            with open(os.path.join(gdir, f"{acc}_genomic.fna"), "wb") as fh:
                fh.write(b">" + acc.encode() + b"\n" + genomes[acc] + b"\n")
        reads = make_reads(tmp, rng, genomes, n_reads_per_genome=2,
                           read_len=800, error_rate=0.02)
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="flat", layout_file="",
        ))
        idx_file = os.path.join(tmp, "ni.taxor.npz")
        from taxor_jax.hixf.index import save_index
        save_index(idx_file, index)

        host_tsv = os.path.join(tmp, "host.tsv")
        run_search(SearchConfig(index_file=idx_file, query_file=reads,
                                report_file=host_tsv, engine="host"))

        # the fused device path runs the escalation logic; small
        # batches create multiple chunks so the escalated width applies
        # to later ones
        dev_tsv = os.path.join(tmp, "dev.tsv")
        run_search(SearchConfig(index_file=idx_file, query_file=reads,
                                report_file=dev_tsv, engine="device",
                                batch_size=20))
        with open(host_tsv) as a, open(dev_tsv) as b:
            assert a.read() == b.read()


class TestSuggestedTopk:
    """Build-time homology pre-seeds the search top-k ladder
    (hixf/index.py suggested_topk, apps/build._suggest_topk)."""

    def test_distinct_refs_stay_at_16(self, tmp_path):
        import numpy as np

        from taxor_jax.apps.build import BuildConfig, run_build

        from .util import make_ref_set

        rng = np.random.default_rng(21)
        tsv, gdir, _ = make_ref_set(str(tmp_path), rng, n_species=12,
                                    genome_len=3000)
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir, output_filename="",
            kmer_size=16, syncmer_size=8, use_syncmer=True,
            layout_mode="flat", layout_file=""))
        assert index.suggested_topk == 16

    def test_near_identical_refs_preseed_and_roundtrip(self, tmp_path):
        import os

        import numpy as np

        from taxor_jax.apps.build import BuildConfig, run_build
        from taxor_jax.hixf.index import load_index

        from .util import make_ref_set

        rng = np.random.default_rng(22)
        tsv, gdir, genomes = make_ref_set(str(tmp_path), rng,
                                          n_species=12, genome_len=3000)
        # overwrite every genome with light mutations of the first
        base = np.frombuffer(genomes[sorted(genomes)[0]],
                             dtype=np.uint8).copy()
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        for acc in sorted(genomes):
            arr = base.copy()
            idx = rng.choice(len(arr), size=len(arr) // 200,
                             replace=False)
            arr[idx] = bases[rng.integers(0, 4, len(idx))]
            with open(os.path.join(gdir, f"{acc}_genomic.fna"),
                      "wb") as fh:
                fh.write(b">" + acc.encode() + b"\n" + arr.tobytes()
                         + b"\n")
        out = str(tmp_path / "idx.npz")
        index = run_build(BuildConfig(
            input_file=tsv, input_sequence_dir=gdir,
            output_filename=out, kmer_size=16, syncmer_size=8,
            use_syncmer=True, layout_mode="flat", layout_file=""))
        assert index.suggested_topk >= 64
        assert load_index(out).suggested_topk == index.suggested_topk

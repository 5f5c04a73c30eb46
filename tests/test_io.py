"""IO layer: FASTA/FASTQ parsing, compression, taxonomy parsing."""

import bz2
import gzip
import os

import numpy as np
import pytest

from taxor_jax.io.fastx import iter_fastx, iter_fastx_chunks, read_all
from taxor_jax.io.taxonomy import (
    parse_gtdb_taxonomy_file,
    parse_refseq_taxonomy_file,
)

FASTA = b">seq1 description here\nACGTACGT\nACGT\n>seq2\nTTTT\n"
FASTQ = b"@read1 desc\nACGTACGT\n+\nIIIIIIII\n@read2\nGGGG\n+\nIIII\n"


class TestFastx:
    def test_fasta_multiline(self, tmp_path):
        p = os.path.join(str(tmp_path), "a.fna")
        open(p, "wb").write(FASTA)
        recs = read_all(p)
        assert [r.id for r in recs] == ["seq1 description here", "seq2"]
        assert recs[0].seq == b"ACGTACGTACGT"
        assert recs[1].seq == b"TTTT"

    def test_fastq(self, tmp_path):
        p = os.path.join(str(tmp_path), "a.fastq")
        open(p, "wb").write(FASTQ)
        recs = read_all(p)
        assert [r.id for r in recs] == ["read1 desc", "read2"]
        assert recs[0].seq == b"ACGTACGT"
        assert recs[1].seq == b"GGGG"

    def test_gzip(self, tmp_path):
        p = os.path.join(str(tmp_path), "a.fna.gz")
        with gzip.open(p, "wb") as fh:
            fh.write(FASTA)
        recs = read_all(p)
        assert len(recs) == 2 and recs[0].seq == b"ACGTACGTACGT"

    def test_bzip2(self, tmp_path):
        p = os.path.join(str(tmp_path), "a.fastq.bz2")
        with bz2.open(p, "wb") as fh:
            fh.write(FASTQ)
        recs = read_all(p)
        assert len(recs) == 2 and recs[1].seq == b"GGGG"

    def test_chunking(self, tmp_path):
        p = os.path.join(str(tmp_path), "many.fna")
        with open(p, "w") as fh:
            for i in range(10):
                fh.write(f">r{i}\nACGT\n")
        chunks = list(iter_fastx_chunks(p, 4))
        assert [len(c) for c in chunks] == [4, 4, 2]

    def test_not_fastx_raises(self, tmp_path):
        p = os.path.join(str(tmp_path), "bad.txt")
        open(p, "w").write("hello\n")
        with pytest.raises(ValueError):
            list(iter_fastx(p))


class TestTaxonomy:
    def test_six_columns(self, tmp_path):
        p = os.path.join(str(tmp_path), "tax.tsv")
        open(p, "w").write(
            "GCF_1.1\t100\tftp://host/path/GCF_1.1_genomic.fna\tOrg 1\t"
            "k__V;s__S\t1;100\n"
        )
        orgs = parse_refseq_taxonomy_file(p)
        assert orgs[0].accession_id == "GCF_1.1"
        assert orgs[0].taxid == "100"
        assert orgs[0].file_stem == "GCF_1.1_genomic.fna"
        assert orgs[0].taxnames_string == "k__V;s__S"
        # GTDB alias parses identically
        assert parse_gtdb_taxonomy_file(p)[0].accession_id == "GCF_1.1"

    def test_missing_file_stem_raises(self, tmp_path):
        p = os.path.join(str(tmp_path), "tax.tsv")
        open(p, "w").write("GCF_1.1\t100\tftp://host/path/\tOrg\tk__V\t1\n")
        with pytest.raises(ValueError):
            parse_refseq_taxonomy_file(p)


class TestMultiLineFastq:
    def test_wrapped_sequence_and_quality(self, tmp_path):
        from taxor_jax.io.fastx import read_all

        p = tmp_path / "w.fastq"
        # wrapped records; quality lines legitimately starting with '@'/'+'
        p.write_text(
            "@r1\nACGTACGT\nAAAA\n+\n@@@@\nIIII\nAAAA\n"
            "@r2 desc\nTTTT\nGG\n+r2\n+@II\nII\n"
        )
        recs = read_all(str(p))
        assert [r.id for r in recs] == ["r1", "r2 desc"]
        assert recs[0].seq == b"ACGTACGTAAAA"
        assert recs[1].seq == b"TTTTGG"

    def test_single_line_fastq_still_works(self, tmp_path):
        from taxor_jax.io.fastx import read_all

        p = tmp_path / "s.fastq"
        p.write_text("@a\nACGT\n+\nIIII\n@b\nGGCC\n+\nIIII\n")
        recs = read_all(str(p))
        assert [(r.id, r.seq) for r in recs] == [("a", b"ACGT"),
                                                 ("b", b"GGCC")]

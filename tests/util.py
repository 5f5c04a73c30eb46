"""Shared synthetic-data helpers for tests and bench."""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng, length: int) -> bytes:
    return BASES[rng.integers(0, 4, length)].tobytes()


def mutate(rng, seq: bytes, error_rate: float) -> bytes:
    """Simple substitution-only read errors."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    n_err = rng.binomial(arr.shape[0], error_rate)
    pos = rng.choice(arr.shape[0], size=n_err, replace=False)
    arr[pos] = BASES[rng.integers(0, 4, n_err)]
    return arr.tobytes()


def simulate_read(rng, genome: bytes, read_len: int,
                  error_rate: float) -> bytes:
    start = int(rng.integers(0, max(1, len(genome) - read_len)))
    return mutate(rng, genome[start : start + read_len], error_rate)


def write_fasta(path: str, records: list[tuple[str, bytes]]) -> None:
    with open(path, "w") as fh:
        for rid, seq in records:
            fh.write(f">{rid}\n{seq.decode()}\n")


def make_ref_set(tmpdir: str, rng, n_species: int = 6,
                 genome_len: int = 20000, genome_lens=None):
    """Creates genome FASTAs + a 6-column taxonomy TSV.  genome_lens
    (optional, one length per species) overrides the fixed genome_len.

    Returns (taxonomy_tsv_path, genome_dir, genomes dict acc->seq).
    """
    gdir = os.path.join(tmpdir, "genomes")
    os.makedirs(gdir, exist_ok=True)
    rows = []
    genomes = {}
    for i in range(n_species):
        acc = f"GCF_{i:06d}.1"
        seq = random_genome(
            rng, genome_len if genome_lens is None else int(genome_lens[i]))
        genomes[acc] = seq
        fname = f"{acc}_genomic.fna"
        write_fasta(os.path.join(gdir, fname), [(f"{acc} chromosome", seq)])
        taxid = str(1000 + i)
        names = (
            f"k__Viruses;p__Phylum{i % 2};c__Class{i % 2};o__Order{i % 2};"
            f"f__Family{i % 3};g__Genus{i};s__Species {i}"
        )
        taxids = (
            f"10239;{2000 + i % 2};{3000 + i % 2};{4000 + i % 2};"
            f"{5000 + i % 3};{6000 + i};{1000 + i}"
        )
        rows.append(
            f"{acc}\t{taxid}\tftp://x/{acc}_genomic.fna\tOrganism {i}\t"
            f"{names}\t{taxids}"
        )
    tsv = os.path.join(tmpdir, "taxonomy.tsv")
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tsv, gdir, genomes


def make_reads(tmpdir: str, rng, genomes: dict, n_reads_per_genome: int = 5,
               read_len: int = 2000, error_rate: float = 0.02) -> str:
    """Simulated reads FASTA; read ids encode the source accession."""
    records = []
    c = 0
    for acc, seq in genomes.items():
        for _ in range(n_reads_per_genome):
            records.append(
                (f"read{c}_{acc}", simulate_read(rng, seq, read_len,
                                                 error_rate))
            )
            c += 1
    path = os.path.join(tmpdir, "reads.fasta")
    write_fasta(path, records)
    return path

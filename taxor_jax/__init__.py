"""taxor_jax — a long-read taxonomic classifier on a JAX accelerator.

A from-scratch JAX/XLA framework with the capabilities of Taxor
(Ulrich & Renard, Genome Research 2024): open-canonical-syncmer / k-mer /
minimizer hashing, hierarchical interleaved XOR filter (HIXF) membership
counting, statistical match thresholds, EM read reassignment and CAMI
profiling output.

Architecture (device-first, not a port):
  - host (numpy / C++): sequence IO, host-route hash extraction, XOR-filter
    peeling (inherently sequential), HIBF layout DP, profile/EM text
    transform
  - device (JAX/XLA, one NVIDIA GPU or a mesh of them): read hash
    extraction, fingerprint probe + per-bin counts over device-resident
    [slots, bins] uint8 tables, level-synchronous HIXF traversal,
    read-sharded (DP) and bin-sharded (index-parallel) meshes

Reference behavior citations use <path>:<line> in the reference Taxor
source tree.
"""

__version__ = "0.1.0"

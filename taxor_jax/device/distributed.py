"""Multi-host distributed setup.

The reference has no distributed backend at all (SURVEY.md §2.3); scaling
beyond one host is an addition of this rebuild.  The model:

  - every host runs the same CLI with ``--distributed`` (or the env vars
    JAX supports natively); ``jax.distributed.initialize`` wires the hosts
    into one runtime, after which ``jax.devices()`` spans every host's
    cards; each host runs ONE process, which owns all of its cards,
  - the search pipeline's 'sharded' engine then builds its reads x bins
    mesh over the global device list: fingerprint columns shard over
    'bins' (each host's HBM holds a slice of a GTDB-scale index),
    read batches shard over 'reads',
  - collectives ride NVLink within a host and the network across hosts,
    compiled by XLA from the sharding annotations — no hand-written
    communication.

Failure semantics: fail-fast (a batch tool re-runs); no elasticity, like
the reference (errors -> exit).
"""

from __future__ import annotations


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the multi-host JAX runtime.  With no arguments, relies
    on the environment (JAX_COORDINATOR_ADDRESS etc.);
    single-process setups may skip calling this entirely."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(reads_shards: int | None = None,
                bin_shards: int | None = None):
    """reads x bins mesh over the global device list.  Defaults: shard
    bins across hosts (index parallel — each host's HBM holds a slice of
    the fingerprint matrix) and reads across the devices of each host
    (data parallel).  jax.devices() is process-major, so the device grid
    is laid out (bins, reads) then transposed: the bins axis then spans
    processes (the network) while the reads axis stays within a host."""
    import jax
    import numpy as np

    from jax.sharding import Mesh

    devices = jax.devices()
    n = len(devices)
    if bin_shards is None:
        bin_shards = max(1, jax.process_count())
    if reads_shards is None:
        reads_shards = max(1, n // bin_shards)
    arr = np.array(devices[: reads_shards * bin_shards])
    arr = arr.reshape(bin_shards, reads_shards).T
    return Mesh(arr, ("reads", "bins"))

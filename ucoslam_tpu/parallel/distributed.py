"""Multi-host initialization and global meshes.

The reference is a single process (SURVEY.md §2.3: std::thread only) —
multi-host distribution is this framework's NEW capability. Topology
convention:

- the intra-host links (NVLink between the GPUs of one host) carry the
  per-LM-step collectives (the psum of the reduced camera system in
  parallel/sharded_ba.py and the two psums per pose-graph step) —
  shardings keep each host's devices contiguous;
- the network between hosts is touched only at `init_distributed`
  (process rendezvous) and by checkpoint IO (io/serialize.py writes from
  process 0).

Single-process fallback: with no coordinator configured, everything here
degrades to the local-device mesh, so call sites never branch on topology.
The tests exercise it on multi-process CPU meshes; multi-host runs on GPUs
have not been made.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the jax.distributed rendezvous (several hosts).

    Arguments default from the standard environment (JAX_COORDINATOR_ADDRESS
    / NUM_PROCESSES / PROCESS_ID or the cluster runtime's auto-detection). Returns
    True when a multi-process runtime was initialized, False for the
    single-process fallback (no coordinator configured — the common
    single-host case, including this test environment).
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("NUM_PROCESSES")
    env_pid = os.environ.get("PROCESS_ID")
    if coordinator_address is None and env_np is None:
        return False  # single-process: nothing to rendezvous
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes
        if num_processes is not None
        else (int(env_np) if env_np else None),
        process_id=process_id
        if process_id is not None
        else (int(env_pid) if env_pid else None),
    )
    _initialized = True
    return jax.process_count() > 1


def global_mesh(axis: str = "pt") -> Mesh:
    """1-D mesh over EVERY device in the job (all hosts).

    Device order groups each process's local devices contiguously, so a
    point-block shard's observations stay on one host and the sharded-BA
    psum reduces within the host before crossing hosts (if any).
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs), (axis,))


def is_primary() -> bool:
    """True on the process that owns checkpoint/log IO (process 0)."""
    return jax.process_index() == 0

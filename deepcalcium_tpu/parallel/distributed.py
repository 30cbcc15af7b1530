"""Multi-host initialization and mesh construction.

The reference is single-process/single-GPU with no collectives (SURVEY
§2.2). This module is the multi-slice/multi-host entry point for the
rebuild: call :func:`initialize` once per process before any JAX use on a
multi-host GPU cluster; build meshes with :func:`pod_mesh`.

On a single host (or under the test harness) both are safe no-ops /
trivial meshes, so the same training scripts run unchanged from a laptop to
a cluster — the GSPMD train step (train/trainer.py) is layout-agnostic.
"""

import logging

import jax
import numpy as np
from jax.sharding import Mesh

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for multi-host runs.

    No-op when no coordinator is configured (single-host). With all args
    None, ``jax.distributed.initialize`` auto-discovers the GPU cluster
    where the scheduler publishes it (e.g. SLURM, Open MPI); elsewhere pass
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly.
    """
    if coordinator_address is None and num_processes is None:
        if jax.process_count() > 1:  # already initialized by the runtime
            return
        try:
            jax.distributed.initialize()
            logger.info("jax.distributed initialized: process %d/%d",
                        jax.process_index(), jax.process_count())
        except Exception as e:
            # WARNING, not info: on a real multi-host cluster a failed
            # auto-init silently degrades to per-host isolated training
            # (gradients never sync across hosts). Single-host users see
            # one benign warning; cluster users get a visible signal.
            logger.warning(
                "jax.distributed auto-init failed (%s) — continuing "
                "single-process. If this IS a multi-host run, training "
                "will NOT synchronize across hosts; pass explicit "
                "coordinator_address/num_processes/process_id.", e)
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def pod_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device of every process (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def global_batch_from_local(mesh: Mesh, batch, axis: str = "data"):
    """Assemble a globally-sharded device batch from each process's LOCAL
    host data (multi-host pods: every process feeds only its own shard;
    SURVEY §2.2 'jax.distributed + DCN').

    Uses ``jax.make_array_from_process_local_data``: the global batch dim is
    the concatenation of all processes' local dim-0 sizes; on a single-host
    mesh this degrades to a sharded ``device_put``. Per-process local batch
    sizes must divide over the process's addressable devices.
    """
    from deepcalcium_tpu.parallel.mesh import batch_sharding

    def put(x):
        x = np.asarray(x)
        s = batch_sharding(mesh, x.ndim, axis)
        return jax.make_array_from_process_local_data(s, x)

    return jax.tree.map(put, batch)

"""Subprocess worker for test_distributed_2proc.py — the first actual
multi-process (multi-host-shaped) run of parallel/distributed.py.

Each of two processes owns 2 virtual CPU devices, joins a
``jax.distributed`` job over a localhost coordinator (gloo collectives),
builds the 4-device global mesh, feeds its OWN half of a deterministic
global batch through ``global_batch_from_local``
(``jax.make_array_from_process_local_data``), and runs ONE GSPMD train
step of the 1-D spike net. Rank 0 writes the resulting loss to a JSON
file; the test compares it against the same step computed single-process.

Usage: python distributed_worker.py <port> <rank> <out_json>
"""

import functools
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

# Force pure-CPU BEFORE any backend init: the two worker processes must
# not contend for an accelerator the host may have.
jax.config.update("jax_platforms", "cpu")
# Multi-process CPU collectives need an explicit implementation.
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np  # noqa: E402


def main(port: int, rank: int, out: str) -> None:
    from deepcalcium_tpu.models import unet1d
    from deepcalcium_tpu.ops import losses as L
    from deepcalcium_tpu.parallel.distributed import (global_batch_from_local,
                                                      initialize, pod_mesh)
    from deepcalcium_tpu.train import trainer as T

    initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert jax.process_count() == 2, jax.process_count()
    mesh = pod_mesh()
    assert mesh.devices.size == 4, mesh  # 2 procs x 2 local devices
    # Marker for the test: coordination succeeded — any failure AFTER this
    # line is a real product bug, not an environment limitation.
    print("MESH_OK", flush=True)

    # Deterministic GLOBAL batch; each process materializes only its half.
    gen = np.random.default_rng(0)
    xg = gen.standard_normal((8, 64)).astype(np.float32)
    yg = (gen.random((8, 64)) < 0.1).astype(np.float32)
    lo, hi = 4 * rank, 4 * rank + 4
    x = global_batch_from_local(mesh, xg[lo:hi])
    y = global_batch_from_local(mesh, yg[lo:hi])

    params, state = unet1d.init(jax.random.PRNGKey(0), nfb=4)
    optimizer = T.make_optimizer(2e-3)
    opt_state = optimizer.init(params)
    apply_fn = functools.partial(unet1d.apply, margin=4)
    step = T.make_train_step(
        apply_fn,
        functools.partial(L.weighted_binary_crossentropy, weightpos=2.0),
        optimizer, metric_fns=dict(L.SPIKE_METRICS), mesh=mesh)
    params, state, opt_state, met = step(params, state, opt_state, x, y,
                                         jax.random.PRNGKey(1))
    loss = float(met["loss"])

    # Second capability under multi-process GSPMD: the flagship 2-D
    # W-packed gradient step (fit(fast_train="auto")'s dispatch), global
    # batch again fed half-per-process.
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.unet2d_fast import apply_fast_w_train

    x2g = gen.standard_normal((8, 32, 32)).astype(np.float32)
    y2g = (gen.random((8, 32, 32)) < 0.1).astype(np.float32)
    x2 = global_batch_from_local(mesh, x2g[lo:hi])
    y2 = global_batch_from_local(mesh, y2g[lo:hi])
    params2, state2 = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt2 = optimizer.init(params2)
    stepw = T.make_train_step(
        functools.partial(apply_fast_w_train, compute_dtype=None),
        L.LOSSES["binary_crossentropy"], optimizer, mesh=mesh)
    _, _, _, met2 = stepw(params2, state2, opt2, x2, y2,
                          jax.random.PRNGKey(2))
    loss_w = float(met2["loss"])

    if rank == 0:
        with open(out, "w") as fp:
            json.dump({"loss": loss, "loss_wpacked": loss_w,
                       "ndev": len(jax.devices()),
                       "local_ndev": len(jax.local_devices()),
                       "nproc": jax.process_count()}, fp)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""Two-process ``jax.distributed`` train step == single-process step.

The multi-PROCESS evidence for parallel/distributed.py (SURVEY §2.2
'jax.distributed + DCN'): everything else in the
suite exercises the degenerate single-process form of
``initialize``/``global_batch_from_local``. Here two real OS processes
(2 virtual CPU devices each) form a 4-device global mesh over a localhost
coordinator, each feeds only its own half of the batch, and one GSPMD
train step's loss must match the same step computed single-process.

Skips (not fails) when the coordinator cannot start — port binding is
environment-dependent.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_step_matches_single(tmp_path):
    port = _free_port()
    out = str(tmp_path / "rank0.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.dirname(os.path.dirname(__file__)),
                    env.get("PYTHONPATH", "")] if p)
    # The worker forces jax_platforms=cpu itself; scrub any conflicting
    # platform pins from the parent test env.
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_PLATFORM_NAME", None)
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(port), str(rank), out],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=420)
            outs.append((p.returncode, so, se))
    except subprocess.TimeoutExpired:
        outs = []
        for p in procs:
            p.kill()
            so, se = p.communicate()
            outs.append((124, so, se))
    # Skip ONLY when the mesh never formed (environment limitation):
    # a timeout/crash AFTER both ranks printed MESH_OK is a real deadlock
    # or product bug and must FAIL, not skip — otherwise this test can
    # never catch the regression class it exists for.
    mesh_formed = all("MESH_OK" in so for _, so, _ in outs)
    if any(rc != 0 for rc, _, _ in outs):
        msgs = "\n".join(se[-2000:] for _, _, se in outs)
        if not mesh_formed:
            # Coordination never completed: port binding / collectives are
            # environment-dependent here.
            pytest.skip(f"distributed init failed in this environment:\n"
                        f"{msgs[-500:]}")
        raise AssertionError(
            f"worker failed AFTER mesh formation (real bug):\n{msgs}")

    with open(out) as fp:
        res = json.load(fp)
    assert res["nproc"] == 2
    assert res["ndev"] == 4 and res["local_ndev"] == 2

    # Single-process oracle: the SAME deterministic batch and step, no mesh.
    from deepcalcium_tpu.models import unet1d
    from deepcalcium_tpu.ops import losses as L
    from deepcalcium_tpu.train import trainer as T

    gen = np.random.default_rng(0)
    xg = gen.standard_normal((8, 64)).astype(np.float32)
    yg = (gen.random((8, 64)) < 0.1).astype(np.float32)
    params, state = unet1d.init(jax.random.PRNGKey(0), nfb=4)
    optimizer = T.make_optimizer(2e-3)
    opt_state = optimizer.init(params)
    apply_fn = functools.partial(unet1d.apply, margin=4)
    step = T.make_train_step(
        apply_fn,
        functools.partial(L.weighted_binary_crossentropy, weightpos=2.0),
        optimizer, metric_fns=dict(L.SPIKE_METRICS))
    _, _, _, met = step(params, state, opt_state, xg, yg,
                        jax.random.PRNGKey(1))
    # Sharded global-batch reductions reassociate floats; tolerance only.
    np.testing.assert_allclose(res["loss"], float(met["loss"]),
                               rtol=2e-5, atol=2e-5)

    # W-packed 2-D gradient step (fit(fast_train="auto")'s dispatch), same
    # deterministic continuation of the worker's RNG stream.
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.unet2d_fast import apply_fast_w_train

    x2g = gen.standard_normal((8, 32, 32)).astype(np.float32)
    y2g = (gen.random((8, 32, 32)) < 0.1).astype(np.float32)
    params2, state2 = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    opt2 = optimizer.init(params2)
    stepw = T.make_train_step(
        functools.partial(apply_fast_w_train, compute_dtype=None),
        L.LOSSES["binary_crossentropy"], optimizer)
    _, _, _, met2 = stepw(params2, state2, opt2, x2g, y2g,
                          jax.random.PRNGKey(2))
    np.testing.assert_allclose(res["loss_wpacked"], float(met2["loss"]),
                               rtol=2e-5, atol=2e-5)

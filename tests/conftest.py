"""Test harness config: force an 8-device virtual CPU mesh before JAX loads.

Mirrors the SURVEY §4 test strategy: unit tests against NumPy oracles, plus
distributed-without-a-cluster via xla_force_host_platform_device_count.
Tests run on the CPU, hermetic and fast; the GPU paths are exercised by
``python chip_smoke.py`` on a machine with a GPU.
"""

import os
import tempfile

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# Redirect config/datasets/checkpoints away from the user's home directory.
_tmp = tempfile.mkdtemp(prefix="dc_tpu_test_")
# Unconditional: an exported DEEPCALCIUM_TPU_DIR (e.g. for bench runs)
# must not leak the user's real data dir into the hermetic test session.
os.environ["DEEPCALCIUM_TPU_DIR"] = _tmp

import jax  # noqa: E402

# Force the CPU through jax.config too, so a host with a GPU still runs the
# suite on the 8 virtual CPU devices.
jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, (
    f"expected 8 virtual CPU devices, got {jax.devices()}")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(865)  # reference CLI seed, unet2ds_nf.py:18

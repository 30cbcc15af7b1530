"""Coverage for small modules with no dedicated test file: the C2S
deprecation stub, the model-download helper (idempotent path, no network),
the shared bench harness (benchtools), and chip_smoke.py's refusal to run
without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest


def test_c2s_stub_raises_with_pointer():
    """SURVEY §2 row 29: the C2S wrapper is documented-deprecated — it must
    refuse construction loudly and point at the working alternatives."""
    from deepcalcium_tpu.models.c2s_segmentation import C2SSegmentation

    with pytest.raises(NotImplementedError, match="GLMSegmentation"):
        C2SSegmentation()


def test_download_model_idempotent(tmp_path):
    """An existing file short-circuits before any network touch (this box
    has zero egress, so reaching urlretrieve would fail loudly)."""
    from deepcalcium_tpu.utils.model_downloads import download_model

    p = tmp_path / "m.hdf5"
    p.write_bytes(b"weights")
    out = download_model("https://unreachable.invalid/m.hdf5", str(p))
    assert out == str(p) and p.read_bytes() == b"weights"


def test_enable_compile_cache_sets_config(tmp_path, monkeypatch):
    from deepcalcium_tpu.utils.benchtools import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        cache = enable_compile_cache()
        assert os.path.isdir(cache)
        assert jax.config.jax_compilation_cache_dir == cache
        # From a checkout the cache anchors at the repo root (pyproject
        # marker).
        assert os.path.exists(os.path.join(os.path.dirname(cache),
                                           "pyproject.toml"))
    finally:
        # Global JAX config: restore so later tests don't silently serve
        # executables from the persistent on-disk cache.
        jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_compile_cache_honours_env(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX already uses that directory:
    enable_compile_cache returns it and sets no other."""
    from deepcalcium_tpu.utils.benchtools import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    assert enable_compile_cache() == str(tmp_path / "cc")
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == prev


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("Tesla V100-SXM2-16GB", None)])
def test_device_peak_table(kind, peak):
    """A known H100 kind has its published bf16 peak; any other kind has
    none (utilization is then null, never against an assumed peak)."""
    from deepcalcium_tpu.utils.benchtools import device_peak

    assert device_peak(kind) == peak


def test_power_limit_watts_parses_nvidia_smi_line():
    from deepcalcium_tpu.utils.benchtools import power_limit_watts

    assert power_limit_watts("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert power_limit_watts("NVIDIA H100 80GB HBM3, [N/A]") is None
    assert power_limit_watts(None) is None


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """chip_smoke.py never reports ok on a CPU-only host, nor from a
    directory that holds it and nothing else of the repo."""
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "chip_smoke.py")
    cwd = root
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_slope_train_step_time_smoke():
    """The shared slope timer must run the real train-step graph end-to-end
    and return a finite per-step time on tiny shapes (CPU; the value itself
    is timing noise here — only bench.py's GPU runs read it)."""
    import functools

    import jax.numpy as jnp

    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.utils.benchtools import slope_train_step_time

    fn = functools.partial(unet2d.apply, compute_dtype=jnp.float32)
    dt = slope_train_step_time(fn, 2, 32, k=3, kmin=1, reps=1, nfb=4)
    assert np.isfinite(dt)


def test_slope_train1d_step_time_smoke():
    """The 1-D counterpart (bench.py's train1d_* fields) runs the real
    UNet1D train-step graph — wbce(pos=2), margin head, SPIKE_METRICS —
    and returns a finite per-step time on tiny shapes."""
    from deepcalcium_tpu.utils.benchtools import slope_train1d_step_time

    dt = slope_train1d_step_time(2, 64, k=3, kmin=1, reps=1, nfb=4)
    assert np.isfinite(dt)


def test_search_csv_torn_row_and_atomic_rewrite(tmp_path):
    """load_rows must drop a torn final line even when the tear preserves
    field count and parseability (a 'seconds' value cut mid-digits), and
    write_rows must replace atomically (tmp+rename) so a snapshotter or a
    VM restart can never observe a header-only truncation (ADVICE r4 /
    round-5 review)."""
    import importlib
    import sys as _sys

    _sys.path.insert(0, "examples/neurons")
    try:
        hs = importlib.import_module("unet2ds_hyperparam_search")
    finally:
        _sys.path.pop(0)

    rows = [
        {"window": "64", "trial": "0", "val_nf_f1_mean": "0.81",
         "seconds": "123.4"},
        {"window": "48", "trial": "1", "val_nf_f1_mean": "0.72",
         "seconds": "456.7"},
    ]
    p = tmp_path / "search.csv"
    hs.write_rows(str(p), rows)
    assert not (tmp_path / "search.csv.tmp").exists()  # renamed, not left
    assert hs.load_rows(str(p)) == rows

    # Tear the final line mid-'seconds': same comma count, still parses —
    # only the missing newline terminator gives it away.
    text = p.read_text()
    assert text.endswith("\n")
    p.write_text(text[: text.rfind("456.7") + 1])  # ...,0.72,4  (no \n)
    kept = hs.load_rows(str(p))
    assert kept == rows[:1]

    # A torn line that DOES break field count is also dropped.
    p.write_text(text + "96,2,0.9")  # missing 'seconds', no newline
    assert hs.load_rows(str(p)) == rows

    # Header-only and empty files resume from zero, not crash.
    p.write_text(text.split("\n")[0] + "\n")
    assert hs.load_rows(str(p)) == []
    p.write_text("")
    assert hs.load_rows(str(p)) == []



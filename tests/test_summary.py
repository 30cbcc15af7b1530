"""Mean/max summary reductions vs np.mean/np.max oracles."""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from deepcalcium_tpu.ops.summary import (
    StreamingSummary,
    movie_summary,
    movie_summary_sharded,
)


@pytest.fixture
def movie(rng):
    return rng.integers(-100, 3000, size=(37, 24, 40)).astype(np.int16)


def test_movie_summary_oracle(movie):
    mean, mx = movie_summary(movie)
    assert mx.dtype == movie.dtype
    np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(mx), movie.max(0))


def test_movie_summary_chunk_invariance(movie):
    """Reducing two time chunks and combining them (what the sharded and
    ragged-tail paths do) equals one reduction of the whole movie."""
    m1, x1 = movie_summary(movie[:20])
    m2, x2 = movie_summary(movie[20:])
    m, x = movie_summary(movie)
    np.testing.assert_allclose((np.asarray(m1) * 20 + np.asarray(m2) * 17)
                               / 37, np.asarray(m), rtol=1e-6)
    np.testing.assert_array_equal(np.maximum(np.asarray(x1), np.asarray(x2)),
                                  np.asarray(x))


def test_movie_summary_float_input(rng):
    movie = rng.standard_normal((16, 8, 16)).astype(np.float32)
    mean, mx = movie_summary(movie)
    np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mx), movie.max(0), rtol=1e-6)


@pytest.mark.parametrize("case", [
    "float_ragged_t", "all_negative_int", "prime_t_ragged_hw", "multirow",
    "int16"])
def test_movie_summary_edge_cases(rng, case):
    """Edge cases the removed tiled kernel had to mask by hand, held against
    the one reduction every path now uses: float input with an odd T (no
    finfo.min padding may poison the sum), an all-negative int movie (no
    zero may leak into the max), a prime T with ragged H and W, many rows,
    and a plain int16 movie."""
    movie = {
        "float_ragged_t": lambda: rng.standard_normal((10, 8, 128))
        .astype(np.float32) - 5.0,
        "all_negative_int": lambda: rng.integers(-5000, -10, (7, 8, 130))
        .astype(np.int16),
        "prime_t_ragged_hw": lambda: rng.integers(-100, 3000, (31, 19, 137))
        .astype(np.int16),
        "multirow": lambda: rng.integers(0, 2000, (12, 40, 128))
        .astype(np.int16),
        "int16": lambda: rng.integers(-100, 3000, (37, 24, 40))
        .astype(np.int16),
    }[case]()
    mean, mx = movie_summary(movie)
    np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(mx), movie.max(0))


def test_streaming_auto_backend_is_device(movie):
    """backend='auto' folds on the device; 'host' stays an explicit choice,
    and an unknown backend is rejected."""
    assert StreamingSummary(movie.shape[1:], backend="auto").backend == "device"
    assert StreamingSummary(movie.shape[1:], backend="host").backend == "host"
    with pytest.raises(ValueError, match="backend"):
        StreamingSummary(movie.shape[1:], backend="probe")


def test_streaming_summary(movie):
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype)
    for i in range(0, movie.shape[0], 10):
        ss.update(movie[i : i + 10])
    mean, mx = ss.result()
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(mx, movie.max(0))


def test_streaming_ragged_tail_stable_shapes(movie):
    """The device path must fold a ragged tail chunk through the SAME
    compiled executable as the full chunks (zero-pad + in-kernel mask) —
    a second compile mid-stream would stall the stream."""
    from deepcalcium_tpu.ops.summary import (_streaming_device_update,
                                             _streaming_device_update_mean)

    for fn in (_streaming_device_update, _streaming_device_update_mean):
        fn.clear_cache()
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                          backend="device")
    for i in range(0, movie.shape[0], 10):  # 37 frames -> tail of 7
        ss.update(movie[i : i + 10])
    assert ss._chunk_len == 10
    mean, mx = ss.result()
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(mx, movie.max(0))
    assert _streaming_device_update._cache_size() == 1
    assert _streaming_device_update_mean._cache_size() == 0

    # Mean-only variant, same contract.
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                          backend="device", track_max=False)
    for i in range(0, movie.shape[0], 10):
        ss.update(movie[i : i + 10])
    mean, _ = ss.result()
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)
    assert _streaming_device_update_mean._cache_size() == 1


def test_streaming_all_negative_max_masked(rng):
    """Zero-padded tail frames must not leak 0 into an all-negative max."""
    movie = rng.integers(-3000, -100, size=(13, 8, 16)).astype(np.int16)
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                          backend="device")
    ss.update(movie[:10])
    ss.update(movie[10:])  # ragged 3-frame tail, padded with zeros
    mean, mx = ss.result()
    assert mx.max() < 0
    np.testing.assert_array_equal(mx, movie.max(0))
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)


def test_sharded_summary_matches_single_device(rng):
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    t = 8 * 6
    movie = rng.integers(0, 1000, size=(t, 16, 128)).astype(np.int16)
    mean, mx = movie_summary_sharded(movie, mesh, axis="data")
    np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(mx), movie.max(0))


def test_sharded_summary_ragged_t(rng):
    """T not divisible by the mesh: head reduces sharded, tail locally —
    result exact vs a single-device reduction (no padded movie copy)."""
    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("data",))
    n = devices.size
    for t in (8 * n + 3, n - 1, 5 * n + n - 1):
        movie = rng.integers(0, 1000, size=(t, 16, 128)).astype(np.int16)
        mean, mx = movie_summary_sharded(movie, mesh, axis="data")
        np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(mx), movie.max(0))


def test_movie_summary_fast_cpu_dispatch(movie):
    """The fused movie evaluator reduces with the one summary path on every
    backend: its mean output is bit-identical to movie_summary's."""
    from deepcalcium_tpu.train.evaluate import make_movie_evaluator

    def apply_fn(params, state, x, train=False, rng=None):
        return jax.nn.sigmoid(x), state

    ev = make_movie_evaluator(apply_fn, movie.shape, window=(32, 48),
                              tta=False)
    _, _, mean = ev({}, {}, movie)
    np.testing.assert_array_equal(np.asarray(mean),
                                  np.asarray(movie_summary(movie)[0]))
    np.testing.assert_allclose(np.asarray(mean), movie.mean(0), rtol=1e-5)


def test_streaming_growing_chunk_stable_shapes(movie):
    """A chunk LARGER than the first-seen one must split into first-seen-
    size slabs (plus a padded short final slab), never specialize a second
    executable — same mid-stream-compile hazard as the ragged tail."""
    from deepcalcium_tpu.ops.summary import _streaming_device_update

    _streaming_device_update.clear_cache()
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                          backend="device")
    ss.update(movie[:10])    # sets _chunk_len = 10
    ss.update(movie[10:35])  # 25 frames: 10 + 10 + padded 5
    ss.update(movie[35:])    # ragged 2-frame tail
    mean, mx = ss.result()
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)
    np.testing.assert_array_equal(mx, movie.max(0))
    assert ss._count == movie.shape[0]
    assert _streaming_device_update._cache_size() == 1


def test_streaming_mean_only_returns_none_max(movie):
    """track_max=False must return None for the max — the min-sentinel
    buffer escaping as data would silently corrupt a stored series/max."""
    ss = StreamingSummary(movie.shape[1:], dtype=movie.dtype,
                          backend="host", track_max=False)
    ss.update(movie)
    mean, mx = ss.result()
    assert mx is None
    np.testing.assert_allclose(mean, movie.mean(0), rtol=1e-5)


def test_sharded_summary_executable_reuse(rng):
    """Repeat movie_summary_sharded calls on same-shaped movies must reuse
    ONE compiled executable (module-level cache) — a fresh shard_map +
    jit per call recompiles every time."""
    import jax
    from jax.sharding import Mesh

    from deepcalcium_tpu.ops.summary import (_sharded_summary_fn,
                                             movie_summary_sharded)

    mesh = Mesh(np.array(jax.devices()), ("data",))
    _sharded_summary_fn.cache_clear()
    m1 = rng.integers(0, 99, (16, 8, 8)).astype(np.int16)
    m2 = rng.integers(0, 99, (16, 8, 8)).astype(np.int16)
    a1 = movie_summary_sharded(m1, mesh)
    a2 = movie_summary_sharded(m2, mesh)
    info = _sharded_summary_fn.cache_info()
    assert info.misses == 1 and info.hits == 1, info
    np.testing.assert_allclose(np.asarray(a1[0]), m1.mean(0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a2[0]), m2.mean(0), rtol=1e-5)

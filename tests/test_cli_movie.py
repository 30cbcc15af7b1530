"""The movie-level CLI subcommands (evaluate-movie, segment) end-to-end on
fixture data with a saved checkpoint."""

import os

import h5py
import jax
import numpy as np
import pytest


@pytest.fixture()
def fixture_env(tmp_path, monkeypatch):
    from deepcalcium_tpu.data.fixtures import make_neurons_hdf5
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.train.checkpoints import save_checkpoint

    monkeypatch.setenv("DEEPCALCIUM_TPU_DIR", str(tmp_path / "dc"))
    ds = make_neurons_hdf5(str(tmp_path / "d" / "dataset.hdf5"),
                           name="cli.0", shape=(48, 48), nb_frames=16)
    # The CLI constructs the stock net (nfb=32), so the checkpoint must
    # match; the 48x48 fixture keeps the forward compile small.
    params, state = unet2d.init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, params, state)
    return ds, ckpt, tmp_path


def test_cli_evaluate_movie(fixture_env):
    from deepcalcium_tpu.cli import main

    ds, ckpt, tmp_path = fixture_env
    out = str(tmp_path / "ev.npz")
    png = str(tmp_path / "ev.png")
    main(["evaluate-movie", ds, "-m", ckpt, "--window", "48",
          "--out", out, "--png", png])
    z = np.load(out)
    assert z["mask"].shape == (48, 48) and z["mask"].dtype == np.uint8
    assert z["prob"].shape == (48, 48)
    assert os.path.exists(png)


def test_cli_segment(fixture_env):
    from deepcalcium_tpu.cli import main

    ds, ckpt, tmp_path = fixture_env
    out = str(tmp_path / "masks.hdf5")
    main(["segment", ds, "-m", ckpt, "--slab", "8", "--out", out])
    with h5py.File(out, "r") as fp:
        masks = fp["masks/frames"][...]
    assert masks.shape == (16, 48, 48) and masks.dtype == np.uint8
    assert set(np.unique(masks)).issubset({0, 1})


def test_segment_movie_reuses_executable():
    """Repeat segment_movie calls must hit ONE lru-cached jitted slab fn —
    a fresh closure per call recompiled the full forward every time."""
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.movie_segmentation import (_make_segment_slab,
                                                           segment_movie)

    params, state = unet2d.init(jax.random.PRNGKey(11), nfb=4)
    _make_segment_slab.cache_clear()
    m1 = np.random.default_rng(0).integers(0, 900, (6, 32, 32)).astype(np.int16)
    m2 = np.random.default_rng(1).integers(0, 900, (9, 32, 32)).astype(np.int16)
    o1 = segment_movie(params, state, m1, slab=4)
    o2 = segment_movie(params, state, m2, slab=4)
    info = _make_segment_slab.cache_info()
    assert info.misses == 1 and info.hits == 1, info
    assert o1.shape == (6, 32, 32) and o2.shape == (9, 32, 32)


def test_segment_movie_auto_dispatch_resolution():
    """The stock transpose-mode checkpoint must resolve to the W-packed
    inference forward; an upsampling-mode one to the parity forward — if
    this regresses, the fast-vs-parity equality test elsewhere becomes
    vacuous (both sides run the same forward)."""
    from deepcalcium_tpu.models import unet2d
    from deepcalcium_tpu.models.movie_segmentation import (_UPSAMPLING_APPLY,
                                                           _resolve_apply)
    from deepcalcium_tpu.models.unet2d_fast import apply_fast_w

    params_t, _ = unet2d.init(jax.random.PRNGKey(0), nfb=4)
    assert _resolve_apply(None, params_t) is apply_fast_w
    params_u, _ = unet2d.init(jax.random.PRNGKey(0), nfb=4,
                              up_mode="upsampling")
    assert _resolve_apply(None, params_u) is _UPSAMPLING_APPLY
    marker = object()
    assert _resolve_apply(marker, params_t) is marker


def test_cli_parity_golden_offline(fixture_env, capsys):
    """The pre-staged golden-parity runner: the full glue
    (load model -> predict -> score -> diff vs expected -> exit code) must
    run end-to-end OFFLINE via --paths/-m, PASS inside a wide tolerance,
    and exit 1 when the expected scores can't match."""
    from deepcalcium_tpu.cli import main

    ds, ckpt, tmp_path = fixture_env
    # Wide tolerance: any score triple passes -> exercises the whole glue.
    main(["parity-golden", "--paths", ds, "-m", ckpt, "--window", "48",
          "--tta", "off", "--tol", "1.0"])
    out = capsys.readouterr().out
    assert "parity-golden: PASS" in out and "[no-TTA] prec" in out

    # Impossible expectation -> machine-readable failure, exit code 1.
    with pytest.raises(SystemExit) as exc:
        main(["parity-golden", "--paths", ds, "-m", ckpt, "--window", "48",
              "--tta", "off", "--tol", "0.000001",
              "--expect-no-tta", "9", "9", "9"])
    assert exc.value.code == 1
    assert "parity-golden: FAIL" in capsys.readouterr().out


def test_parity_golden_label_mapping():
    """Pin the golden expectations to the reference's OWN loop order
    (an earlier version had these swapped). The reference
    evaluation loop is ``for aug in [True, False]`` — the TTA pass runs
    FIRST (/root/reference/examples/neurons/unet2ds_nf.py:52-62), and in
    the README's captured output the 0.976/0.988 block appears BEFORE the
    "Evaluation without TTA." log line while 0.919/0.958 appears after it
    (/root/reference/README.md:29-37). Therefore 0.976/1.000/0.988 is the
    WITH-TTA score and 0.919/1.000/0.958 the no-TTA score. Re-swapping
    these would make the north-star egress-day check fail both passes
    (tol 0.005 vs a 0.057 precision gap)."""
    from deepcalcium_tpu.cli import _GOLDEN_NO_TTA, _GOLDEN_TTA

    assert _GOLDEN_TTA == (0.976, 1.000, 0.988)
    assert _GOLDEN_NO_TTA == (0.919, 1.000, 0.958)
    # The two passes must stay distinguishable at the default tolerance.
    assert abs(_GOLDEN_TTA[0] - _GOLDEN_NO_TTA[0]) > 0.005

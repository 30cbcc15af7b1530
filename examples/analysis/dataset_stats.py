"""Dataset statistics and throughput report.

Counterpart of the reference's ``notebooks/dlmia_workshop_figures.ipynb``
analysis cells (SURVEY §2 row 34): per-dataset frame/neuron counts,
positive-pixel proportion of the mask summaries (reference reported mean
0.126 across Neurofinder train), and an end-to-end evaluate-throughput
measurement (the 8,057 frames/min cell).

    python examples/analysis/dataset_stats.py all_train [--model m.ckpt]
"""

import argparse
import logging
import sys
import time

sys.path.append(".")

import h5py
import numpy as np

logging.basicConfig(level=logging.INFO)


def main():
    from deepcalcium_tpu.data.nf import nf_load_hdf5
    from deepcalcium_tpu.models.unet_2d_summary import (
        UNet2DSummary, summarize_mask)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_name", default="all_train")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="local contract-HDF5 dataset paths (skips download)")
    ap.add_argument("--model", help="checkpoint for the throughput cell "
                    "(default: fresh init — throughput is weight-agnostic)")
    ap.add_argument("--throughput", action="store_true",
                    help="run the evaluate-throughput cell (the reference's "
                    "8,057 frames/min cell) through the library's "
                    "streaming/fused movie evaluator at realistic T")
    ap.add_argument("--throughput-frames", type=int, default=3000)
    ap.add_argument("--throughput-size", type=int, default=512)
    args = ap.parse_args()

    paths = args.paths or nf_load_hdf5(args.dataset_name)

    total_frames = total_neurons = 0
    pos_props = []
    print(f"{'dataset':28s} {'frames':>7s} {'neurons':>8s} {'HxW':>10s} {'pos%':>6s}")
    for p in paths:
        with h5py.File(p, "r") as fp:
            name = fp.attrs["name"]
            t, h, w = fp["series/raw"].shape
            n = fp["masks/raw"].shape[0] if "masks" in fp else 0
        total_frames += t
        total_neurons += n
        pos = np.nan
        if n:
            summ = summarize_mask(p)
            pos = float(summ.mean())
            pos_props.append(pos)
        print(f"{name:28s} {t:7d} {n:8d} {h:5d}x{w:<4d} {pos:6.3f}")

    print(f"\ntotals: {total_frames} frames, {total_neurons} neurons, "
          f"mean positive-pixel proportion "
          f"{np.mean(pos_props) if pos_props else float('nan'):.3f}")

    if args.throughput or args.model:
        # The reference's cell 7 (dlmia_workshop_figures.ipynb) timed the
        # whole evaluate pipeline at 8,057 frames/min on cached data. This
        # measures the LIBRARY PATH users get on realistic movie lengths:
        # UNet2DSummary.evaluate_movie (the fused summary + TTA device
        # graph for an in-memory movie), not per-call dispatch over short
        # fixtures, which would time dispatch overhead instead.
        import jax

        from deepcalcium_tpu.models import unet2d

        t, hw = args.throughput_frames, args.throughput_size
        rng = np.random.default_rng(0)
        # Random int16 frames; one movie-sized buffer (~1.5 GB at defaults).
        movie = rng.integers(0, 2000, (t, hw, hw), dtype=np.int16)

        model = UNet2DSummary()
        if args.model:
            params, state = model._load_params(args.model)
        else:
            params, state = unet2d.init(jax.random.PRNGKey(0), nfb=32)

        # Warm: two calls at the FULL movie length — the fused device route
        # specializes its graph on the movie's (T, H, W), so a short-prefix
        # warm-up would leave the T=full compile inside the timed region.
        for _ in range(2):
            model.evaluate_movie(movie, params=params, state=state,
                                 window_shape=(hw, hw))
        tic = time.time()
        mask, prob = model.evaluate_movie(movie, params=params, state=state,
                                          window_shape=(hw, hw))
        dt = time.time() - tic
        dev = jax.devices()[0]
        print(f"\nevaluate throughput (evaluate_movie, {t} frames @ "
              f"{hw}x{hw}, warm jit, on {dev.platform} {dev.device_kind}): "
              f"{t / dt * 60:,.0f} frames/min = "
              f"{t / dt:,.1f} frames/s "
              f"(reference dlmia cell 7: 8,057 frames/min)")


if __name__ == "__main__":
    main()

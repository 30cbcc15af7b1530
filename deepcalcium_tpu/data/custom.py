"""Custom/new-data ingestion: arbitrary TIFF stacks + annotations -> HDF5.

Generalizes the reference's St. Jude workflow (``examples/neurons/
unet2ds_sj.py:33-115``, ``make_stjude_dataset``) into a library function:

- TIFF glob -> ``series/{raw,mean,max}`` with the summary reduction on
  device (StreamingSummary) instead of per-frame NumPy.
- Corrupted/missing-TIFF tolerance: zero-fill the frame and warn (reference
  ``:75-82``).
- Masks from either (a) explicit per-neuron binary masks, or (b) center
  coordinates + box radius producing square bbox masks with the reference's
  area invariant (``:92-107``).
- Idempotent: existing dataset paths are returned untouched (``:53-55``).

Matlab annotation parsing (scipy.io.loadmat) lives in the example script —
the library takes plain arrays.
"""

import logging
import os
from glob import glob

import numpy as np

from deepcalcium_tpu.utils.runtime import funcname

__all__ = ["make_dataset_from_tiffs", "bbox_masks"]


def bbox_masks(centers, radius: int, shape) -> np.ndarray:
    """(cx, cy) centers + radius -> (N, H, W) square masks.

    Mirrors the reference bbox rasterization (``unet2ds_sj.py:99-107``),
    including the clip-at-border behavior and the full-square area assert for
    interior boxes.
    """
    h, w = shape
    masks = np.zeros((len(centers), h, w), np.int8)
    for idx, (x, y) in enumerate(centers):
        y0, y1 = max(0, y - radius), min(h, y + radius)
        x0, x1 = max(0, x - radius), min(w, x + radius)
        masks[idx, y0:y1, x0:x1] = 1
        if 0 <= y - radius and y + radius <= h and 0 <= x - radius and x + radius <= w:
            assert masks[idx].sum() == (2 * radius) ** 2
    return masks


def make_dataset_from_tiffs(name: str, tiffglob: str, dataset_path: str,
                            masks: np.ndarray | None = None,
                            centers=None, radius: int | None = None,
                            chunk: int = 64) -> str:
    """TIFF stack (+ optional annotations) -> contract HDF5.

    # Arguments
        name: dataset name (stored as the file attr).
        tiffglob: glob for the TIFF frames, e.g. '/data/frames/*.tif'.
        dataset_path: output HDF5 path; returned untouched if it exists.
        masks: optional (N, H, W) binary neuron masks.
        centers, radius: alternative annotation form -> square bbox masks.
    """
    logger = logging.getLogger(funcname())
    if os.path.exists(dataset_path):
        logger.info("%s already exists.", dataset_path)
        return dataset_path

    from deepcalcium_tpu.data._ingest import read_tiff, write_series

    paths = sorted(glob(tiffglob))
    if not paths:
        raise FileNotFoundError(f"no TIFFs match {tiffglob}")
    h, w = read_tiff(paths[0]).shape

    tmp = dataset_path + ".tmp"
    import h5py

    with h5py.File(tmp, "w") as fp:
        fp.attrs["name"] = name
        write_series(fp, paths, (h, w), chunk)

        if masks is None and centers is not None:
            assert radius is not None, "centers require a radius"
            masks = bbox_masks(centers, int(radius), (h, w))
        if masks is not None:
            fp.create_dataset("masks/raw", data=np.asarray(masks, np.int8),
                              dtype="int8")
            fp.create_dataset("masks/max", data=np.asarray(masks).max(axis=0),
                              dtype="int8")

    os.replace(tmp, dataset_path)
    size_gb = os.path.getsize(dataset_path) / 1024**3
    logger.info("Done. File is %.2f GB on disk.", size_gb)
    return dataset_path

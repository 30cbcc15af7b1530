"""Neurofinder dataset layer: registry, download, HDF5 ingest, submissions.

Parity rebuild of reference ``datasets/nf.py``:

- Same 28-dataset registry and S3 URL map (``nf.py:21-34``), same special
  names ``all`` / ``all_train`` / ``all_test`` and comma-splitting
  (``nf.py:57-67``), same idempotent download->unzip->delete flow
  (``nf.py:73-97``).
- Same HDF5 contract: ``series/{raw,mean,max}``, ``masks/{raw,max}``, attr
  ``name`` (``nf.py:38-44``) — mean stored float16, raw/max int16.
- Ingest hot loop rebuilt: TIFF frames are decoded on host (PIL) in chunks
  and folded into device-resident mean/max accumulators
  (ops.summary.StreamingSummary) instead of per-frame NumPy updates
  (``nf.py:126-130``). Mean accumulates in float32 (the reference's float16
  ``+=`` loses precision; deviation is below the float16 storage quantum).
- ``nf_submit`` fixes the reference's off-by-one (``nf.py:205`` iterates
  ``range(1, max)``, silently dropping the last labeled region); we emit all
  labels — deviation noted per SURVEY §7.9.
"""

import json
import logging
import os
import shutil
import zipfile
from glob import glob

import numpy as np

from deepcalcium_tpu.metrics.neurofinder import label_mask, nf_mask_metrics  # noqa: F401 (re-export)
from deepcalcium_tpu.utils.config import datasets_dir
from deepcalcium_tpu.utils.runtime import funcname

__all__ = ["NEUROFINDER_NAMES", "NAME_TO_URL", "nf_load_hdf5", "nf_submit",
           "nf_mask_metrics", "ingest_tiff_dataset"]

NEUROFINDER_NAMES = sorted([
    "neurofinder.00.00", "neurofinder.00.01", "neurofinder.00.02",
    "neurofinder.00.03", "neurofinder.00.04", "neurofinder.00.05",
    "neurofinder.00.06", "neurofinder.00.07", "neurofinder.00.08",
    "neurofinder.00.09", "neurofinder.00.10", "neurofinder.00.11",
    "neurofinder.01.00", "neurofinder.01.01", "neurofinder.02.00",
    "neurofinder.02.01", "neurofinder.03.00", "neurofinder.04.00",
    "neurofinder.04.01", "neurofinder.00.00.test", "neurofinder.00.01.test",
    "neurofinder.01.00.test", "neurofinder.01.01.test", "neurofinder.02.00.test",
    "neurofinder.02.01.test", "neurofinder.03.00.test", "neurofinder.04.00.test",
    "neurofinder.04.01.test"])

NAME_TO_URL = {
    name: f"https://s3.amazonaws.com/neuro.datasets/challenges/neurofinder/{name}.zip"
    for name in NEUROFINDER_NAMES
}


def _resolve_names(names):
    """Special names and comma-splitting (reference nf.py:57-67)."""
    if isinstance(names, str) and names.lower() == "all":
        return list(NEUROFINDER_NAMES)
    if isinstance(names, str) and names.lower() == "all_train":
        return sorted(n for n in NEUROFINDER_NAMES if ".test" not in n)
    if isinstance(names, str) and names.lower() == "all_test":
        return sorted(n for n in NEUROFINDER_NAMES if ".test" in n)
    if isinstance(names, str):
        return names.split(",")
    return list(names)


def _download_and_unzip(name: str, ddir: str) -> None:
    """Idempotent fetch (reference nf.py:73-97)."""
    logger = logging.getLogger(funcname())
    unzip_path = os.path.join(ddir, name)
    if os.path.exists(unzip_path):
        logger.info("%s already downloaded.", name)
        return
    import requests

    url = NAME_TO_URL[name]
    zip_path = unzip_path + ".zip"
    logger.info("Downloading %s.", url)
    # Stream to disk: the archives are multi-GB and must not be buffered in
    # host RAM (the reference streamed via urlretrieve too).
    with requests.get(url, timeout=600, stream=True) as resp:
        resp.raise_for_status()
        with open(zip_path, "wb") as fp:
            for block in resp.iter_content(chunk_size=1 << 22):
                fp.write(block)
    logger.info("Unzipping %s.", zip_path)
    # Extract into a temp dir and os.replace into place: idempotency keys
    # on unzip_path existing, so a non-atomic extractall interrupted
    # mid-way would be treated as complete forever after (same tmp+rename
    # rule as checkpoints).
    tmp_dir = unzip_path + ".extract_tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    with zipfile.ZipFile(zip_path, "r") as z:
        z.extractall(tmp_dir)
    extracted = os.path.join(tmp_dir, name)
    if not os.path.isdir(extracted):  # archive without the top-level dir
        extracted = tmp_dir
        tmp_dir = None
    os.replace(extracted, unzip_path)
    if tmp_dir is not None and os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.remove(zip_path)


def ingest_tiff_dataset(ds_dir: str, ds_path: str, name: str,
                        chunk: int = 64) -> str:
    """TIFF tree -> contract HDF5 with device-accumulated summaries.

    Mirrors the reference frames pass (``nf.py:117-144``) with both hot ends
    rebuilt: decode runs in the native thread-pool loader, and the mean/max
    reduction folds on device (shared core in data/_ingest.py).
    """
    from deepcalcium_tpu.data._ingest import read_tiff, write_series

    logger = logging.getLogger(funcname())
    s_paths = sorted(glob(os.path.join(ds_dir, "images", "*.tiff"))) or \
        sorted(glob(os.path.join(ds_dir, "images", "*.tif")))
    if not s_paths:
        raise FileNotFoundError(f"no TIFF frames under {ds_dir}/images")
    i_shape = read_tiff(s_paths[0]).shape

    tmp_path = ds_path + ".tmp"
    import h5py

    with h5py.File(tmp_path, "w") as dsf:
        dsf.attrs["name"] = name
        write_series(dsf, s_paths, i_shape, chunk)

        # Ground-truth masks (absent for .test sets) — reference nf.py:132-144.
        regions_path = os.path.join(ds_dir, "regions", "regions.json")
        if os.path.exists(regions_path):
            with open(regions_path) as fp:
                regions = json.load(fp)
            m_raw = dsf.create_dataset(
                "masks/raw", (len(regions),) + i_shape, dtype="int8")
            m_max = np.zeros(i_shape, np.int8)
            for idx, r in enumerate(regions):
                msk = np.zeros(i_shape, np.int8)
                coords = np.asarray(r["coordinates"], np.int64)
                msk[coords[:, 0], coords[:, 1]] = 1
                m_raw[idx] = msk
                np.maximum(m_max, msk, out=m_max)
            dsf.create_dataset("masks/max", data=m_max, dtype="int8")

    os.replace(tmp_path, ds_path)
    logger.info("Populated %s (%d frames).", ds_path, len(s_paths))
    return ds_path


def nf_load_hdf5(names, datasets_dir_override=None):
    """Download + ingest Neurofinder datasets; returns HDF5 paths.

    Reference entry point ``nf_load_hdf5`` (``nf.py:37-150``); idempotent at
    both the download and the ingest level.
    """
    logger = logging.getLogger(funcname())
    ddir = datasets_dir_override or os.path.join(datasets_dir(), "neurons_nf")
    os.makedirs(ddir, exist_ok=True)

    dataset_names = _resolve_names(names)
    paths = []
    for name in dataset_names:
        _download_and_unzip(name, ddir)
        ds_path = os.path.join(ddir, name, "dataset.hdf5")
        if not os.path.exists(ds_path):
            logger.info("Populating %s.", ds_path)
            ingest_tiff_dataset(os.path.join(ddir, name), ds_path, name)
        paths.append(ds_path)
    return paths


def nf_submit(Mp, names, json_path) -> None:
    """Write a Neurofinder challenge submission JSON.

    Reference ``nf_submit`` (``nf.py:177-218``). Deviation: the reference
    iterates ``range(1, max(labels))`` and drops the final connected
    component (``nf.py:205``); we emit every label. The reference also emits
    np.where's (row, col) order under keys it calls (x, y); we keep the same
    byte-level layout for submission compatibility.
    """
    logger = logging.getLogger(funcname())
    submission = []
    for mp, name in zip(Mp, names):
        if name.startswith("neurofinder."):
            name = ".".join(name.split(".")[1:])
        labeled = label_mask(np.asarray(mp))
        nb = labeled.max()
        if nb == 0:
            regions = [{"coordinates": [[0, 0]]}]
        else:
            regions = []
            for lbl in range(1, nb + 1):
                xx, yy = np.where(labeled == lbl)
                regions.append(
                    {"coordinates": [[int(x), int(y)] for x, y in zip(xx, yy)]})
        submission.append({"dataset": name, "regions": regions})

    with open(json_path, "w") as fp:
        json.dump(submission, fp)
    logger.info("Saved submission to %s.", json_path)

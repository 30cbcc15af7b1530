"""Checkpoint save/load: atomic pytree serialization.

Replaces the reference's Keras ``ModelCheckpoint`` HDF5 files plus the
input-shape-rewriting loader (``utils/keras_helpers.py:24-68``). The JAX nets
are fully convolutional, so checkpoints carry no input shape at all — one
file serves 128² training and 512² inference.

Format: one ``np.savez`` archive. Each array leaf of ``params``, ``state``
and (optionally) ``opt_state`` is stored under ``"<tree>/<key path>"``;
``meta`` is a JSON string under ``"__meta__"`` and each leaf's dtype name
under ``"__dtypes__"`` (bfloat16 leaves are stored as their uint16 bit
pattern, which ``np.savez`` can hold). The file is written atomically
(tmp + rename) so a preempted job never sees a torn checkpoint. Loading
needs numpy only: no pickle, no third-party serializer.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_TREES = ("params", "state", "opt_state")


def _key(tree_name, path):
    return f"{tree_name}/{jax.tree_util.keystr(path)}"


def save_checkpoint(path: str, params, state, opt_state=None, meta: dict | None = None):
    """Atomically serialize a training snapshot to ``path``."""
    arrays, dtypes = {}, {}
    for name, tree in zip(_TREES, (params, state, opt_state)):
        if tree is None:
            continue
        for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
            a = np.asarray(leaf)
            k = _key(name, p)
            dtypes[k] = a.dtype.name
            if a.dtype.kind == "V" or a.dtype.name not in np.sctypeDict:
                # ml_dtypes (bfloat16 & co.): keep the raw bits.
                a = a.view(f"u{a.dtype.itemsize}")
            arrays[k] = a
    arrays["__meta__"] = np.asarray(json.dumps(meta or {}))
    arrays["__dtypes__"] = np.asarray(json.dumps(dtypes))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fp:
            np.savez(fp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _restore(npz, dtypes, tree_name, like):
    def leaf(p, _):
        k = _key(tree_name, p)
        if k not in npz:
            raise KeyError(f"checkpoint has no leaf {k!r}")
        return np.asarray(npz[k]).view(jnp.dtype(dtypes[k]))

    return jax.tree_util.tree_map_with_path(leaf, like)


def load_checkpoint(path: str, params_like, state_like, opt_state_like=None):
    """Deserialize a snapshot; ``*_like`` provide the pytree structure.

    # Returns
        (params, state, opt_state_or_None, meta)
    """
    with np.load(path, allow_pickle=False) as npz:
        dtypes = json.loads(str(npz["__dtypes__"]))
        meta = json.loads(str(npz["__meta__"]))
        params = _restore(npz, dtypes, "params", params_like)
        state = _restore(npz, dtypes, "state", state_like)
        opt = None
        if opt_state_like is not None and any(
                k.startswith("opt_state/") for k in dtypes):
            opt = _restore(npz, dtypes, "opt_state", opt_state_like)
    return params, state, opt, meta


def latest_checkpoint(cpdir: str, prefix: str = "") -> str | None:
    """Newest checkpoint by mtime (the reference picks best-by-mtime too,
    ``unet_1d_segmentation.py:304-307``)."""
    if not os.path.isdir(cpdir):
        return None
    cands = [
        os.path.join(cpdir, f)
        for f in os.listdir(cpdir)
        if f.startswith(prefix) and f.endswith(".ckpt")
    ]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)

"""Invertible 2-D augmentations (the dihedral group D4) for TTA and training.

Parity target: reference ``utils/neurons.py:112-137``
(``INVERTIBLE_2D_AUGMENTATIONS``: 8 named (forward, inverse) pairs over batch
axes (1, 2)) and the train-time augmentation walk
(``unet_2d_summary.py:459-466,523-527``: 0..N random draws from the 6
generators {identity, hflip, vflip, rot90, rot180, rot270} composed
sequentially).

Design:
- TTA is ONE batched forward: :func:`tta_expand` stacks all 8 views on a new
  leading axis (pure ``jnp`` flips/rot90s, fully fused by XLA), the model runs
  once on the 8x batch, and :func:`tta_collapse` inverts + averages on device.
  This replaces the reference's 8 sequential host->GPU predict calls
  (``unet_2d_summary.py:585-590``).
- Train-time augmentation is expressed as a single D4 *group element per
  sample*: the reference's random walk over generators is composed on the
  host into one element of D4 (exact group composition, zero image work),
  then applied on device with a vmapped 8-way branch. Same distribution
  support (all of D4); composition happens in the 8-element group table
  instead of repeated image flips.

Conventions: all image ops act on arrays shaped (B, H, W) or (B, H, W, C),
spatial axes (1, 2), matching the reference registry. H == W is required for
the rotations to preserve shape (reference trains/predicts on square windows).
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "AUGMENTATION_NAMES",
    "INVERTIBLE_2D_AUGMENTATIONS",
    "D4_TABLE",
    "D4_INVERSE",
    "GENERATOR_CODES",
    "tta_expand",
    "tta_collapse",
    "tta_expand_np",
    "tta_collapse_np",
    "apply_d4",
    "apply_d4_batch",
    "compose_random_walk",
]


def _rot90(x, k):
    return jnp.rot90(x, k, axes=(1, 2))


def _vflip(x):
    # Reference 'vflip' flips axis 1 (rows); utils/neurons.py:117.
    return jnp.flip(x, axis=1)


def _hflip(x):
    # Reference 'hflip' flips axis 2 (cols); utils/neurons.py:120.
    return jnp.flip(x, axis=2)


# The 8 named TTA entries, (name, forward, inverse), exactly mirroring
# reference utils/neurons.py:112-137 (same names, same order, same axes).
INVERTIBLE_2D_AUGMENTATIONS = [
    ("identity", lambda x: x, lambda x: x),
    ("vflip", _vflip, _vflip),
    ("hflip", _hflip, _hflip),
    ("rot90", lambda x: _rot90(x, 1), lambda x: _rot90(x, -1)),
    ("rot180", lambda x: _rot90(x, 2), lambda x: _rot90(x, -2)),
    ("rot270", lambda x: _rot90(x, 3), lambda x: _rot90(x, -3)),
    ("rot90vflip", lambda x: _vflip(_rot90(x, 1)), lambda x: _vflip(_rot90(x, 1))),
    ("rot90hflip", lambda x: _hflip(_rot90(x, 1)), lambda x: _hflip(_rot90(x, 1))),
]

AUGMENTATION_NAMES = [name for name, _, _ in INVERTIBLE_2D_AUGMENTATIONS]

# --- D4 group structure -----------------------------------------------------
# Code i corresponds to INVERTIBLE_2D_AUGMENTATIONS[i]. The Cayley table and
# inverses below are derived programmatically in tests/test_augment.py and
# hard-coded here so train-time composition is pure integer arithmetic.
#
# D4_TABLE[a, b] = code of (augmentation a applied AFTER augmentation b),
# i.e. fwd[a] o fwd[b].
D4_TABLE = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7],
        [1, 0, 4, 6, 2, 7, 3, 5],
        [2, 4, 0, 7, 1, 6, 5, 3],
        [3, 7, 6, 4, 5, 0, 1, 2],
        [4, 2, 1, 5, 0, 3, 7, 6],
        [5, 6, 7, 0, 3, 4, 2, 1],
        [6, 5, 3, 2, 7, 1, 0, 4],
        [7, 3, 5, 1, 6, 2, 4, 0],
    ],
    dtype=np.int32,
)

# D4_INVERSE[a] = code of the inverse of augmentation a.
D4_INVERSE = np.array([0, 1, 2, 5, 4, 3, 6, 7], dtype=np.int32)

# Codes of the 6 train-time generators in reference order
# (unet_2d_summary.py:459-466): identity, hflip, vflip, rot90, rot180, rot270.
GENERATOR_CODES = np.array([0, 2, 1, 3, 4, 5], dtype=np.int32)


# --- TTA as one batched forward ---------------------------------------------

def tta_expand(batch):
    """Stack all 8 augmented views of ``batch`` on a new leading axis.

    Input (B, H, W) -> output (8, B, H, W). Requires H == W.
    """
    return jnp.stack([fwd(batch) for _, fwd, _ in INVERTIBLE_2D_AUGMENTATIONS])


def tta_collapse(preds):
    """Invert each of the 8 views and average: (8, B, H, W) -> (B, H, W).

    Equivalent to the reference accumulation loop
    (``unet_2d_summary.py:585-590``), but on device in one fused graph.
    """
    inverted = [
        inv(preds[i]) for i, (_, _, inv) in enumerate(INVERTIBLE_2D_AUGMENTATIONS)
    ]
    return jnp.mean(jnp.stack(inverted), axis=0)


# --- Host-side twins ---------------------------------------------------------
# np.flip/np.rot90 share semantics with the jnp ops above; parity is pinned
# by tests/test_augment.py. These exist so host-resident pipelines
# (predict_tta's batching layer) can expand/collapse without shipping the
# 8x-expanded tensors across a thin host<->device link.

_NP_AUGS = [
    ("identity", lambda x: x, lambda x: x),
    ("vflip", lambda x: np.flip(x, 1), lambda x: np.flip(x, 1)),
    ("hflip", lambda x: np.flip(x, 2), lambda x: np.flip(x, 2)),
    ("rot90", lambda x: np.rot90(x, 1, (1, 2)), lambda x: np.rot90(x, -1, (1, 2))),
    ("rot180", lambda x: np.rot90(x, 2, (1, 2)), lambda x: np.rot90(x, -2, (1, 2))),
    ("rot270", lambda x: np.rot90(x, 3, (1, 2)), lambda x: np.rot90(x, -3, (1, 2))),
    ("rot90vflip", lambda x: np.flip(np.rot90(x, 1, (1, 2)), 1),
     lambda x: np.flip(np.rot90(x, 1, (1, 2)), 1)),
    ("rot90hflip", lambda x: np.flip(np.rot90(x, 1, (1, 2)), 2),
     lambda x: np.flip(np.rot90(x, 1, (1, 2)), 2)),
]


def tta_expand_np(batch):
    """Host-side :func:`tta_expand`: (B, H, W) numpy -> (8, B, H, W)."""
    return np.stack([fwd(batch) for _, fwd, _ in _NP_AUGS])


def tta_collapse_np(preds):
    """Host-side :func:`tta_collapse`: (8, B, H, W) numpy -> (B, H, W)."""
    inverted = [inv(preds[i]) for i, (_, _, inv) in enumerate(_NP_AUGS)]
    return np.mean(np.stack(inverted), axis=0)


# --- Train-time random augmentation ------------------------------------------

def apply_d4(img2d, code):
    """Apply D4 element ``code`` (traced int) to one 2-D image on device."""
    branches = [
        lambda x, f=fwd: f(x[None])[0] for _, fwd, _ in INVERTIBLE_2D_AUGMENTATIONS
    ]
    return jax.lax.switch(code, branches, img2d)


def apply_d4_batch(batch, codes):
    """Apply a per-sample D4 element: (B, H, W), (B,) int32 -> (B, H, W)."""
    return jax.vmap(apply_d4)(batch, codes)


def compose_random_walk(rng: np.random.Generator, nb_max_augment: int) -> int:
    """Sample the reference's augmentation random walk as ONE D4 code.

    The reference draws ``k ~ U{0..nb_max_augment}`` generators and applies
    them sequentially to the image (``unet_2d_summary.py:523-527``). Since the
    generators lie in D4, the composite is a single group element; we compose
    codes in the Cayley table instead of flipping pixels k times.
    """
    k = int(rng.integers(0, nb_max_augment + 1))
    code = 0
    for _ in range(k):
        g = GENERATOR_CODES[int(rng.integers(0, len(GENERATOR_CODES)))]
        code = int(D4_TABLE[g, code])  # apply g after current composite
    return code

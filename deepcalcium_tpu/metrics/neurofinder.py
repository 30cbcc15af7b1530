"""Neurofinder challenge metrics: precision/recall/inclusion/exclusion/F1.

The reference delegates scoring to the external ``neurofinder==1.1.1`` and
``regional==1.1.2`` packages (reference ``datasets/nf.py:4,168-173``); those
are re-implemented here from their published semantics since they are the
scoring ground truth:

- A *region* is a set of (y, x) pixel coordinates; its *center* is the
  coordinate-wise mean (regional's ``center`` property).
- ``match(a, b, threshold)`` (neurofinder-python): greedy sequential
  matching — iterate regions of ``a`` in order; for each, find the nearest
  *remaining* center in ``b`` (Euclidean distance between centers); if the
  distance is below ``threshold``, consume that target, else leave unmatched.
- ``centers(a, b)``: recall = matched/|a|, precision = matched/|b|.
- ``shapes(a, b)``: over matched pairs (a_j, b_i), inclusion =
  |a_j ∩ b_i| / |a_j| and exclusion = |a_j ∩ b_i| / |b_i|, averaged.
- The reference calls ``centers(m, mp)`` / ``shapes(m, mp)`` with the library
  default threshold (unbounded), which we mirror: ``threshold=inf``.

Connected-component labeling replaces ``skimage.measure.label`` with
``scipy.ndimage.label``. skimage's default for binary 2-D input is
2-connectivity (8-neighborhood)? No — ``measure.label`` default connectivity
is full (2 for 2-D, i.e. 8-neighbors). We therefore label with the 3x3
all-ones structure to match.

Host-side by design: labeling and greedy matching are irregular, tiny
(hundreds of regions), and run once per image — the dense work (the network
forward producing the masks) stays on the device.
"""

import numpy as np
from scipy import ndimage

__all__ = [
    "Region",
    "label_mask",
    "mask_to_regions",
    "regions_to_mask",
    "match_centers",
    "centers",
    "shapes",
    "nf_mask_metrics",
]

# 8-connectivity structure matching skimage.measure.label's default
# (connectivity=2 for 2-D input).
_STRUCT8 = np.ones((3, 3), dtype=np.int32)


class Region:
    """A set of pixel coordinates with cached center (mean of coordinates)."""

    __slots__ = ("coordinates", "center", "_coord_set")

    def __init__(self, coordinates):
        self.coordinates = np.asarray(coordinates, dtype=np.int64)
        if self.coordinates.ndim != 2 or self.coordinates.shape[1] != 2:
            raise ValueError("coordinates must be (N, 2)")
        self.center = self.coordinates.mean(axis=0)
        self._coord_set = None

    @property
    def coord_set(self):
        if self._coord_set is None:
            self._coord_set = {tuple(c) for c in self.coordinates.tolist()}
        return self._coord_set

    def __len__(self):
        return len(self.coordinates)


def label_mask(m: np.ndarray) -> np.ndarray:
    """8-connected component labeling of a binary 2-D mask."""
    m = np.asarray(m)
    labeled, _ = ndimage.label(m > 0, structure=_STRUCT8)
    return labeled


def mask_to_regions(m: np.ndarray) -> list:
    """Binary 2-D mask -> list of Regions, one per 8-connected component.

    Mirrors reference ``_mask_to_regional`` (``datasets/nf.py:221-229``).
    """
    labeled = label_mask(m)
    n = labeled.max()
    regions = []
    if n == 0:
        return regions
    # ndimage.find_objects keeps label order 1..n like the reference loop.
    slices = ndimage.find_objects(labeled)
    for lbl, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        sub = labeled[sl] == lbl
        yy, xx = np.nonzero(sub)
        coords = np.stack([yy + sl[0].start, xx + sl[1].start], axis=1)
        regions.append(Region(coords))
    return regions


def regions_to_mask(regions, shape) -> np.ndarray:
    """List of Regions -> binary 2-D mask."""
    m = np.zeros(shape, dtype=np.uint8)
    for r in regions:
        m[r.coordinates[:, 0], r.coordinates[:, 1]] = 1
    return m


def match_centers(a, b, threshold=np.inf):
    """Greedy sequential center matching (neurofinder-python ``match``).

    Returns a list of len(a): index into ``b`` for each matched region of
    ``a``, or None when unmatched.
    """
    if len(b) == 0:
        return [None] * len(a)
    targets = np.stack([r.center for r in b])  # (Nb, 2)
    alive = np.ones(len(b), dtype=bool)
    out = []
    for ra in a:
        if not alive.any():
            out.append(None)
            continue
        d = np.linalg.norm(targets - ra.center, axis=1)
        d[~alive] = np.inf
        i = int(np.argmin(d))
        if d[i] < threshold:
            out.append(i)
            alive[i] = False
        else:
            out.append(None)
    return out


def centers(a, b, threshold=np.inf):
    """(recall, precision) from greedy center matching.

    Matches neurofinder-python ``centers``: recall = matched/|a| (a = ground
    truth), precision = matched/|b| (b = prediction). Reference call site:
    ``datasets/nf.py:171`` (``r, p = centers(m, mp)``).
    """
    inds = match_centers(a, b, threshold)
    nmatched = sum(1 for i in inds if i is not None)
    recall = nmatched / float(len(a)) if len(a) else 0.0
    precision = nmatched / float(len(b)) if len(b) else 0.0
    return recall, precision


def shapes(a, b, threshold=np.inf):
    """(inclusion, exclusion) over matched pairs.

    inclusion = |a ∩ b| / |a| (fraction of the ground-truth region covered),
    exclusion = |a ∩ b| / |b| (fraction of the predicted region that is
    ground truth), averaged over matched pairs. Reference call site:
    ``datasets/nf.py:172`` (``i, e = shapes(m, mp)``).
    """
    inds = match_centers(a, b, threshold)
    incl, excl = [], []
    for j, i in enumerate(inds):
        if i is None:
            continue
        inter = len(a[j].coord_set & b[i].coord_set)
        incl.append(inter / float(len(a[j])))
        excl.append(inter / float(len(b[i])))
    if not incl:
        return 0.0, 0.0
    return float(np.mean(incl)), float(np.mean(excl))


def nf_mask_metrics(m, mp, threshold=np.inf):
    """Precision, recall, inclusion, exclusion, F1 for 2-D binary masks.

    Behavioral mirror of reference ``nf_mask_metrics`` (``datasets/nf.py:
    153-174``) including the all-zeros short-circuit for an empty prediction
    (``nf.py:165-166``).

    # Returns
        (p, r, i, e, f1) — note the reference returns precision first even
        though ``centers`` yields (recall, precision).
    """
    # Round ONCE and use the rounded map throughout: the emptiness gate
    # rounds, so labeling the raw map would threshold a probability input
    # at > 0 instead of >= 0.5 (every 0.001-prob pixel becoming predicted
    # area) — a silent trap for public-API callers passing sigmoid maps.
    mp = np.round(np.asarray(mp))
    if np.sum(mp) == 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    ra = mask_to_regions(np.asarray(m))
    rb = mask_to_regions(mp)
    r, p = centers(ra, rb, threshold)
    i, e = shapes(ra, rb, threshold)
    f1 = 2.0 * (r * p) / (r + p) if (r + p) > 0 else 0.0
    return p, r, i, e, f1

"""Property tests: metrics/neurofinder.py vs the independent second oracle.

The scoring path is the ground truth for every F1
the framework reports, and its greedy-match tie-breaking/ordering must not
silently diverge. Two independent transcriptions of the published
neurofinder/regional semantics (numpy/scipy production code vs pure-Python
BFS/dict oracle) are compared on ~10^3 random configurations including
ties, nested regions, empty sets, and threshold edges.
"""

import math

import numpy as np
import pytest

from deepcalcium_tpu.metrics.neurofinder import (Region, centers,
                                                 mask_to_regions,
                                                 match_centers,
                                                 nf_mask_metrics, shapes)
from tests.oracle_nf_scoring import (bfs_label, greedy_match, score_masks)


def _random_mask(rng, h, w, nblobs, rmax=3):
    m = np.zeros((h, w), np.uint8)
    for _ in range(nblobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(1, rmax + 1)
        yy, xx = np.ogrid[:h, :w]
        m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return m


def test_labeling_matches_bfs_oracle():
    rng = np.random.default_rng(0)
    for _ in range(60):
        m = (rng.random((rng.integers(3, 24), rng.integers(3, 24))) < 0.35)
        ours = mask_to_regions(m.astype(np.uint8))
        oracle = bfs_label(m.tolist())
        assert len(ours) == len(oracle)
        ours_sets = sorted(sorted(map(tuple, r.coordinates.tolist()))
                           for r in ours)
        assert ours_sets == sorted(oracle)


def test_match_property_sweep():
    """~1000 random region configurations, including exact-tie centers."""
    rng = np.random.default_rng(1)
    for trial in range(1000):
        na, nb = rng.integers(0, 8), rng.integers(0, 8)
        # Quantized coordinates force frequent distance ties.
        A = [np.stack([rng.integers(0, 6, 3), rng.integers(0, 6, 3)], 1)
             for _ in range(na)]
        B = [np.stack([rng.integers(0, 6, 3), rng.integers(0, 6, 3)], 1)
             for _ in range(nb)]
        thr = [math.inf, 2.0, 0.0, 1e-9][trial % 4]
        ra = [Region(c) for c in A]
        rb = [Region(c) for c in B]
        got = match_centers(ra, rb, thr)
        want = greedy_match([list(map(tuple, c)) for c in A],
                            [list(map(tuple, c)) for c in B], thr)
        assert got == want, (trial, got, want)

        rg, pg = centers(ra, rb, thr)
        ig, eg = shapes(ra, rb, thr)
        nm = sum(1 for i in want if i is not None)
        assert rg == pytest.approx(nm / na if na else 0.0)
        assert pg == pytest.approx(nm / nb if nb else 0.0)


def test_full_metric_property_sweep():
    """End-to-end mask scoring: production vs oracle on random blob masks,
    nested/overlapping regions included by construction."""
    rng = np.random.default_rng(2)
    for trial in range(120):
        h, w = rng.integers(8, 40), rng.integers(8, 40)
        m = _random_mask(rng, h, w, rng.integers(0, 5))
        mp = _random_mask(rng, h, w, rng.integers(0, 5))
        if trial % 7 == 0:
            mp = m.copy()  # perfect prediction
        if trial % 11 == 0:
            mp[:] = 0     # empty prediction short-circuit
        got = nf_mask_metrics(m, mp)
        want = score_masks(m.tolist(), mp.tolist())
        np.testing.assert_allclose(got, want, atol=1e-12, err_msg=str(trial))


def test_exact_tie_consumes_lowest_index():
    """Two targets at identical distance: the first (lowest index) wins —
    the semantics np.argmin and order-preserving deletion share."""
    a = [Region([(0, 0)]), Region([(0, 0)])]
    b = [Region([(0, 2)]), Region([(2, 0)])]  # both at distance 2
    assert match_centers(a, b) == [0, 1]


def test_threshold_is_strict():
    a = [Region([(0, 0)])]
    b = [Region([(0, 2)])]  # distance exactly 2
    assert match_centers(a, b, threshold=2.0) == [None]
    assert match_centers(a, b, threshold=2.0 + 1e-9) == [0]

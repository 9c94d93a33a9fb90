"""``search_for_initialization`` against a plain per-key loop of the
reference matcher's semantics (``searchForInitializaion``,
DescriptorMatching.cc:39-99): finest-octave reference keys, a radius window
scaled by the key's octave, neighbouring octaves only, absolute threshold,
best/second-best ratio, and one-to-one resolution by smallest distance."""

import numpy as np
import pytest

from triangulation_in_deformable_scenes_tpu.ops import matching


def _planted_problem(rng, n1, n2, n_scales=4, spread=400.0):
    kp1 = rng.uniform(0, spread, size=(n1, 2)).astype(np.float32)
    kp2 = rng.uniform(0, spread, size=(n2, 2)).astype(np.float32)
    d1 = rng.integers(0, 2, size=(n1, 256)).astype(np.int8)
    d2 = rng.integers(0, 2, size=(n2, 256)).astype(np.int8)
    # Plant near-duplicates so real matches (and ratio-test near-ties) exist.
    k = min(n1, n2) // 2
    d2[:k] = d1[:k]
    flip = rng.integers(0, 256, size=(k, 8))
    for i in range(k):
        d2[i, flip[i]] ^= 1
    kp2[:k] = kp1[:k] + rng.normal(0, 5.0, size=(k, 2))
    o1 = rng.integers(0, n_scales, size=n1).astype(np.int32)
    o2 = rng.integers(0, n_scales, size=n2).astype(np.int32)
    v1 = rng.uniform(size=n1) > 0.1
    v2 = rng.uniform(size=n2) > 0.1
    sf = np.array([1.2**o for o in range(n_scales)], dtype=np.float32)
    return kp1, d1, o1, v1, kp2, d2, o2, v2, sf


def reference_loop(kp1, d1, o1, v1, kp2, d2, o2, v2, sf, th, window_factor, ratio, max_octave):
    n1, n2 = len(kp1), len(kp2)
    best = np.full(n1, -1)
    best_d = np.full(n1, np.inf)
    for i in range(n1):
        if not v1[i] or o1[i] > max_octave:
            continue
        radius = np.float32(window_factor) * sf[min(max(o1[i], 0), len(sf) - 1)]
        dists = []
        for j in range(n2):
            if not v2[j] or not (o1[i] - 1 <= o2[j] <= o1[i] + 1):
                continue
            if np.sum((kp1[i] - kp2[j]) ** 2, dtype=np.float32) > radius * radius:
                continue
            dists.append((int(np.sum(d1[i] != d2[j])), j))
        if not dists:
            continue
        dists.sort()
        d0, j0 = dists[0]
        d_second = dists[1][0] if len(dists) > 1 else np.inf
        if d0 <= th and d0 < d_second * ratio:
            best[i], best_d[i] = j0, d0
    # One-to-one: a current key keeps only its closest reference key(s).
    out = best.copy()
    for j in set(best[best >= 0].tolist()):
        rows = np.nonzero(best == j)[0]
        out[rows[best_d[rows] > best_d[rows].min()]] = -1
    return out


KW = dict(th=60.0, window_factor=30.0, ratio=0.9, max_octave=3)


@pytest.mark.parametrize("n1,n2", [(128, 128), (200, 330), (100, 513)])
def test_matches_reference_loop(n1, n2):
    rng = np.random.default_rng(n1 * 1000 + n2)
    args = _planted_problem(rng, n1, n2)
    m, n = matching.search_for_initialization(*args, **KW)
    want = reference_loop(*args, **KW)
    np.testing.assert_array_equal(np.asarray(m), want)
    assert int(n) == int(np.sum(want >= 0)) > 0


def test_rows_failing_every_gate_stay_unmatched():
    rng = np.random.default_rng(7)
    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = _planted_problem(rng, 64, 64)
    v1[:] = False
    m, n = matching.search_for_initialization(kp1, d1, o1, v1, kp2, d2, o2, v2, sf)
    assert int(n) == 0
    assert np.all(np.asarray(m) == -1)

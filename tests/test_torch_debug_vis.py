"""volym_tpu_torch.render.debug_vis (the midpoint importance check, the
ray-direction / step-count view and the march-length histogram) against
volym_tpu.render.debug_vis under eager JAX."""

import numpy as np
import pytest

from tstep_common import camera, eager, params, sphere, teapot
from volym_tpu.render import debug_vis as jdebug
from volym_tpu_torch.render import debug_vis

RES = 16


def test_importance_debug_matches_eager_jax():
    sj, st = teapot()
    _, mj, mt = camera()
    want = eager(jdebug.importance_debug, sj, mj, RES, RES)
    got = debug_vis.importance_debug(st, mt, RES, RES).numpy()
    np.testing.assert_array_equal(got, want)
    # red, blue and black all occur (importance_test.wgsl:84-99)
    assert {tuple(px) for px in got[..., :3].reshape(-1, 3).tolist()} == {(0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                                                                           (0.0, 0.0, 1.0)}


@pytest.fixture(scope="module")
def matrix():
    """(port params, port scene, port matrices, JAX's debug matrix): the
    step count of a march that some rays end early in and others run to
    ``max_steps``."""
    sj, st = sphere()
    _, mj, mt = camera(30.0, 20.0)
    pj, pt = params(use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=12, use_shading=False)
    return pt, st, mt, eager(jdebug.debug_matrix, sj, mj, pj, RES, RES)


def test_debug_matrix_matches_eager_jax(matrix):
    pt, st, mt, want = matrix
    got = debug_vis.debug_matrix(st, mt, pt, RES, RES).numpy()
    np.testing.assert_array_equal(got, want)
    counts = np.round(want[..., 3] * 12)
    assert counts.min() == 0 and counts.max() == 12 and len(np.unique(counts)) > 3


def test_step_counts_and_histogram_match_jax(matrix):
    pt, st, mt, want = matrix
    counts = debug_vis.step_counts(st, mt, pt, RES, RES).numpy()
    np.testing.assert_array_equal(counts, np.round(want[..., 3] * 12).astype(np.int32))
    edges, hist = debug_vis.step_count_histogram(st, mt, pt, RES, RES, bins=8)
    want_hist, want_edges = np.histogram(counts, bins=8, range=(0, 12))
    np.testing.assert_array_equal(edges, want_edges)
    np.testing.assert_array_equal(hist, want_hist)
    assert hist.sum() == RES * RES and hist[1:].sum() > 0

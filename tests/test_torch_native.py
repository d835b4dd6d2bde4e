"""PyTorch port, sets/native (the ctypes bindings of native/polylp.cpp):
support, support_batch, min_hrep_mask and vertices against lbmpc_tpu's
sets/native on tests/test_native.py's inputs (the unit box, an unbounded
direction, seeded random polytopes), within 1e-12. They skip where the
reference's tests skip: without a native library for lbmpc_tpu."""

import numpy as np
import pytest

from lbmpc_tpu_torch.sets import native as t_native

from lbmpc_tpu.sets import native as j_native
from lbmpc_tpu.sets.polytope import box


@pytest.fixture(scope="module")
def lib():
    if not j_native.available():
        pytest.skip("no C++ toolchain for native polylp")
    return j_native.get_lib()


def _random_polytope(seed: int, n: int, extra: int, box_h: float, lo: float, hi: float):
    rng = np.random.default_rng(seed)
    F = np.vstack([np.eye(n), -np.eye(n), rng.standard_normal((extra, n))])
    h = np.concatenate([np.full(2 * n, box_h), rng.uniform(lo, hi, extra)])
    return F, h


def test_support_matches_reference(lib):
    """tests/test_native.py's random polytope in R^5 and 8 directions, and
    its unbounded direction (+inf in both)."""
    F, h = _random_polytope(0, 5, 12, 2.0, 0.5, 2.0)
    for seed in range(8):
        c = np.random.default_rng(seed).standard_normal(5)
        assert abs(t_native.support(c, F, h) - j_native.support(c, F, h)) <= 1e-12
    Fu, hu, cu = np.array([[-1.0, 0.0]]), np.array([1.0]), np.array([1.0, 0.0])
    assert t_native.support(cu, Fu, hu) == j_native.support(cu, Fu, hu) == np.inf


@pytest.mark.parametrize("polytope", ["box", "random"])
def test_support_batch_matches_reference(lib, polytope):
    """The unit box in R^4 with 32 directions (tests/test_native.py's
    test_native_batch, also against |c|_1), and the random polytope in R^5;
    an F whose width is not C's is refused before the native call."""
    if polytope == "box":
        F, h = np.vstack([np.eye(4), -np.eye(4)]), np.ones(8)
    else:
        F, h = _random_polytope(0, 5, 12, 2.0, 0.5, 2.0)
    C = np.random.default_rng(1).standard_normal((32, F.shape[1]))
    got = t_native.support_batch(C, F, h)
    assert got.shape == (32,)
    np.testing.assert_allclose(got, j_native.support_batch(C, F, h), rtol=0, atol=1e-12)
    if polytope == "box":
        np.testing.assert_allclose(got, np.abs(C).sum(axis=1), atol=1e-8)
    with pytest.raises(ValueError, match="disagree"):
        t_native.support_batch(C, F[:, 1:], h)


def test_min_hrep_mask_matches_reference(lib):
    """The unit square with two redundant rows (tests/test_native.py), and
    a random polytope in R^3 with 8 cuts."""
    p = box([-1, -1], [1, 1])
    cases = [(np.vstack([p.F, [[0.5, 0.5], [1.0, 0.0]]]), np.concatenate([p.h, [5.0, 2.0]])),
             _random_polytope(1, 3, 8, 1.5, 0.8, 2.0)]
    for F, h in cases:
        np.testing.assert_array_equal(t_native.min_hrep_mask(F, h),
                                      j_native.min_hrep_mask(F, h))
    assert t_native.min_hrep_mask(*cases[0]).tolist() == [True] * 4 + [False] * 2


def test_vertices_match_reference(lib):
    """The unit cube in R^3 (8 corners), tests/test_native.py's five random
    polytopes in R^3 (seed 1), and its instance past the native budget
    (None in both)."""
    cube = box(-np.ones(3), np.ones(3))
    rng = np.random.default_rng(1)
    cases = [(cube.F, cube.h)]
    for _ in range(5):
        cases.append((np.vstack([np.eye(3), -np.eye(3), rng.standard_normal((8, 3))]),
                      np.concatenate([np.full(6, 1.5), rng.uniform(0.8, 2.0, 8)])))
    for F, h in cases:
        got, ref = t_native.vertices(F, h), j_native.vertices(F, h)
        assert got is not None and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert t_native.vertices(cube.F, cube.h).shape == (8, 3)
    F, h = _random_polytope(3, 8, 200, 1.0, 1.0, 3.0)
    assert t_native.vertices(F, h) is None and j_native.vertices(F, h) is None

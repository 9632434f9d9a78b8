"""The work and bytes counts against hand counts at the shapes of the
kernel table's rows 3, 19 and 20, at the unpadded n."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_factor_row3_shared_gt_f32():
    # 1024 instances, n = 256, m = 512, Gt shared, float32
    B, n, m = 1024, 256, 512
    flops, nbytes = roofline.factor_work(B, n, m, True, 4)
    # S's lower triangle: n (n + 1) / 2 entries of m multiply-adds each,
    # and the Cholesky's n^3 / 3
    assert flops == pytest.approx(B * (256 * 257 * 512 + 256 ** 3 / 3))
    # P's and L's lower triangles and dinv2 per instance, Gt once
    words = B * (2 * 256 * 257 / 2 + 512) + 256 * 512
    assert nbytes == pytest.approx(4 * words)
    t = roofline.least_seconds(flops, nbytes, 4)
    assert t == pytest.approx(flops / 67e12)          # bound by FLOPs
    assert 0.59e-3 < t < 0.61e-3


def test_factor_row19_f64():
    n = 10240
    flops, nbytes = roofline.factor_work(1, n, n, True, 8)
    assert flops == pytest.approx(n * (n + 1) * n + n ** 3 / 3)
    assert nbytes == pytest.approx(8 * (n * (n + 1) + n + n * n))
    t = roofline.least_seconds(flops, nbytes, 8)
    assert t == pytest.approx(21.37e-3, rel=1e-3)     # row 19's bound


def test_solve_row20_f64():
    n = 10240
    flops, nbytes = roofline.solve_work(1, n, 1, False, 8)
    assert flops == pytest.approx(2.0 * n * n)
    # L's lower triangle read once, one right-hand side in and out
    assert nbytes == pytest.approx(8 * (n * (n + 1) / 2 + 2 * n))
    t = roofline.least_seconds(flops, nbytes, 8)
    assert t == pytest.approx(nbytes / 3.35e12)       # bound by bytes
    assert 0.125e-3 < t < 0.126e-3


def test_solve_shared_identity_counts_once():
    B, n = 1024, 256
    _, shared = roofline.solve_work(B, n, n, True, 4)
    _, per = roofline.solve_work(B, n, n, False, 4)
    assert per - shared == pytest.approx(4 * (B - 1) * n * n)


@pytest.mark.parametrize("n_call, n_problem, want", [
    (320, 257, 257), (256, 256, 256), (320, None, 320), (320, 200, 320),
    (10240, 10240, 10240)])
def test_true_n(n_call, n_problem, want):
    assert roofline.true_n(n_call, n_problem) == want

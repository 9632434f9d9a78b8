"""The port's MPS I/O (cvxopt_tpu_torch/mpsio.py) against
cvxopt_tpu/mpsio.py — twins of tests/test_mpsio.py: both packages parse
the same files into equal `MPSData` (exactly), a write and re-read is
exact, and the LPs solve to the same objective (within 1e-6) through
each package's `solvers.lp` on the CPU."""

import io
import os

import numpy as np
import pytest
import torch

from cvxopt_tpu import mpsio as jm, solvers as jsolvers
from cvxopt_tpu_torch import mpsio as tm, solvers as tsolvers

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

BOEING2 = os.path.join(os.path.dirname(__file__), "data", "boeing2.mps")
MAXLP = """NAME          MAXLP
OBJSENSE
    MAXIMIZE
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  LIM3
COLUMNS
    X1        COST      1.0        LIM1      1.0
    X2        COST      2.0        LIM1      1.0
    X2        LIM2      1.0        LIM3      1.0
    X3        LIM3      1.0
RHS
    RHS       LIM1      4.0        LIM2      -1.0
    RHS       LIM3      2.0
RANGES
    RNG       LIM1      6.0        LIM3      -1.5
BOUNDS
 UP BND       X1        3.0
 UP BND       X2        3.0
 MI BND       X3
ENDATA
"""
FIELDS = ("name", "var_names", "row_names", "obj_name", "c", "objconst",
          "Arows", "rlo", "rhi", "lo", "hi", "integer", "maximize")


def _equal(d, e):
    for f in FIELDS:
        u, v = getattr(d, f), getattr(e, f)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(u, v, err_msg=f)
        else:
            assert u == v, f


def test_boeing2_load():
    d = tm.mps_load(BOEING2)
    _equal(d, jm.mps_load(BOEING2))
    assert d.name == "BOEING2"
    assert len(d.var_names) == 143 and len(d.row_names) == 166
    for u, v in zip(d.to_lp(), jm.mps_load(BOEING2).to_lp()):
        np.testing.assert_array_equal(u, v)


def test_boeing2_solve_optimal():
    """BASELINE config 1 through conelp: 'optimal', the NETLIB objective
    -315.0187280, the JAX package's objective within 1e-6."""
    c, G, h, A, b, objconst = tm.lp_from_mps(BOEING2)
    assert objconst == 0.0
    sol = tsolvers.lp(c, G, h, A=A, b=b, device="cpu")
    ref = jsolvers.lp(c, G, h, A=A, b=b)
    assert sol["status"] == ref["status"] == "optimal"
    assert abs(sol["primal objective"] - (-315.0187280)) < 1e-3
    assert abs(sol["primal objective"] - ref["primal objective"]) < 1e-6


@pytest.mark.parametrize("source", ["boeing2", "ranges"])
def test_mps_roundtrip(source):
    """A write and re-read gives back the same data, and the port writes
    the same text as the JAX package."""
    d = tm.mps_load(BOEING2 if source == "boeing2" else io.StringIO(MAXLP))
    buf, jbuf = io.StringIO(), io.StringIO()
    tm.mps_write(buf, d)
    jm.mps_write(jbuf, d)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    d2 = tm.mps_load(buf)
    assert d2.var_names == d.var_names and d2.row_names == d.row_names
    for f in ("c", "Arows", "rlo", "rhi", "lo", "hi"):
        np.testing.assert_allclose(getattr(d2, f), getattr(d, f),
                                   rtol=1e-12, err_msg=f)


def test_objsense_max():
    """OBJSENSE MAXIMIZE (sectioned and one-line forms) normalizes to
    minimize form with `maximize=True`; the ranged rows follow MPS."""
    d = tm.mps_load(io.StringIO(MAXLP))
    _equal(d, jm.mps_load(io.StringIO(MAXLP)))
    assert d.maximize
    np.testing.assert_allclose(d.c, [-1.0, -2.0, 0.0])
    np.testing.assert_allclose(d.rlo, [-2.0, -1.0, 0.5])
    np.testing.assert_allclose(d.rhi, [4.0, np.inf, 2.0])
    c, G, h, A, b = d.to_lp()
    sol = tsolvers.lp(c, G, h, A=A, b=b, device="cpu")
    ref = jsolvers.lp(c, G, h, A=A, b=b)
    assert sol["status"] == ref["status"] == "optimal"
    # max x1 + 2 x2 s.t. x1 + x2 <= 4, 0 <= x <= 3 -> 7
    assert abs(-sol["primal objective"] - 7.0) < 1e-5
    assert abs(sol["primal objective"] - ref["primal objective"]) < 1e-6
    one_line = MAXLP.replace("OBJSENSE\n    MAXIMIZE", "OBJSENSE MAX")
    d2 = tm.mps_load(io.StringIO(one_line))
    _equal(d2, d)

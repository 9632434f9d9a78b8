"""cvxopt_tpu_torch.solvers — solver front door of the port.

Twin of `cvxopt_tpu/solvers.py`: the cone solvers (`conelp`, `coneqp`,
with operator-form G/A/P and callable kktsolvers), their front ends
(`lp`, `qp`, `socp`, `sdp`; `lp` with solver='glpk' runs the native
simplex, and lp/qp/socp with solver='mosek' the MOSEK bridge), the
nonlinear solvers (`cp`, `cpl`, `gp`) and the shared `options` dict,
read at call time:

    options['show_progress']  bool (default: False)
    options['maxiters']       positive integer (default: 100)
    options['abstol']         scalar (default: 1e-7)
    options['reltol']         scalar (default: 1e-6)
    options['feastol']        scalar (default: 1e-7)
    options['refinement']     nonnegative integer (default: 0 when no
                              'q'/'s' cones, else 1)
    options['kktreg']         static KKT regularization (default: None)
    options['factor_dtype']   'auto' (default; the working dtype),
                              'float32', 'rescue' or 'none'
    options['glpk']           GLPK parameters for solver='glpk'
    options['mosek']          MOSEK parameters for solver='mosek'
"""

from cvxopt_tpu_torch.conelp import conelp, make_conelp, \
    make_conelp_cascade, make_conelp_ws, make_conelp_refresh
from cvxopt_tpu_torch.coneqp import coneqp, make_coneqp, \
    make_coneqp_cascade
from cvxopt_tpu_torch.frontends import lp, qp, socp, sdp
from cvxopt_tpu_torch.cvxprog import cp, cpl, gp

options = {}

__all__ = ["conelp", "coneqp", "cp", "cpl", "gp",
           "lp", "qp", "socp", "sdp", "options",
           "make_conelp", "make_coneqp", "make_coneqp_cascade",
           "make_conelp_cascade", "make_conelp_ws", "make_conelp_refresh"]

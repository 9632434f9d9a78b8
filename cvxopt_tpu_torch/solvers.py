"""cvxopt_tpu_torch.solvers — solver front door of the port (the cone-QP
solver so far; see ROADMAP.md for the rest).

    options['maxiters']       positive integer (default: 100)
    options['abstol']         scalar (default: 1e-7)
    options['reltol']         scalar (default: 1e-6)
    options['feastol']        scalar (default: 1e-7)
    options['refinement']     nonnegative integer (default: 0 when no
                              'q'/'s' cones, else 1)
    options['factor_dtype']   'auto' (default; the working dtype),
                              'float32', 'rescue' or 'none'
"""

from cvxopt_tpu_torch.coneqp import coneqp, make_coneqp, \
    make_coneqp_cascade

options = {}

__all__ = ["coneqp", "options", "make_coneqp", "make_coneqp_cascade"]

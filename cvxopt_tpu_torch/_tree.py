"""Batch and tree helpers shared by the solvers (conelp, coneqp,
cvxprog).

Solver state is batched: every tensor has a leading batch axis B, and a
per-instance scalar is a (B,) tensor that broadcasts against each
leaf's rank.  x and y (and c, b) may also be dicts, lists and tuples of
such tensors (the reference's level-3 customization, coneprog.py:
286-402; `cvxopt_tpu/conelp.py:97-147`); the `_t*` helpers do their
arithmetic over such trees.

User callables (operators ``G(x, trans)``, ``LinearOperator``s,
kktsolvers) see one unbatched problem, as the JAX package's users write
them under vmap; `_per_instance` and `_per_instance_factor` run them
once per instance in a Python loop and put the batch axis back on what
they return.
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch.ops.matvec import mv, mvt, vdot


def _col(t):
    """Per-instance scalar (B,) as a column (B, 1)."""
    return t.unsqueeze(-1)


def _tmap(fn, *trees):
    a = trees[0]
    if isinstance(a, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tmap(fn, *u) for u in zip(*trees))
    return fn(*trees)


def _leaves(a):
    """Leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(a, dict):
        return [v for k in sorted(a) for v in _leaves(a[k])]
    if isinstance(a, (list, tuple)):
        return [v for u in a for v in _leaves(u)]
    return [a]


def _bcol(alpha, u):
    """Per-instance alpha (B,) shaped to broadcast against u (B, ...)."""
    return alpha.reshape(alpha.shape + (1,) * (u.dim() - alpha.dim()))


def _where(mask, a, b):
    """torch.where over matching trees with a per-instance (B,) mask."""
    return _tmap(lambda u, v: torch.where(_bcol(mask, u), u, v), a, b)


def _tdot(a, b):
    """Inner product of two trees, one value per instance."""
    if torch.is_tensor(a):
        return a * b if a.dim() == 1 else vdot(a, b)
    out = 0.0
    for u, v in zip(_leaves(a), _leaves(b)):
        w = u * v
        out = out + (w if w.dim() == 1 else w.flatten(1).sum(-1))
    return out


def _tnorm(a):
    if torch.is_tensor(a) and a.dim() == 2:
        return torch.linalg.vector_norm(a, dim=-1)
    return torch.sqrt(torch.clamp(_tdot(a, a), min=0.0))


def _tzeros(a):
    return _tmap(torch.zeros_like, a)


def _tneg(a):
    return _tmap(torch.neg, a)


def _tscale(alpha, a):
    return _tmap(lambda u: _bcol(alpha, u) * u, a)


def _taxpy(alpha, a, b):
    """b + alpha * a."""
    return _tmap(lambda u, v: v + _bcol(alpha, u) * u, a, b)


def _tadd(a, b):
    return _tmap(torch.add, a, b)


def _tsub(a, b):
    return _tmap(torch.sub, a, b)


def _tnorm_parts(parts):
    """sqrt(sum of squared 2-norms) over a tuple of trees, one value per
    instance."""
    t = 0.0
    for pt in parts:
        t = t + _tdot(pt, pt)
    return torch.sqrt(torch.clamp(t, min=0.0))


def _take(tree, k):
    """Instance k of a batched tree."""
    return _tmap(lambda u: u[k], tree)


def _stack(trees):
    return _tmap(lambda *u: torch.stack(u), *trees)


def _per_instance(fn):
    """A user function of one unbatched problem, applied to each
    instance of batched arguments; its (tree) result gets the batch axis
    back."""
    def apply(*args):
        nb = _leaves(args[0])[0].shape[0]
        return _stack([fn(*(_take(a, k) for a in args)) for k in range(nb)])
    return apply


def _per_instance_factor(kktsolver):
    """A user kktsolver (``kktsolver(W)``, or cpl's ``kktsolver(x, znl,
    W)``) on a batch: one factor per instance, each fed its unbatched
    arguments, and a batched solve(bx, by, bz) -> (ux, uy, W uz)."""
    def factor(*args):
        nb = _leaves(args[0])[0].shape[0]
        solves = [kktsolver(*(_take(a, k) for a in args))
                  for k in range(nb)]

        def solve(bx, by, bz):
            outs = [sv(_take(bx, k), _take(by, k), _take(bz, k))
                    for k, sv in enumerate(solves)]
            return tuple(_stack([o[i] for o in outs]) for i in range(3))

        return solve

    return factor


def _operator_maps(op):
    """(mv, rmv) on batched vectors for a `LinearOperator`, a callable
    ``op(x, trans)`` of one instance, or a dense (shared or batched)
    matrix."""
    if not _is_operator(op):
        return (lambda x: mv(op, x)), (lambda z: mvt(op, z))
    if hasattr(op, "rmv"):
        return _per_instance(op.mv), _per_instance(op.rmv)
    return (_per_instance(lambda x: op(x, "N")),
            _per_instance(lambda z: op(z, "T")))


def _is_operator(u):
    return u is not None and not torch.is_tensor(u) and (
        callable(u) or hasattr(u, "rmv"))

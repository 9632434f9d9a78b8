"""Modeling layer — piecewise-linear LP DSL.

Twin of `cvxopt_tpu/modeling.py` (the reference's `cvxopt.modeling`):
`variable`, affine and piecewise-linear expressions built by operator
overloading, `constraint`s from <=, >=, ==, `op` problems with
`solve()`, `max`, `min`, `sum`, `dot`, and MPS file I/O
(`op.fromfile`/`op.tofile`, through `cvxopt_tpu_torch.mpsio`).

  - an `Expr` is an affine part (per-variable coefficient matrices +
    constant) plus a list of convex max-terms (each an elementwise max
    over affine pieces, optionally sum-reduced) with +1/-1 signs:
    +max-terms make it convex, -max-terms (i.e. mins) concave;
  - `op.solve()` performs the epigraph transform to a pure LP
    (the analogue of the reference's op._inmatrixform): one auxiliary
    variable vector per max-term, then dispatches to the port's
    `solvers.lp` on `device` and writes `.value` back into variables
    and `constraint.multiplier` as numpy arrays.

The expressions are host numpy; only the solve reaches the device.
Unlike the JAX package, dividing by a one-element list or tuple divides
by its scalar.
"""

from __future__ import annotations

import builtins
from typing import Dict, List, Optional

import numpy as np
import torch

_builtin_max = builtins.max
_builtin_min = builtins.min
_builtin_sum = builtins.sum


class variable:
    """Optimization variable (modeling.py:37)."""

    _counter = [0]
    __array_ufunc__ = None

    def __init__(self, size: int = 1, name: str = ""):
        size = int(size)
        if size < 1:
            raise TypeError("size must be a positive integer")
        self._size = size
        self.name = name or f"x{variable._counter[0]}"
        variable._counter[0] += 1
        self.value: Optional[np.ndarray] = None

    def __len__(self):
        return self._size

    def _expr(self) -> "Expr":
        return Expr({self: np.eye(self._size)}, np.zeros(self._size))

    def __repr__(self):
        return f"variable({self._size},'{self.name}')"

    def __str__(self):
        if self.value is None:
            return f"variable({self._size},'{self.name}'): value not set"
        return f"{self.name} = {np.asarray(self.value)}"

    # arithmetic defers to Expr
    def __add__(self, o):
        return self._expr() + o

    def __radd__(self, o):
        return self._expr() + o

    def __sub__(self, o):
        return self._expr() - o

    def __rsub__(self, o):
        return (-self._expr()) + o

    def __neg__(self):
        return -self._expr()

    def __mul__(self, o):
        return self._expr() * o

    def __rmul__(self, o):
        return self._expr().__rmul__(o)

    def __truediv__(self, o):
        return self._expr() / o

    def __pos__(self):
        return self._expr()

    def __matmul__(self, o):
        raise TypeError("variable cannot left-multiply")

    def __rmatmul__(self, o):
        return self._expr().__rmul__(o)

    def __abs__(self):
        return abs(self._expr())

    def __getitem__(self, k):
        return self._expr()[k]

    def __le__(self, o):
        return self._expr() <= o

    def __ge__(self, o):
        return self._expr() >= o

    def __eq__(self, o):
        return self._expr() == o

    # strict comparisons are constraint aliases, as in the reference
    # (modeling.py:654-659: __lt__ == __le__, __gt__ == __ge__)
    __lt__ = __le__
    __gt__ = __ge__

    def __hash__(self):
        return id(self)


class MaxTerm:
    """Elementwise max over affine pieces; `reduced` means the term
    contributes sum_i max_k pieces[k][i] (a scalar)."""

    def __init__(self, pieces: List["Expr"], size: int,
                 reduced: bool = False):
        self.pieces = pieces        # affine Exprs, each length size or 1
        self.size = size
        self.reduced = reduced


def _const_expr(v, size=None) -> "Expr":
    a = np.atleast_1d(np.asarray(v, dtype=float)).reshape(-1)
    if size is not None and a.size == 1 and size != 1:
        a = np.full(size, a[0])
    return Expr({}, a)


def _to_expr(o, size=None) -> "Expr":
    if isinstance(o, Expr):
        return o
    if isinstance(o, variable):
        return o._expr()
    return _const_expr(o, size)


class Expr:
    """Affine + signed max-terms expression."""

    __array_ufunc__ = None
    __array_priority__ = 100

    def __init__(self, coeffs: Dict[variable, np.ndarray],
                 const: np.ndarray, terms=None):
        self.coeffs = {v: np.atleast_2d(np.asarray(c, dtype=float))
                       for v, c in coeffs.items()}
        self.const = np.atleast_1d(np.asarray(const, dtype=float)
                                   ).reshape(-1)
        self.terms = list(terms or [])   # list of (sign, MaxTerm)

    # ---- properties ------------------------------------------------

    def __len__(self):
        n = self.const.shape[0]
        for sgn, t in self.terms:
            if not t.reduced:
                n = _builtin_max(n, t.size)
        return n

    @property
    def is_affine(self):
        return not self.terms

    @property
    def is_convex(self):
        return all(s > 0 for s, _ in self.terms)

    @property
    def is_concave(self):
        return all(s < 0 for s, _ in self.terms)

    def value(self):
        """Evaluate at the variables' current values
        (modeling.py _function.value)."""
        m = len(self)
        out = np.zeros(m) + _bcast(self.const, m)
        for v, C in self.coeffs.items():
            if v.value is None:
                return None
            out = out + C @ np.asarray(v.value).reshape(-1)
        for sgn, t in self.terms:
            pv = [_bcast(p.value(), t.size) for p in t.pieces]
            mx = np.max(np.stack(pv), axis=0)
            out = out + sgn * (np.sum(mx) if t.reduced
                               else _bcast(mx, m))
        return out

    # ---- arithmetic ------------------------------------------------

    def _combine(self, other: "Expr", sign: float) -> "Expr":
        m = _builtin_max(len(self), len(other))
        coeffs = {}
        for v, C in self.coeffs.items():
            coeffs[v] = _bcast_rows(C, m).copy()
        for v, C in other.coeffs.items():
            C2 = sign * _bcast_rows(C, m)
            coeffs[v] = coeffs.get(v, 0.0) + C2
        const = _bcast(self.const, m) + sign * _bcast(other.const, m)
        terms = list(self.terms) + [(sign * s, t)
                                    for s, t in other.terms]
        return Expr(coeffs, const, terms)

    def __add__(self, o):
        return self._combine(_to_expr(o, len(self)), 1.0)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._combine(_to_expr(o, len(self)), -1.0)

    def __rsub__(self, o):
        return _to_expr(o, len(self))._combine(self, -1.0)

    def __neg__(self):
        return Expr({v: -C for v, C in self.coeffs.items()},
                    -self.const, [(-s, t) for s, t in self.terms])

    def _scale(self, a: float) -> "Expr":
        a = float(a)
        if a >= 0:
            terms = [(s * a, t) for s, t in self.terms]
        else:
            terms = [(s * a, t) for s, t in self.terms]
        return Expr({v: a * C for v, C in self.coeffs.items()},
                    a * self.const, terms)

    def __mul__(self, o):
        if np.isscalar(o) or (isinstance(o, np.ndarray) and o.size == 1):
            return self._scale(float(np.asarray(o).reshape(())))
        raise TypeError("only scalar right-multiplication is supported")

    def __pos__(self):
        return self

    def __truediv__(self, o):
        """Division by a nonzero scalar constant (reference
        modeling.py:576-633); dividing BY an expression is a
        TypeError there too."""
        if isinstance(o, (Expr, variable)):
            raise TypeError("division by an expression is not "
                            "supported")
        a = np.asarray(o, dtype=float)
        if a.size == 1:
            return self._scale(1.0 / float(a.reshape(())))
        raise TypeError("only scalar division is supported")

    def __rtruediv__(self, o):
        raise TypeError("division by an expression is not supported")

    def __rmul__(self, o):
        o = np.asarray(o, dtype=float)
        if o.ndim == 0 or o.size == 1:
            return self._scale(float(o.reshape(())))
        if not self.is_affine:
            raise TypeError("matrix * PWL expression is not supported")
        if o.ndim == 1:
            o = o.reshape(1, -1)
        coeffs = {v: o @ C for v, C in self.coeffs.items()}
        return Expr(coeffs, o @ self.const)

    def __rmatmul__(self, o):
        return self.__rmul__(o)

    def __abs__(self):
        if not self.is_affine:
            raise TypeError("abs() of a non-affine expression")
        t = MaxTerm([self, -self], len(self))
        return Expr({}, np.zeros(1), [(1.0, t)])

    def __getitem__(self, k):
        if not self.is_affine:
            raise TypeError("indexing a non-affine expression")
        m = len(self)
        idx = np.arange(m)[k]
        idx = np.atleast_1d(idx)
        coeffs = {v: _bcast_rows(C, m)[idx] for v, C in
                  self.coeffs.items()}
        return Expr(coeffs, _bcast(self.const, m)[idx])

    # ---- comparisons -> constraints --------------------------------

    def __le__(self, o):
        return constraint(self - _to_expr(o, len(self)), "<")

    def __ge__(self, o):
        return constraint(_to_expr(o, len(self)) - self, "<")

    def __eq__(self, o):
        return constraint(self - _to_expr(o, len(self)), "=")

    # strict comparisons alias the non-strict ones (reference
    # modeling.py:654-659)
    __lt__ = __le__
    __gt__ = __ge__

    def __hash__(self):
        return id(self)

    def __repr__(self):
        kind = ("affine" if self.is_affine else
                "convex" if self.is_convex else
                "concave" if self.is_concave else "general")
        return f"<{kind} expression of length {len(self)}>"

    __str__ = __repr__


def _host(v):
    """A solver result (tensor on any device, or numpy) as numpy."""
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _bcast(a, m):
    a = np.atleast_1d(np.asarray(a, dtype=float)).reshape(-1)
    if a.shape[0] == m:
        return a
    if a.shape[0] == 1:
        return np.full(m, a[0])
    raise ValueError(f"length mismatch {a.shape[0]} vs {m}")


def _bcast_rows(C, m):
    C = np.atleast_2d(C)
    if C.shape[0] == m:
        return C
    if C.shape[0] == 1:
        return np.repeat(C, m, axis=0)
    raise ValueError("row mismatch")


# ---- free functions (modeling.py:963, 1617, 1656, 3068) --------------


def sum(e, *rest):
    if rest or not isinstance(e, (Expr, variable)):
        return _builtin_sum([e, *rest]) if rest else _builtin_sum(e)
    e = _to_expr(e)
    m = len(e)
    ones = np.ones((1, m))
    aff = Expr({v: ones @ _bcast_rows(C, m)
                for v, C in e.coeffs.items()},
               ones @ _bcast(e.const, m))
    terms = []
    for s, t in e.terms:
        if t.reduced:
            terms.append((s, t))
        else:
            terms.append((s, MaxTerm(t.pieces, t.size, reduced=True)))
    aff.terms = terms
    return aff


def _affine_pieces(e: Expr) -> List[Expr]:
    """Flatten a convex PWL expression into affine pieces whose
    elementwise max equals e.  Supports affine exprs and
    affine + positive_scale * single max-term (a max of maxes
    distributes the affine part into every piece)."""
    if e.is_affine:
        return [e]
    if len(e.terms) == 1:
        s, t = e.terms[0]
        if s > 0 and not t.reduced:
            aff = Expr(e.coeffs, e.const)
            return [aff + p._scale(s) for p in t.pieces]
    raise TypeError("this expression cannot be used inside max()")


def max(*args):
    """max of affine/PWL expressions: one argument -> max over its
    entries; several arguments -> elementwise max (modeling.py:1617)."""
    if not any(isinstance(a, (Expr, variable)) for a in args):
        return _builtin_max(*args)
    exprs = [_to_expr(a) for a in args]
    if len(exprs) == 1:
        pieces, _ = _scalar_pieces(exprs[0])
        t = MaxTerm(pieces, 1)
        return Expr({}, np.zeros(1), [(1.0, t)])
    m = _builtin_max(len(e) for e in exprs)
    pieces = []
    for e in exprs:
        pieces.extend(_affine_pieces(e))
    t = MaxTerm(pieces, m)
    return Expr({}, np.zeros(1), [(1.0, t)])


def min(*args):
    if not any(isinstance(a, (Expr, variable)) for a in args):
        return _builtin_min(*args)
    return -max(*[-_to_expr(a) for a in args])


def dot(u, v):
    """Inner product (modeling.py:3068)."""
    if isinstance(u, (Expr, variable)) and not isinstance(
            v, (Expr, variable)):
        u, v = v, u
    u = np.asarray(u, dtype=float).reshape(-1)
    return u.reshape(1, -1) @ _to_expr(v)


def _scalar_pieces(e: Expr):
    """Flatten an expression into scalar affine pieces whose max equals
    max over the entries of e."""
    out = []
    for p in _affine_pieces(e):
        mp = len(p)
        if mp == 1:
            out.append(p)
        else:
            out.extend(p[i] for i in range(mp))
    return out, len(e)


# ---- constraints and problems ---------------------------------------


class constraint:
    """f <= 0 ('<') or f == 0 ('=') (modeling.py:1833)."""

    def __init__(self, lhs: Expr, ctype: str, name: str = ""):
        if ctype == "=" and not lhs.is_affine:
            raise TypeError("equality constraints must be affine")
        if ctype == "<" and not lhs.is_convex:
            raise TypeError("inequality lhs-rhs must be convex")
        self.lhs = lhs
        self.type = ctype
        self.name = name
        self.multiplier = variable(_builtin_max(len(lhs), 1),
                                   f"mul_{name}")

    def __len__(self):
        return len(self.lhs)

    def __repr__(self):
        op_ = "<=" if self.type == "<" else "=="
        return f"<constraint of length {len(self)} ({op_})>"

    __str__ = __repr__


class op:
    """Optimization problem (modeling.py:2093): minimize a convex PWL
    objective subject to PWL inequality / affine equality constraints."""

    def __init__(self, objective=0.0, constraints=None, name=""):
        if isinstance(constraints, constraint):
            constraints = [constraints]
        self.objective = _to_expr(objective)
        if len(self.objective) != 1:
            raise TypeError("objective must be scalar")
        if not self.objective.is_convex:
            raise TypeError("objective must be convex (PWL)")
        self.constraints = list(constraints or [])
        self.name = name
        self.status = None

    def variables(self):
        vs = []
        seen = set()

        def visit(e):
            for v in e.coeffs:
                if id(v) not in seen:
                    seen.add(id(v))
                    vs.append(v)
            for _, t in e.terms:
                for p in t.pieces:
                    visit(p)

        visit(self.objective)
        for c in self.constraints:
            visit(c.lhs)
        return vs

    def addconstraint(self, c: constraint):
        self.constraints.append(c)

    # ---- LP transform (op._inmatrixform analogue) ------------------

    def _tolp(self):
        vs = self.variables()
        offs, n = {}, 0
        for v in vs:
            offs[v] = n
            n += len(v)

        aux = []          # (offset, size) per max-term occurrence
        aux_specs = []    # (term, offset)

        def scan_terms(e):
            nonlocal n
            out = []
            for s, t in e.terms:
                aux_specs.append((t, n))
                out.append((s, t, n))
                aux.append((n, t.size))
                n += t.size
                for p in t.pieces:
                    for v in p.coeffs:
                        if v not in offs:
                            offs[v] = n
                            n += len(v)
            return out

        obj_terms = scan_terms(self.objective)
        con_terms = [scan_terms(c.lhs) for c in self.constraints]
        for c in self.constraints:
            for v in c.lhs.coeffs:
                if v not in offs:
                    offs[v] = n
                    n += len(v)
        for v in self.objective.coeffs:
            if v not in offs:
                offs[v] = n
                n += len(v)

        def aff_rows(e: Expr, m):
            M = np.zeros((m, n))
            for v, C in e.coeffs.items():
                C = _bcast_rows(C, m)
                M[:, offs[v]:offs[v] + len(v)] += C
            return M, _bcast(e.const, m)

        Grows, hvals = [], []
        Arows, bvals = [], []

        # objective: c'x
        cvec = np.zeros(n)
        Mo, co = aff_rows(Expr(self.objective.coeffs,
                               self.objective.const), 1)
        cvec += Mo[0]
        obj_const = co[0]
        for s, t, off in obj_terms:
            if s <= 0:
                raise TypeError("objective must be convex")
            if t.reduced:
                cvec[off:off + t.size] += s
            else:
                if t.size != 1:
                    raise TypeError("vector max in scalar objective")
                cvec[off] += s

        # epigraph constraints for every max-term: pieces - t <= 0
        def add_epigraph(t: MaxTerm, off):
            for p in t.pieces:
                M, cst = aff_rows(p, t.size)
                M[np.arange(t.size), off + np.arange(t.size)] -= 1.0
                Grows.append(M)
                hvals.append(-cst)

        for t, off in aux_specs:
            add_epigraph(t, off)

        # constraints
        con_rows = []
        for c, terms in zip(self.constraints, con_terms):
            m = len(c)
            M, cst = aff_rows(Expr(c.lhs.coeffs, c.lhs.const), m)
            for s, t, off in terms:
                if t.reduced:
                    M[:, off:off + t.size] += s
                else:
                    tsz = t.size
                    if tsz == m:
                        M[np.arange(m), off + np.arange(m)] += s
                    elif tsz == 1:
                        M[:, off] += s
                    else:
                        raise TypeError("term size mismatch")
            if c.type == "<":
                con_rows.append(("G", _builtin_sum(
                    gr.shape[0] for gr in Grows), m))
                Grows.append(M)
                hvals.append(-cst)
            else:
                con_rows.append(("A", _builtin_sum(
                    ar.shape[0] for ar in Arows), m))
                Arows.append(M)
                bvals.append(-cst)

        G = np.concatenate(Grows) if Grows else np.zeros((0, n))
        h = (np.concatenate(hvals) if hvals else np.zeros(0))
        A = np.concatenate(Arows) if Arows else None
        b = (np.concatenate(bvals) if bvals else None)
        return cvec, obj_const, G, h, A, b, offs, con_rows

    def solve(self, format="dense", solver=None, options=None,
              device="cuda"):
        """Transform to an LP and solve it with the port's `solvers.lp`
        on `device` (modeling.py:2579-2636)."""
        from cvxopt_tpu_torch.solvers import lp as lp_solver
        cvec, obj_const, G, h, A, b, offs, con_rows = self._tolp()
        sol = lp_solver(cvec, G, h, A=A, b=b, solver=solver,
                        options=options, device=device)
        self.status = sol["status"]
        if sol["status"] == "optimal":
            x = _host(sol["x"])
            z = _host(sol["z"])
            y = _host(sol["y"]) if sol["y"] is not None else None
            for v, off in offs.items():
                if isinstance(v, variable):
                    v.value = x[off:off + len(v)]
            for c, (kind, off, m) in zip(self.constraints, con_rows):
                src = z if kind == "G" else y
                if src is not None:
                    c.multiplier.value = src[off:off + m]
        return sol

    def tofile(self, path):
        """Write the problem in MPS format (modeling.py:2640)."""
        from cvxopt_tpu_torch import mpsio
        cvec, obj_const, G, h, A, b, offs, con_rows = self._tolp()
        n = cvec.shape[0]
        rows = []
        rlo, rhi = [], []
        if G.shape[0]:
            rows.append(G)
            rlo.append(np.full(G.shape[0], -mpsio.INF))
            rhi.append(h)
        if A is not None and A.shape[0]:
            rows.append(A)
            rlo.append(b)
            rhi.append(b)
        Ar = np.concatenate(rows) if rows else np.zeros((0, n))
        data = mpsio.MPSData(
            name=self.name or "OP", var_names=[f"X{i}" for i in
                                               range(n)],
            row_names=[f"R{i}" for i in range(Ar.shape[0])],
            obj_name="OBJ", c=cvec, objconst=float(obj_const),
            Arows=Ar,
            rlo=(np.concatenate(rlo) if rlo else np.zeros(0)),
            rhi=(np.concatenate(rhi) if rhi else np.zeros(0)),
            lo=np.full(n, -mpsio.INF), hi=np.full(n, mpsio.INF))
        mpsio.mps_write(path, data)

    def fromfile(self, path):
        """Load an LP from an MPS file (modeling.py:2760) as real
        modeling objects — one vector variable plus matrix
        constraints — so `objective.value()` and `variable.value`
        work after `solve()` the same way as for hand-built problems.
        OBJSENSE MAX files arrive already negated into minimize form
        (mpsio.mps_load)."""
        from cvxopt_tpu_torch import mpsio
        d = mpsio.mps_load(path)
        c, G, h, A, b = d.to_lp()
        n = c.shape[0]
        x = variable(n, "x")
        obj = dot(np.asarray(c, dtype=float), x)
        if d.objconst:
            obj = obj + float(d.objconst)
        self.objective = _to_expr(obj)
        self.constraints = []
        if G.shape[0]:
            self.constraints.append(
                np.asarray(G, dtype=float) @ x <= np.asarray(
                    h, dtype=float))
        if A is not None and A.shape[0]:
            self.constraints.append(
                np.asarray(A, dtype=float) @ x == np.asarray(
                    b, dtype=float))
        if d.name and not self.name:
            self.name = d.name
        return self

    def __repr__(self):
        return f"<op: {len(self.constraints)} constraints, " \
            f"{len(self.variables())} variables>"

    __str__ = __repr__

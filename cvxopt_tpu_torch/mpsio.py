"""MPS file I/O for linear programs.

Twin of `cvxopt_tpu/mpsio.py` (host code, numpy only, no device): reads
fixed/free-format MPS (ROWS, COLUMNS, RHS, RANGES, BOUNDS, OBJSENSE)
into a plain `MPSData` of numpy arrays, which `to_lp()` converts to the
(c, G, h, A, b) form that `solvers.lp` takes, and writes LPs back out
(the reference's op.fromfile / op.tofile, modeling.py:2760 / :2640):

    minimize c'x + objconst
    s.t. row activities  a_i'x  in  [rlo_i, rhi_i]
         variable bounds        x  in  [lo, hi]

RANGES semantics (standard MPS):
    L row, range R:  rhs - |R| <= a'x <= rhs
    G row, range R:  rhs <= a'x <= rhs + |R|
    E row, range R>0: rhs <= a'x <= rhs+R;  R<0: rhs+R <= a'x <= rhs
BOUNDS: LO/UP/FX/FR/MI/PL supported (default bounds [0, +inf)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

INF = float("inf")


@dataclass
class MPSData:
    name: str
    var_names: List[str]
    row_names: List[str]             # constraint rows (objective excluded)
    obj_name: str
    c: np.ndarray                    # (n,)
    objconst: float
    Arows: np.ndarray                # (nrows, n) dense constraint matrix
    rlo: np.ndarray                  # (nrows,) row lower limits
    rhi: np.ndarray                  # (nrows,) row upper limits
    lo: np.ndarray                   # (n,) variable lower bounds
    hi: np.ndarray                   # (n,) variable upper bounds
    integer: List[str] = field(default_factory=list)
    maximize: bool = False           # OBJSENSE MAX: c/objconst are
    #                                  already negated to minimize form

    def to_lp(self):
        """Convert to conelp form: returns (c, G, h, A, b).

        Equality rows and fixed variables go to (A, b); finite
        inequality sides and bounds become rows of (G, h)."""
        n = len(self.var_names)
        Grows, hvals = [], []
        Aeq, bvals = [], []
        for i in range(self.Arows.shape[0]):
            a = self.Arows[i]
            lo, hi = self.rlo[i], self.rhi[i]
            if lo == hi:
                Aeq.append(a)
                bvals.append(lo)
                continue
            if hi < INF:
                Grows.append(a)
                hvals.append(hi)
            if lo > -INF:
                Grows.append(-a)
                hvals.append(-lo)
        for j in range(n):
            ej = np.zeros(n)
            ej[j] = 1.0
            if self.lo[j] == self.hi[j]:
                Aeq.append(ej)
                bvals.append(self.lo[j])
                continue
            if self.hi[j] < INF:
                Grows.append(ej)
                hvals.append(self.hi[j])
            if self.lo[j] > -INF:
                Grows.append(-ej)
                hvals.append(-self.lo[j])
        G = np.array(Grows) if Grows else np.zeros((0, n))
        h = np.array(hvals)
        A = np.array(Aeq) if Aeq else None
        b = np.array(bvals) if Aeq else None
        return self.c, G, h, A, b


def mps_load(path_or_file) -> MPSData:
    """Parse an MPS file (reference: modeling.op.fromfile,
    modeling.py:2760)."""
    if hasattr(path_or_file, "read"):
        lines = path_or_file.read().splitlines()
    else:
        with open(path_or_file) as f:
            lines = f.read().splitlines()

    name = ""
    section = None
    row_types: Dict[str, str] = {}
    row_order: List[str] = []
    obj_name: Optional[str] = None
    cols: Dict[str, Dict[str, float]] = {}
    var_order: List[str] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds_lo: Dict[str, float] = {}
    bounds_hi: Dict[str, float] = {}
    integer_vars: List[str] = []
    in_integer = False
    maximize = False

    for raw in lines:
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if raw[0] not in " \t":
            parts = raw.split()
            kw = parts[0].upper()
            if kw == "NAME":
                name = parts[1] if len(parts) > 1 else ""
                continue
            if kw in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                      "ENDATA", "OBJSENSE"):
                section = kw
                # free-format one-line form: "OBJSENSE MAX"
                if kw == "OBJSENSE" and len(parts) > 1:
                    maximize = parts[1].upper().startswith("MAX")
                continue
            raise ValueError(f"unknown MPS section: {kw}")

        parts = raw.split()
        if section == "OBJSENSE":
            maximize = parts[0].upper().startswith("MAX")
        elif section == "ROWS":
            rtype, rname = parts[0].upper(), parts[1]
            if rtype == "N":
                if obj_name is None:
                    obj_name = rname
                continue
            row_types[rname] = rtype
            row_order.append(rname)
        elif section == "COLUMNS":
            if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                marker = parts[2].upper().strip("'")
                in_integer = marker == "INTORG"
                continue
            vname = parts[0]
            if vname not in cols:
                cols[vname] = {}
                var_order.append(vname)
                if in_integer:
                    integer_vars.append(vname)
            for k in range(1, len(parts) - 1, 2):
                cols[vname][parts[k]] = float(parts[k + 1])
        elif section == "RHS":
            for k in range(1, len(parts) - 1, 2):
                rhs[parts[k]] = float(parts[k + 1])
        elif section == "RANGES":
            for k in range(1, len(parts) - 1, 2):
                ranges[parts[k]] = float(parts[k + 1])
        elif section == "BOUNDS":
            btype = parts[0].upper()
            vname = parts[2]
            val = float(parts[3]) if len(parts) > 3 else 0.0
            if btype == "LO":
                bounds_lo[vname] = val
            elif btype == "UP":
                bounds_hi[vname] = val
            elif btype == "FX":
                bounds_lo[vname] = val
                bounds_hi[vname] = val
            elif btype == "FR":
                bounds_lo[vname] = -INF
                bounds_hi.setdefault(vname, INF)
            elif btype == "MI":
                bounds_lo[vname] = -INF
            elif btype == "PL":
                bounds_hi[vname] = INF
            elif btype in ("BV", "UI", "LI"):
                integer_vars.append(vname)
                if btype == "BV":
                    bounds_lo[vname] = 0.0
                    bounds_hi[vname] = 1.0
            else:
                raise ValueError(f"unknown bound type {btype}")

    if obj_name is None:
        raise ValueError("MPS file has no objective (N) row")

    n = len(var_order)
    nrows = len(row_order)
    ridx = {r: i for i, r in enumerate(row_order)}
    c = np.zeros(n)
    A = np.zeros((nrows, n))
    for j, v in enumerate(var_order):
        for rname, val in cols[v].items():
            if rname == obj_name:
                c[j] = val
            elif rname in ridx:
                A[ridx[rname], j] = val
    objconst = -rhs.get(obj_name, 0.0)
    if maximize:
        # normalize to minimize form; `maximize` records the flip so
        # callers can report -objective
        c = -c
        objconst = -objconst

    rlo = np.full(nrows, -INF)
    rhi = np.full(nrows, INF)
    for i, r in enumerate(row_order):
        rv = rhs.get(r, 0.0)
        t = row_types[r]
        if t == "L":
            rhi[i] = rv
        elif t == "G":
            rlo[i] = rv
        else:                         # E
            rlo[i] = rhi[i] = rv
        if r in ranges:
            rng = ranges[r]
            if t == "L":
                rlo[i] = rv - abs(rng)
            elif t == "G":
                rhi[i] = rv + abs(rng)
            else:
                if rng >= 0:
                    rhi[i] = rv + rng
                else:
                    rlo[i] = rv + rng

    lo = np.zeros(n)
    hi = np.full(n, INF)
    for j, v in enumerate(var_order):
        if v in bounds_lo:
            lo[j] = bounds_lo[v]
        if v in bounds_hi:
            hi[j] = bounds_hi[v]

    return MPSData(name=name, var_names=var_order, row_names=row_order,
                   obj_name=obj_name, c=c, objconst=objconst, Arows=A,
                   rlo=rlo, rhi=rhi, lo=lo, hi=hi,
                   integer=integer_vars, maximize=maximize)


def mps_write(path_or_file, data: MPSData):
    """Write MPS (reference: modeling.op.tofile, modeling.py:2640)."""
    out = []
    out.append(f"NAME          {data.name}")
    out.append("ROWS")
    out.append(f" N  {data.obj_name}")
    for i, r in enumerate(data.row_names):
        lo, hi = data.rlo[i], data.rhi[i]
        if lo == hi:
            t = "E"
        elif hi < INF and lo > -INF:
            t = "L"                   # range written in RANGES
        elif hi < INF:
            t = "L"
        else:
            t = "G"
        out.append(f" {t}  {r}")
    out.append("COLUMNS")
    for j, v in enumerate(data.var_names):
        if data.c[j] != 0.0:
            out.append(f"    {v:<10}{data.obj_name:<10}{data.c[j]:< .12g}")
        for i, r in enumerate(data.row_names):
            a = data.Arows[i, j]
            if a != 0.0:
                out.append(f"    {v:<10}{r:<10}{a:< .12g}")
    out.append("RHS")
    for i, r in enumerate(data.row_names):
        lo, hi = data.rlo[i], data.rhi[i]
        rv = hi if hi < INF else lo
        if rv not in (-INF, INF) and rv != 0.0:
            out.append(f"    RHS       {r:<10}{rv:< .12g}")
    if data.objconst:
        out.append(f"    RHS       {data.obj_name:<10}{-data.objconst:< .12g}")
    ranges_lines = []
    for i, r in enumerate(data.row_names):
        lo, hi = data.rlo[i], data.rhi[i]
        if lo != hi and hi < INF and lo > -INF:
            ranges_lines.append(f"    RNG       {r:<10}{hi - lo:< .12g}")
    if ranges_lines:
        out.append("RANGES")
        out.extend(ranges_lines)
    bl = []
    for j, v in enumerate(data.var_names):
        lo, hi = data.lo[j], data.hi[j]
        if lo == hi:
            bl.append(f" FX BND       {v:<10}{lo:< .12g}")
            continue
        if lo == -INF:
            bl.append(f" MI BND       {v:<10}")
        elif lo != 0.0:
            bl.append(f" LO BND       {v:<10}{lo:< .12g}")
        if hi < INF:
            bl.append(f" UP BND       {v:<10}{hi:< .12g}")
    if bl:
        out.append("BOUNDS")
        out.extend(bl)
    out.append("ENDATA")
    text = "\n".join(out) + "\n"
    if hasattr(path_or_file, "write"):
        path_or_file.write(text)
    else:
        with open(path_or_file, "w") as f:
            f.write(text)


def lp_from_mps(path) -> Tuple:
    """Convenience: parse and convert to (c, G, h, A, b, objconst)."""
    data = mps_load(path)
    c, G, h, A, b = data.to_lp()
    return c, G, h, A, b, data.objconst

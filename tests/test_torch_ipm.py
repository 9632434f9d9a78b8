"""The IPM-loop layer (`cvxopt_tpu_torch/ipm.py`) under the cone solvers.

  - The layers import one way: no module of the port takes a private
    name, or a name `conelp` only imports, from `conelp`, and `coneqp`
    imports nothing from it.
  - The two cascades run in one `ipm.cascade`: on the CPU at n = 64, B = 8
    their profiles have the same keys, and each opens the `cvx.*`
    spans it is pinned to here.

The cone-layer helpers the two solvers share are tested beside the cone
algebra: `cones.push_interior` in test_torch_cones.py, `scaling.unscale`
and `scaling.update_args` in test_torch_scaling.py.

This file imports no jax.
"""

from __future__ import annotations

import ast
import collections
import os

import pytest
import torch

from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.conelp import make_conelp_cascade
from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
from test_torch_trace import N, TOLS, box_data, spans, traced

torch.set_num_threads(1)

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cvxopt_tpu_torch")
CONELP = "cvxopt_tpu_torch.conelp"


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _module_name(path):
    rel = os.path.relpath(path, os.path.dirname(PKG))[:-3]
    return rel.replace(os.sep, ".").removesuffix(".__init__")


def _conelp_uses(path):
    """The names `path` takes from conelp: ``from ..conelp import x``
    gives x, ``from cvxopt_tpu_torch import conelp`` (or ``import
    cvxopt_tpu_torch.conelp``) gives each attribute read off it, and a
    bare module import of conelp gives '*'."""
    tree = ast.parse(open(path).read())
    pkg = _module_name(path).rsplit(".", 1)[0]
    aliases, names = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0]
                mod = f"{base}.{mod}" if mod else base
            if mod == CONELP:
                names += [a.name for a in node.names]
            elif mod == "cvxopt_tpu_torch":
                for a in node.names:
                    if a.name == "conelp":
                        aliases.add(a.asname or "conelp")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == CONELP:
                    if a.asname:
                        aliases.add(a.asname)
                    else:
                        names.append("*")
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            names.append(node.attr)
        elif isinstance(node, ast.Name) and node.id in aliases:
            names.append("*")
    return names


def _defined_in(path):
    """The top-level names a module defines itself (not imports)."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def test_no_module_takes_conelps_internals():
    own = _defined_in(os.path.join(PKG, "conelp.py"))
    bad = []
    for path in _sources():
        rel = os.path.relpath(path, PKG)
        if rel == "conelp.py":
            continue
        for name in _conelp_uses(path):
            if name.startswith("_") or (name != "*" and name not in own):
                bad.append((rel, name))
    assert not bad, bad


def test_coneqp_imports_nothing_from_conelp():
    assert _conelp_uses(os.path.join(PKG, "coneqp.py")) == []


def test_the_layer_lives_in_ipm():
    moved = ("STATUS_STRINGS", "STEP", "EXPON", "RESCUE_STALL_ITERS",
             "RESCUE_RELRES", "_running", "_run_loop", "_restart_state",
             "rescue_compacted", "cascade", "_tensors", "_unbatch",
             "_lp_maps", "_start_values", "_prep_inputs")
    own = _defined_in(os.path.join(PKG, "ipm.py"))
    assert set(moved) <= own
    assert not own & _defined_in(os.path.join(PKG, "conelp.py"))
    assert not own & _defined_in(os.path.join(PKG, "coneqp.py"))


# The `cvx.*` spans of one traced call of each cascade on `box_data(3)`
# (every instance finishes in phase A and B; phase C reads the status
# once and solves nothing).
SPANS = {
    "coneqp": {"cvx.cascade.solve": 1, "cvx.cascade.a": 1,
               "cvx.cascade.b": 1, "cvx.cascade.c": 1,
               "cvx.cascade.sync": 1, "cvx.ipm.start": 2,
               "cvx.ipm.pass": 10, "cvx.ipm.sync": 13,
               "cvx.kkt.factor": 11, "cvx.kkt.solve": 24},
    "conelp": {"cvx.cascade.solve": 1, "cvx.cascade.a": 1,
               "cvx.cascade.b": 1, "cvx.cascade.c": 1,
               "cvx.cascade.sync": 1, "cvx.ipm.start": 2,
               "cvx.ipm.pass": 10, "cvx.ipm.sync": 12,
               "cvx.kkt.factor": 12, "cvx.kkt.solve": 40},
}


def _cascade(kind):
    P, q, G, h, A, b = box_data(seed=3)
    if kind == "coneqp":
        solve = make_coneqp_cascade(ConeDims(l=2 * N), kktsolver="chol2_inv",
                                    instrument=True, device="cpu", **TOLS)
        return solve, (P, q, G, h, A, b)
    solve = make_conelp_cascade(ConeDims(l=2 * N), instrument=True,
                                device="cpu", **TOLS)
    return solve, (q, G, h, A, b)


def test_cascade_profiles_have_the_same_keys():
    keys = []
    for kind in ("coneqp", "conelp"):
        solve, args = _cascade(kind)
        out = solve(*args)
        assert (out["status"] == 0).all()
        keys.append(list(out["profile"]))
    assert keys[0] == keys[1]
    assert keys[0] == [
        "a_iters", "a_s", "a_host_syncs", "a_replays", "b_iters", "b_s",
        "b_host_syncs", "b_replays", "c_iters", "c_s", "c_instances",
        "c_host_syncs", "captures"]


@pytest.mark.parametrize("kind", ["coneqp", "conelp"])
def test_cascade_span_counts(kind, tmp_path):
    solve, args = _cascade(kind)
    solve(*args)
    out, events = traced(lambda: solve(*args), tmp_path)
    assert (out["status"] == 0).all()
    names = collections.Counter(name for _, _, name in spans(events))
    assert dict(names) == SPANS[kind]
    prof = out["profile"]
    # neither cascade tapes on the CPU
    assert prof["a_replays"] == prof["b_replays"] == prof["captures"] == 0
    assert prof["a_host_syncs"] + prof["b_host_syncs"] + \
        prof["c_host_syncs"] == sum(v for k, v in names.items()
                                    if k.endswith(".sync"))

"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program.  Each check runs in a
fresh interpreter, so that what this test process imported does not
count; top-level names are compared whole."""

from __future__ import annotations

import json
import subprocess
import sys

from .conftest import ROOT, TINY

DRY = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
for cell, ov in {tiny!r}.items():
    for trace in (0, 1):
        r = harness.run_cell(cell, 5, 0.3, trace, device="cpu",
                             t_start=time.time(), overrides=ov)
        assert r is not None and r["correct"], (cell, trace, r)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.npref, benchmark.reference.qp_torch
import benchmark.reference.qp_check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_dry_run_loads_no_jax():
    names = loaded(DRY.format(root=ROOT, tiny=TINY))
    assert "cvxopt_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "cvxopt_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded(REF.format(root=ROOT))
    assert "numpy" in names and "torch" in names
    assert not names & {"cvxopt_tpu_torch", "cvxopt_tpu", "jax", "jaxlib"}


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "cvxopt_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert "cvxopt_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.banned_modules()

"""The IPM tapes (`cvxopt_tpu_torch.ipm_graph`): when one engages, the
wrappers' ``out=``, and a taped solver against an eager one.

On the CPU a tape cannot capture graphs.  `ClosureTape` stands in for
one there: it records by keeping the pass's closure and replays by
calling it on the tape's static state, so that a value the solver does
not pin is read from the recording call, as a graph reads it from the
recording call's address.  The tests marked `gpu` record real CUDA
graphs at the benchmark's scenario shapes (n = 256, m = 512, p = 1);
they skip without a card.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_ipm_graph.py
"""

import numpy as np
import pytest
import torch

from cvxopt_tpu_torch import ipm_graph
from cvxopt_tpu_torch import kkt as tk
from cvxopt_tpu_torch._tree import _leaves
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import coneqp, make_coneqp, make_coneqp_cascade
from cvxopt_tpu_torch.ops import fused_chol as fc

torch.set_num_threads(1)

TOLS = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
RESULT_KEYS = ("x", "y", "s", "z", "status", "iterations")


class ClosureTape(ipm_graph.Tape):
    """A tape for the CPU (see the module's docstring)."""

    def _record(self, step, more):
        self.parts = [(step, more)]
        ipm_graph.COUNTS["captures"] += 1

    def _replay(self):
        (step, more), = self.parts
        new = step(self.state)
        for dst, src in zip(_leaves(self.state), _leaves(new)):
            dst.copy_(src)
        self.more.copy_(more(self.state))
        ipm_graph.COUNTS["replays"] += 1


class ClosureTapes(ipm_graph.Tapes):
    def __init__(self, device):
        super().__init__(device)
        self.graphs = True


@pytest.fixture()
def closure_tapes(monkeypatch):
    """Solvers made inside the test engage ClosureTapes on the CPU."""
    monkeypatch.setattr(ipm_graph, "Tapes", ClosureTapes)
    monkeypatch.setattr(ipm_graph, "Tape", ClosureTape)


@pytest.fixture(autouse=True)
def _counts():
    ipm_graph.reset_counts()


def scenario(B, n, seed, device="cpu", upper=1.0):
    """bench.py's scenario QPs: P = F F' + 0.1 I, q ~ -U(0, 0.1), 0 <= x
    <= upper, sum x = 1; G, h, A, b shared (float64)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0, 0.1, (B, n))
    G = np.concatenate([-np.eye(n), np.eye(n)])
    h = np.concatenate([np.zeros(n), upper * np.ones(n)])
    kw = dict(dtype=torch.float64, device=device)
    return tuple(torch.as_tensor(u, **kw)
                 for u in (P, q, G, h, np.ones((1, n)), np.ones(1)))


def other_data(B, n, seed, device="cpu"):
    """Scenario QPs with another G, h and scale of q, so that the norms
    the solver scales its residuals by differ from `scenario`'s."""
    P, q, G, h, A, b = scenario(B, n, seed, device, upper=0.5)
    return P, 30.0 * q, 1.5 * G, 1.5 * h, A, b


def assert_same(out, ref):
    for k in RESULT_KEYS:
        assert torch.equal(out[k], ref[k]), k


def check_against_eager(make, calls, captures):
    """Call one solver from `make()` on each of `calls`, and a fresh
    (eager) solver beside each: equal results, host syncs and wrapper
    calls; `captures` captures on the second call, none on the others;
    from the second call on every pass replayed (a cascade's phase A and
    B passes)."""
    taped = make()
    for k, data in enumerate(calls):
        before = ipm_graph.counts()
        fc.reset_launch_counts()
        out = taped(*data)
        taped_launches = fc.launch_counts()
        got = {c: ipm_graph.counts()[c] - before[c] for c in before}
        fc.reset_launch_counts()
        ref = make()(*data)
        assert fc.launch_counts() == taped_launches
        assert_same(out, ref)
        assert out["host_syncs"] == ref["host_syncs"]
        assert got["captures"] == (captures if k == 1 else 0)
        prof = out.get("profile")
        if not k:
            assert got["replays"] == 0
        elif prof is None:
            assert got["replays"] == out["host_syncs"] - 1
        else:
            assert prof["a_replays"] == prof["a_host_syncs"] - 1
            assert prof["b_replays"] == prof["b_host_syncs"] - 1
            assert prof["captures"] == got["captures"]
            for c in ("a_host_syncs", "c_instances"):
                assert prof[c] == ref["profile"][c], c
        if k:
            assert got["eager_passes"] == 0


# ---- when a tape engages ----------------------------------------------

@pytest.mark.parametrize("device,capturable,engaged", [
    ("cuda", True, [False, True, True]),
    ("cuda", False, [False, False, False]),
    ("cpu", True, [False, False, False]),
])
def test_tape_engages_from_a_keys_second_call(device, capturable, engaged):
    """Only on CUDA, for a capturable pass, from the second call of a key
    on; the same tape comes back for the key; another phase or shape is
    a new key.  (No CUDA call is made: a tape allocates on first use.)"""
    tapes = ipm_graph.Tapes(device)
    x = torch.zeros(4, 3)
    got = [tapes.get("a", (x,), capturable) for _ in engaged]
    assert [t is not None for t in got] == engaged
    if engaged[-1]:
        assert got[1] is got[2]
        assert tapes.get("b", (x,), capturable) is None
        assert tapes.get("a", (torch.zeros(5, 3),), capturable) is None
        assert tapes.get("a", (x.double(),), capturable) is None


@pytest.mark.parametrize("name,dims,factor_dtype,expected", [
    ("chol2_inv", ConeDims(l=8), None, True),
    ("chol2", ConeDims(l=8), "float32", True),
    ("chol2", ConeDims(l=8), "adaptive", False),
    ("chol2", ConeDims(l=2, q=(3,)), None, False),
    ("chol2_inv", ConeDims(l=2, s=(2,)), None, False),
    ("chol", ConeDims(l=8), None, False),
    ("ldl", ConeDims(l=8), None, False),
    ("cholqr_inv", ConeDims(l=8), "float32", False),
])
def test_capturable_kktsolvers(name, dims, factor_dtype, expected):
    assert tk.capturable(name, dims, factor_dtype) is expected


def _three_calls(make, data):
    fn = make()
    return [fn(*data) for _ in range(3)]


@pytest.mark.parametrize("case", [
    "cpu", "one_shot", "show_progress", "debug", "ldl", "rescue", "q_cone",
])
def test_eager_where_no_tape_engages(case, request, capsys):
    """Each of these runs its passes eagerly although its calls repeat:
    the CPU device (without the stand-in tapes), a one-shot `coneqp`, a
    solver that prints, a kktsolver that is not capturable, the two-loop
    'rescue' mode and a cascade over a 'q' cone.  The results are those
    of the first, unrepeated call."""
    if case != "cpu":
        request.getfixturevalue("closure_tapes")
    P, q, G, h, A, b = scenario(3, 8, seed=1)
    dims = ConeDims(l=16)
    kw = dict(kktsolver="chol2", device="cpu", **TOLS)
    if case == "cpu":
        runs = _three_calls(lambda: make_coneqp_cascade(
            dims, kktsolver="chol2_inv", device="cpu", **TOLS),
            (P, q, G, h, A, b))
    elif case == "one_shot":
        runs = [coneqp(P[0], q[0], G, h, A=A, b=b, device="cpu",
                       options=dict(TOLS, show_progress=False))
                for _ in range(3)]
    elif case in ("show_progress", "debug"):
        runs = _three_calls(lambda: make_coneqp(dims, **{case: True}, **kw),
                            (P, q, G, h, A, b))
    elif case == "ldl":
        runs = _three_calls(lambda: make_coneqp(
            dims, **dict(kw, kktsolver="ldl")), (P, q, G, h, A, b))
    elif case == "rescue":
        runs = _three_calls(lambda: make_coneqp(
            dims, factor_dtype="rescue", **kw), (P, q, G, h, A, b))
    else:
        # ||(x0, x1)|| <= 2: a 'q' block that never binds
        Gq = torch.cat([G, torch.zeros(1, 8, dtype=G.dtype),
                        -torch.eye(8, dtype=G.dtype)[:2]])
        hq = torch.cat([h, torch.tensor([2.0, 0.0, 0.0], dtype=h.dtype)])
        runs = _three_calls(lambda: make_coneqp_cascade(
            ConeDims(l=16, q=(3,)), kktsolver="chol2_inv", device="cpu",
            **TOLS), (P, q, Gq, hq, A, b))
    capsys.readouterr()
    got = ipm_graph.counts()
    assert got["replays"] == 0 and got["captures"] == 0
    assert got["eager_passes"] > 0
    for r in runs[1:]:
        for k in ("x", "z") if case == "one_shot" else RESULT_KEYS:
            assert torch.equal(torch.as_tensor(r[k]),
                               torch.as_tensor(runs[0][k])), k


# ---- a taped solver against an eager one, on the CPU -------------------

def _maker(kind, n, device):
    """A solver factory: the cascade, `make_coneqp` with 'chol2' in
    float64 or with the float32 factor, or the cascade's phase C alone
    (the float64 rescue, which no instance of these data reaches)."""
    def make():
        if kind in ("cascade", "phase_c"):
            solve = make_coneqp_cascade(
                ConeDims(l=2 * n), kktsolver="chol2_inv", maxiters=50,
                instrument=True, device=device, **TOLS)
            return solve if kind == "cascade" else solve.phase_c
        return make_coneqp(ConeDims(l=2 * n), kktsolver="chol2",
                           factor_dtype="float32" if kind == "qp_f32"
                           else None, device=device, **TOLS)
    return make


@pytest.mark.parametrize("kind", ["cascade", "qp", "qp_f32", "phase_c"])
def test_closure_tape_matches_eager(kind, closure_tapes):
    """Calls 2-4 of one solver replay their passes from the stand-in
    tape; each equals a fresh (eager) solver's call exactly, including a
    call whose G, h and scale of q differ from the recording call's.
    Only call 2 records."""
    calls = [scenario(3, 16, seed=s) for s in (2, 3, 4)]
    calls.append(other_data(3, 16, seed=5))
    check_against_eager(_maker(kind, 16, "cpu"), calls,
                        2 if kind == "cascade" else 1)


def test_results_do_not_alias_the_tape(closure_tapes):
    """A later call writes the tape's static state: the results handed
    out before stay as they were."""
    solve = make_coneqp(ConeDims(l=32), kktsolver="chol2", device="cpu",
                        **TOLS)
    first, second, third = (scenario(2, 16, seed=s) for s in (6, 7, 8))
    solve(*first)
    out = solve(*second)
    kept = {k: out[k].clone() for k in RESULT_KEYS}
    solve(*third)
    assert_same(out, kept)


# ---- the wrappers' out= ------------------------------------------------

def _factor_args(batched, B=3, n=64, m=80, seed=0):
    g = torch.Generator().manual_seed(seed)
    F = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    P = F @ F.mT + n * torch.eye(n, dtype=torch.float64)
    Gt = torch.randn((n, m) if batched else (B, n, m), generator=g,
                     dtype=torch.float64)
    d2 = torch.rand(B, m, generator=g, dtype=torch.float64) + 0.5
    return P, Gt, d2


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("equilibrate", [False, True])
def test_factor_out(batched, equilibrate):
    name = "fused_schur_cholesky" + ("_batched" if batched else "")
    fn = getattr(fc, name)
    args = _factor_args(batched)
    kw = dict(equilibrate=equilibrate, device="cpu",
              **(dict(tb=1) if batched else {}))
    out = fc.out_buffers(name, *args, **kw)
    ref = fn(*args, **kw)
    got = fn(*args, out=out, **kw)
    assert got is out and len(out) == len(ref)
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="out must be"):
        fn(*args, out=out[:1], **kw)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("nrhs", [1, 64])
def test_solve_out(batched, nrhs):
    name = "fused_cholesky_solve" + ("_batched" if batched else "")
    fn = getattr(fc, name)
    P, Gt, d2 = _factor_args(True)
    L, Dinv = fc.fused_schur_cholesky_batched(P, Gt, d2, tb=1, device="cpu")
    rows = torch.randn(3, nrhs, 64, dtype=torch.float64)
    kw = dict(device="cpu", **(dict(tb=1) if batched else {}))
    out = fc.out_buffers(name, L, Dinv, rows)
    assert fn(L, Dinv, rows, out=out, **kw) is out
    assert torch.equal(out, fn(L, Dinv, rows, **kw))
    with pytest.raises(ValueError, match="out must be"):
        fn(L, Dinv, rows, out=out[:, :, 1:], **kw)


# ---- on the card -------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,shared", [(16, 256, True), (1024, 256, True),
                                        (16, 40, True), (16, 64, False)])
def test_taped_cascade_matches_eager_on_card(cuda_device, B, n, shared):
    """The benchmark's scenario cascade (n = 256, m = 512, p = 1; at n =
    40, which the KKT layer pads to 64; and with G, h, A, b per instance,
    through the unbatched wrappers): calls 2-4 of one solver replay their
    passes from CUDA graphs and equal a fresh (eager) solver's exactly,
    with the same factor and solve calls; only call 2 captures.  A call
    with another G and h after them equals the eager solve too."""
    calls = [scenario(B, n, seed=s, device=cuda_device) for s in (1, 2, 3)]
    calls.append(other_data(B, n, seed=5, device=cuda_device))
    if not shared:
        calls = [d[:2] + tuple(u.expand((B,) + u.shape).contiguous()
                               for u in d[2:]) for d in calls]

    def make():
        return make_coneqp_cascade(ConeDims(l=2 * n), kktsolver="chol2_inv",
                                   maxiters=50, instrument=True,
                                   shared_GhAb=shared, device=cuda_device,
                                   **TOLS)
    check_against_eager(make, calls, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["qp", "qp_f32", "phase_c"])
@pytest.mark.parametrize("n", [256, 40])
def test_taped_qp_matches_eager_on_card(cuda_device, kind, n):
    """'chol2' (a kernel solve per KKT solve, so several wrapper calls a
    pass): make_coneqp in float64 and with the equilibrated float32
    factor, and the cascade's float64 phase C: calls 2-4 replay and
    equal a fresh solver's exactly."""
    calls = [scenario(16, n, seed=s, device=cuda_device) for s in (1, 2, 3)]
    calls.append(other_data(16, n, seed=5, device=cuda_device))
    check_against_eager(_maker(kind, n, cuda_device), calls, 1)


@pytest.mark.gpu
def test_taped_calls_keep_the_benchmarks_kernel_spans(cuda_device):
    """Under the benchmark's traced slice (its spans around the four
    wrappers, put in by module attribute), a taped solver's wrapper calls
    still run inside their `bench.factor.*` / `bench.solve.*` spans, and
    each span holds device time."""
    from benchmark import tracing
    n = 256
    data = scenario(16, n, seed=9, device=cuda_device)
    solve = make_coneqp_cascade(ConeDims(l=2 * n), kktsolver="chol2_inv",
                                maxiters=50, device=cuda_device, **TOLS)
    for _ in range(2):
        solve(*data)
    replays = ipm_graph.counts()["replays"]

    def run_call(k):
        with torch.profiler.record_function(tracing.CALL):
            solve(*data)
            torch.cuda.synchronize()

    calls, reduced = tracing.profile_calls(run_call, 2)
    assert ipm_graph.counts()["replays"] > replays
    kinds = {rec["kind"] for rec in calls}
    assert kinds == {"factor", "solve"}
    dev = reduced["span_device_s"]
    traced = [(rec["kind"], i) for i, rec in enumerate(calls)
              if (rec["kind"], i) in dev]
    assert traced and all(dev[key] > 0.0 for key in traced)
    assert {kind for kind, _ in traced} == {"factor", "solve"}

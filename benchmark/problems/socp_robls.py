"""Batched robust least-squares SOCPs (bench.py's bench_socp, the robls
pattern of CVXOPT's examples/doc/chap9/robls.py; BASELINE.json
configs[2]):

    min 1/2 x'Px + q'x  s.t.  ||D_i x + f_i|| <= g_i'x + 1,  i = 1..nq,

P = F F' + ridge I with F (n, cols) ~ N(0, 1) / sqrt(n), q ~ -U(0,
q_range); block i's rows of G are [-g_i'; -D_i] and its part of h is
[1; f_i], with G ~ g_scale N(0, 1) and f_i ~ f_scale N(0, 1) drawn for
each instance, so that x = 0 is strictly feasible; no equalities.
Drawn on the device from the seed, in float64, a pool of distinct
batches that together hold the deployment's set; each call of the
window takes the next one.  The solver is `make_coneqp_cascade(
ConeDims(q=(mq,) * nq), ..., shared_GhAb=False)`'s solve.

The judge recomputes the stopping criteria and the cone membership of
each kept answer (`reference/socp_check.py`) and holds its x to the
plain reference (`reference/socp_torch.py`) solved in float64 on the
same instance, on its device.  The traced slice puts `bench.qr.<i>`
spans around `torch.linalg.qr`, which phase B's 'cholqr_inv' factor
calls through that module attribute.
"""

from __future__ import annotations

import torch

from benchmark.reference import socp_check, socp_torch

F64 = torch.float64


def qr_shape(M, *args, **kwargs):
    """(B, rows, cols) of a QR's matrix argument."""
    return (M.shape[0] if M.dim() == 3 else 1,) + tuple(M.shape[-2:])


KERNEL_SPANS = (("torch.linalg", "qr", "qr", qr_shape),)


def make_pool(cfg, traffic, seed, device):
    n, cols, B = cfg["n"], cfg["factor_cols"], traffic["batch"]
    nq, mq = cfg["nq"], cfg["mq"]
    s = cfg["solver"]
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    kw = dict(dtype=F64, device=device)
    shared = dict(A=torch.zeros((B, 0, n), **kw), b=torch.zeros((B, 0), **kw),
                  judge=dict(dims={"l": 0, "q": [mq] * nq},
                             maxiters=s["maxiters"], abstol=s["abstol"],
                             reltol=s["reltol"], feastol=s["feastol"]))
    pool = []
    for _ in range(traffic["pool"]):
        F = torch.randn((B, n, cols), generator=g, **kw) / n ** 0.5
        P = F @ F.mT
        del F
        P = 0.5 * (P + P.mT)
        P.diagonal(dim1=1, dim2=2).add_(cfg["ridge"])
        q = -cfg["q_range"] * torch.rand((B, n), generator=g, **kw)
        G = cfg["g_scale"] * torch.randn((B, nq * mq, n), generator=g, **kw)
        h = cfg["f_scale"] * torch.randn((B, nq, mq), generator=g, **kw)
        h[:, :, 0] = 1.0
        pool.append(dict(P=P, q=q, G=G, h=h.reshape(B, nq * mq), **shared))
    return pool


def _cascade(cfg, device, **kw):
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    s = cfg["solver"]
    return make_coneqp_cascade(
        ConeDims(q=(cfg["mq"],) * cfg["nq"]), kktsolver=s["kktsolver"],
        maxiters=s["maxiters"], abstol=s["abstol"], reltol=s["reltol"],
        feastol=s["feastol"], shared_GhAb=False, device=device, **kw)


def make_solver(cfg, traffic, device, instrument):
    solve = _cascade(cfg, device, instrument=instrument)

    def call(d):
        return solve(d["P"], d["q"], d["G"], d["h"], d["A"], d["b"])
    return call


def make_control(cfg, traffic, device):
    """The control: the cascade's own float32 path (phase A) run to the
    configuration's tolerances, with no float64 phase after it."""
    solve = _cascade(cfg, device, phase1_tol=cfg["solver"]["abstol"])

    def call(d):
        return solve.phase_a(d["P"], d["q"], d["G"], d["h"], d["A"],
                             d["b"])
    return call


def record(out):
    """Per call: batch size, optimal flags and iterations (on the
    device) and the cascade's host syncs in phases A and B."""
    prof = out.get("profile")
    return dict(batch=out["status"].shape[0], ok=out["status"] == 0,
                iters=out["iterations"],
                host_syncs=(prof["a_host_syncs"] + prof["b_host_syncs"]
                            if prof else None))


def keep(out, i):
    return {k: out[k][i].clone() for k in ("x", "y", "s", "z")}


def instance(d, i):
    return {k: d[k][i] for k in ("P", "q", "G", "h", "A", "b")}


def judge(d, i, ans):
    """pres, dres, gap and cone of the answer (`socp_check`), and x_ref:
    max |x - x_ref| / max(1, max |x_ref|) against the plain reference in
    float64 on the same instance (inf where it does not return
    optimal).  P is positive definite, so the optimal x is unique."""
    data, spec = instance(d, i), d["judge"]
    nums = socp_check.kkt_numbers(**data, dims=spec["dims"], **ans)
    ref = socp_torch.coneqp_cones(
        *(data[k].to(F64) for k in ("P", "q", "G", "h")), spec["dims"],
        data["A"].to(F64), data["b"].to(F64), maxiters=spec["maxiters"],
        abstol=spec["abstol"], reltol=spec["reltol"],
        feastol=spec["feastol"])
    xr = ref["x"]
    nums["x_ref"] = (float((ans["x"].to(F64) - xr).abs().max())
                     / max(1.0, float(xr.abs().max()))
                     if ref["status"] == "optimal" else float("inf"))
    return nums

"""Batched scenario QPs (bench.py's make_batch, BASELINE.json configs[4]):

    min 1/2 x'Px + q'x   s.t.  0 <= x <= 1,  sum x = 1,

P = F F' + ridge I with F (n, cols) ~ N(0, 1) / sqrt(n), q ~ -U(0,
q_range); G = [-I; I], h = [0; 1], A = 1', b = 1 shared by the batch.
Drawn on the device from the seed, in float64, a pool of distinct
batches; each call of the window takes the next one.  The solver is
`make_coneqp_cascade(...)`'s solve.
"""

from __future__ import annotations

import torch

from benchmark.reference import qp_check

F64 = torch.float64


def make_pool(cfg, traffic, seed, device):
    n, cols, B = cfg["n"], cfg["factor_cols"], traffic["batch"]
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    kw = dict(dtype=F64, device=device)
    eye = torch.eye(n, **kw)
    shared = dict(G=torch.cat([-eye, eye]),
                  h=torch.cat([torch.zeros(n, **kw), torch.ones(n, **kw)]),
                  A=torch.ones((1, n), **kw), b=torch.ones(1, **kw))
    pool = []
    for _ in range(traffic["pool"]):
        F = torch.randn((B, n, cols), generator=g, **kw) / n ** 0.5
        P = F @ F.mT
        del F
        P = 0.5 * (P + P.mT)
        P.diagonal(dim1=1, dim2=2).add_(cfg["ridge"])
        q = -cfg["q_range"] * torch.rand((B, n), generator=g, **kw)
        pool.append(dict(P=P, q=q, **shared))
    return pool


def make_solver(cfg, traffic, device, instrument):
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    s = cfg["solver"]
    solve = make_coneqp_cascade(
        ConeDims(l=cfg["m"]), kktsolver=s["kktsolver"],
        maxiters=s["maxiters"], abstol=s["abstol"], reltol=s["reltol"],
        feastol=s["feastol"], instrument=instrument, device=device)

    def call(d):
        return solve(d["P"], d["q"], d["G"], d["h"], d["A"], d["b"])
    return call


def make_control(cfg, traffic, device):
    """The control: the cascade's own float32 path (phase A) run to the
    configuration's tolerances, with no float64 phase after it."""
    from cvxopt_tpu_torch.cones import ConeDims
    from cvxopt_tpu_torch.coneqp import make_coneqp_cascade
    s = cfg["solver"]
    solve = make_coneqp_cascade(
        ConeDims(l=cfg["m"]), kktsolver=s["kktsolver"],
        maxiters=s["maxiters"], abstol=s["abstol"], reltol=s["reltol"],
        feastol=s["feastol"], phase1_tol=s["abstol"], device=device)

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
    return dict(P=d["P"][i], q=d["q"][i], G=d["G"], h=d["h"], A=d["A"],
                b=d["b"])


def judge(d, i, ans):
    return qp_check.kkt_numbers(**instance(d, i), **ans)

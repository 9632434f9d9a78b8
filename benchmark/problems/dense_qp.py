"""One large dense QP a call (bench.py's bench_large_kkt, the BASELINE.json
metric "KKT factorize+solve ms at n=10k QP"):

    min 1/2 x'Px + q'x   s.t.  Gx + s = h, s >= 0,

P = F F' + I with F (n, cols) ~ N(0, 1); G (m, n) ~ N(0, 1) / sqrt(n);
h = G x0 + s0 with x0 ~ N(0, 1), s0 ~ U(0.5, 2), so that the problem is
strictly feasible; q ~ N(0, 1).  Drawn on the device from the seed, in
float64, a pool of distinct instances; each call of the window takes
the next one through the front door, `cvxopt_tpu_torch.solvers.qp`.
"""

from __future__ import annotations

import torch

from benchmark.reference import qp_check, qp_torch

F64 = torch.float64


def make_pool(cfg, traffic, seed, device):
    if traffic["batch"] != 1:
        raise ValueError("solvers.qp takes one problem a call")
    n, m, cols = cfg["n"], cfg["m"], cfg["factor_cols"]
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    kw = dict(dtype=F64, device=device)
    pool = []
    for _ in range(traffic["pool"]):
        F = torch.randn((n, cols), generator=g, **kw)
        P = F @ F.T
        del F
        P = 0.5 * (P + P.T)
        P.diagonal().add_(1.0)
        G = torch.randn((m, n), generator=g, **kw) / n ** 0.5
        x0 = torch.randn(n, generator=g, **kw)
        s0 = 0.5 + 1.5 * torch.rand(m, generator=g, **kw)
        q = torch.randn(n, generator=g, **kw)
        pool.append(dict(P=P, q=q, G=G, h=G @ x0 + s0,
                         A=torch.zeros((0, n), **kw),
                         b=torch.zeros(0, **kw)))
    return pool


def make_solver(cfg, traffic, device, instrument):
    from cvxopt_tpu_torch import solvers
    s = cfg["solver"]
    opts = {"abstol": s["abstol"], "reltol": s["reltol"],
            "feastol": s["feastol"], "maxiters": s["maxiters"]}

    def call(d):
        return solvers.qp(d["P"], d["q"], d["G"], d["h"], options=opts,
                          device=device)
    return call


def make_control(cfg, traffic, device):
    """The control: the plain reference iteration (reference/qp_torch.py)
    in float32, TF32 off, in the program's place; it returns the
    program's result format."""
    s = cfg["solver"]

    def call(d):
        data = {k: d[k].to(torch.float32) for k in
                ("P", "q", "G", "h", "A", "b")}
        return qp_torch.coneqp_l(**data, maxiters=s["maxiters"],
                                 abstol=s["abstol"], reltol=s["reltol"],
                                 feastol=s["feastol"])
    return call


def record(out):
    return dict(batch=1, ok=torch.tensor([out["status"] == "optimal"]),
                iters=torch.tensor([out["iterations"]]), host_syncs=None)


def keep(out, i):
    return {k: out[k].reshape(-1).clone() for k in ("x", "y", "s", "z")}


def instance(d, i):
    return {k: d[k] for k in ("P", "q", "G", "h", "A", "b")}


def judge(d, i, ans):
    return qp_check.kkt_numbers(**instance(d, i), **ans)

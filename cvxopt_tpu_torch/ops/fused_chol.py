"""Fused condensed-KKT factor and solve: wrappers of the Hopper kernels
in `csrc/fused_chol.cu`, and their plain PyTorch versions.

Twin of `cvxopt_tpu/ops/pallas_chol.py`.  The four TPU kernels there
map onto two CUDA kernels, each templated on float and double:

  fused_schur_cholesky          (pallas_chol.py:129)  -> schur_chol
  fused_schur_cholesky_batched  (pallas_chol.py:338)  -> schur_chol
  fused_cholesky_solve          (pallas_chol.py:194)  -> chol_solve
  fused_cholesky_solve_batched  (pallas_chol.py:404)  -> chol_solve

    S = P + Gt diag(dinv2) Gt' ;  S = L L' ;  Dinv[j] = inv(L_jj)
    x = (L L')^{-1} b            (right-hand sides stored as rows)

The unbatched pair takes one instance or a batch with a per-instance
Gt (the vmapped form); the batched pair takes a Gt shared across the
batch.  With ``equilibrate=True`` the factor also computes
``deq = 1/sqrt(max(diag(S), 1e-30))``, factors ``D S D`` instead of S
and returns deq; with it False the function is exactly the TPU
kernel's.  n must be a multiple of BP = 64 (ValueError otherwise); the
KKT layer pads.

A wrapper given CPU tensors (with ``device="cpu"``) computes the plain
version; given CUDA tensors it launches its kernel or raises.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

A pivot <= 0 or not finite poisons the whole instance with NaN, in the
kernels and the plain versions alike; the solvers read NaN as a
singular KKT system.
"""

from __future__ import annotations

import ctypes

import torch

from cvxopt_tpu_torch._device import resolve_device, check_on

BP = 64          # panel width
SOLVE_ROWS = 16  # right-hand-side rows per chol_solve block

_DTYPES = (torch.float32, torch.float64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# ---- plain PyTorch versions -------------------------------------------

def _diag_blocks(L):
    """The (npan, BP, BP) diagonal blocks of (..., n, n) L."""
    n = L.shape[-1]
    npan = n // BP
    Lr = L.reshape(L.shape[:-2] + (npan, BP, npan, BP))
    return torch.diagonal(Lr, dim1=-4, dim2=-2).movedim(-1, -3)


def fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate=False):
    """Plain version of the factor: (L, Dinv) or (L, Dinv, deq)."""
    if P.dim() == 2:
        dinv2 = dinv2.reshape(-1)
    S = P + (Gt * dinv2.unsqueeze(-2)) @ Gt.transpose(-1, -2)
    deq = None
    if equilibrate:
        deq = torch.rsqrt(torch.clamp(
            torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
        S = S * deq.unsqueeze(-1) * deq.unsqueeze(-2)
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0) | ~torch.isfinite(L).all(-1).all(-1)
    L = torch.where(bad[..., None, None],
                    torch.full_like(L, float("nan")), L)
    eye = torch.eye(BP, dtype=L.dtype, device=L.device)
    Dinv = torch.linalg.solve_triangular(_diag_blocks(L), eye,
                                         upper=False)
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve_ref(L, Dinv, B_rows):
    """Plain version of the solve: (L L')^{-1} b for rows b."""
    y = torch.linalg.solve_triangular(L, B_rows.transpose(-1, -2),
                                      upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.transpose(-1, -2)


def fused_schur_cholesky_batched_ref(P, Gt, dinv2, equilibrate=False):
    return fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate)


def fused_cholesky_solve_batched_ref(L, Dinv, B_rows):
    return fused_cholesky_solve_ref(L, Dinv, B_rows)


# ---- kernel launches ---------------------------------------------------

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from cvxopt_tpu_torch.ops._build import load
        lib = load("fused_chol")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for sfx in ("f32", "f64"):
            f = getattr(lib, "schur_chol_" + sfx)
            f.argtypes = [vp, ll, vp, ll, vp, ll, vp, vp, vp,
                          ci, ci, ci, vp]
            f.restype = ci
            f = getattr(lib, "chol_solve_" + sfx)
            f.argtypes = [vp, vp, vp, ll, vp, ci, ci, ci, ci, vp]
            f.restype = ci
        lib.smem_optin.argtypes = [ci, ctypes.POINTER(ci)]
        lib.smem_optin.restype = ci
        _lib = lib
    return _lib


def _check_dtype(*ts):
    dt = ts[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"dtype {dt} not supported (float32/float64)")
    for t in ts:
        if t.dtype != dt:
            raise TypeError("all operands must share one dtype")


def _inner_contig(t, name):
    """Raise unless the last two axes of t are row-major contiguous."""
    if t.shape[-1] > 1 and t.stride(-1) != 1 or \
            t.dim() >= 2 and t.shape[-2] > 1 and \
            t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name} must be contiguous in its last two axes")


def _launch_schur(P3, Gt, gt_bs, d2, d_bs, equilibrate):
    Bsz, n, _ = P3.shape
    m = Gt.shape[-1]
    if not P3.is_contiguous():
        raise ValueError("P must be contiguous")
    _inner_contig(Gt, "Gt")
    if d2.stride(-1) != 1:
        raise ValueError("dinv2 must be contiguous")
    kw = dict(dtype=P3.dtype, device=P3.device)
    L = torch.empty((Bsz, n, n), **kw)
    Dinv = torch.empty((Bsz, n // BP, BP, BP), **kw)
    deq = torch.empty((Bsz, n), **kw) if equilibrate else None
    fn = getattr(_kernels(), "schur_chol_" + _SUFFIX[P3.dtype])
    with torch.cuda.device(P3.device):
        stream = torch.cuda.current_stream(P3.device).cuda_stream
        err = fn(P3.data_ptr(), n * n, Gt.data_ptr(), gt_bs,
                 d2.data_ptr(), d_bs, L.data_ptr(), Dinv.data_ptr(),
                 deq.data_ptr() if deq is not None else None,
                 Bsz, n, m, stream)
    if err:
        raise RuntimeError(f"schur_chol launch failed: CUDA error {err}")
    return L, Dinv, deq


_smem = {}


def _smem_optin(device):
    """Shared memory one block of `device` may opt in to, in bytes."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _smem:
        out = ctypes.c_int(0)
        err = _kernels().smem_optin(idx, ctypes.byref(out))
        if err:
            raise RuntimeError(f"smem_optin failed: CUDA error {err}")
        _smem[idx] = out.value
    return _smem[idx]


def solve_rows(n, nrhs, esize, smem):
    """Right-hand-side rows per chol_solve block: up to SOLVE_ROWS, as
    many as fit `smem` bytes beside the 64x65 tile and the 64-wide
    accumulator (the block holds its rows of y, R n words).  Raises
    ValueError when not even one row fits."""
    words = smem // esize - BP * (BP + 1)
    fit = words // (BP + n)
    if fit < 1:
        nmax = (words - BP) // BP * BP
        raise ValueError(
            f"chol_solve holds a right-hand side of n words in shared "
            f"memory: n ({n}) exceeds {nmax} for {esize}-byte elements "
            f"in {smem} bytes")
    return max(1, min(SOLVE_ROWS, nrhs, fit))


def _launch_solve(L3, D4, Bm, b_bs, nrhs):
    Bsz, n, _ = L3.shape
    if not (L3.is_contiguous() and D4.is_contiguous()):
        raise ValueError("L and Dinv must be contiguous")
    _inner_contig(Bm, "B_rows")
    rows = solve_rows(n, nrhs, L3.element_size(), _smem_optin(L3.device))
    X = torch.empty((Bsz, nrhs, n), dtype=L3.dtype, device=L3.device)
    fn = getattr(_kernels(), "chol_solve_" + _SUFFIX[L3.dtype])
    with torch.cuda.device(L3.device):
        stream = torch.cuda.current_stream(L3.device).cuda_stream
        err = fn(L3.data_ptr(), D4.data_ptr(), Bm.data_ptr(), b_bs,
                 X.data_ptr(), Bsz, n, nrhs, rows, stream)
    if err:
        raise RuntimeError(f"chol_solve launch failed: CUDA error {err}")
    return X


def _check_n(n):
    if n % BP:
        raise ValueError(f"n ({n}) must be a multiple of {BP}")


# ---- public wrappers ---------------------------------------------------

def fused_schur_cholesky(P, Gt, dinv2, *, equilibrate=False,
                         device="cuda"):
    """L, Dinv = chol(P + Gt diag(dinv2) Gt') with panel inverses.

    P (n, n) or (B, n, n); Gt (n, m) or per-instance (B, n, m); dinv2
    (m,), (1, m) or (B, m).  Returns L (..., n, n), Dinv (..., n/64,
    64, 64), and deq (..., n) when `equilibrate`."""
    dev = resolve_device(device)
    check_on(dev, P, Gt, dinv2)
    _check_dtype(P, Gt, dinv2)
    n = P.shape[-1]
    _check_n(n)
    if dev.type == "cpu":
        return fused_schur_cholesky_ref(P, Gt, dinv2, equilibrate)
    single = P.dim() == 2
    P3 = P.unsqueeze(0) if single else P
    Bsz = P3.shape[0]
    m = Gt.shape[-1]
    d2 = dinv2.reshape(-1, m)
    if d2.shape[0] not in (1, Bsz):
        raise ValueError("dinv2 batch does not match P")
    if Gt.dim() == 3 and Gt.shape[0] != Bsz:
        raise ValueError("Gt batch does not match P")
    gt_bs = Gt.stride(0) if Gt.dim() == 3 else 0
    d_bs = d2.stride(0) if d2.shape[0] == Bsz and Bsz > 1 else 0
    L, Dinv, deq = _launch_schur(P3, Gt, gt_bs, d2, d_bs, equilibrate)
    fused_schur_cholesky.launches += 1
    if single:
        L, Dinv = L[0], Dinv[0]
        deq = deq[0] if deq is not None else None
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve(L, Dinv, B_rows, *, device="cuda"):
    """x = (L L')^{-1} b for right-hand sides stored as rows.

    L (n, n) or (B, n, n); Dinv (..., n/64, 64, 64); B_rows (nrhs, n)
    or (B, nrhs, n).  Returns B_rows' shape.  On the card a block holds
    whole right-hand-side rows in shared memory, so n is at most 24832
    in float64 and 53888 in float32 with the 227 KB of an H100
    (`solve_rows`; ValueError beyond)."""
    dev = resolve_device(device)
    check_on(dev, L, Dinv, B_rows)
    _check_dtype(L, Dinv, B_rows)
    n = L.shape[-1]
    _check_n(n)
    if dev.type == "cpu":
        return fused_cholesky_solve_ref(L, Dinv, B_rows)
    single = L.dim() == 2
    L3 = L.unsqueeze(0) if single else L
    D4 = Dinv.unsqueeze(0) if single else Dinv
    Bm = B_rows.unsqueeze(0) if B_rows.dim() == 2 else B_rows
    if Bm.shape[0] != L3.shape[0]:
        Bm = Bm.expand(L3.shape[0], -1, -1)
    X = _launch_solve(L3, D4, Bm, Bm.stride(0), Bm.shape[1])
    fused_cholesky_solve.launches += 1
    return X[0] if single and B_rows.dim() == 2 else X


def fused_schur_cholesky_batched(P, Gt, dinv2, tb: int = 8, *,
                                 equilibrate=False, device="cuda"):
    """Batched L, Dinv with a shared Gt: P (B, n, n), Gt (n, m), dinv2
    (B, m).  B must be a multiple of tb (kept from the TPU kernel's
    signature; the CUDA kernel runs one instance per thread block and
    otherwise ignores it) and n of BP."""
    dev = resolve_device(device)
    check_on(dev, P, Gt, dinv2)
    _check_dtype(P, Gt, dinv2)
    Bsz, n, _ = P.shape
    if Bsz % tb or n % BP:
        raise ValueError("B must be divisible by tb and n by BP")
    if Gt.dim() != 2 or dinv2.shape != (Bsz, Gt.shape[1]):
        raise ValueError("expected Gt (n, m) and dinv2 (B, m)")
    if dev.type == "cpu":
        return fused_schur_cholesky_batched_ref(P, Gt, dinv2, equilibrate)
    L, Dinv, deq = _launch_schur(P, Gt, 0, dinv2, dinv2.stride(0),
                                 equilibrate)
    fused_schur_cholesky_batched.launches += 1
    return (L, Dinv) if deq is None else (L, Dinv, deq)


def fused_cholesky_solve_batched(L, Dinv, B_rows, tb: int = 8, *,
                                 device="cuda"):
    """Batched multi-RHS solve: L (B, n, n), Dinv (B, n/64, 64, 64),
    B_rows (B, nrhs, n); B_rows may be an expanded view with batch
    stride 0 (e.g. one identity for the whole batch).  n is limited as
    in `fused_cholesky_solve`."""
    dev = resolve_device(device)
    check_on(dev, L, Dinv, B_rows)
    _check_dtype(L, Dinv, B_rows)
    Bsz, n, _ = L.shape
    if Bsz % tb or n % BP:
        raise ValueError("B must be divisible by tb and n by BP")
    if dev.type == "cpu":
        return fused_cholesky_solve_batched_ref(L, Dinv, B_rows)
    X = _launch_solve(L, Dinv, B_rows, B_rows.stride(0), B_rows.shape[1])
    fused_cholesky_solve_batched.launches += 1
    return X


WRAPPERS = (fused_schur_cholesky, fused_cholesky_solve,
            fused_schur_cholesky_batched, fused_cholesky_solve_batched)


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts():
    return {w.__name__: w.launches for w in WRAPPERS}


reset_launch_counts()

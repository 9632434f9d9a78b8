"""Discrete transforms, the cvxopt.fftw equivalents (dft/idft,
dftn/idftn, dct/idct, dctn/idctn, dst/idst, dstn/idstn); twin of
`cvxopt_tpu/utils/fft.py`, on `torch.fft`.

The DCT/DST types are built as the JAX module builds them:
  * DCT-I / DST-I by the even/odd-extension FFT identities;
  * DCT-II by Makhoul's reordering and one FFT (jax.scipy.fft.dct);
  * DCT-III through the unnormalized inverse of DCT-II
    (jax.scipy.fft.idct: twiddle, inverse FFT, de-interleave);
  * DST-II/III by the index and sign mappings onto DCT-II/III;
  * type IV as one dense cosine/sine matrix product.

Conventions follow scipy.fft with norm=None (the unnormalized sums
FFTW computes); the inverses are scipy's unnormalized idct/idst.
Transforms run along `axis` (default 0, the reference's column
direction), or over all axes for the *n variants, on the device of x.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cvxopt_tpu_torch._device import tensors


def _t(x):
    x, = tensors(x)
    return x


def dft(x, axis=0):
    return torch.fft.fft(_t(x), dim=axis)


def idft(x, axis=0):
    return torch.fft.ifft(_t(x), dim=axis)


def dftn(x, axes=None):
    return torch.fft.fftn(_t(x), dim=axes)


def idftn(x, axes=None):
    return torch.fft.ifftn(_t(x), dim=axes)


def _axis0(fn):
    """Apply a leading-axis transform along `axis`."""
    def wrapped(x, axis=0):
        x = torch.movedim(_t(x), axis, 0)
        return torch.movedim(fn(x), 0, axis)

    return wrapped


def _col(v, x):
    """A (n,) vector shaped to broadcast along x's leading axis."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _w4(n, x):
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    return torch.exp(-0.5j * math.pi * k / n)


def _dct2_0(x):
    """DCT-II along axis 0 (Makhoul: interleave, FFT, twiddle)."""
    n = x.shape[0]
    v = torch.cat([x[::2], torch.flip(x[1::2], (0,))])
    V = torch.fft.fft(v, dim=0)
    return 2.0 * (V * _col(_w4(n, x).to(V.dtype), x)).real


def _idct2_0(x):
    """jax.scipy.fft.idct(x, type=2, norm=None) along axis 0: DCT-III
    over 2N."""
    n = x.shape[0]
    f = torch.full((n,), 2.0, dtype=x.dtype, device=x.device)
    f[0] = 4.0
    x = x / _col(f * n, x)
    w = _col(_w4(n, x), x).to(torch.complex64 if x.dtype == torch.float32
                              else torch.complex128)
    y = torch.fft.ifft((x.to(w.dtype) / w) * (2 * n), dim=0).real
    # de-interleave: evens from the first half, odds from the reversed
    # second half
    h = math.ceil(n / 2)
    out = torch.empty_like(y)
    out[::2] = y[:h]
    out[1::2] = torch.flip(y[h:], (0,))
    return out


@_axis0
def _dct1(x):
    # even extension [x0..x_{N-1}, x_{N-2}..x1], length 2N-2
    ext = torch.cat([x, torch.flip(x[1:-1], (0,))])
    return torch.fft.fft(ext, dim=0).real[: x.shape[0]]


@_axis0
def _dct2(x):
    return _dct2_0(x)


@_axis0
def _dct3(x):
    return _idct2_0(x) * (2.0 * x.shape[0])


def _trig4_matrix(n, fn, like):
    k = np.arange(n)
    M = 2.0 * fn(np.pi * (2 * k[:, None] + 1) * (2 * k[None, :] + 1)
                 / (4.0 * n))
    return torch.as_tensor(M, dtype=like.dtype, device=like.device)


@_axis0
def _dct4(x):
    return torch.tensordot(_trig4_matrix(x.shape[0], np.cos, x), x,
                           dims=([1], [0]))


def dct(x, type=2, axis=0):
    if type == 1:
        return _dct1(x, axis=axis)
    if type == 2:
        return _dct2(x, axis=axis)
    if type == 3:
        return _dct3(x, axis=axis)
    if type == 4:
        return _dct4(x, axis=axis)
    raise ValueError(f"invalid DCT type {type}")


def idct(x, type=2, axis=0):
    """Unnormalized inverse (scipy norm=None)."""
    x = _t(x)
    n = x.shape[axis]
    if type == 1:
        return dct(x, 1, axis) / (2.0 * (n - 1))
    if type == 2:
        return dct(x, 3, axis) / (2.0 * n)
    if type == 3:
        return dct(x, 2, axis) / (2.0 * n)
    if type == 4:
        return dct(x, 4, axis) / (2.0 * n)
    raise ValueError(f"invalid DCT type {type}")


def _over_axes(fn, x, type, axes):
    x = _t(x)
    for ax in (range(x.dim()) if axes is None else axes):
        x = fn(x, type=type, axis=ax)
    return x


def dctn(x, type=2, axes=None):
    return _over_axes(dct, x, type, axes)


def idctn(x, type=2, axes=None):
    return _over_axes(idct, x, type, axes)


@_axis0
def _dst1(x):
    # odd extension [0, x, 0, -rev(x)], length 2N+2
    n = x.shape[0]
    z = torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    ext = torch.cat([z, x, z, -torch.flip(x, (0,))])
    return -torch.fft.fft(ext, dim=0).imag[1:n + 1]


def _signs(x):
    n = x.shape[0]
    return _col(torch.as_tensor((-1.0) ** np.arange(n), dtype=x.dtype,
                                device=x.device), x)


@_axis0
def _dst2(x):
    # DST-II(x)_k = DCT-II((-1)^n x_n)_{N-1-k}
    return torch.flip(_dct2_0(x * _signs(x)), (0,))


@_axis0
def _dst3(x):
    # DST-III(x) = (-1)^n DCT-III(reversed x)
    y = _idct2_0(torch.flip(x, (0,))) * (2.0 * x.shape[0])
    return y * _signs(x)


@_axis0
def _dst4(x):
    return torch.tensordot(_trig4_matrix(x.shape[0], np.sin, x), x,
                           dims=([1], [0]))


def dst(x, type=1, axis=0):
    if type == 1:
        return _dst1(x, axis=axis)
    if type == 2:
        return _dst2(x, axis=axis)
    if type == 3:
        return _dst3(x, axis=axis)
    if type == 4:
        return _dst4(x, axis=axis)
    raise ValueError(f"invalid DST type {type}")


def idst(x, type=1, axis=0):
    """Unnormalized inverse (scipy norm=None)."""
    x = _t(x)
    n = x.shape[axis]
    if type == 1:
        return dst(x, 1, axis) / (2.0 * (n + 1))
    if type == 2:
        return dst(x, 3, axis) / (2.0 * n)
    if type == 3:
        return dst(x, 2, axis) / (2.0 * n)
    if type == 4:
        return dst(x, 4, axis) / (2.0 * n)
    raise ValueError(f"invalid DST type {type}")


def dstn(x, type=1, axes=None):
    return _over_axes(dst, x, type, axes)


def idstn(x, type=1, axes=None):
    return _over_axes(idst, x, type, axes)

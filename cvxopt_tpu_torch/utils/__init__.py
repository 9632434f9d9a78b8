"""Utility modules, twin of `cvxopt_tpu/utils`: discrete transforms
(fftw equivalent), random number generation (gsl equivalent) and
printing."""

from cvxopt_tpu_torch.utils import fft, rng, printing

__all__ = ["fft", "rng", "printing"]

"""FFTLog: fast Hankel / spherical-Bessel transforms on log grids (a copy of
``nbodykit_tpu/ops/fftlog.py``).

Replaces the reference's dependency on ``mcfit`` (consumed at
nbodykit/cosmology/correlation.py:5 and cosmology/power/zeldovich.py:7).

Derivation: for a Mellin-convolution transform
    G(y) = int_0^inf F(x) K(x*y) dx/x
sampled log-uniformly (x_j = x0 e^{j Delta}), expanding F in discrete
Fourier modes over ln x turns the integral into a product with the
Mellin transform M_K(s) = int K(t) t^{s-1} dt at s = q + i*omega_m:

    G(y_j) = y_j^{-q} (1/N) FFT_j[ FFThat{F x^{-q}}_m
                                    * M_K(q + i w_m) * e^{-i w_m ln(x0 y0)} ]

with w_m = 2 pi m / (N Delta). The bias q keeps both ends of the
integrand decaying.

The spherical-Bessel kernel Mellin transform (standard result):
    int_0^inf j_l(t) t^{s-1} dt
      = 2^{s-2} sqrt(pi) Gamma((l+s)/2) / Gamma((l+3-s)/2),
valid for -l < Re s < 2 — hence the default bias q = 1.5.
"""

import numpy as np
from scipy.special import loggamma


def _mellin_sph_bessel(ell):
    def M(s):
        return (2.0 ** (s - 2) * np.sqrt(np.pi)
                * np.exp(loggamma((ell + s) / 2)
                         - loggamma((ell + 3 - s) / 2)))
    return M


def fftlog_mellin(x, F, mellin, q=1.5):
    """Evaluate G(y) = int F(x) K(xy) dx/x on the reciprocal log grid
    y_j = 1 / x_{N-1-j}, given the kernel's Mellin transform."""
    x = np.asarray(x, dtype='f8')
    F = np.asarray(F, dtype='f8')
    N = len(x)
    delta = np.log(x[1] / x[0])
    u0 = np.log(x[0])

    Fhat = np.fft.fft(F * x ** (-q))
    m = np.fft.fftfreq(N, d=1.0 / N)
    omega = 2 * np.pi * m / (N * delta)
    s = q + 1j * omega
    Mk = mellin(s)

    y0 = 1.0 / x[-1]
    v0 = np.log(y0)
    coeff = Fhat * Mk * np.exp(-1j * omega * (v0 + u0))
    G = np.fft.fft(coeff) / N
    y = y0 * np.exp(np.arange(N) * delta)
    return y, G.real * y ** (-q)


def pk_to_xi_fftlog(k, pk, ell=0, q=1.5):
    """xi_l(r) = (i^l)/(2 pi^2) int dk k^2 P(k) j_l(kr)  — returns
    (r, xi) with the i^l phase for even l folded in as (-1)^(l/2)."""
    F = k ** 3 * np.asarray(pk) / (2 * np.pi ** 2)
    r, xi = fftlog_mellin(k, F, _mellin_sph_bessel(ell), q=q)
    sign = (-1) ** (ell // 2) if ell % 2 == 0 else 1.0
    return r, sign * xi


def xi_to_pk_fftlog(r, xi, ell=0, q=1.5):
    """P_l(k) = 4 pi (-i)^l int dr r^2 xi(r) j_l(kr)."""
    F = 4 * np.pi * r ** 3 * np.asarray(xi)
    k, pk = fftlog_mellin(r, F, _mellin_sph_bessel(ell), q=q)
    sign = (-1) ** (ell // 2) if ell % 2 == 0 else 1.0
    return k, sign * pk

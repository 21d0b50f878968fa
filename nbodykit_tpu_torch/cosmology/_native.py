"""ctypes binding of the native Einstein-Boltzmann kernel (counterpart of
``nbodykit_tpu/cosmology/_native.py``).

The library is the repo's root ``csrc/boltzmann_kernel.cpp``, built by
``g++`` into ``nbodykit_tpu_torch/_build/`` at first use
(:func:`nbodykit_tpu_torch._build.load_host`). A failed build, or a
non-zero return code from the solve, raises: there is no fallback to the
Python BDF path, which a caller selects only with
``BoltzmannSolver(..., use_native=False)``.
"""

import ctypes

import numpy as np

from .. import _build

LIBRARY = 'boltzmann_kernel'
NAMES = ('phi', 'psi', 'd_cdm', 't_cdm', 'd_b', 't_b',
         'd_g', 't_g', 'd_ur', 't_ur', 'd_ncdm', 't_ncdm')


def _dp(x):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


_D, _I = ctypes.c_double, ctypes.c_int
_P = ctypes.POINTER(ctypes.c_double)
# nbk_solve_mode's parameters, in order (csrc/boltzmann_kernel.cpp)
ARGTYPES = ([_D, _D, _I, _P, _P, _P, _P,            # background grid
             _I, _P, _P, _P,                        # ncdm tables
             _I, _P, _P, _P, _P,                    # ncdm quadrature
             _I, _I, _I, _I,                        # hierarchy lmax
             _D, _D, _D, _D,                        # H0^2 Omega_g/ur/b/cdm
             _D, _D, _D, _D,                        # k, lna0, x_tc, x_sw
             _P, _I, _D,                            # y0, nvar, rtol
             _I, _P, _P, ctypes.POINTER(ctypes.c_long)])


def _lib():
    lib = _build.load_host(LIBRARY)
    lib.nbk_solve_mode.restype = ctypes.c_int
    lib.nbk_solve_mode.argtypes = ARGTYPES
    return lib


def solve_mode_native(solver, k, lna_out):
    """Run one k-mode through the C++ kernel; returns the same dict as
    ``BoltzmannSolver._solve_mode_py``. Raises ``RuntimeError`` on a
    non-zero return code."""
    lib = _lib()
    bg = solver.bg
    ns = len(bg.ncdm)
    ng = len(solver._g_lnHc)

    lna0 = solver._lna_start(k)
    x_tc = max(solver._tca_switch_lna(k, lna0), lna0)
    x_sw = solver._rsa_switch_lna(k, lna0)
    if not np.isfinite(x_sw) or x_sw <= x_tc or x_sw >= 0.0:
        x_sw = 1.0            # sentinel: no RSA phase
    y0 = np.ascontiguousarray(solver._initial(k, lna0))

    lna_out = np.ascontiguousarray(np.asarray(lna_out, dtype='f8'))
    nout = len(lna_out)
    out = np.empty((nout, 12))
    stats = np.zeros(2, dtype=np.int64)

    if ns:
        lndrho = np.ascontiguousarray(np.stack(solver._g_ncdm_lndrho))
        wtab = np.ascontiguousarray(np.stack(solver._g_ncdm_w))
        cg2tab = np.ascontiguousarray(np.stack(solver._g_ncdm_cg2))
        y0n = np.array([s.y0 for s in bg.ncdm])
    else:
        lndrho = wtab = cg2tab = np.zeros((1, ng))
        y0n = np.zeros(1)

    H02 = bg.H0 ** 2
    rc = lib.nbk_solve_mode(
        ctypes.c_double(solver._gx0), ctypes.c_double(solver._gdx),
        ctypes.c_int(ng),
        _dp(solver._g_lnHc), _dp(solver._g_lntau),
        _dp(solver._g_lndk), _dp(solver._g_cs2),
        ctypes.c_int(ns), _dp(lndrho), _dp(wtab), _dp(cg2tab),
        ctypes.c_int(solver.nq), _dp(solver._q), _dp(solver._Wq),
        _dp(solver._dlnf), _dp(y0n),
        ctypes.c_int(solver.lg), ctypes.c_int(solver.lp),
        ctypes.c_int(solver.lu), ctypes.c_int(solver.ln),
        ctypes.c_double(H02 * bg.Omega_g),
        ctypes.c_double(H02 * bg.Omega_ur),
        ctypes.c_double(H02 * bg.Omega_b),
        ctypes.c_double(H02 * bg.Omega_cdm),
        ctypes.c_double(k), ctypes.c_double(lna0),
        ctypes.c_double(x_tc), ctypes.c_double(x_sw),
        _dp(y0), ctypes.c_int(solver.nvar),
        ctypes.c_double(solver.rtol),
        ctypes.c_int(nout), _dp(lna_out),
        _dp(out), stats.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc != 0:
        raise RuntimeError("native Boltzmann solve failed at k=%g /Mpc "
                           "(return code %d)" % (k, rc))
    return {n: out[:, i].copy() for i, n in enumerate(NAMES)}

"""Field-level inference: a Gaussian posterior over the linear modes,
optimized with ``torch.autograd`` through the whole forward model
(counterpart of ``nbodykit_tpu/forward/infer.py``).

A unit-normal prior on the real whitenoise leaf g (one number a lattice
cell; modes = r2c(g) * sqrt(Ntot) * amp) and a Gaussian likelihood of
the modelled density against the observed painted field:

  -log P(g | obs) = 0.5 ||density(modes(g)) - obs||^2 / sigma^2
                  + 0.5 ||g||^2  (+ const).

FFTRecon (BAO reconstruction) is the classical baseline the recovered
field must beat on cross-correlation with the truth.

With P ranks the fields are this rank's slabs and every sum runs over
the ranks (``global_sum``, ``replicated_sum``): the loss, the
metrics and Adam's steps are the one-rank run's.
"""

import numpy as np
import torch

from ..parallel.runtime import global_sum, replicated_sum


def _hermitian(pm, dtype):
    """Double-count weights of the compressed kz half-space on this
    rank's slab."""
    w = torch.full(pm.local_shape_complex, 2.0, dtype=dtype,
                   device=pm.device)
    w[..., 0] = 1.0
    if int(pm.Nmesh[2]) % 2 == 0:
        w[..., -1] = 1.0
    return w


def _shells(pm):
    """Integer-lattice shell index (shell = round(|k|/kf), nmesh//2
    bins, DC in shell 0, which callers drop) and hermitian weights on
    the compressed complex mesh."""
    kx, ky, kz = pm.k_list()
    kf = 2.0 * np.pi / np.asarray(pm.BoxSize, 'f8')
    n = torch.sqrt((kx / kf[0]) ** 2 + (ky / kf[1]) ** 2
                   + (kz / kf[2]) ** 2)
    nbins = int(pm.Nmesh[0]) // 2
    idx = torch.clamp(torch.floor(n + 0.5).to(torch.int32), 0, nbins)
    return idx, _hermitian(pm, n.dtype), nbins, float(kf[0])


def _shell_sum(idx, nbins, vals, comm=None):
    """The per-shell sums of ``vals`` over every rank's slab."""
    out = torch.zeros(nbins + 1, dtype=vals.dtype,
                      device=vals.device).index_add_(
        0, idx.reshape(-1).long(), vals.reshape(-1))
    return replicated_sum(out, comm)


def binned_power(pm, c):
    """Shell-averaged P(k) of complex modes ``c`` (hermitian-weighted,
    DC dropped): (k, P, nmodes)."""
    idx, w, nbins, kf = _shells(pm)
    p = w * torch.abs(c) ** 2
    psum = _shell_sum(idx, nbins, p, pm.comm)[1:]
    nsum = _shell_sum(idx, nbins, w, pm.comm)[1:]
    V = float(np.prod(pm.BoxSize))
    k = kf * torch.arange(1, nbins + 1, dtype=p.dtype, device=p.device)
    P = torch.where(nsum > 0, psum / torch.clamp(nsum, min=1) * V, 0.0)
    return k, P, nsum


def cross_correlation(pm, a, b):
    """Per-shell cross-correlation coefficient r(k) = P_ab /
    sqrt(P_aa P_bb) of two mode sets on one mesh: (k, r, nmodes), r = 0
    where a shell has no modes."""
    if a.shape != b.shape:
        raise ValueError("cross_correlation needs same-mesh modes")
    idx, w, nbins, kf = _shells(pm)
    ab = _shell_sum(idx, nbins, w * (a * torch.conj(b)).real, pm.comm)[1:]
    aa = _shell_sum(idx, nbins, w * torch.abs(a) ** 2, pm.comm)[1:]
    bb = _shell_sum(idx, nbins, w * torch.abs(b) ** 2, pm.comm)[1:]
    nsum = _shell_sum(idx, nbins, w, pm.comm)[1:]
    denom = torch.sqrt(torch.clamp(aa * bb, min=1e-300))
    k = kf * torch.arange(1, nbins + 1, dtype=ab.dtype, device=ab.device)
    r = torch.where(nsum > 0, ab / denom, 0.0)
    return k, r, nsum


def mean_cross_correlation(pm, a, b, kmax=None):
    """One scalar, the hermitian-weighted whole-field cross-correlation
    sum(Re a b*) / sqrt(sum|a|^2 sum|b|^2) over the modes with
    0 < |k| <= kmax (all when None): the recovery metric."""
    if a.shape != b.shape:
        raise ValueError("mean_cross_correlation needs same-mesh modes")
    kx, ky, kz = pm.k_list()
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    mask = _hermitian(pm, k2.dtype) * (k2 > 0)
    if kmax is not None:
        mask = mask * (k2 <= float(kmax) ** 2)
    ab = global_sum(mask * (a * torch.conj(b)).real, pm.comm)
    aa = global_sum(mask * torch.abs(a) ** 2, pm.comm)
    bb = global_sum(mask * torch.abs(b) ** 2, pm.comm)
    return ab / torch.sqrt(torch.clamp(aa * bb, min=1e-300))


def make_loss(model, obs, noise_std=0.1):
    """The negative log posterior over the real whitenoise leaf (module
    docstring); ``obs`` is an observed 1+delta field on ``model.pm``
    (this rank's slab). The value is the same on every rank."""
    obs = torch.as_tensor(obs, device=model.device).to(
        model.pm.torch_compute_dtype)
    inv = 1.0 / float(noise_std)
    comm = model.pm.comm

    def loss(white):
        d = model.density(model.modes_from_white(white))
        r = (d - obs) * inv
        return 0.5 * global_sum(r * r, comm) \
            + 0.5 * global_sum(white * white, comm)
    return loss


def linear_init(model, obs):
    """The linear-theory start of the whitenoise leaf: the observed
    overdensity taken as linear and the modes-from-white map inverted,
    white = c2r(r2c(obs - 1) / (sqrt(Ntot) amp)) (amp-zero modes drop
    to zero). Needs the lattice to be the force mesh (npart ==
    nmesh^3)."""
    lat = model.lattice
    if lat is not model.pm:
        raise ValueError('linear_init needs npart == nmesh^3 (the '
                         'lattice must be the force mesh; got ng=%d '
                         'on nmesh=%d)' % (int(lat.Nmesh[0]),
                                           int(model.pm.Nmesh[0])))
    obs = torch.as_tensor(obs, device=model.device).to(
        lat.torch_compute_dtype)
    dk = lat.r2c(obs - 1.0)
    amp = model.amp
    inv = torch.where(amp > 0, 1.0 / (np.sqrt(lat.Ntot)
                                      * torch.clamp(amp, min=1e-300)),
                      0.0)
    return lat.c2r(dk * inv)


def recover(model, obs, steps=30, lr=0.05, noise_std=0.1, white0=None):
    """Adam on the whitenoise leaf against ``obs``: each step one value
    and gradient of the whole LPT + KDK + paint map, then the JAX
    package's hand-written Adam update, in its order. Returns (white,
    losses). With P ranks the leaf and Adam's moments are this rank's
    slabs (the update is elementwise) and the losses every rank's."""
    loss_fn = make_loss(model, obs, noise_std)

    def vg(white):
        white = white.detach().requires_grad_(True)
        val = loss_fn(white)
        g, = torch.autograd.grad(val, white)
        return val.detach(), g

    w = model.white_guess() if white0 is None else \
        torch.as_tensor(white0, device=model.device).detach()
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for t in range(1, int(steps) + 1):
        val, g = vg(w)
        losses.append(float(val))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / (1.0 - b1 ** t)
        vh = v / (1.0 - b2 ** t)
        w = w - lr * mh / (torch.sqrt(vh) + eps)
    return w, losses


def fftrecon_baseline(model, pos, R=20.0, bias=1.0, ran_seed=12345):
    """The classical baseline: FFTRecon (LGS) of the evolved particles
    ``pos``, as linear-field modes on the particle lattice (directly
    cross-correlatable with the truth modes). The randoms are a uniform
    numpy catalog of the same size from ``ran_seed``. With P ranks
    ``pos`` is this rank's rows, and the randoms are cut into rows as
    the JAX package shards them."""
    from ..algorithms.fftrecon import FFTRecon
    from ..source.catalog.array import ArrayCatalog

    lat = model.lattice
    box = np.asarray(lat.BoxSize, 'f8')
    rng = np.random.RandomState(ran_seed)
    ran_pos = rng.uniform(0.0, 1.0, size=(model.npart, 3)) * box
    ran = ArrayCatalog({'Position': ran_pos.astype('f8')},
                       device=lat.device, comm=lat.comm, BoxSize=box)
    # the evolved particles as this rank's rows of the data
    data = ran._rows_catalog({'Position': torch.as_tensor(pos).detach()},
                             {'BoxSize': box})
    recon = FFTRecon(data, ran, Nmesh=int(lat.Nmesh[0]), bias=bias,
                     R=R, BoxSize=box, scheme='LGS',
                     resampler=model.resampler)
    field = recon.run()
    return lat.r2c(field.value.to(lat.torch_dtype))

"""Weighted 2-D histograms, the (k, mu) binning engine (counterpart of
``nbodykit_tpu/ops/histogram.py``).

The JAX package bins with a one-hot matrix product on the TPU's matrix
unit and with ``bincount`` elsewhere; the port uses the bincount form
(exact in the weights' dtype) on every device.
"""

import numpy as np
import torch


def lattice_shell_index(isq, nbins):
    """Exact integer-lattice shell index floor(sqrt(isq)), clipped to
    ``nbins - 1``: an f32 square root corrected by two integer compares,
    so modes ON a shell boundary (perfect squares) land exactly."""
    isq = isq.to(torch.int32)
    r = torch.sqrt(isq.to(torch.float32)).to(torch.int32)
    r = r - (r * r > isq).to(torch.int32) \
        + ((r + 1) * (r + 1) <= isq).to(torch.int32)
    return torch.clamp(r, max=nbins - 1)


def lattice_shell_edges(xedges, unit):
    """Integer squared-norm thresholds (int32 numpy) for digitizing exact
    lattice norms |i|^2 against physical edges ``xedges`` on a lattice of
    fundamental ``unit``: for integer v, (e <= v) == (ceil(e) <= v)."""
    qe = np.ceil((np.asarray(xedges, dtype='f8') / float(unit)) ** 2)
    return np.clip(qe, 0, np.iinfo(np.int32).max).astype('i4')


def hist2d_weighted(abin, bbin, weights, NA, NB):
    """Weighted 2-D histograms of flat bin-index streams: one (NA, NB)
    tensor per weight stream, in the weights' dtype."""
    multi = abin.long() * NB + bbin.long()
    return [torch.bincount(multi, weights=w, minlength=NA * NB)
            .reshape(NA, NB) for w in weights]

"""FOF: the friends-of-friends halo finder on one device (counterpart of
``nbodykit_tpu/algorithms/fof.py``; its domain-decomposed branch waits
for the multi-GPU port).

1. Particles are hashed to cells of the linking length and ordered by
   cell (:class:`..ops.devicehash.DeviceGridHash`: the radix rank
   kernel on the card).
2. Labels start as the sorted indices; each sweep takes, for every
   particle, the least label within the linking length over the 27
   neighbour cells, then jumps pointers twice, until nothing changes.
   The linked pairs are listed once and each sweep is a min over the
   list (``links`` mode), or, when the list does not fit the device's
   free memory, each sweep searches the neighbour cells (``search``
   mode): CUDA kernels on the card (``ops/fof_cuda.py``).
3. Groups are relabelled by descending size on the device (label 0:
   below ``nmin``), and the halo columns (Length, periodic CMPosition,
   CMVelocity) are segment sums over the labels.
"""

import logging

import numpy as np
import torch

from ..utils import stage
from ..parallel.runtime import require_one_rank


def _fof_labels(pos, BoxSize, ll, periodic=True, order='auto', stats=None):
    """FOF root labels on one device.

    pos : (N, 3) positions (a tensor, or an array placed on the entry
    points' device);
    BoxSize : (3,) floats; ll : the linking length. Returns (N,) int32:
    the index of one member of each particle's group (its first in cell
    order), in input order. ``order`` picks the cell-order engine
    ('auto', 'radix', 'argsort'); ``stats`` receives the sweep count,
    the sweeps' mode and the number of links."""
    from ..ops.devicehash import local_fof_labels
    box = np.asarray(BoxSize, dtype='f8')
    return local_fof_labels(pos, None, box, float(ll), periodic=periodic,
                            order=order, stats=stats)


def size_ordered_labels(roots, nmin):
    """(labels, nhalo): groups of at least ``nmin`` members labelled 1,
    2, ... by descending size (ties in the order of their root index),
    every other particle 0; int64 on the roots' device. The labels of
    the JAX package's ``np.unique`` relabel."""
    uniq, inv, counts = torch.unique(roots, sorted=True, return_inverse=True,
                                     return_counts=True)
    eligible = counts >= nmin
    idx = torch.nonzero(eligible).squeeze(1)
    order = torch.argsort(-counts[idx], stable=True)
    label_map = torch.zeros(uniq.shape[0], dtype=torch.int64,
                            device=roots.device)
    label_map[idx[order]] = torch.arange(1, idx.shape[0] + 1,
                                         dtype=torch.int64,
                                         device=roots.device)
    return label_map[inv], int(idx.shape[0])


class FOF(object):
    """Friends-of-friends groups of a CatalogSource, on its device.

    source : catalog with a Position column and attrs['BoxSize'];
    linking_length : in units of the mean inter-particle separation
    unless ``absolute``; nmin : the least group size; periodic : wrap at
    the box boundary.

    Attributes: ``labels``, (N,) int64 halo label per particle, 0 for
    particles in no group of ``nmin`` or more, halos by descending size
    (label 1 is the largest); ``sweeps``, the sweeps to the fixpoint;
    ``sweep_mode``, the sweeps' mode ('links', or 'search' where the
    link list would not fit the device's free memory); ``links``, the
    number of linked pairs.
    """

    logger = logging.getLogger('FOF')

    def __init__(self, source, linking_length, nmin, absolute=False,
                 periodic=True):
        require_one_rank(source, 'FOF')
        if 'Position' not in source:
            raise ValueError("source must have a Position column")
        self._source = source
        self.device = source.device
        self.attrs = {
            'linking_length': linking_length,
            'nmin': nmin,
            'absolute': absolute,
            'periodic': periodic,
        }
        if 'BoxSize' in source.attrs:
            self.attrs['BoxSize'] = np.ones(3) * np.asarray(
                source.attrs['BoxSize'], dtype='f8')
        else:
            raise ValueError("source must define attrs['BoxSize']")

        if not absolute:
            mean_sep = (np.prod(self.attrs['BoxSize'])
                        / len(source)) ** (1. / 3)
            linking_length = linking_length * mean_sep
        self._ll = float(linking_length)

        self.labels = self.run()

    def run(self):
        stats = {}
        roots = _fof_labels(self._source['Position'], self.attrs['BoxSize'],
                            self._ll, periodic=self.attrs['periodic'],
                            stats=stats)
        self.sweeps = stats['sweeps']
        self.sweep_mode = stats['sweep_mode']
        self.links = stats['links']
        with stage('fof_relabel'):
            labels, self._halo_count = size_ordered_labels(
                roots, self.attrs['nmin'])
        return labels

    def find_features(self, peakcolumn=None):
        """The halo catalog (label 0, the particles in no halo, first):
        an ArrayCatalog with Length, CMPosition, CMVelocity, and
        PeakPosition (PeakVelocity) when ``peakcolumn`` is given."""
        from ..source.catalog.array import ArrayCatalog
        with stage('fof_catalog'):
            data = fof_catalog(self._source, self.labels,
                               self._halo_count + 1,
                               self.attrs['BoxSize'],
                               periodic=self.attrs['periodic'],
                               peakcolumn=peakcolumn)
        return ArrayCatalog(data, device=self.device, **self.attrs)

    def to_halos(self, particle_mass, cosmo, redshift, mdef='vir'):
        """A HaloCatalog of the halos (label 0 dropped) with Position,
        Velocity, Length and Mass = Length * particle_mass."""
        from ..source.catalog.array import ArrayCatalog
        from ..source.catalog.halos import HaloCatalog
        features = self.find_features()
        with stage('to_halos'):
            data = {
                'Position': features['CMPosition'][1:],
                'Velocity': features['CMVelocity'][1:],
                'Length': features['Length'][1:],
            }
            attrs = dict(self.attrs)
            attrs.update(particle_mass=particle_mass, redshift=redshift,
                         mdef=mdef)
            cat = ArrayCatalog(data, device=self.device, **attrs)
            return HaloCatalog(cat, cosmo=cosmo, redshift=redshift,
                               mdef=mdef, mass='Mass', position='Position',
                               velocity='Velocity',
                               particle_mass=particle_mass)


def fof_catalog(source, labels, nhalo, BoxSize, periodic=True,
                peakcolumn=None):
    """Per-halo reductions over ``labels`` (int, in [0, nhalo)): Length,
    the periodic centre of mass (offsets from each halo's least-index
    member, minimum-imaged), the mean velocity, and with ``peakcolumn``
    the position (velocity) of each halo's densest member (the highest
    index among ties). Returns a dict of tensors on the labels'
    device."""
    pos = source['Position']
    dev = pos.device
    labels = torch.as_tensor(labels, device=dev).to(torch.int64)
    box = torch.as_tensor(np.asarray(BoxSize, 'f8'), dtype=pos.dtype,
                          device=dev)
    N = labels.shape[0]

    length = torch.bincount(labels, minlength=nhalo)

    # each halo's least member index (0 for an empty label, as the JAX
    # package's in-order scatter leaves it)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    first_idx = torch.zeros(nhalo, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, labels, idx, 'amin', include_self=False)
    ref = pos[first_idx]
    d = pos - ref[labels]
    if periodic:
        d = d - torch.round(d / box) * box
    dsum = torch.zeros((nhalo, 3), dtype=pos.dtype, device=dev) \
        .index_add_(0, labels, d)
    del d
    lsafe = torch.clamp(length, min=1).to(pos.dtype)[:, None]
    cm = ref + dsum / lsafe
    if periodic:
        cm = torch.remainder(cm, box)

    data = {'Length': length, 'CMPosition': cm}

    if 'Velocity' in source:
        vel = source['Velocity']
        vsum = torch.zeros((nhalo, 3), dtype=vel.dtype, device=dev) \
            .index_add_(0, labels, vel)
        data['CMVelocity'] = vsum / lsafe
    else:
        data['CMVelocity'] = torch.zeros((nhalo, 3), dtype=pos.dtype,
                                         device=dev)

    if peakcolumn is not None and peakcolumn in source:
        density = source[peakcolumn]
        dmax = torch.full((nhalo,), -np.inf, dtype=density.dtype,
                          device=dev).scatter_reduce(0, labels, density,
                                                     'amax')
        ispeak = density >= dmax[labels]
        # non-peak particles go to a spare bucket (nhalo)
        peak_idx = torch.zeros(nhalo + 1, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, torch.where(ispeak, labels, nhalo), idx,
                            'amax')[:nhalo]
        data['PeakPosition'] = pos[peak_idx]
        if 'Velocity' in source:
            data['PeakVelocity'] = source['Velocity'][peak_idx]

    return data

"""FOF: the friends-of-friends halo finder (counterpart of
``nbodykit_tpu/algorithms/fof.py``).

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

Across ranks (a catalog with a ``comm`` of P ranks) the sweep runs
domain-decomposed when the linking length fits a slab
(:func:`_fof_labels_distributed`): the particles and their lower-face
ghosts go to the owners of balanced x-slabs, each rank finds its local
components once, and a merge loop stitches them across the slabs into
groups rooted at their least global index. The halo columns are sums
over every rank's rows. A linking length wider than a slab gathers the
catalog on every rank and runs the one-device FOF, as the JAX package
does; :attr:`FOF.branch` says which ran.
"""

import logging

import numpy as np
import torch

from ..utils import stage
from ..parallel.runtime import mesh_size


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


def _fof_labels_distributed(pos, BoxSize, ll, mesh, periodic=True,
                            max_ncell=4096, stats=None):
    """FOF root labels across the ranks of ``mesh``: every particle's
    least global index in its group, for this rank's rows (the JAX
    package's distributed FOF, the reference's parallel FOF).

    1. The particles, and a ghost copy of those within ``ll`` of their
       slab's lower face, go to the owners of x-slabs balanced on the
       particles (:func:`..parallel.domain.slab_route`, ``'down'``):
       every linked pair is then whole on one rank.
    2. Each rank finds the connected components of what it received,
       once (:func:`..ops.devicehash.local_fof_labels`).
    3. Until no label changes on any rank: every copy takes its
       particle's label through the same route, each component takes
       the least label of its copies, and each copy's label goes back
       to its particle's rank as a min (shared ghosts stitch the
       components across the slabs).

    pos : (n, 3) this rank's positions; the rows of the ranks are the
    catalog in rank order. ``stats``, a dict, receives the merge rounds
    and the local components' sweeps, sweep mode and links. Returns (n,)
    labels (int32 below 2**31 particles, else int64)."""
    from ..ops.devicehash import local_fof_labels
    from ..parallel.domain import (rows_layout, scatter_reduce_by_index,
                                   slab_route)
    n = pos.shape[0]
    dev = pos.device
    box = np.asarray(BoxSize, dtype='f8')
    counts, start = rows_layout(n, mesh)
    N = sum(counts)
    idt = torch.int32 if N < 2 ** 31 - 1 else torch.int64
    big = torch.iinfo(idt).max
    gid = start + torch.arange(n, dtype=idt, device=dev)
    with stage('fof_route'):
        route, _, _ = slab_route(pos, box, ll, mesh, ghosts='down',
                                 periodic=periodic, balance=True)
        (pos_r, gid_r), ok, _ = route.exchange([pos, gid])
        got = torch.nonzero(ok).squeeze(1)
        pos_r, gid_r = pos_r[got].contiguous(), gid_r[got]
    local = {'sweeps': 0, 'sweep_mode': None, 'links': 0}
    root = local_fof_labels(pos_r, None, box, float(ll), periodic=periodic,
                            max_ncell=max_ncell, stats=local).long() \
        if pos_r.shape[0] else got
    glab = gid.clone()
    rounds = 0
    while True:
        with stage('fof_merge'):
            (lab_r,), _, _ = route.exchange([glab])
            comp = torch.full((root.shape[0],), big, dtype=idt, device=dev) \
                .scatter_reduce_(0, root, lab_r[got], 'amin')
            new = scatter_reduce_by_index(gid_r, comp[root], N, mesh,
                                          op='min', init=glab, counts=counts)
            changed = mesh.all_reduce(
                (new != glab).any().to(torch.int32).reshape(1), 'max')
            glab = new
            rounds += 1
            if not int(changed):
                break
    if stats is not None:
        stats.update(local, merge_rounds=rounds)
    return glab


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

    Attributes: ``labels``, (N,) int64 halo label per particle (this
    rank's rows), 0 for particles in no group of ``nmin`` or more, halos
    by descending size (label 1 is the largest; equal sizes in the order
    of their roots); ``branch``, 'one_rank', 'slab' (across ranks) or
    'gathered' (across ranks, a linking length wider than a slab);
    ``sweeps``, the sweeps to the fixpoint; ``sweep_mode``, the sweeps'
    mode ('links', or 'search' where the link list would not fit the
    device's free memory); ``links``, the number of linked pairs
    (``sweeps``, ``sweep_mode`` and ``links`` are those of this rank's
    local components on the slab branch, which also sets
    ``merge_rounds``).
    """

    logger = logging.getLogger('FOF')

    def __init__(self, source, linking_length, nmin, absolute=False,
                 periodic=True):
        if 'Position' not in source:
            raise ValueError("source must have a Position column")
        self._source = source
        self.comm = source.comm
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
                        / source.csize) ** (1. / 3)
            linking_length = linking_length * mean_sep
        self._ll = float(linking_length)

        self.labels = self.run()

    def run(self):
        nproc = mesh_size(self.comm)
        if nproc > 1 and self._ll <= self.attrs['BoxSize'][0] / nproc:
            self.branch = 'slab'
            self.logger.info("FOF branch slab")
            return self._run_distributed()
        pos = self._source['Position']
        if nproc > 1:
            # the JAX package gathers the catalog (as_numpy) when the
            # linking length exceeds a slab: every rank runs the whole
            from ..parallel.domain import allgather_rows, rows_layout
            self.branch = 'gathered'
            counts, start = rows_layout(pos.shape[0], self.comm)
            pos = allgather_rows(pos, self.comm)
        else:
            self.branch = 'one_rank'
        self.logger.info("FOF branch %s", self.branch)
        stats = {}
        roots = _fof_labels(pos, self.attrs['BoxSize'], self._ll,
                            periodic=self.attrs['periodic'], stats=stats)
        self.sweeps = stats['sweeps']
        self.sweep_mode = stats['sweep_mode']
        self.links = stats['links']
        with stage('fof_relabel'):
            labels, self._halo_count = size_ordered_labels(
                roots, self.attrs['nmin'])
        if nproc > 1:
            labels = labels[start:start + counts[self.comm.rank]]
        return labels

    def _run_distributed(self):
        """The slab branch: labels from :func:`_fof_labels_distributed`,
        relabelled by descending group size. The size of each group is
        a sum into its root's row; the roots of the groups of ``nmin``
        or more, with their sizes, reach every rank (a few per halo),
        which orders them alike (equal sizes by ascending root) and
        labels its own rows' roots; each particle then looks its root's
        label up."""
        from ..parallel.domain import (allgather_rows, gather_by_index,
                                       rows_layout, scatter_reduce_by_index)
        mesh = self.comm
        pos = self._source['Position']
        n = pos.shape[0]
        stats = {}
        roots = _fof_labels_distributed(
            pos, self.attrs['BoxSize'], self._ll, mesh,
            periodic=self.attrs['periodic'], stats=stats)
        for k in ('merge_rounds', 'sweeps', 'sweep_mode', 'links'):
            setattr(self, k, stats[k])
        with stage('fof_relabel'):
            counts, start = rows_layout(n, mesh)
            sizes = scatter_reduce_by_index(
                roots, torch.ones(n, dtype=torch.int64, device=pos.device),
                sum(counts), mesh, op='add', counts=counts)
            mine = torch.nonzero(sizes >= self.attrs['nmin']).squeeze(1)
            halos = allgather_rows(torch.stack([start + mine, sizes[mine]],
                                               dim=1), mesh)
            order = torch.argsort(-halos[:, 1], stable=True)
            self._halo_count = int(halos.shape[0])
            label_map = torch.zeros(n, dtype=torch.int64, device=pos.device)
            root_of = halos[order, 0] - start
            here = (root_of >= 0) & (root_of < n)
            label_map[root_of[here]] = torch.arange(
                1, self._halo_count + 1, device=pos.device)[here]
            return gather_by_index(roots, label_map, mesh)

    def _features(self, peakcolumn=None):
        with stage('fof_catalog'):
            return fof_catalog(self._source, self.labels,
                               self._halo_count + 1, self.attrs['BoxSize'],
                               periodic=self.attrs['periodic'],
                               peakcolumn=peakcolumn)

    def find_features(self, peakcolumn=None):
        """The halo catalog (label 0, the particles in no halo, first):
        an ArrayCatalog with Length, CMPosition, CMVelocity, and
        PeakPosition (PeakVelocity) when ``peakcolumn`` is given. Across
        ranks each rank holds its row split of the halos, as the JAX
        package shards them."""
        from ..source.catalog.array import ArrayCatalog
        return ArrayCatalog(self._features(peakcolumn), device=self.device,
                            comm=self.comm, **self.attrs)

    def to_halos(self, particle_mass, cosmo, redshift, mdef='vir'):
        """A HaloCatalog of the halos (label 0 dropped) with Position,
        Velocity, Length and Mass = Length * particle_mass (across
        ranks, each rank's row split of the halos)."""
        from ..source.catalog.array import ArrayCatalog
        from ..source.catalog.halos import HaloCatalog
        features = self._features()
        with stage('to_halos'):
            data = {
                'Position': features['CMPosition'][1:],
                'Velocity': features['CMVelocity'][1:],
                'Length': features['Length'][1:],
            }
            attrs = dict(self.attrs)
            attrs.update(particle_mass=particle_mass, redshift=redshift,
                         mdef=mdef)
            cat = ArrayCatalog(data, device=self.device, comm=self.comm,
                               **attrs)
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
    device, whole (nhalo rows) on every rank.

    Across ranks (the source's ``comm``) the indices are global, each
    sum, least index and largest density is this rank's rows' reduced
    over the ranks, and a member's position reaches every rank from the
    rank that holds it (one rank adds it, the others zeros). The sums of
    offsets and velocities then add in another order than on one rank:
    the same to the rounding of those sums."""
    from ..parallel.domain import rows_layout
    comm = source.comm
    ranks = mesh_size(comm) > 1
    pos = source['Position']
    dev = pos.device
    labels = torch.as_tensor(labels, device=dev).to(torch.int64)
    box = torch.as_tensor(np.asarray(BoxSize, 'f8'), dtype=pos.dtype,
                          device=dev)
    N = labels.shape[0]
    counts, start = rows_layout(N, comm)

    def total(t, op='sum'):
        return comm.all_reduce(t, op) if ranks else t

    def rows_of(col, idx):
        """The rows ``idx`` (global) of column ``col`` on every rank."""
        loc = idx - start
        here = (loc >= 0) & (loc < N)
        out = torch.zeros((idx.shape[0],) + tuple(col.shape[1:]),
                          dtype=col.dtype, device=dev)
        out[here] = col[loc[here]]
        return total(out)

    length = total(torch.bincount(labels, minlength=nhalo))

    # each halo's least member index (0 for an empty label, as the JAX
    # package's in-order scatter leaves it)
    idx = start + torch.arange(N, dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    first_idx = total(torch.full((nhalo,), big, dtype=torch.int64,
                                 device=dev).scatter_reduce(
        0, labels, idx, 'amin'), 'min')
    first_idx = torch.where(first_idx == big, 0, first_idx)
    ref = rows_of(pos, first_idx)
    d = pos - ref[labels]
    if periodic:
        d = d - torch.round(d / box) * box
    dsum = total(torch.zeros((nhalo, 3), dtype=pos.dtype, device=dev)
                 .index_add_(0, labels, d))
    del d
    lsafe = torch.clamp(length, min=1).to(pos.dtype)[:, None]
    cm = ref + dsum / lsafe
    if periodic:
        cm = torch.remainder(cm, box)

    data = {'Length': length, 'CMPosition': cm}

    if 'Velocity' in source:
        vel = source['Velocity']
        vsum = total(torch.zeros((nhalo, 3), dtype=vel.dtype, device=dev)
                     .index_add_(0, labels, vel))
        data['CMVelocity'] = vsum / lsafe
    else:
        data['CMVelocity'] = torch.zeros((nhalo, 3), dtype=pos.dtype,
                                         device=dev)

    if peakcolumn is not None and peakcolumn in source:
        density = source[peakcolumn]
        dmax = total(torch.full((nhalo,), -np.inf, dtype=density.dtype,
                                device=dev).scatter_reduce(
            0, labels, density, 'amax'), 'max')
        ispeak = density >= dmax[labels]
        # non-peak particles go to a spare bucket (nhalo)
        peak_idx = total(torch.zeros(nhalo + 1, dtype=torch.int64,
                                     device=dev).scatter_reduce(
            0, torch.where(ispeak, labels, nhalo), idx, 'amax')[:nhalo],
            'max')
        data['PeakPosition'] = rows_of(pos, peak_idx)
        if 'Velocity' in source:
            data['PeakVelocity'] = rows_of(source['Velocity'], peak_idx)

    return data

"""Pair counting (counterpart of
``nbodykit_tpu/algorithms/pair_counters/core.py``).

Weighted pair counts binned in r ('1d'), (r, mu) ('2d'), (rp, pi)
('projected') or theta ('angular'): the secondaries are hashed into
cells at least r_max wide (:class:`...ops.devicehash.GridHash`, f64), the
queries are put in the grid's cell order, and
:func:`...ops.paircount_cuda.paircount_hist` bins every candidate pair
of the neighbour cells (the CUDA kernel on the card, the plain fold on
the CPU). Positions and weights are f64 throughout.

:func:`paircount` counts on one device; :func:`paircount_dist` across
the ranks of a mesh: the primaries go to the owners of x-slabs balanced
on them, the secondaries to the same slabs with ghost copies within
r_max of both faces, each rank counts its primaries against what it
holds, and the histograms are summed over the ranks.
"""

import numpy as np
import torch

from ... import resolve_device
from ...ops.devicehash import GridHash
from ...ops.paircount_cuda import paircount_hist


def rmax_of(mode, edges, pimax=None):
    """The largest separation a mode and its edges count."""
    edges = np.asarray(edges, dtype='f8')
    if mode == 'angular':
        return float(2 * np.sin(0.5 * np.radians(edges[-1])))
    if mode == 'projected':
        return float(np.sqrt(edges[-1] ** 2 + pimax ** 2))
    return float(edges[-1])


def _mode_setup(pos1, pos2, box, edges, mode, Nmu, pimax, grid_origin,
                periodic):
    """The mode's work coordinates (>= 0), working box, radial edges,
    largest separation, bin counts and periodicity. Angular positions
    are unit vectors, shifted by 2 into a box of 4, binned in chords."""
    box = np.asarray(box, dtype='f8')
    edges = np.asarray(edges, dtype='f8')
    if mode == 'angular':
        redges = 2 * np.sin(0.5 * np.radians(edges))
        work_box = np.ones(3) * 4.0
        p1 = pos1 + 2.0
        p2 = pos2 + 2.0
        periodic = False
    else:
        redges = edges
        work_box = box
        org = torch.as_tensor(np.broadcast_to(
            np.asarray(grid_origin, dtype='f8'), (3,)).copy(),
            device=pos1.device)
        p1 = pos1 - org
        p2 = pos2 - org

    if mode == '1d':
        rmax, nb2 = redges[-1], 1
    elif mode == '2d':
        rmax, nb2 = redges[-1], Nmu
    elif mode == 'projected':
        rmax, nb2 = np.sqrt(redges[-1] ** 2 + pimax ** 2), int(pimax)
    elif mode == 'angular':
        rmax, nb2 = redges[-1], 1
    else:
        raise ValueError("unknown mode %r" % mode)
    nb1 = len(redges) - 1
    return p1, p2, work_box, redges, float(rmax), nb1, nb2, periodic


def _package(npairs, wpairs, nb1, nb2):
    """The in-range radial bins (1..nb1) of the flat histograms."""
    npairs = np.asarray(npairs).reshape(nb1 + 2, nb2)
    wpairs = np.asarray(wpairs).reshape(nb1 + 2, nb2)
    return dict(npairs=npairs[1:nb1 + 1].squeeze(),
                wnpairs=wpairs[1:nb1 + 1].squeeze())


def _as_f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype='f8'), device=device)


def paircount_inputs(pos1, w1, pos2, w2, box, edges, mode='1d', Nmu=None,
                     pimax=None, los=2, periodic=True, is_auto=False,
                     grid_origin=0.0, pair_los='axis', device=None):
    """The arguments of :func:`...ops.paircount_cuda.paircount_hist` for
    a count (the parameters of :func:`paircount`): (args, kwargs, nb1,
    nb2), args = (grid, w2_s, p1, w1, live, ci1, r2edges, mode) with the
    queries in the grid's cell order (an auto count queries the grid's
    own sorted points, whose pairs the kernel counts once and doubles)."""
    dev = pos1.device if isinstance(pos1, torch.Tensor) \
        else resolve_device(device)
    pos1 = _as_f64(pos1, dev)
    pos2 = pos1 if is_auto else _as_f64(pos2, dev)
    w1 = torch.ones(pos1.shape[0], dtype=torch.float64, device=dev) \
        if w1 is None else _as_f64(w1, dev)
    w2 = w1 if is_auto else (
        torch.ones(pos2.shape[0], dtype=torch.float64, device=dev)
        if w2 is None else _as_f64(w2, dev))

    p1, p2, work_box, redges, rmax, nb1, nb2, periodic = _mode_setup(
        pos1, pos2, box, edges, mode, Nmu, pimax, grid_origin, periodic)
    grid = GridHash(p2, work_box, rmax, periodic=periodic)
    w2_s = w2[grid.order].contiguous()
    if is_auto:
        args = _hist_args(grid, w2_s, grid.pos_s, w2_s, redges, mode,
                          in_cell_order=True)
    else:
        args = _hist_args(grid, w2_s, p1, w1, redges, mode)
    return args, _hist_kwargs(nb2, pimax, los, grid_origin, pair_los,
                              is_auto), nb1, nb2


def _hist_args(grid, w2_s, p1, w1, redges, mode, in_cell_order=False):
    """The positional arguments of ``paircount_hist``: the queries put in
    the grid's cell order (unless they are already), all live."""
    ci1 = grid.cell_of(p1)
    if not in_cell_order:
        qorder = grid.cell_order(ci1)
        p1, w1, ci1 = p1[qorder], w1[qorder], ci1[qorder]
    live = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    return (grid, w2_s, p1.contiguous(), w1.contiguous(), live,
            ci1.contiguous(), redges ** 2, mode)


def _hist_kwargs(nb2, pimax, los, grid_origin, pair_los, is_auto):
    return dict(nb2=nb2, pimax=pimax,
                los='midpoint' if pair_los == 'midpoint' else int(los),
                origin=np.broadcast_to(np.asarray(grid_origin, dtype='f8'),
                                       (3,)),
                is_auto=is_auto)


def paircount(pos1, w1, pos2, w2, box, edges, mode='1d', Nmu=None,
              pimax=None, los=2, periodic=True, is_auto=False,
              grid_origin=0.0, pair_los='axis', device=None):
    """Weighted pair counts on one device.

    pos1, w1 : primaries (N1, 3), (N1,) (w1 None: ones); pos2, w2 : the
    secondaries (the same arrays for an auto count: set ``is_auto``);
    tensors stay on their device, arrays go to ``device`` (the entry
    points' device by default); box : (3,) box, the wrap when
    ``periodic``; edges : r for '1d'/'2d', rp for 'projected', theta in
    degrees for 'angular'; Nmu : mu bins in [0, 1] ('2d'); pimax : the
    largest line-of-sight separation, in bins of 1 ('projected'); los :
    the line-of-sight axis; is_auto : every pair with r2 == 0 (self
    pairs and coincident duplicates) drops out and each pair counts
    twice, the reference's Corrfunc convention; grid_origin : (3,)
    subtracted before hashing (non-periodic data may sit anywhere);
    pair_los : 'axis', or 'midpoint' (mu against the pair midpoint
    seen from the observer at the coordinate origin: survey data).

    Returns a dict of 'npairs' and 'wnpairs' arrays of the binned
    shape."""
    args, kwargs, nb1, nb2 = paircount_inputs(
        pos1, w1, pos2, w2, box, edges, mode=mode, Nmu=Nmu, pimax=pimax,
        los=los, periodic=periodic, is_auto=is_auto,
        grid_origin=grid_origin, pair_los=pair_los, device=device)
    npairs, wpairs = paircount_hist(*args, **kwargs)
    return _package(npairs.cpu().numpy(), wpairs.cpu().numpy(), nb1, nb2)


def paircount_dist(pos1, w1, pos2, w2, box, edges, mesh, mode='1d',
                   Nmu=None, pimax=None, los=2, periodic=True,
                   is_auto=False, grid_origin=0.0, pair_los='axis',
                   max_ncell=4096):
    """Weighted pair counts across the ranks of ``mesh``: the contract of
    :func:`paircount` on this rank's rows of both catalogs (the same
    result on every rank); no rank gathers a catalog.

    The primaries route to the owners of x-slabs balanced on them
    (:func:`...parallel.domain.slab_route`, no ghosts), the secondaries
    to the same slabs with ghosts on both faces, so every primary finds
    every secondary within r_max on its rank. Each rank counts with
    ``paircount_hist`` and the histograms are summed over the ranks. An
    auto count queries the owner copies against every copy held, each
    pair from both ends with every r2 == 0 pair dropped, never the
    kernel's count-once-and-double path (its queries are not the grid's
    own points). Requires r_max <= the work box's x / P (one hop of
    ghosts); the pair-count classes gather the catalogs where it does
    not hold, as the JAX package does. ``max_ncell`` caps the grid's
    cells a side."""
    from ...parallel.domain import slab_route
    dev = mesh.device
    pos1 = _as_f64(pos1, dev)
    pos2 = _as_f64(pos2, dev)
    w1 = torch.ones(pos1.shape[0], dtype=torch.float64, device=dev) \
        if w1 is None else _as_f64(w1, dev)
    w2 = torch.ones(pos2.shape[0], dtype=torch.float64, device=dev) \
        if w2 is None else _as_f64(w2, dev)
    p1, p2, work_box, redges, rmax, nb1, nb2, periodic = _mode_setup(
        pos1, pos2, box, edges, mode, Nmu, pimax, grid_origin, periodic)

    route1, _, _ = slab_route(p1, work_box, rmax, mesh, ghosts=None,
                              periodic=periodic, balance=True)
    route2, _, _ = slab_route(p2, work_box, rmax, mesh, ghosts='both',
                              periodic=periodic, edges=route1.edges)
    (p1_r, w1_r), ok1, _ = route1.exchange([p1, w1])
    (p2_r, w2_r), ok2, _ = route2.exchange([p2, w2])
    got1 = torch.nonzero(ok1).squeeze(1)
    got2 = torch.nonzero(ok2).squeeze(1)
    nbins = (nb1 + 2) * nb2
    if got1.shape[0] and got2.shape[0]:
        grid = GridHash(p2_r[got2], work_box, rmax, periodic=periodic,
                        max_ncell=max_ncell)
        w2_s = w2_r[got2][grid.order].contiguous()
        npairs, wpairs = paircount_hist(
            *_hist_args(grid, w2_s, p1_r[got1], w1_r[got1], redges, mode),
            **_hist_kwargs(nb2, pimax, los, grid_origin, pair_los, is_auto))
    else:
        npairs = torch.zeros(nbins, dtype=torch.float64, device=dev)
        wpairs = torch.zeros(nbins, dtype=torch.float64, device=dev)
    npairs = mesh.all_reduce(npairs)
    wpairs = mesh.all_reduce(wpairs)
    return _package(npairs.cpu().numpy(), wpairs.cpu().numpy(), nb1, nb2)

"""The grid hash on the device and the FOF labels of one device's
particles (counterpart of ``nbodykit_tpu/ops/devicehash.py``, without the
``shard_map`` axis: across ranks each rank runs these on its routed
particles, ``algorithms/fof._fof_labels_distributed``).

:meth:`DeviceGridHash.fold` is the plain candidate traversal the
particle algorithms fold over (:func:`.gridhash.offset_candidates`);
:class:`GridHash`, the JAX package's host-side class of
``ops/gridhash.py``, is a DeviceGridHash of f64 positions.

Particles are hashed into cells at least ``rmax`` wide, ordered by flat
cell id and located by binary search into the sorted ids: no dense cell
table. The order is :func:`.radix.order_keys` over the alphabet of
``ncells + 1`` ids (the sentinel of dead slots included): the radix rank
kernel on the card, ``argsort(stable=True)`` on the CPU, one permutation
either way. Grids of 2**31 - 1 cells or more take int64 ids and a stable
argsort, as in the JAX package.

:func:`local_fof_labels` repeats the min-label sweep with two pointer
jumps per sweep until no label changes, then maps the roots back to slot
order. The sweep runs in one of two modes (``ops/fof_cuda.py``; CUDA
kernels on the card, their plain versions on the CPU): ``links`` builds
the list of linked pairs once (a count, a cumsum, a fill) and each sweep
is a min over it; ``search`` looks the neighbour cells up in every
sweep. :func:`fof_fixpoint` takes ``links`` when the list fits the
device's free memory, ``search`` otherwise; both give the same labels in
the same sweeps.
"""

import logging

import numpy as np
import torch

from .. import resolve_device
from ..utils import stage
from .fof_cuda import (column_table, fof_link_count, fof_link_fill,
                       fof_links_sweep, fof_sweep)
from .gridhash import neighbor_offsets, offset_candidates
from .radix import order_keys
from .radix_cuda import raise_on_bad_digits


class DeviceGridHash(object):
    """Cell-hash neighbour tables on the positions' device.

    pos : (n, 3) tensor of positions in [0, box); box : (3,) domain
    size; rmax : interaction radius (cells are >= rmax per side);
    valid : (n,) bool of live entries (None: all); periodic :
    minimum-image wrapping at the box boundary; max_ncell : per-axis cap
    on the cell grid; order : the engine of the cell order ('auto',
    'radix' or 'argsort', :func:`.radix.order_keys`).

    Attributes: ``order`` (the permutation to cell order), ``flat_s``,
    ``pos_s``, ``valid_s`` (the sorted arrays), ``offsets`` (the
    deduplicated neighbour offsets), ``ncell_np``, ``box_np``.
    :meth:`columns` builds the column table of the CUDA kernels once.
    """

    def __init__(self, pos, box, rmax, valid=None, periodic=True,
                 max_ncell=4096, order='auto'):
        box = np.ones(int(pos.shape[-1])) * np.asarray(box, dtype='f8')
        ncell = np.maximum(np.floor(box / float(rmax)), 1).astype('i8')
        ncell = np.minimum(ncell, int(max_ncell))
        cellsize = box / ncell
        dev = pos.device
        self.periodic = bool(periodic)
        self.ncell_np = ncell
        self.box_np = box
        self.ncells_tot = int(np.prod(ncell))
        self.offsets = neighbor_offsets(ncell, periodic=periodic)
        self._idt = torch.int32 if self.ncells_tot < 2 ** 31 - 1 \
            else torch.int64
        self.ncell = torch.as_tensor(ncell, dtype=torch.int32, device=dev)
        self.cellsize = torch.as_tensor(cellsize, dtype=pos.dtype,
                                        device=dev)

        n = pos.shape[0]
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        flat = self._flatten(self.cell_of(pos))
        # dead slots go to a sentinel id no query can produce
        flat = torch.where(valid, flat, torch.tensor(
            self.ncells_tot, dtype=self._idt, device=dev))
        if self._idt == torch.int32:
            order = order_keys(flat, self.ncells_tot + 1, method=order)
        else:
            order = torch.argsort(flat, stable=True)
        self.flat_s = flat[order]
        self.order = order
        self.pos_s = pos[order]
        self.valid_s = valid[order]
        self._cols = None

    def _flatten(self, ci):
        nc1, nc2 = int(self.ncell_np[1]), int(self.ncell_np[2])
        ci = ci.to(self._idt)
        return (ci[..., 0] * nc1 + ci[..., 1]) * nc2 + ci[..., 2]

    def cell_of(self, p):
        """(.., 3) int32 cell coordinates: ``p / cellsize`` in the
        positions' dtype, truncated and clipped to the grid."""
        ci = (p / self.cellsize).to(torch.int32)
        return torch.minimum(torch.clamp(ci, min=0), self.ncell - 1)

    def columns(self):
        """The column table of the sorted ids on a CUDA device (built on
        the first call, :func:`.fof_cuda.column_table`); None on the
        CPU, whose plain versions do not read it."""
        if self._cols is None and self.flat_s.device.type == 'cuda':
            self._cols = column_table(self.flat_s, self.ncell_np)
        return self._cols

    def geometry(self, ll2):
        """The trailing arguments of the :mod:`.fof_cuda` functions:
        (offsets, ncell, box, ll2, periodic)."""
        return (self.offsets, self.ncell_np, self.box_np, ll2,
                self.periodic)

    def fold(self, p, ci, body, carry, block=None):
        """``carry = body(carry, j, valid, d, r2)`` over every (offset,
        slot) candidate of the queries ``p`` (m, 3) in cells ``ci`` (m, 3)
        (:func:`.gridhash.offset_candidates`: ``j`` indexes the sorted
        arrays, ``d = pos_s[j] - p``, minimum-imaged when periodic). With
        ``block``, up to that many slots a call, arrays of (m, s)."""
        for j, ok, d, r2 in offset_candidates(
                self.pos_s, self.flat_s, p, ci, self.offsets, self.ncell_np,
                self.box_np, self.periodic, block=block):
            carry = body(carry, j, ok, d, r2)
        return carry

    def sweep(self, ci_s, labels, ll2):
        """One search-mode min-label sweep over the sorted arrays
        (:func:`.fof_cuda.fof_sweep`)."""
        return fof_sweep(self.pos_s, ci_s, self.flat_s, self.valid_s,
                         labels, *self.geometry(ll2), cols=self.columns())


class GridHash(DeviceGridHash):
    """The grid hash of the particle algorithms (counterpart of the JAX
    package's host-side ``ops/gridhash.GridHash``): a
    :class:`DeviceGridHash` of f64 positions in [0, box), placed on the
    entry points' device unless already a tensor. Its callers read
    ``order``, ``pos_s``, ``offsets``, ``cell_of`` and ``fold``; the
    kernels also ``flat_s`` and ``columns()``. Cells are at least
    ``rmax`` wide, capped at DeviceGridHash's 4096 a side (the JAX class
    caps at 128: every pair within ``rmax`` is visited either way). The
    cell order is DeviceGridHash's default engine's; :meth:`cell_order`
    orders queries with the same engine."""

    def __init__(self, pos, box, rmax, periodic=True, max_ncell=4096):
        if not isinstance(pos, torch.Tensor):
            pos = torch.as_tensor(np.asarray(pos, dtype='f8'),
                                  device=resolve_device())
        pos = pos.to(torch.float64).contiguous()
        DeviceGridHash.__init__(self, pos, box, rmax, periodic=periodic,
                                max_ncell=max_ncell)
        raise_on_bad_digits(pos.device)

    def cell_order(self, ci):
        """The stable permutation of queries in cells ``ci`` (m, 3) to
        the grid's cell order, by the engine of the grid's own order
        (the rank pass on a CUDA device for int32 ids)."""
        key = self._flatten(ci)
        if self._idt == torch.int32:
            return order_keys(key, self.ncells_tot)
        return torch.argsort(key, stable=True)


# bytes a particle of the label arrays a sweep and its pointer jumps hold
# beside the link list: the labels, the sweep's output, the two jumps'
# gathers and minima, 4 bytes each
FIXPOINT_LABEL_BYTES = 16


def fits(nbytes, device):
    """Whether ``nbytes`` more can be allocated on a CUDA device: within
    the card's free memory (``cudaMemGetInfo``), else within that and the
    blocks torch's caching allocator holds unused (its statistics, a
    slower read). True on any other device."""
    if device.type != 'cuda':
        return True
    free = torch.cuda.mem_get_info(device)[0]
    if nbytes <= free:
        return True
    stats = torch.cuda.memory_stats(device)
    return nbytes <= free + stats['reserved_bytes.all.current'] \
        - stats['allocated_bytes.all.current']


def sweep_to_fixpoint(sweep, n, device):
    """Labels from ``arange(n)``: ``sweep`` (labels -> new labels, one
    Jacobi min-label sweep), each followed by two pointer jumps, until no
    label changes. Returns ((n,) int32 labels, the number of sweeps)."""
    labels = torch.arange(n, dtype=torch.int32, device=device)
    sweeps = 0
    while True:
        new = sweep(labels)
        new = torch.minimum(new, torch.index_select(new, 0, new))
        new = torch.minimum(new, torch.index_select(new, 0, new))
        sweeps += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels, sweeps


def fof_fixpoint(grid, ll, stats=None):
    """The min-label fixpoint on a grid's sorted arrays. Returns
    (labels, sweeps, ci_s): (n,) int32 root positions in the sorted
    order, the number of sweeps, and the sorted cell coordinates.

    Counts the links (:func:`.fof_cuda.fof_link_count`, a cumsum to CSR
    row offsets), then takes the ``links`` mode (the list filled once,
    each sweep a min over it) when the list and the fixpoint's label
    arrays (:data:`FIXPOINT_LABEL_BYTES` a particle) fit the device's
    memory (:func:`fits`), else the ``search`` mode (each sweep searches
    the neighbour cells): the same labels in the same sweeps. The mode
    is logged; ``stats``, a dict, receives ``sweep_mode`` and ``links``
    (E)."""
    ci_s = grid.cell_of(grid.pos_s).contiguous()
    ll2 = float(ll) ** 2
    n = grid.pos_s.shape[0]
    dev = grid.pos_s.device
    geo = grid.geometry(ll2)
    sorted_args = (grid.pos_s, ci_s, grid.flat_s, grid.valid_s,
                   grid.columns())
    counts = fof_link_count(*sorted_args, *geo)
    row = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=row[1:])
    del counts
    nlinks = int(row[-1])
    need = 4 * nlinks + FIXPOINT_LABEL_BYTES * n
    if fits(need, dev):
        mode = 'links'
        links = fof_link_fill(*sorted_args, row, *geo, nlinks=nlinks)

        def sweep(labels):
            return fof_links_sweep(row, links, labels)
    else:
        mode = 'search'
        del row

        def sweep(labels):
            return grid.sweep(ci_s, labels, ll2)
    logging.getLogger('FOF').info(
        "sweep mode %s: %d links for %d particles (the list and the "
        "labels need %d bytes)", mode, nlinks, n, need)
    if stats is not None:
        stats.update(sweep_mode=mode, links=nlinks)
    labels, sweeps = sweep_to_fixpoint(sweep, n, dev)
    return labels, sweeps, ci_s


def roots_in_slot_order(grid, labels):
    """(n,) int32: for every slot, the slot index of its root, from the
    fixpoint's root positions in the sorted order."""
    root_slot = torch.index_select(grid.order, 0, labels)
    out = torch.zeros(labels.shape[0], dtype=torch.int32,
                      device=labels.device)
    out[grid.order] = root_slot.to(torch.int32)
    return out


def local_fof_labels(pos, valid, box, ll, periodic=True, max_ncell=4096,
                     order='auto', stats=None):
    """Connected components under the linking length ``ll`` on one
    device.

    pos : (n, 3) positions (a tensor, or an array placed on the
    entry points' device: the ``device`` option, else ``cuda``); valid :
    (n,) bool or None.
    Returns (n,) int32: for every slot, the slot index of its
    component's root (the member first in cell order); invalid slots
    are their own root. ``stats``, a dict, receives the number of
    sweeps, the sweeps' mode and the number of links
    (:func:`fof_fixpoint`)."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(np.asarray(pos), device=resolve_device())
    if valid is not None and not isinstance(valid, torch.Tensor):
        valid = torch.as_tensor(np.asarray(valid), device=pos.device)
    with stage('fof_grid'):
        grid = DeviceGridHash(pos, box, ll, valid=valid, periodic=periodic,
                              max_ncell=max_ncell, order=order)
        # the rank passes count digits outside their alphabet on the
        # device; read the count before the sweeps' first sync
        raise_on_bad_digits(pos.device)
    with stage('fof_sweeps'):
        labels, sweeps, _ = fof_fixpoint(grid, ll, stats=stats)
    if stats is not None:
        stats['sweeps'] = sweeps
    return roots_in_slot_order(grid, labels)

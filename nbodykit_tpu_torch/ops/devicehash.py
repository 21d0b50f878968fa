"""The grid hash on the device and the single-device FOF labels
(counterpart of ``nbodykit_tpu/ops/devicehash.py``, without the
``shard_map`` axis: the distributed FOF waits for the multi-GPU port).

Particles are hashed into cells at least ``rmax`` wide, ordered by flat
cell id and located by binary search into the sorted ids: no dense cell
table. The order is :func:`.radix.order_keys` over the alphabet of
``ncells + 1`` ids (the sentinel of dead slots included): the radix rank
kernel on the card, ``argsort(stable=True)`` on the CPU, one permutation
either way. Grids of 2**31 - 1 cells or more take int64 ids and a stable
argsort, as in the JAX package.

:func:`local_fof_labels` repeats the min-label sweep
(:func:`.fof_cuda.fof_sweep`: a CUDA kernel on the card) with two
pointer jumps per sweep until no label changes, then maps the roots back
to slot order.
"""

import numpy as np
import torch

from .. import resolve_device
from ..utils import stage
from .fof_cuda import fof_sweep
from .gridhash import neighbor_offsets
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

    def _flatten(self, ci):
        nc1, nc2 = int(self.ncell_np[1]), int(self.ncell_np[2])
        ci = ci.to(self._idt)
        return (ci[..., 0] * nc1 + ci[..., 1]) * nc2 + ci[..., 2]

    def cell_of(self, p):
        """(.., 3) int32 cell coordinates: ``p / cellsize`` in the
        positions' dtype, truncated and clipped to the grid."""
        ci = (p / self.cellsize).to(torch.int32)
        return torch.minimum(torch.clamp(ci, min=0), self.ncell - 1)

    def sweep(self, ci_s, labels, ll2):
        """One min-label sweep over the sorted arrays
        (:func:`.fof_cuda.fof_sweep`)."""
        return fof_sweep(self.pos_s, ci_s, self.flat_s, self.valid_s,
                         labels, self.offsets, self.ncell_np, self.box_np,
                         ll2, self.periodic)


def fof_fixpoint(grid, ll):
    """The min-label fixpoint on a grid's sorted arrays: sweeps, each
    followed by two pointer jumps, until no label changes. Returns
    (labels, sweeps, ci_s): (n,) int32 root positions in the sorted
    order, the number of sweeps, and the sorted cell coordinates."""
    ci_s = grid.cell_of(grid.pos_s).contiguous()
    ll2 = float(ll) ** 2
    n = grid.pos_s.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=grid.pos_s.device)
    sweeps = 0
    while True:
        new = grid.sweep(ci_s, labels, ll2)
        new = torch.minimum(new, torch.index_select(new, 0, new))
        new = torch.minimum(new, torch.index_select(new, 0, new))
        sweeps += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels, sweeps, ci_s


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
    sweeps."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(np.asarray(pos), device=resolve_device())
    n = pos.shape[0]
    if valid is not None and not isinstance(valid, torch.Tensor):
        valid = torch.as_tensor(np.asarray(valid), device=pos.device)
    with stage('fof_grid'):
        grid = DeviceGridHash(pos, box, ll, valid=valid, periodic=periodic,
                              max_ncell=max_ncell, order=order)
        # the rank passes count digits outside their alphabet on the
        # device; read the count before the sweeps' first sync
        raise_on_bad_digits(pos.device)
    with stage('fof_sweeps'):
        labels, sweeps, _ = fof_fixpoint(grid, ll)
    if stats is not None:
        stats['sweeps'] = sweeps
    # back to slot order: root slot = original slot of the root entry
    root_slot = torch.index_select(grid.order, 0, labels)
    out = torch.zeros(n, dtype=torch.int32, device=pos.device)
    out[grid.order] = root_slot.to(torch.int32)
    return out

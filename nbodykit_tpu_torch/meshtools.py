"""Mesh coordinate utilities (counterpart of ``nbodykit_tpu/meshtools.py``).

Per-slab coordinate, mu and hermitian-weight helpers of the reference's
binning loops (``nbodykit/meshtools.py``: MeshSlab :3, SlabIterator
:217). The port bins whole arrays (algorithms/fftpower.py), so these
serve post-processing of fetched fields: they take host numpy arrays,
and tensors are fetched to the host first.
"""

import numpy as np

from .utils import as_numpy


class MeshSlab(object):
    """One y-z plane of a coordinate mesh (host-side)."""

    def __init__(self, islab, coords, axis, symmetry_axis):
        self.index = islab
        self._coords = coords
        self.axis = axis
        self.symmetry_axis = symmetry_axis
        self.hermitian_symmetric = symmetry_axis is not None

    def __str__(self):
        name = self.__class__.__name__
        return "<%s: axis=%d, index=%d>" % (name, self.axis, self.index)

    @property
    def shape(self):
        return tuple(len(np.squeeze(c)) for i, c in
                     enumerate(self._coords) if i != self.axis)

    def coords(self, i):
        """The i-th coordinate array, broadcastable on this slab."""
        c = self._coords[i]
        if i == self.axis:
            return np.take(c, self.index, axis=self.axis)
        return np.squeeze(c, axis=self.axis) if c.shape[self.axis] == 1 \
            else np.take(c, 0, axis=self.axis)

    def norm2(self):
        """|x|^2 on the slab."""
        return sum(self.coords(i) ** 2 for i in range(3))

    def mu(self, los):
        """Cosine of the angle to ``los`` on the slab."""
        norm = self.norm2() ** 0.5
        with np.errstate(invalid='ignore', divide='ignore'):
            out = sum(self.coords(i) * los[i] for i in range(3)) / norm
        if np.isscalar(out):
            return 0.0 if norm == 0 else out
        out = np.asarray(out)
        out[norm == 0] = 0.0
        return out

    @property
    def nonsingular(self):
        """True where the symmetry-axis frequency is positive (the
        hermitian-doubled modes)."""
        idx = np.ones(self.shape, dtype=bool)
        if not self.hermitian_symmetric:
            return idx
        if self.symmetry_axis == self.axis:
            if float(np.ravel(self.coords(self.axis))[0]) <= 0:
                idx[...] = False
            return idx
        c = self._coords[self.symmetry_axis]
        pos = np.squeeze(c) > 0
        shape = [1, 1]
        other_axes = [i for i in range(3) if i != self.axis]
        which = other_axes.index(self.symmetry_axis)
        shape[which] = -1
        idx[...] = pos.reshape(shape)
        return idx

    @property
    def hermitian_weights(self):
        """Double-count weights for hermitian-compressed storage.

        Follows the reference convention that the symmetry-axis Nyquist
        frequency carries a *negative* coordinate (weight 1); pass
        coords accordingly (reference meshtools.py:188-215).
        """
        if not self.hermitian_symmetric:
            return 1.0
        if self.symmetry_axis == self.axis:
            return 2.0 if float(np.ravel(
                self.coords(self.axis))[0]) > 0 else 1.0
        w = np.ones(self.shape, dtype='f4')
        w[self.nonsingular] = 2.0
        return w


def SlabIterator(coords, axis=0, symmetry_axis=None):
    """Iterate MeshSlabs over ``axis`` of a broadcastable coordinate
    list (reference meshtools.py:217)."""
    coords = [as_numpy(c) for c in coords]
    n = max(c.shape[axis] for c in coords)
    for islab in range(n):
        yield MeshSlab(islab, coords, axis, symmetry_axis)

"""BigFileMesh: load a saved mesh field (counterpart of
``nbodykit_tpu/source/mesh/bigfile.py``).

Reference: ``nbodykit/source/mesh/bigfile.py:15`` — reads a field
written by ``MeshSource.save`` back as a MeshSource (the de-facto
checkpoint format for intermediate fields). One device: the field is
read whole and moved to the mesh's device.
"""

import os

import numpy as np
import torch

from ... import resolve_device
from ...base.mesh import Field, MeshSource
from ...io.bigfile import BigFileDataset, read_attrs_file
from ...utils import bf16_from_numpy
from ...parallel.runtime import CurrentMesh, require_one_rank


class BigFileMesh(MeshSource):
    """A MeshSource backed by a saved field directory; ``device`` as for
    every mesh ('cuda' unless the caller asks for the CPU); ``comm`` one
    rank (default: the ambient mesh), as the partitioned read is not
    ported.

    As in the JAX package, :meth:`to_real_field` returns the saved
    values as a ``'real'`` Field whatever mode they were saved in: a
    mesh saved with ``mode='complex'`` comes back as a real-kind Field
    of the complex values (ROADMAP Queue C records the reference's
    behaviour)."""

    def __init__(self, path, dataset='Field', comm=None, device=None):
        # the device and the ranks first: without CUDA and without a
        # request for the CPU, or with several ranks, raise before any
        # file is read
        device = resolve_device(device)
        require_one_rank(CurrentMesh.resolve(comm), 'BigFileMesh')
        self.path = path
        self.dataset = dataset
        attrs = read_attrs_file(os.path.join(path, dataset))
        if 'ndarray.shape' not in attrs:
            raise ValueError("%s does not look like a saved mesh "
                             "(missing ndarray.shape)" % path)
        shape = tuple(int(n) for n in np.atleast_1d(
            attrs['ndarray.shape']))
        Nmesh = attrs.get('Nmesh', shape)
        BoxSize = attrs.get('BoxSize', 1.0)

        self._block = BigFileDataset(path, dataset)
        self._shape = shape
        self.attrs = {k: v for k, v in attrs.items()
                      if k != 'ndarray.shape'}
        # the mesh of a complex block (saved with mode='complex') takes
        # the real dtype of its parts; a block of 2-byte items ('<V2',
        # a saved bfloat16 field) is a bf16 mesh
        dtype = self._block.dtype
        if dtype.kind == 'c':
            dtype = np.dtype('f%d' % (dtype.itemsize // 2))
        self._bf16 = dtype.kind == 'V' and dtype.itemsize == 2
        MeshSource.__init__(self, Nmesh, BoxSize,
                            dtype='bf16' if self._bf16 else dtype.str,
                            device=device, comm=comm)

    def to_real_field(self):
        data = self._block.read(0, self._block.size).reshape(self._shape)
        value = bf16_from_numpy(data) if self._bf16 \
            else torch.as_tensor(data)
        return Field(value.to(self.device), self.pm, 'real')

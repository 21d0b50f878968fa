"""The rank substrate (counterpart of ``nbodykit_tpu/parallel``): the
rank runtime over ``torch.distributed``, the slab-distributed FFT, the
counted particle exchange, the halo exchange, the slab domain
decomposition of the particle algorithms and the distributed sort. The
reference's mpi4py + pfft/pmesh/mpsort layer, run as one process a
rank."""

from .runtime import (CurrentMesh, RankMesh, cpu_mesh, init_distributed,
                      single_device_mesh, use_mesh, world_mesh)
from .dfft import dist_fft_plan, dist_irfftn, dist_rfftn
from .halo import halo_add, halo_fill
from .exchange import auto_capacity, counted_capacity, exchange_by_dest
from .domain import (Route, balanced_slab_edges, gather_by_index,
                     scatter_reduce_by_index, slab_route)
from .sort import dist_sort, sortable_key

__all__ = [
    'CurrentMesh', 'RankMesh', 'cpu_mesh', 'init_distributed',
    'single_device_mesh', 'use_mesh', 'world_mesh',
    'dist_rfftn', 'dist_irfftn', 'dist_fft_plan',
    'halo_add', 'halo_fill',
    'exchange_by_dest', 'auto_capacity', 'counted_capacity',
    'Route', 'slab_route', 'balanced_slab_edges', 'scatter_reduce_by_index',
    'gather_by_index', 'dist_sort', 'sortable_key',
]

"""The rank runtime: the ambient group of ranks (counterpart of
``nbodykit_tpu/parallel/runtime.py``).

The JAX package is single-controller: one process holds global arrays
sharded over a device ``Mesh``. The port is multi-process SPMD, as the
reference nbodykit was under MPI: every rank runs the user's script,
and the "mesh" (the ``comm`` argument of the entry points) is a
:class:`RankMesh`, the ranks of a ``torch.distributed`` process group
with this rank's index and device. ``None`` means one rank, with no
collectives.

Conventions
-----------
- A catalog's columns hold this rank's rows. Rank r of P holds the rows
  ``[r*per, min((r+1)*per, n))`` of an n-row global array, with
  ``per = ceil(n/P)`` (:func:`row_range`), the JAX package's own
  source numbering, so counted exchange capacities agree with JAX's.
- A real field is this rank's x-slab ``(N0/P, N1, N2)``; a transposed
  complex field its ky-slab ``(N1/P, N0, N2//2+1)``.
- Results (``BinnedStatistic``) are the same on every rank.
- Collectives on a gloo group take host tensors: a gloo mesh on a CUDA
  device copies each payload to the host and back around the call
  (``RankMesh.staged``), an explicit path chosen by the backend. NCCL
  takes CUDA tensors as they are.
- Autograd runs through ``all_to_all``, a ``torch.autograd.Function``
  whose backward sends the cotangents back along the same splits; every
  rank must build the same graph, so the backward collectives run in
  the same order everywhere. ``all_reduce`` refuses autograd: its
  backward depends on who consumes the sum. ``replicated_sum`` is the
  sum for a consumer that every rank runs alike (a loss, a metric),
  differentiated on every rank with the same cotangent, which counts
  once: its backward is the identity. A rank-local consumer (a slab
  scaled by a global mean) would need the cotangents summed over the
  ranks, which nothing here provides.
"""

import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# gloo groups of the first n world ranks, made once per process in the
# same order on every rank (torch.distributed's group creation is a
# collective of the whole world)
_cpu_groups = {}
# the device init_distributed chose for this process's world mesh
_world = {}


class RankMesh(object):
    """The ranks of one process group running one program together.

    group : a ``torch.distributed`` ProcessGroup, or None for one rank
        (every collective is then the identity)
    ranks : the world ranks of the members, in group-rank order
    rank : this process's index in the group
    device : the ``torch.device`` of this rank's tensors
    backend : ``'gloo'``, ``'nccl'`` or None (one rank)

    ``staged`` is True on a gloo group with a CUDA device: collectives
    copy their payloads to the host and back.
    """

    def __init__(self, group, ranks, rank, device, backend):
        self.group = group
        self.ranks = list(ranks)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.staged = backend == 'gloo' and self.device.type == 'cuda'

    @property
    def size(self):
        return len(self.ranks)

    def __repr__(self):
        return "RankMesh(rank=%d of %d, device=%s, backend=%s%s)" % (
            self.rank, self.size, self.device, self.backend,
            ', staged' if self.staged else '')

    # -- collectives (each is called by every rank of the group) ------------

    def _wire(self, t):
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def _home(self, t):
        return t.to(self.device) if self.staged else t

    def all_reduce(self, t, op='sum'):
        """The elementwise ``'sum'``, ``'max'`` or ``'min'`` of ``t``
        over the ranks, as a new tensor on this rank's device. Not
        differentiable (module docstring): a ``t`` that requires grad
        raises; :func:`replicated_sum` is the sum of a replicated
        result."""
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                "RankMesh.all_reduce does not run under autograd: use "
                "runtime.replicated_sum for a result every rank consumes "
                "alike, or detach the tensor")
        return self._all_reduce(t, op)

    def _all_reduce(self, t, op):
        if self.group is None:
            return t.clone()
        x = self._wire(t).clone()
        dist.all_reduce(x, op={'sum': dist.ReduceOp.SUM,
                               'max': dist.ReduceOp.MAX,
                               'min': dist.ReduceOp.MIN}[op],
                        group=self.group)
        return self._home(x)

    def all_gather(self, t):
        """Every rank's ``t`` stacked in rank order: (P,) + t.shape."""
        if self.group is None:
            return t[None].clone()
        x = self._wire(t)
        out = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(out, x, group=self.group)
        return self._home(torch.stack(out))

    def broadcast(self, t, src=0):
        """Group rank ``src``'s ``t`` on every rank (same shape and
        dtype everywhere)."""
        if self.group is None:
            return t.clone()
        x = self._wire(t).clone()
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return self._home(x)

    def all_to_all(self, send, send_splits=None, recv_splits=None):
        """``all_to_all_single`` along dimension 0: the rows of ``send``
        cut in P blocks (equal, or of ``send_splits`` rows) go to the
        ranks in order; the blocks received are concatenated in source
        order (equal, or of ``recv_splits`` rows). Any dtype: the rows
        travel as raw bytes. Differentiable: the backward sends the
        cotangents back along the same splits."""
        if torch.is_grad_enabled() and send.requires_grad:
            return _AllToAll.apply(send, self, send_splits, recv_splits)
        return self._all_to_all(send, send_splits, recv_splits)

    def _all_to_all(self, send, send_splits, recv_splits):
        if self.group is None:
            return send.clone()
        x = self._wire(send)
        if x.is_complex():
            x = torch.view_as_real(x).contiguous()
        rows = x.shape[0]
        rowbytes = int(np.prod(x.shape[1:], dtype=np.int64)) * \
            x.element_size()
        wire = x.reshape(-1).view(torch.uint8).reshape(rows, rowbytes)
        nrecv = sum(recv_splits) if recv_splits is not None else rows
        out = torch.empty((nrecv, rowbytes), dtype=torch.uint8,
                          device=wire.device)
        dist.all_to_all_single(out, wire, output_split_sizes=recv_splits,
                               input_split_sizes=send_splits,
                               group=self.group)
        out = out.view(x.dtype).reshape((nrecv,) + tuple(x.shape[1:]))
        if send.is_complex():
            out = torch.view_as_complex(out)
        return self._home(out)


class _AllToAll(torch.autograd.Function):
    """``RankMesh.all_to_all`` under autograd: the adjoint of a route is
    the route back, along the same splits swapped."""

    @staticmethod
    def forward(ctx, send, mesh, send_splits, recv_splits):
        ctx.mesh, ctx.splits = mesh, (send_splits, recv_splits)
        return mesh._all_to_all(send, send_splits, recv_splits)

    @staticmethod
    def backward(ctx, grad):
        send_splits, recv_splits = ctx.splits
        return (ctx.mesh._all_to_all(grad, recv_splits, send_splits), None,
                None, None)


class _ReplicatedSum(torch.autograd.Function):
    """The sum over the ranks of a replicated result: every rank seeds
    the same cotangent, so the backward passes it on as it is."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh._all_reduce(t, 'sum')

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated_sum(t, mesh):
    """The elementwise sum of ``t`` over the ranks, for a consumer that
    every rank runs alike (a loss, a metric): differentiable with an
    identity backward (module docstring). mesh None is one rank."""
    if mesh_size(mesh) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _ReplicatedSum.apply(t, mesh)
    return mesh.all_reduce(t)


def global_sum(t, mesh):
    """``t.sum()`` over every rank's part of a distributed tensor (this
    rank's slab or rows), the same 0-d tensor on every rank
    (:func:`replicated_sum`)."""
    return replicated_sum(t.sum(), mesh)


def init_distributed(init_method=None, num_processes=None, process_id=None,
                     backend=None, device=None, timeout_s=300):
    """Join this process to the world of ranks (the reference's MPI_Init;
    the JAX package's ``jax.distributed.initialize``).

    Arguments default to the launcher's environment: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``init_method='env://'``), ``WORLD_SIZE`` and
    ``RANK``, as ``torchrun`` sets them. ``backend`` is ``'nccl'`` on a
    CUDA device and ``'gloo'`` on the CPU unless given; ``'gloo'`` on a
    CUDA device lets several ranks share one card. ``device`` is this
    rank's device (default: ``cuda:$LOCAL_RANK`` under NCCL when the
    launcher sets it, else the ``device`` option, else ``cuda``).

    Returns False, and does nothing, when neither the arguments nor the
    environment ask for more than one process; True once joined.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and 'MASTER_ADDR' in env and \
            'MASTER_PORT' in env:
        init_method = 'env://'
    if num_processes is None and 'WORLD_SIZE' in env:
        num_processes = int(env['WORLD_SIZE'])
    if process_id is None and 'RANK' in env:
        process_id = int(env['RANK'])
    if init_method is None and num_processes is None:
        return False
    if device is None and backend in (None, 'nccl') and \
            'LOCAL_RANK' in env and torch.cuda.is_available():
        device = 'cuda:%d' % int(env['LOCAL_RANK'])
    device = resolve_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _world['device'] = device
    return True


def world_mesh():
    """The mesh of every rank of the world (COMM_WORLD) on the device
    :func:`init_distributed` chose; one rank when no world was joined."""
    if not dist.is_initialized():
        return single_device_mesh()
    n = dist.get_world_size()
    device = _world['device'] if 'device' in _world else \
        resolve_device(None)
    return RankMesh(dist.group.WORLD, range(n), dist.get_rank(), device,
                    dist.get_backend())


def process_index():
    """This process's rank in the world (0 without a world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of ranks in the world (1 without a world)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def single_device_mesh(device=None):
    """One rank on ``device``: collectives become the identity."""
    return RankMesh(None, [0], 0, resolve_device(device), None)


def cpu_mesh(n=None):
    """The first ``n`` ranks of the world (default: all) as a gloo group
    on the CPU, for testing rank-count logic on one host. A collective
    of the whole world: every rank calls it, in the same order. Ranks
    outside the first ``n`` get None and take no part. Without a world,
    ``n`` of None or 1 is one CPU rank."""
    cpu = torch.device('cpu')
    if not dist.is_initialized():
        if n in (None, 1):
            return RankMesh(None, [0], 0, cpu, None)
        raise RuntimeError("cpu_mesh(%d) needs a world of ranks: call "
                           "init_distributed first" % n)
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if not 1 <= n <= world:
        raise ValueError("cpu_mesh(%d) in a world of %d ranks"
                         % (n, world))
    if n not in _cpu_groups:
        _cpu_groups[n] = dist.new_group(ranks=list(range(n)),
                                        backend='gloo')
    rank = dist.get_rank()
    if rank >= n:
        return None
    return RankMesh(_cpu_groups[n], range(n), rank, cpu, 'gloo')


class CurrentMesh(object):
    """A per-thread stack of ambient meshes (the reference's
    ``CurrentMPIComm``). A thread's stack starts from the main thread's
    current mesh."""

    _tls = threading.local()
    _main_stack = [None]

    @classmethod
    def _stack(cls):
        if threading.current_thread() is threading.main_thread():
            return cls._main_stack
        st = getattr(cls._tls, 'stack', None)
        if st is None:
            st = [cls._main_stack[-1]]
            cls._tls.stack = st
        return st

    @classmethod
    def get(cls):
        """The current ambient mesh (None: one rank)."""
        return cls._stack()[-1]

    @classmethod
    def push(cls, mesh):
        cls._stack().append(mesh)

    @classmethod
    def pop(cls):
        st = cls._stack()
        if len(st) == 1:
            raise RuntimeError("cannot pop the root mesh")
        return st.pop()

    @classmethod
    def resolve(cls, comm):
        """A ``comm=`` argument: an explicit mesh wins, else the ambient
        one."""
        return comm if comm is not None else cls.get()


class use_mesh(object):
    """Context manager pushing a mesh as the ambient context::

        with use_mesh(world_mesh()):
            cat = UniformCatalog(nbar, BoxSize, seed=42)
    """

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        CurrentMesh.push(self.mesh)
        return self.mesh

    def __exit__(self, *args):
        CurrentMesh.pop()


def mesh_size(mesh):
    """The number of ranks of the mesh (1 when mesh is None)."""
    return 1 if mesh is None else mesh.size


def require_one_rank(obj, what):
    """Raise when ``obj`` (a RankMesh, or a catalog, mesh or algorithm
    input carrying ``comm`` or ``pm.comm``) spans more than one rank:
    ``what`` has no multi-rank branch in the port yet."""
    comm = obj if isinstance(obj, RankMesh) else getattr(obj, 'comm', None)
    if comm is None:
        comm = getattr(getattr(obj, 'pm', None), 'comm', None)
    if mesh_size(comm) > 1:
        raise NotImplementedError(
            "%s runs on one rank; its multi-rank branch is not ported yet "
            "(ROADMAP.md, Queue A: modules to port)" % what)


def same_mesh(a, b):
    """Whether meshes ``a`` and ``b`` are one group of ranks: both one
    rank (None or a 1-rank mesh), or the same process group over the
    same ranks."""
    if mesh_size(a) == 1 or mesh_size(b) == 1:
        return mesh_size(a) == mesh_size(b)
    return a.group is b.group and a.ranks == b.ranks


def row_range(n, nproc, rank):
    """Rows ``[start, stop)`` that rank ``rank`` of ``nproc`` holds of an
    n-row global array: ``per = ceil(n/nproc)`` rows a rank, the last
    ranks short or empty."""
    per = -(-int(n) // int(nproc))
    start = min(int(rank) * per, int(n))
    return start, min(start + per, int(n))


def shard_leading(mesh, arr):
    """This rank's rows (:func:`row_range`) of a global array given
    whole on every rank, as a tensor on the mesh's device; ``arr``
    unchanged when mesh is None."""
    if mesh is None:
        return arr
    t = arr if isinstance(arr, torch.Tensor) else \
        torch.as_tensor(np.asarray(arr))
    start, stop = row_range(t.shape[0], mesh.size, mesh.rank)
    return t[start:stop].to(mesh.device)


def replicate(mesh, arr):
    """The same tensor on every rank: rank 0's ``arr`` (every rank
    passes one of the same shape and dtype), on the mesh's device;
    ``arr`` unchanged when mesh is None."""
    if mesh is None:
        return arr
    t = arr if isinstance(arr, torch.Tensor) else \
        torch.as_tensor(np.asarray(arr))
    return mesh.broadcast(t.to(mesh.device))

"""TaskManager: task-level parallelism over groups of ranks (counterpart
of ``nbodykit_tpu/batch.py``).

The reference splits MPI COMM_WORLD into worker sub-communicators of
``cpus_per_task`` ranks and farms tasks to them. The port is one process
a rank, as the reference was, so the JAX package's multi-process form is
the model:

- the ranks of the mesh are cut into groups of ``cpus_per_task``
  (:func:`split_ranks`); each group is a ``torch.distributed`` subgroup
  and a :class:`.parallel.runtime.RankMesh`, made by every rank of the
  mesh in the same order; ranks that fill no whole group sit idle (with
  the JAX package's warning);
- inside ``with TaskManager(...) as tm:`` the ambient mesh is this
  rank's group (:class:`.parallel.runtime.use_mesh`), so the entry
  points called in a task run across that group;
- :meth:`TaskManager.iterate` yields this group's round-robin share of
  the tasks, and :meth:`TaskManager.map` runs that share, the group's
  first rank publishes its results, and one object all-gather over the
  whole mesh returns the full list, in task order, on every rank.

A task that raises does not leave another group waiting: its error
travels in that all-gather, and every rank then raises the first failing
task's error, with ``task_index`` set. With one rank (``comm`` None)
``map`` is a serial loop.
"""

import logging
import pickle
import traceback

import torch.distributed as dist

from .parallel.runtime import CurrentMesh, RankMesh, mesh_size, use_mesh

# the torch.distributed subgroups made here, by (world ranks, backend):
# a group of ranks is made once a process, whatever makes it again
_groups = {}


def split_ranks(N_ranks, N_per, include_all=False):
    """Partition range(N_ranks) into chunks of N_per (the reference's
    ``split_ranks``); yields (color, ranks). ``include_all`` is taken
    for the reference's signature; every rank is in a chunk either
    way."""
    available = list(range(N_ranks))
    color = 0
    for i in range(0, len(available), N_per):
        yield color, available[i:i + N_per]
        color += 1


def _subgroup(ranks, backend):
    """The ``torch.distributed`` group of the world ``ranks`` (None on a
    rank outside them): made once a process, only its members taking
    part in the rendezvous."""
    key = (tuple(ranks), backend)
    if key not in _groups:
        _groups[key] = dist.new_group(list(ranks), backend=backend,
                                      use_local_synchronization=True)
    return _groups[key]


class TaskManager(object):
    """Farm tasks to groups of ranks.

    Parameters
    ----------
    cpus_per_task : ranks a task group
    comm : the mesh of ranks to split (default: the ambient one)
    debug : verbose logging
    use_all_cpus : one group of every rank (tasks run one after another
        on the whole mesh)
    """

    logger = logging.getLogger('TaskManager')

    def __init__(self, cpus_per_task, comm=None, debug=False,
                 use_all_cpus=False):
        self.cpus_per_task = int(cpus_per_task)
        self.use_all_cpus = use_all_cpus
        if debug:
            self.logger.setLevel(logging.DEBUG)
        self.comm = CurrentMesh.resolve(comm)
        self._ctx = None
        self._plan = None

    # -- groups -------------------------------------------------------------

    def _group_ranks(self):
        """The groups as lists of the mesh's rank indices: whole groups
        of ``cpus_per_task`` (one of every rank with ``use_all_cpus``,
        or when the mesh is smaller than a group)."""
        P = mesh_size(self.comm)
        if self.use_all_cpus or P == 1:
            return [list(range(P))]
        groups = [r for _, r in split_ranks(P, self.cpus_per_task)
                  if len(r) == self.cpus_per_task]
        if not groups:
            return [list(range(P))]
        idle = sorted(set(range(P)) - {r for g in groups for r in g})
        if idle:
            # the reference's split_ranks leaves these ranks idle too
            self.logger.warning(
                "%d rank(s) %s do not fill a %d-rank task group and will "
                "be idle", len(idle), idle, self.cpus_per_task)
        return groups

    def _groups(self):
        """(groups, meshes, this rank's group index or None): every
        group's mesh as this rank sees it (:meth:`_group_mesh`). Made
        once; every rank of the mesh makes every group, in the same
        order."""
        if self._plan is None:
            comm = self.comm
            groups = self._group_ranks()
            if mesh_size(comm) == 1:
                self._plan = (groups, [comm], 0)
            else:
                meshes = [self._group_mesh(g) for g in groups]
                mine = [gi for gi, g in enumerate(groups) if comm.rank in g]
                self._plan = (groups, meshes, mine[0] if mine else None)
        return self._plan

    def _group_mesh(self, g):
        """The RankMesh of the group of the mesh's rank indices ``g`` on
        this rank, None on a rank outside it: the mesh itself for a group
        of every rank, a one-rank mesh for a group of one, else a
        subgroup (:func:`_subgroup`, made on every rank)."""
        comm = self.comm
        if len(g) == comm.size:
            return comm
        ranks = [comm.ranks[r] for r in g]
        pg = _subgroup(ranks, comm.backend) if len(g) > 1 else None
        if comm.rank not in g:
            return None
        return RankMesh(pg, ranks, g.index(comm.rank), comm.device,
                        comm.backend if pg is not None else None)

    def sub_meshes(self):
        """The task groups' meshes, in group order, as this rank sees
        them: its own group's RankMesh, None for the others (one entry,
        ``comm``, with one rank). A collective of the mesh the first
        time."""
        return list(self._groups()[1])

    def _my_mesh(self):
        """This rank's group mesh; an idle rank's own one-rank mesh."""
        _, meshes, mine = self._groups()
        if mine is not None:
            return meshes[mine]
        return self._group_mesh([self.comm.rank])

    def _share(self, ntasks):
        """The task indices this rank's group runs: its round-robin
        share."""
        groups, _, mine = self._groups()
        if mine is None:
            return []
        return [i for i in range(ntasks) if i % len(groups) == mine]

    # -- context ------------------------------------------------------------

    def __enter__(self):
        self._ctx = use_mesh(self._my_mesh())
        self._ctx.__enter__()
        return self

    def __exit__(self, *args):
        if self._ctx is not None:
            self._ctx.__exit__(*args)
            self._ctx = None

    # -- farming ------------------------------------------------------------

    def iterate(self, tasks):
        """Yield this group's round-robin share of ``tasks`` (every task
        with one rank); the ambient mesh inside ``with`` is the
        group's."""
        tasks = list(tasks)
        for i in self._share(len(tasks)):
            yield tasks[i]

    def _exchange(self, local):
        """Every rank's ``local`` object, in rank order, on every rank
        (one object all-gather over the mesh)."""
        got = [None] * self.comm.size
        dist.all_gather_object(got, local, group=self.comm.group)
        return got

    def map(self, function, tasks):
        """``[function(t) for t in tasks]`` farmed over the groups: each
        group runs its share under its mesh, and every rank returns the
        whole list in task order. A task that raises ends its group's
        share; after the exchange every rank raises the first failing
        task's error, with ``task_index`` set (on the ranks where it was
        not raised, the error travelled pickled, its traceback's text in
        ``remote_traceback``)."""
        tasks = list(tasks)
        if mesh_size(self.comm) == 1:
            return [function(t) for t in tasks]
        groups, _, mine = self._groups()
        mesh = self._my_mesh()
        # the group's first rank publishes its results
        publish = mine is not None and groups[mine][0] == self.comm.rank
        results, errors, raised = {}, {}, {}
        for i in self._share(len(tasks)):
            try:
                with use_mesh(mesh):
                    self.logger.debug("task %d on ranks %s", i, mesh.ranks)
                    res = function(tasks[i])
            except Exception as e:
                raised[i] = e
                errors[i] = _portable(e)
                break
            if publish:
                results[i] = res
        for part in self._exchange((results, errors)):
            results.update(part[0])
            for i, err in part[1].items():
                errors.setdefault(i, err)
        if errors:
            i = min(errors)
            e = raised.get(i)
            if e is None:
                e, tb = errors[i]
                e.remote_traceback = tb
            self.logger.error("task %d raised %s: %s", i, type(e).__name__,
                              e)
            e.task_index = i
            raise e
        missing = [i for i in range(len(tasks)) if i not in results]
        if missing:
            raise RuntimeError("task farming lost the results of tasks %s"
                               % missing)
        return [results[i] for i in range(len(tasks))]

    def is_root(self):
        return True

    def everyone(self):
        from contextlib import contextmanager

        @contextmanager
        def ctx():
            yield
        return ctx()


def _portable(e):
    """(an exception that pickles, the text of ``e``'s traceback): ``e``
    itself, or a RuntimeError naming it when it does not pickle."""
    tb = ''.join(traceback.format_exception(type(e), e, e.__traceback__))
    try:
        pickle.loads(pickle.dumps(e))
        return e, tb
    except Exception:
        return RuntimeError("%s: %s" % (type(e).__name__, e)), tb

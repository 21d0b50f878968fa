"""TaskManager across ranks: one world of 4 gloo CPU ranks
(``tests/_torch_ranks.py`` ``batch_cases``) farms tasks to groups of
``cpus_per_task`` = 1, 2, 3 (rank 3 idle) and 4 ranks, each group a
``torch.distributed`` subgroup and the ambient mesh of its tasks. Every
rank returns every task's result, in task order; a raising task is
re-raised on every rank with its ``task_index``, never a hang (the world
has a timeout); FFTPower tasks on groups of 2 equal the serial one-rank
map (modes identical, P(k) within 1e-10 of its largest value)."""

import numpy as np
import pytest

import _torch_ranks as R
from nbodykit_tpu.batch import split_ranks as jax_split_ranks
from nbodykit_tpu_torch.batch import TaskManager, split_ranks
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope='module')
def world():
    return R.run_world('batch_cases', timeout=120)


def groups_of(cpus):
    """The groups of the 4-rank world, as the JAX package cuts them."""
    whole = [g for g in (list(range(i, i + cpus))
                         for i in range(0, R.WORLD, cpus))
             if len(g) == cpus and g[-1] < R.WORLD]
    return whole or [list(range(R.WORLD))]


def test_split_ranks_equals_jax():
    for n, per in ((4, 1), (4, 2), (4, 3), (4, 4), (7, 3), (1, 2)):
        assert list(split_ranks(n, per)) == list(jax_split_ranks(n, per))


@pytest.mark.parametrize('cpus', R.BT_CPUS)
def test_map_runs_each_task_on_its_group(world, cpus):
    """Every rank gets the whole list in task order; task i ran on group
    i mod G, whose ranks all took part (an all_reduce over the group
    inside the task)."""
    groups = groups_of(cpus)
    want = [dict(task=i, ranks=groups[i % len(groups)],
                 total=float(len(groups[i % len(groups)])))
            for i in range(R.BT_TASKS)]
    for r in range(R.WORLD):
        assert world[r]['map', cpus] == want, (r, cpus)


@pytest.mark.parametrize('cpus', R.BT_CPUS)
def test_groups_iterate_and_ambient_mesh(world, cpus):
    """``iterate`` yields the group's round-robin share; inside ``with``
    the ambient mesh is the group's (an idle rank's own); sub_meshes
    holds this rank's group and None for the others; the mesh is
    restored on exit."""
    groups = groups_of(cpus)
    for r in range(R.WORLD):
        mine = [g for g in groups if r in g]
        got = world[r]
        if mine:
            gi = groups.index(mine[0])
            assert got['ambient', cpus] == mine[0]
            assert got['iterate', cpus] == [
                i for i in range(R.BT_TASKS) if i % len(groups) == gi]
        else:
            assert cpus == 3 and r == 3
            assert got['ambient', cpus] == [r]
            assert got['iterate', cpus] == []
        assert got['sub_meshes', cpus] == [g if r in g else None
                                           for g in groups]
        assert got['after', cpus]


def test_raising_task_reraised_on_every_rank(world):
    """Tasks 3 (group 1) and 4 (group 0) raise: every rank raises task
    3's ValueError with ``task_index`` 3, the ranks of group 0 from the
    pickled error with its traceback's text; the manager then maps
    again."""
    for r in range(R.WORLD):
        got = world[r]['raised']
        assert got == dict(message='task 3 failed', task_index=3,
                           remote=r in (0, 1)), (r, got)
        assert [t['task'] for t in world[r]['after_raise']] == [0, 1]


def test_use_all_cpus_and_reference_hooks(world):
    for r in range(R.WORLD):
        got = world[r]
        assert got['all_cpus'] == [dict(task=i, ranks=list(range(R.WORLD)),
                                        total=float(R.WORLD))
                                   for i in range(3)]
        assert got['all_cpus_meshes'] == 1
        assert got['is_root'] and got['everyone']


def test_fftpower_tasks_equal_one_rank(world):
    """FFTPower tasks on groups of 2 (each task's catalog and mesh on its
    group) equal the serial map of one rank; with one rank the manager
    is serial (one mesh, None, and every task)."""
    for r in range(R.WORLD):
        got, one = world[r]['power'], world[r]['serial_power']
        assert len(got) == len(R.BT_SEEDS)
        for g, o in zip(got, one):
            assert g['nrank'] == 2 and o['nrank'] == 1
            np.testing.assert_array_equal(g['modes'], o['modes'])
            R.close(g['power'], o['power'], 1e-10)
        assert world[r]['serial_meshes'] == [None]
        assert world[r]['serial_iterate'] == [0, 1, 2]


def test_one_rank_map_is_serial():
    """Without a mesh, map is a loop in this process: a raising task
    raises itself."""
    tm = TaskManager(2)
    assert tm.map(lambda t: t * t, range(4)) == [0, 1, 4, 9]
    with tm:
        assert list(tm.iterate('abc')) == ['a', 'b', 'c']

    def boom(t):
        raise KeyError(t)
    with pytest.raises(KeyError):
        tm.map(boom, [1])

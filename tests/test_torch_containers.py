"""The containers' names that the JAX package defines and its tests call,
through the PyTorch port and the JAX package on the same seeded numpy
inputs: the catalog's ``compute``, ``get_hardcolumn``, ``make_column``,
``create_instance``, ``copy``, ``persist``, ``csize``, ``gslice`` and
``concatenate``; the mesh's ``view``, ``to_mesh`` and ``len``; the six
named compensations; ``utils.get_data_bounds`` and the small utilities;
and the ``profile`` context."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu import transform as jtransform
from nbodykit_tpu import utils as jutils
from nbodykit_tpu.base.catalog import CatalogSourceBase as JBase
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArray
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JUniform
from nbodykit_tpu.source.mesh import catalog as jmc
from nbodykit_tpu_torch import transform, utils
from nbodykit_tpu_torch.base.catalog import CatalogSourceBase
from nbodykit_tpu_torch.source.catalog.array import ArrayCatalog
from nbodykit_tpu_torch.source.catalog.uniform import UniformCatalog
from nbodykit_tpu_torch.source.mesh import catalog as tmc


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def an(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def columns():
    rng = np.random.RandomState(4)
    return {'Mass': rng.uniform(size=50),
            'Position': rng.uniform(0, 10, (50, 3))}


def test_sort_gslice_concatenate_csize():
    cat = ArrayCatalog(columns(), BoxSize=10.0)
    jcat = JArray(columns(), BoxSize=10.0)
    assert cat.csize == jcat.csize == 50
    sl, jsl = cat.gslice(10, 20), jcat.gslice(10, 20)
    assert sl.csize == jsl.csize == 10
    np.testing.assert_array_equal(an(sl['Mass']), an(jsl['Mass']))
    stepped, jstepped = cat.gslice(3, 40, 7), jcat.gslice(3, 40, 7)
    np.testing.assert_array_equal(an(stepped['Position']),
                                  an(jstepped['Position']))
    both, jboth = cat.concatenate(cat, sl), jcat.concatenate(jcat, jsl)
    assert both.csize == jboth.csize == 110
    np.testing.assert_array_equal(an(both['Mass']), an(jboth['Mass']))
    assert transform.ConcatenateSources(cat, cat).csize == \
        jtransform.ConcatenateSources(jcat, jcat).csize == 100
    heavy = cat[an(cat['Mass']) > 0.5]
    jheavy = jcat[an(jcat['Mass']) > 0.5]
    assert heavy.csize == jheavy.csize
    s, js = cat.sort('Mass'), jcat.sort('Mass')
    np.testing.assert_array_equal(an(s['Mass']), an(js['Mass']))


def test_catalog_parity_methods():
    """copy, persist, compute, get_hardcolumn, make_column and
    create_instance, as the JAX package's test calls them."""
    c = UniformCatalog(nbar=1e-3, BoxSize=100.0, seed=3)
    jc = JUniform(nbar=1e-3, BoxSize=100.0, seed=3)
    np.testing.assert_array_equal(an(c['Position']), an(jc['Position']))
    c2, jc2 = c.copy(), jc.copy()
    assert c2.size == jc2.size == c.size
    assert isinstance(c2, UniformCatalog)
    assert c2.columns == c.columns and sorted(jc2.columns) == jc2.columns
    c2.attrs['x'] = 1
    assert 'x' not in c.attrs          # attrs decoupled, unlike view
    assert c2['Position'] is c['Position']

    p, jp = c.persist(['Position']), jc.persist(['Position'])
    np.testing.assert_array_equal(an(p['Position']), an(jp['Position']))
    assert p.attrs['seed'] == jp.attrs['seed'] == 3
    assert p.device == c.device

    pos, w = c.compute('Position', 'Weight')
    jpos, jw = jc.compute('Position', 'Weight')
    np.testing.assert_array_equal(an(pos), an(jpos))
    np.testing.assert_array_equal(an(w), an(jw))
    assert c.compute('Position') is c['Position']
    np.testing.assert_array_equal(an(c.get_hardcolumn('Index')),
                                  an(jc.get_hardcolumn('Index')))

    col = c.make_column(np.arange(4))
    assert isinstance(col, torch.Tensor) and col.shape == (4,)
    np.testing.assert_array_equal(an(col), an(jc.make_column(np.arange(4))))
    inst = CatalogSourceBase.create_instance(UniformCatalog)
    jinst = JBase.create_instance(JUniform)
    assert isinstance(inst, UniformCatalog) and isinstance(jinst, JUniform)
    assert inst.attrs == jinst.attrs == {}
    assert inst._columns == jinst._columns == {}


def test_mesh_view_to_mesh_len():
    c = UniformCatalog(nbar=1e-3, BoxSize=100.0, seed=3)
    jc = JUniform(nbar=1e-3, BoxSize=100.0, seed=3)
    m, jm = c.to_mesh(Nmesh=16), jc.to_mesh(Nmesh=16)
    v, jv = m.view(), jm.view()
    assert v.base is m and jv.base is jm
    assert v.attrs == m.attrs and v.attrs is not m.attrs
    assert m.to_mesh() is m and jm.to_mesh() is jm
    assert len(m) == len(jm) == 0
    np.testing.assert_allclose(an(v.compute().value),
                               an(jv.compute().value), rtol=1e-6, atol=1e-6)
    from nbodykit_tpu_torch.base.mesh import FieldMesh
    fm = FieldMesh(m.compute())
    assert fm.to_mesh() is fm and len(fm) == 0 and fm.view().base is fm


NAMES = ['CompensateCIC', 'CompensateTSC', 'CompensatePCS',
         'CompensateCICShotnoise', 'CompensateTSCShotnoise',
         'CompensatePCSShotnoise']


@pytest.mark.parametrize('name', NAMES)
def test_named_compensations(name):
    """Each named kernel through ``apply(kind='circular')`` equals the
    JAX package's, and the ``compensated=True`` pipeline it names (the
    plain names interlaced, the *Shotnoise forms not)."""
    res = name[len('Compensate'):len('Compensate') + 3].lower()
    interlaced = not name.endswith('Shotnoise')
    rng = np.random.RandomState(7)
    pos = rng.uniform(0, 50.0, (4000, 3))
    kw = dict(Nmesh=16, resampler=res, interlaced=interlaced, dtype='f8')
    cat, jcat = (ArrayCatalog({'Position': pos}, BoxSize=50.0),
                 JArray({'Position': pos}, BoxSize=50.0))
    func, jfunc = getattr(tmc, name), getattr(jmc, name)
    assert func.__name__ == jfunc.__name__ == name
    got = cat.to_mesh(compensated=False, **kw).apply(
        func, kind='circular', mode='complex').compute(mode='real').value
    want = jcat.to_mesh(compensated=False, **kw).apply(
        jfunc, kind='circular', mode='complex').compute(mode='real').value
    scale = np.abs(an(want)).max()
    np.testing.assert_allclose(an(got), an(want), rtol=0,
                               atol=1e-12 * scale)
    piped = cat.to_mesh(compensated=True, **kw).compute(mode='real').value
    np.testing.assert_allclose(an(got), an(piped), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize('kind', ['f8 rows', 'f8 column', 'i8 column'])
def test_get_data_bounds(kind):
    rng = np.random.RandomState(2)
    data = {'f8 rows': rng.normal(size=(40, 3)),
            'f8 column': rng.normal(size=40),
            'i8 column': rng.randint(-50, 50, size=40)}[kind]
    sel = rng.uniform(size=40) > 0.5
    for s in (None, sel, np.zeros(40, bool)):
        lo, hi = utils.get_data_bounds(torch.as_tensor(data), selection=s)
        jlo, jhi = jutils.get_data_bounds(jnp.asarray(data), selection=s)
        np.testing.assert_array_equal(lo, np.asarray(jlo))
        np.testing.assert_array_equal(hi, np.asarray(jhi))
        assert np.asarray(lo).dtype == np.asarray(jlo).dtype


def test_small_utilities_match_jax():
    for s in (1, 2, 7, 8, 12, 36, 64, 97):
        assert utils.split_size_3d(s) == jutils.split_size_3d(s)
    attrs = {'a': 1, 'b': [2]}
    assert utils.attrs_to_dict(attrs, 'x.') == \
        jutils.attrs_to_dict(attrs, 'x.')
    arr = np.zeros(3, dtype=[('a', 'f8')])
    for x in (arr, np.zeros(3), torch.zeros(3), [1]):
        assert utils.is_structured_array(x) == \
            jutils.is_structured_array(x)
    with utils.captured_output() as (out, err):
        print('to stdout')
    assert out.getvalue() == 'to stdout\n' and err.getvalue() == ''


def test_profile_writes_a_trace(tmp_path):
    path = str(tmp_path / 'trace.json')
    with nbodykit_tpu_torch.profile(path) as p:
        assert p == path
        torch.ones(16).sum()
    with open(path) as f:
        assert 'traceEvents' in json.load(f)
    assert os.path.getsize(path) > 0

"""The port's file readers and file catalogs against the JAX package's.

Each ``FileType`` (Binary, TPM, Gadget-1, FITS through the built-in
BINTABLE parser, HDF, CSV, and ``FileStack`` by glob) reads what the
JAX package reads from the same file, over ranges and steps; each file
catalog gives the JAX catalog's columns on the CPU; ``SubVolumesCatalog``
gives JAX's order (ties included) and ``SubVolumeIndex``."""

import pickle

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu import io as jio
from nbodykit_tpu.io.fits import write_bintable as jwrite_bintable
from nbodykit_tpu.io.gadget import DefaultHeaderDtype
from nbodykit_tpu.source.catalog import file as jfile
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArrayCatalog
from nbodykit_tpu.source.catalog.subvolumes import \
    SubVolumesCatalog as JSubVolumes
from nbodykit_tpu_torch import io as tio
from nbodykit_tpu_torch.io.fits import write_bintable
from nbodykit_tpu_torch.source.catalog import file as tfile
from nbodykit_tpu_torch.source.catalog.array import ArrayCatalog
from nbodykit_tpu_torch.source.catalog.subvolumes import SubVolumesCatalog
from _torch_threads import one_torch_thread  # noqa: F401

h5py = pytest.importorskip('h5py')
pytest.importorskip('pandas')

N = 2003


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _binary(tmp_path):
    r = np.random.RandomState(0)
    pos, vel = r.uniform(size=(N, 3)), r.uniform(size=(N, 3)).astype('f4')
    path = str(tmp_path / 'data.bin')
    with open(path, 'wb') as ff:
        np.arange(10, dtype='i8').tofile(ff)          # an 80-byte header
        pos.tofile(ff)
        vel.tofile(ff)
    dtype = [('Position', ('f8', 3)), ('Velocity', ('f4', 3))]
    return path, (), dict(dtype=dtype, header_size=80)


def _tpm(tmp_path):
    r = np.random.RandomState(1)
    path = str(tmp_path / 'tpm.bin')
    with open(path, 'wb') as ff:
        np.zeros(28, dtype='u1').tofile(ff)
        r.uniform(size=(N, 3)).astype('f4').tofile(ff)
        r.uniform(size=(N, 3)).astype('f4').tofile(ff)
        np.arange(N, dtype='u8').tofile(ff)
    return path, (), {}


def _gadget(tmp_path):
    r = np.random.RandomState(2)
    npart = [5, N, 0, 7, 0, 0]
    tot = sum(npart)
    header = np.zeros(1, dtype=DefaultHeaderDtype)
    header['Npart'][0] = npart
    header['BoxSize'] = 100.0
    path = str(tmp_path / 'snap.0')

    def record(ff, arr):
        n = np.array([arr.nbytes], dtype='i4')
        n.tofile(ff)
        arr.tofile(ff)
        n.tofile(ff)

    with open(path, 'wb') as ff:
        np.array([256], dtype='i4').tofile(ff)
        header.tofile(ff)
        np.zeros(256 - header.nbytes, dtype='u1').tofile(ff)
        np.array([256], dtype='i4').tofile(ff)
        record(ff, r.uniform(size=(tot, 3)).astype('f4'))
        record(ff, r.uniform(size=(tot, 3)).astype('f4'))
        record(ff, np.arange(tot, dtype='u4'))
    return path, (), dict(ptype=1)


def _fits(tmp_path):
    r = np.random.RandomState(3)
    path = str(tmp_path / 'cat.fits')
    write_bintable(path, [('POS', r.uniform(0, 100, (N, 3))),
                          ('MASS', r.uniform(size=N).astype('f4')),
                          ('ID', np.arange(N, dtype='i8')),
                          ('FLAG', r.randint(0, 9, N).astype('i4'))])
    return path, (), {}


def _hdf(tmp_path):
    r = np.random.RandomState(4)
    path = str(tmp_path / 'data.h5')
    with h5py.File(path, 'w') as ff:
        g = ff.create_group('cat')
        g.create_dataset('Position', data=r.uniform(size=(N, 3)))
        g.create_dataset('Mass', data=r.uniform(size=N).astype('f4'))
        g.create_dataset('Skip', data=r.uniform(size=N))
    return path, (), dict(dataset='cat', exclude=['Skip'])


def _csv(tmp_path):
    r = np.random.RandomState(5)
    path = str(tmp_path / 'data.txt')
    data = r.uniform(size=(N, 4))
    with open(path, 'w') as ff:
        ff.write('# a comment\n\n')
        np.savetxt(ff, data[:100], fmt='%.10e')
        ff.write('# mid-file comment\n')
        np.savetxt(ff, data[100:], fmt='%.10e')
    return path, (), dict(names=list('abcd'), dtype={'a': 'f4', 'b': 'f8',
                                                     'c': 'f8', 'd': 'f4'},
                          usecols=['a', 'b', 'd'])


def _stack(tmp_path):
    r = np.random.RandomState(6)
    for i, n in enumerate((700, 0, 1303)):
        with open(str(tmp_path / ('part%d.bin' % i)), 'wb') as ff:
            r.uniform(size=(n, 3)).tofile(ff)
            r.uniform(size=n).tofile(ff)
    dtype = [('Position', ('f8', 3)), ('Mass', 'f8')]
    return str(tmp_path / 'part*.bin'), (), dict(dtype=dtype)


FORMATS = {
    'binary': (_binary, 'BinaryFile', 'BinaryCatalog'),
    'tpm': (_tpm, 'TPMBinaryFile', 'TPMBinaryCatalog'),
    'gadget1': (_gadget, 'Gadget1File', 'Gadget1Catalog'),
    'fits': (_fits, 'FITSFile', 'FITSCatalog'),
    'hdf': (_hdf, 'HDFFile', 'HDFCatalog'),
    'csv': (_csv, 'CSVFile', 'CSVCatalog'),
    'stack': (_stack, 'BinaryFile', 'BinaryCatalog'),
}

RANGES = [(0, N, 1), (0, 1, 1), (N - 1, N, 1), (650, 1450, 1),
          (700, 700, 1), (3, N - 2, 7), (0, N, 500)]


def _open(pkg, fmt, tmp_path):
    make, ftype, _ = FORMATS[fmt]
    path, args, kw = make(tmp_path)
    cls = getattr(pkg, ftype)
    if fmt == 'stack':
        return pkg.FileStack(cls, path, *args, **kw)
    return cls(path, *args, **kw)


@pytest.mark.parametrize('fmt', sorted(FORMATS))
def test_file_types_read_what_jax_reads(tmp_path, fmt):
    tf, jf = _open(tio, fmt, tmp_path), _open(jio, fmt, tmp_path)
    assert tf.size == jf.size == N
    assert tf.dtype == jf.dtype and tf.columns == jf.columns
    assert tf.shape == jf.shape and tf.ncol == jf.ncol
    for start, stop, step in RANGES:
        a = tf.read(tf.columns, start, stop, step)
        b = jf.read(jf.columns, start, stop, step)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), (start, stop, step)
    if len({tf.dtype[c].base for c in tf.columns}) == 1:
        assert tf.asarray().tobytes() == jf.asarray().tobytes()
    col = tf.columns[-1]
    assert tf[col][5:40].tobytes() == jf[col][5:40].tobytes()
    mask = np.random.RandomState(9).uniform(size=N) < 0.5
    assert tf[mask].tobytes() == jf[mask].tobytes()
    assert tf[[3, 1, 4]].tobytes() == jf[[3, 1, 4]].tobytes()
    if fmt == 'gadget1':
        assert sorted(tf.attrs) == sorted(jf.attrs)
        np.testing.assert_array_equal(tf.attrs['Npart'], jf.attrs['Npart'])
    if fmt == 'fits':
        assert tf._backend == jf._backend == 'native'
        assert tf.attrs == jf.attrs


@pytest.mark.parametrize('fmt', sorted(FORMATS))
def test_streaming_reads_match_jax(tmp_path, fmt):
    tf, jf = _open(tio, fmt, tmp_path), _open(jio, fmt, tmp_path)
    for nranks in (1, 3, 7):
        for rank in range(nranks):
            assert tf.row_range(rank, nranks) == jf.row_range(rank, nranks)
            tc = list(tf.read_chunks(tf.columns, 300, rank, nranks))
            jc = list(jf.read_chunks(jf.columns, 300, rank, nranks))
            assert [c.tobytes() for c in tc] == [c.tobytes() for c in jc]
    with pytest.raises(ValueError):
        tf.row_range(3, 3)
    with pytest.raises(ValueError):
        next(tf.read_chunks(tf.columns, 0))


@pytest.mark.parametrize('fmt', sorted(FORMATS))
def test_file_catalogs_match_jax(tmp_path, fmt):
    make, _, catname = FORMATS[fmt]
    path, args, kw = make(tmp_path)
    tc = getattr(tfile, catname)(path, *args, **kw)
    jc = getattr(jfile, catname)(path, *args, **kw)
    assert len(tc) == jc.csize == N
    assert tc.columns == sorted(jc.columns)
    assert tc.device.type == 'cpu'
    for col in tc.columns:
        a, b = tc[col], np.asarray(jc[col])
        assert isinstance(a, torch.Tensor) and a.device.type == 'cpu'
        assert a.numpy().dtype == b.dtype, col
        assert a.numpy().tobytes() == b.tobytes(), col
    assert sorted(tc.attrs) == sorted(jc.attrs)
    sub = tc[10:20]
    assert len(sub) == 10


def test_file_catalog_and_factory(tmp_path):
    path, _, kw = _binary(tmp_path)
    tc = tfile.FileCatalog(tio.BinaryFile, path, attrs={'BoxSize': 1.0},
                           **kw)
    jc = jfile.FileCatalog(jio.BinaryFile, path, attrs={'BoxSize': 1.0},
                           **kw)
    assert tc['Position'].numpy().tobytes() == \
        np.asarray(jc['Position']).tobytes()
    assert tc.attrs['BoxSize'] == 1.0
    Cls = tfile.FileCatalogFactory('MyBinary', tio.BinaryFile)
    assert Cls.__name__ == 'MyBinary'
    assert torch.equal(Cls(path, **kw)['Velocity'], tc['Velocity'])
    # a glob builds a FileStack; an explicit device is honoured
    spath, _, skw = _stack(tmp_path)
    st = tfile.BinaryCatalog(spath, device='cpu', **skw)
    assert isinstance(st._source, tio.FileStack) and st._source.nfiles == 3
    assert len(st) == N


def test_bigfile_catalog_by_glob_is_a_stack(tmp_path):
    r = np.random.RandomState(8)
    parts = [r.uniform(size=(n, 3)) for n in (11, 0, 23)]
    for i, p in enumerate(parts):
        with tio.BigFileWriter(str(tmp_path / ('snap%d' % i))) as ff:
            ff.write('Position', p if len(p) else np.zeros((1, 3)))
    tc = tfile.BigFileCatalog(str(tmp_path / 'snap*'))
    jc = jfile.BigFileCatalog(str(tmp_path / 'snap*'))
    assert len(tc) == jc.csize == 35
    assert tc['Position'].numpy().tobytes() == \
        np.asarray(jc['Position']).tobytes()


def test_fits_writers_agree(tmp_path):
    r = np.random.RandomState(10)
    cols = [('A', r.uniform(size=(50, 2))), ('B', r.randint(0, 5, 50)),
            ('C', r.uniform(size=50).astype('f4'))]
    write_bintable(str(tmp_path / 't.fits'), cols)
    jwrite_bintable(str(tmp_path / 'j.fits'), cols)
    assert (tmp_path / 't.fits').read_bytes() == \
        (tmp_path / 'j.fits').read_bytes()


def test_getitem_semantics_and_pickle(tmp_path):
    tf, jf = _open(tio, 'csv', tmp_path), _open(jio, 'csv', tmp_path)
    for bad in ([], ['BAD1']):
        with pytest.raises(IndexError):
            tf[bad]
    with pytest.raises(IndexError):
        tf['a']['a']
    f2 = tf[['a', 'd']]
    assert f2.columns == ['a', 'd']
    with pytest.raises(IndexError):
        f2[['b']]
    assert f2.asarray().tobytes() == jf[['a', 'd']].asarray().tobytes()
    with pytest.raises(ValueError, match='uniform column'):
        tf.asarray()
    t2 = pickle.loads(pickle.dumps(tf))
    assert t2['d'][::-1].tobytes() == jf['d'][::-1].tobytes()
    bf = _open(tio, 'binary', tmp_path)
    assert pickle.loads(pickle.dumps(bf)).read(['Position'], 4, 9).tobytes() \
        == bf.read(['Position'], 4, 9).tobytes()


@pytest.mark.parametrize('fmt', ['binary', 'csv', 'hdf', 'stack'])
def test_reader_errors_match_jax(tmp_path, fmt):
    if fmt == 'binary':
        path, _, kw = _binary(tmp_path)
        for bad in (dict(kw, header_size=79),
                    dict(kw, offsets={'Position': 0}),
                    dict(kw, offsets=[('Position', 0)])):
            errors = []
            for pkg in (tio, jio):
                with pytest.raises((ValueError, TypeError)) as e:
                    pkg.BinaryFile(path, **bad)
                errors.append(e.type)
            assert errors[0] is errors[1]
    elif fmt == 'csv':
        path, _, kw = _csv(tmp_path)
        for bad in (dict(kw, names=list('abc'), usecols=None, dtype='f8'),
                    dict(kw, header=True), dict(kw, index_col=0)):
            for pkg in (tio, jio):
                with pytest.raises(ValueError):
                    pkg.CSVFile(path, **bad)
    elif fmt == 'hdf':
        path, _, kw = _hdf(tmp_path)
        for bad in (dict(dataset='Z'), dict(dataset='cat',
                                            exclude=['Nope'])):
            for pkg in (tio, jio):
                with pytest.raises(ValueError):
                    pkg.HDFFile(path, **bad)
    else:
        for pkg in (tio, jio):
            with pytest.raises(FileNotFoundError):
                pkg.FileStack(pkg.BinaryFile, str(tmp_path / 'nope.*'),
                              dtype=[('x', 'f8')])


def _tied_catalog(n=1500, seed=12):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 50, (n, 3))
    # ties: the same position many times, on a subvolume's edge and
    # outside the box (clipped into the edge cells)
    pos[::7] = pos[0]
    pos[1::11] = [25.0, 0.0, 50.0]
    pos[2::13] = [-1.0, 51.0, 12.5]
    return {'Position': pos, 'Mass': r.uniform(size=n),
            'ID': np.arange(n, dtype='i8')}


@pytest.mark.parametrize('domain', [None, [2, 2, 2], [1, 3, 4], [5, 1, 2],
                                    [7, 7, 7]])
@pytest.mark.parametrize('dtype', ['f8', 'f4'])
def test_subvolumes_match_jax(domain, dtype):
    data = _tied_catalog()
    data['Position'] = data['Position'].astype(dtype)
    tcat = ArrayCatalog(data, BoxSize=50.0)
    jcat = JArrayCatalog(data, BoxSize=50.0)
    ts = SubVolumesCatalog(tcat, domain=domain)
    js = JSubVolumes(jcat, domain=domain)
    for col in ('Position', 'Mass', 'ID', 'SubVolumeIndex'):
        a, b = ts[col].numpy(), np.asarray(js[col])
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, err_msg=col)
    ids = ts['ID'].numpy()
    sv = ts['SubVolumeIndex'].numpy()
    assert (np.diff(sv) >= 0).all()
    # stable: within a subvolume, catalog order
    for v in np.unique(sv):
        assert (np.diff(ids[sv == v]) > 0).all()
    np.testing.assert_array_equal(ts.attrs['domain'], js.attrs['domain'])
    assert float(ts.attrs['BoxSize']) == 50.0


def test_to_subvolumes_and_column_subset():
    data = _tied_catalog(400, 3)
    tcat = ArrayCatalog(data, BoxSize=50.0)
    ts = tcat.to_subvolumes(domain=[2, 1, 2], columns=['Position'])
    js = JArrayCatalog(data, BoxSize=50.0).to_subvolumes(
        domain=[2, 1, 2], columns=['Position'])
    assert sorted(ts._columns) == ['Position', 'SubVolumeIndex']
    np.testing.assert_array_equal(ts['Position'].numpy(),
                                  np.asarray(js['Position']))
    with pytest.raises(ValueError, match='overflows int32'):
        SubVolumesCatalog(tcat, domain=[2 ** 11, 2 ** 11, 2 ** 10])

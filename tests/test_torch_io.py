"""The bigfile store of the PyTorch port against the JAX package's.

The same numpy data written by either package's ``BigFileWriter`` (or
``CatalogSource.save`` / ``MeshSource.save``) gives byte-identical
directories: data files, ``header`` and ``attr-v2``. Each package reads
the other's directories bit for bit. The port's native part-file reader
(the root ``csrc/bigfile_io.cpp``, built by ``_build.py``) equals the
numpy loop, and a failed build or read raises. The slice as a whole:
``UniformCatalog`` -> ``save`` -> ``BigFileCatalog`` -> ``FFTPower``
against the same flow in JAX, at the f8 parity bar (1e-10)."""

import os

import numpy as np
import pytest
import torch

import nbodykit_tpu
import nbodykit_tpu_torch
from nbodykit_tpu import io as jio
from nbodykit_tpu.algorithms.fftpower import FFTPower as JFFTPower
from nbodykit_tpu.cosmology import LinearPower as JLinearPower
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.io.bigfile import BigFileDataset as JDataset
from nbodykit_tpu.io.bigfile import read_attrs_file as jread_attrs_file
from nbodykit_tpu.source.catalog.file import BigFileCatalog as JBigFileCatalog
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JUniform
from nbodykit_tpu.source.mesh.bigfile import BigFileMesh as JBigFileMesh
from nbodykit_tpu.source.mesh.linear import LinearMesh as JLinearMesh
from nbodykit_tpu_torch import _build
from nbodykit_tpu_torch import io as tio
from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
from nbodykit_tpu_torch.cosmology import LinearPower, Planck15
from nbodykit_tpu_torch.io import _native
from nbodykit_tpu_torch.io.bigfile import BigFileDataset, read_attrs_file
from nbodykit_tpu_torch.source.catalog.file import BigFileCatalog
from nbodykit_tpu_torch.source.catalog.uniform import UniformCatalog
from nbodykit_tpu_torch.source.mesh.bigfile import BigFileMesh
from nbodykit_tpu_torch.source.mesh.linear import LinearMesh
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def tree(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    differ = [k for k in ta if ta[k] != tb[k]]
    assert not differ, differ


COLUMNS = {
    'f8x3': lambda r, n: r.uniform(0, 100, (n, 3)),
    'f4': lambda r, n: r.uniform(size=n).astype('f4'),
    'i8': lambda r, n: r.randint(-2 ** 40, 2 ** 40, n),
    'u4': lambda r, n: r.randint(0, 2 ** 32, n, dtype='u8').astype('u4'),
    'bool': lambda r, n: r.uniform(size=n) < 0.3,
    'c16': lambda r, n: r.normal(size=n) + 1j * r.normal(size=n),
    'f4x2x2': lambda r, n: r.normal(size=(n, 2, 2)).astype('f4'),
    'f8big': lambda r, n: r.normal(size=n).astype('>f8'),
}

ATTRS = {
    'BoxSize': np.array([100.0, 100.0, 100.0]),
    'Nmesh': np.array([32, 32, 32]),
    'Label': 'hello world',
    'Names': np.array(['ab', 'cde']),
    'nbar': 1e-3,
    'seed': 42,
    'flag': True,
    'Nested': {'a': 1, 'b': [1.5, 2.5], 'arr': np.arange(3)},
}


@pytest.mark.parametrize('nfile', [None, 1, 3, 7])
@pytest.mark.parametrize('col', sorted(COLUMNS))
def test_writers_give_byte_identical_directories(tmp_path, col, nfile):
    data = COLUMNS[col](np.random.RandomState(7), 1001)
    for pkg, root in ((jio, 'j'), (tio, 't')):
        with pkg.BigFileWriter(str(tmp_path / root)) as ff:
            ff.write(col, data, attrs={'unit': 'Mpc/h', 'n': 3},
                     nfile=nfile)
            ff.write_attrs('Header', ATTRS)
    assert_same_tree(tmp_path / 'j', tmp_path / 't')


def test_attrs_of_both_packages_are_byte_identical(tmp_path):
    """Strings, arrays, numpy and Python scalars, ``json://`` values (a
    nested dict, a cosmology's parameters and the Cosmology itself); a
    tensor attr is stored as the numpy array a JAX array gives."""
    import jax.numpy as jnp
    jattrs = dict(ATTRS, arr=jnp.arange(4.0), cosmology=JPlanck15,
                  **JLinearPower(JPlanck15, 0.55, 'EisensteinHu').attrs)
    tattrs = dict(ATTRS, arr=torch.arange(4.0, dtype=torch.float64),
                  cosmology=Planck15, **_plin().attrs)
    with jio.BigFileWriter(str(tmp_path / 'j')) as ff:
        ff.write_attrs('Header', jattrs)
    with tio.BigFileWriter(str(tmp_path / 't')) as ff:
        ff.write_attrs('Header', tattrs)
    assert_same_tree(tmp_path / 'j', tmp_path / 't')
    text = (tmp_path / 't' / 'Header' / 'attr-v2').read_text()
    assert 'json://' in bytes.fromhex(
        [ln for ln in text.splitlines()
         if ln.startswith('Nested ')][0].split()[3]).decode()
    got = read_attrs_file(str(tmp_path / 't' / 'Header'))
    want = jread_attrs_file(str(tmp_path / 'j' / 'Header'))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            assert got[k].keys() == want[k].keys()
        else:
            np.testing.assert_array_equal(got[k], want[k])
    assert got['Nested']['a'] == 1 and got['Label'] == 'hello world'
    assert got['cosmo']['h'] == 0.6774
    assert got['cosmology'] == str(Planck15) == str(JPlanck15)


RANGES = [(0, 1001, 1), (0, 1, 1), (1000, 1001, 1), (143, 857, 1),
          (500, 500, 1), (3, 998, 7), (0, 1001, 250)]


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_package_reads_the_others_blocks(tmp_path, writer):
    r = np.random.RandomState(3)
    pos = r.uniform(0, 100, (1001, 3))
    mass = r.uniform(size=1001).astype('f4')
    ids = np.arange(1001, dtype='u8')
    pkg = jio if writer == 'jax' else tio
    path = str(tmp_path / 'cat')
    with pkg.BigFileWriter(path) as ff:
        ff.write_attrs('Header', ATTRS)
        ff.write('Position', pos, nfile=4)
        ff.write('Mass', mass, nfile=3)
        ff.write('ID', ids)
    jf, tf = jio.BigFile(path), tio.BigFile(path)
    assert tf.size == jf.size == 1001
    assert tf.dtype == jf.dtype and tf.columns == jf.columns
    for start, stop, step in RANGES:
        a = tf.read(tf.columns, start, stop, step)
        b = jf.read(jf.columns, start, stop, step)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(tf.read(['Position'], 0, 1001)['Position'],
                                  pos)
    assert sorted(tf.attrs) == sorted(jf.attrs)
    np.testing.assert_array_equal(tf.attrs['BoxSize'], jf.attrs['BoxSize'])
    assert tf.attrs['Nested'].keys() == jf.attrs['Nested'].keys()


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_bigfile_catalogs_read_the_others_saves(tmp_path, writer):
    """Port ``UniformCatalog(seed=5).save`` equals JAX's block for block
    (the draws are bit-identical), all columns by default; each
    package's ``BigFileCatalog`` reads the other's directory bit for
    bit."""
    jc = JUniform(nbar=3e-3, BoxSize=64.0, seed=5)
    tc = UniformCatalog(nbar=3e-3, BoxSize=64.0, seed=5)
    jc.save(str(tmp_path / 'j'))
    tc.save(str(tmp_path / 't'))
    assert_same_tree(tmp_path / 'j', tmp_path / 't')
    assert sorted(os.listdir(tmp_path / 't')) == [
        'Header', 'Index', 'Position', 'Selection', 'Value', 'Velocity',
        'Weight']
    src = str(tmp_path / ('j' if writer == 'jax' else 't'))
    t2, j2 = BigFileCatalog(src), JBigFileCatalog(src)
    assert t2.device.type == 'cpu' and len(t2) == len(tc)
    assert t2.columns == sorted(j2.columns)
    for col in ('Position', 'Velocity', 'Index', 'Selection'):
        a, b = t2[col].numpy(), np.asarray(j2[col])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert t2['Position'].numpy().tobytes() == \
        tc['Position'].numpy().tobytes()
    np.testing.assert_array_equal(t2.attrs['BoxSize'], [64.0] * 3)
    assert int(t2.attrs['seed']) == 5


def test_catalog_save_columns_and_datasets(tmp_path):
    jc = JUniform(nbar=3e-3, BoxSize=64.0, seed=9)
    tc = UniformCatalog(nbar=3e-3, BoxSize=64.0, seed=9)
    kw = dict(columns=['Position', 'Velocity'], datasets=['1/Pos', '1/Vel'],
              header='1/Header')
    jc.save(str(tmp_path / 'j'), **kw)
    tc.save(str(tmp_path / 't'), **kw)
    assert_same_tree(tmp_path / 'j', tmp_path / 't')
    t2 = BigFileCatalog(str(tmp_path / 't'), dataset='1',
                        header='1/Header')
    assert t2.columns == sorted(['Pos', 'Vel', 'Selection', 'Weight',
                                 'Value', 'Index'])
    assert torch.equal(t2['Vel'], tc['Velocity'])
    assert float(t2.attrs['nbar']) == 3e-3


def _plin():
    return LinearPower(Planck15, 0.55, 'EisensteinHu')


@pytest.mark.parametrize('mode', ['real', 'complex'])
def test_mesh_save_of_linear_mesh(tmp_path, mode):
    """The same-seed LinearMesh (f8) saved by each package: values to
    1e-10, shapes, header layout and attrs equal."""
    jm = JLinearMesh(JLinearPower(JPlanck15, 0.55, 'EisensteinHu'),
                     BoxSize=64.0, Nmesh=16, seed=3, dtype='f8')
    tm = LinearMesh(_plin(), BoxSize=64.0, Nmesh=16, seed=3, dtype='f8')
    jm.save(str(tmp_path / 'j'), mode=mode)
    tm.save(str(tmp_path / 't'), mode=mode)
    jt, tt = tree(tmp_path / 'j'), tree(tmp_path / 't')
    assert sorted(jt) == sorted(tt) == ['Field/000000', 'Field/attr-v2',
                                        'Field/header']
    assert jt['Field/attr-v2'] == tt['Field/attr-v2']
    jh, th = (t['Field/header'].decode().splitlines() for t in (jt, tt))
    assert jh[:3] == th[:3] and jh[3].split(':')[1] == th[3].split(':')[1]
    dt = np.dtype(th[0].split()[1])
    a = np.frombuffer(tt['Field/000000'], dt)
    b = np.frombuffer(jt['Field/000000'], dt)
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * abs(b).max())
    shape = (16, 16, 16) if mode == 'real' else (16, 16, 9)
    for pkg_mesh in (BigFileMesh(str(tmp_path / 'j')),
                     BigFileMesh(str(tmp_path / 't'))):
        assert pkg_mesh._shape == shape
        np.testing.assert_array_equal(pkg_mesh.attrs['Nmesh'], [16] * 3)


def test_bigfile_mesh_reads_the_others_fields_bit_for_bit(tmp_path):
    jm = JLinearMesh(JLinearPower(JPlanck15, 0.55, 'EisensteinHu'),
                     BoxSize=64.0, Nmesh=16, seed=3, dtype='f8')
    jm.save(str(tmp_path / 'j'))
    tm = BigFileMesh(str(tmp_path / 'j'))
    want = np.asarray(JBigFileMesh(str(tmp_path / 'j'))
                      .compute(mode='real').value)
    got = tm.compute(mode='real').value.numpy()
    assert got.tobytes() == want.tobytes()
    assert tm.pm.device.type == 'cpu'
    # the port's save of the reloaded mesh is the JAX package's (both
    # differ from the first save in the #HUMANE comment of the decoded
    # json:// attr), and the JAX package reads it
    tm.save(str(tmp_path / 't'))
    JBigFileMesh(str(tmp_path / 'j')).save(str(tmp_path / 'jj'))
    assert_same_tree(tmp_path / 'jj', tmp_path / 't')
    back = np.asarray(JBigFileMesh(str(tmp_path / 't')).compute().value)
    assert back.tobytes() == want.tobytes()
    # FFTPower of the reloaded field equals FFTPower of the saved one
    r1 = FFTPower(tm, mode='1d', dk=0.05).power
    r2 = FFTPower(BigFileMesh(str(tmp_path / 't')), mode='1d',
                  dk=0.05).power
    np.testing.assert_array_equal(r1['power'], r2['power'])


def test_complex_mode_mesh_reloads_as_real_kind_as_in_jax(tmp_path):
    """The reference defect the port keeps: ``BigFileMesh`` of a mesh
    saved with ``mode='complex'`` returns the transposed complex values
    as a Field of kind ``'real'`` (JAX
    ``source/mesh/bigfile.py:46``), so ``compute(mode='complex')``
    tries an r2c of complex data and raises in both packages."""
    jm = JLinearMesh(JLinearPower(JPlanck15, 0.55, 'EisensteinHu'),
                     BoxSize=64.0, Nmesh=8, seed=4, dtype='f8')
    jm.save(str(tmp_path / 'c'), mode='complex')
    jf = JBigFileMesh(str(tmp_path / 'c')).to_real_field()
    tf = BigFileMesh(str(tmp_path / 'c')).to_real_field()
    assert jf.kind == tf.kind == 'real'
    assert tuple(tf.value.shape) == tuple(jf.value.shape) == (8, 8, 5)
    assert tf.value.is_complex()
    assert tf.value.numpy().tobytes() == np.asarray(jf.value).tobytes()
    with pytest.raises(Exception):
        JBigFileMesh(str(tmp_path / 'c')).compute(mode='complex')
    with pytest.raises(Exception):
        BigFileMesh(str(tmp_path / 'c')).compute(mode='complex')


def _corrupt(fn, at=8):
    with open(fn, 'r+b') as ff:
        ff.seek(at)
        b = ff.read(1)
        ff.seek(at)
        ff.write(bytes([b[0] ^ 0xFF]))


def test_checksum_mismatch_carries_the_jax_fields(tmp_path):
    path = str(tmp_path / 'rot')
    data = np.arange(300, dtype='f8').reshape(100, 3)
    with tio.BigFileWriter(path) as bf:
        bf.write('Position', data, nfile=2)
    _corrupt(str(tmp_path / 'rot' / 'Position' / '000001'))
    ds = BigFileDataset(path, 'Position')
    np.testing.assert_array_equal(ds.read(0, 10), data[:10])
    with pytest.raises(tio.ChecksumMismatch) as ti:
        ds.read(0, 100)
    with pytest.raises(jio.ChecksumMismatch) as ji:
        JDataset(path, 'Position').read(0, 100)
    for field in ('file', 'column', 'expected', 'got'):
        assert getattr(ti.value, field) == getattr(ji.value, field), field
    assert str(ti.value) == str(ji.value)
    assert isinstance(ti.value, IOError)
    # a catalog read raises too, before any byte reaches the device
    with pytest.raises(tio.ChecksumMismatch):
        BigFileCatalog(path)['Position']


@pytest.mark.parametrize('how', ['option', 'legacy', 'zero'])
def test_checksum_verification_skips(tmp_path, how):
    """``io_verify_checksums=False`` loads the bytes as they are; a
    header entry without a checksum, or with the ``: 0`` placeholder,
    skips that file's check."""
    path = str(tmp_path / 'blk')
    data = np.arange(300, dtype='f8')
    with tio.BigFileWriter(path) as bf:
        bf.write('X', data, nfile=2)
    hdr = tmp_path / 'blk' / 'X' / 'header'
    lines = hdr.read_text().splitlines()
    if how != 'option':
        out = []
        for line in lines:
            parts = line.split(':')
            if len(parts) == 3:
                line = '%s: %s' % (parts[0], parts[1].strip())
                if how == 'zero':
                    line += ' : 0'
            out.append(line)
        hdr.write_text('\n'.join(out) + '\n')
    _corrupt(str(tmp_path / 'blk' / 'X' / '000000'))
    if how == 'option':
        with nbodykit_tpu_torch.set_options(io_verify_checksums=False):
            got = BigFileDataset(path, 'X').read(0, 300)
        with pytest.raises(tio.ChecksumMismatch):
            BigFileDataset(path, 'X').read(0, 300)
        with nbodykit_tpu.set_options(io_verify_checksums=False):
                want = JDataset(path, 'X').read(0, 300)
        assert got.tobytes() == want.tobytes()
    else:
        ds = BigFileDataset(path, 'X')
        assert not ds.checksums.get(0)
        got = ds.read(0, 300)
    assert not np.array_equal(got, data)
    np.testing.assert_array_equal(got[150:], data[150:])


@pytest.mark.parametrize('dtype', ['f8', 'f4', 'i4', 'u1'])
def test_native_reader_equals_numpy_loop(tmp_path, dtype):
    path = str(tmp_path / 'striped')
    data = (np.arange(3000) % 251).astype(dtype).reshape(1000, 3)
    with tio.BigFileWriter(path) as bf:
        bf.write('Position', data, nfile=7)
    ds = BigFileDataset(path, 'Position')
    for start, stop, _ in RANGES[:5] + [(0, 143, 1), (142, 143, 1)]:
        stop = min(stop, 1000)
        native = ds.read(start, stop)
        loop = ds.read(start, stop, native=False)
        direct = _native.read_block(ds.dir, ds.bounds, ds.dtype, ds.nmemb,
                                    start, stop, nthreads=3)
        assert native.dtype == loop.dtype == np.dtype(dtype)
        assert native.tobytes() == loop.tobytes() == direct.tobytes() == \
            data[start:stop].tobytes()


def test_native_checksum_is_the_byte_sum():
    r = np.random.RandomState(1)
    for n in (0, 1, 7, 8, 9, 4097, 100003):
        buf = r.randint(0, 256, n).astype(np.uint8)
        want = int(buf.sum(dtype=np.uint64) & 0xFFFFFFFF)
        assert _native.checksum(buf) == want
    # the 32-bit wrap
    big = np.full(2 ** 24 + 5, 255, dtype=np.uint8)
    assert _native.checksum(big) == (255 * big.size) & 0xFFFFFFFF


def test_native_read_failure_raises(tmp_path):
    path = str(tmp_path / 'gone')
    with tio.BigFileWriter(path) as bf:
        bf.write('X', np.arange(100.0), nfile=2)
    ds = BigFileDataset(path, 'X')
    with pytest.raises(IndexError):
        ds.read(0, 101)
    with pytest.raises(IndexError):
        ds.read(7, 3)
    with pytest.raises(IndexError):
        _native.read_block(ds.dir, ds.bounds, ds.dtype, 1, -1, 5)
    with open(os.path.join(ds.dir, '000001'), 'r+b') as f:
        f.truncate(16)                       # a short read
    with pytest.raises(OSError, match='return code'):
        _native.read_block(ds.dir, ds.bounds, ds.dtype, 1, 0, 100)
    os.remove(os.path.join(ds.dir, '000001'))
    with pytest.raises(OSError, match='return code'):
        _native.read_block(ds.dir, ds.bounds, ds.dtype, 1, 40, 60)


def test_failed_reader_build_raises(monkeypatch, tmp_path):
    """No g++ at the path given: the build raises, and so does every
    read and checksum that needs the library; nothing falls back."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(_build, 'gxx', lambda: str(tmp_path / 'no-g++'))
    with pytest.raises(OSError):
        _build.load_host('bigfile_io')
    with pytest.raises(OSError):
        _native.checksum(np.zeros(4, dtype=np.uint8))
    with pytest.raises(OSError):
        with tio.BigFileWriter(str(tmp_path / 'w')) as bf:
            bf.write('X', np.arange(10.0))
    monkeypatch.setattr(_build, 'gxx', lambda: 'g++')
    monkeypatch.setattr(_build, 'HOST_FLAGS', ['-O3', '-shared', '-fPIC',
                                               '-std=c++17',
                                               '-fno-such-option-nbk'])
    with pytest.raises(RuntimeError, match='failed to build'):
        _build.load_host('bigfile_io')


def test_reader_is_built_with_the_jax_flags():
    import inspect
    from nbodykit_tpu import _native_build
    from nbodykit_tpu.io import _native as jnative
    assert "extra_flags=('-pthread',)" in inspect.getsource(jnative._build)
    assert _build.host_flags('bigfile_io') == \
        ['-O3', '-shared', '-fPIC', '-std=c++17', '-pthread']
    assert _build.host_flags('boltzmann_kernel') == _build.HOST_FLAGS
    src, lib = _build._target('bigfile_io')
    assert os.path.samefile(src, os.path.join(_native_build._CSRC,
                                              'bigfile_io.cpp'))
    assert lib.startswith(_build.BUILD_DIR)


def test_save_reload_fftpower_matches_jax(tmp_path):
    """The slice as a whole: UniformCatalog -> save -> BigFileCatalog ->
    FFTPower (f8 mesh), in each package, to 1e-10; the reloaded
    catalog's power equals the in-memory catalog's exactly."""
    kw = dict(nbar=3e-3, BoxSize=64.0, seed=11)
    JUniform(**kw).save(str(tmp_path / 'j'), columns=['Position',
                                                      'Velocity'])
    tcat = UniformCatalog(**kw)
    tcat.save(str(tmp_path / 't'), columns=['Position', 'Velocity'])
    assert_same_tree(tmp_path / 'j', tmp_path / 't')
    alg = dict(mode='2d', Nmu=4, poles=[0, 2], dk=0.05, kmin=0.01)
    jcat = JBigFileCatalog(str(tmp_path / 'j'))
    jr = JFFTPower(jcat.to_mesh(Nmesh=16, dtype='f8', compensated=True),
                   **alg)
    cat = BigFileCatalog(str(tmp_path / 't'))
    tr = FFTPower(cat.to_mesh(Nmesh=16, dtype='f8', compensated=True),
                  **alg)
    mem = FFTPower(tcat.to_mesh(Nmesh=16, dtype='f8', compensated=True),
                   **alg)
    for stat, cols in (('power', ('k', 'mu', 'power')),
                       ('poles', ('k', 'power_0', 'power_2'))):
        t, j, m = (getattr(r, stat) for r in (tr, jr, mem))
        np.testing.assert_array_equal(t['modes'], j['modes'])
        for col in cols:
            a, b = np.asarray(t[col]), np.asarray(j[col])
            scale = np.nanmax(np.abs(b))
            np.testing.assert_allclose(a, b, rtol=1e-10,
                                       atol=1e-10 * scale)
            np.testing.assert_array_equal(a, np.asarray(m[col]))

"""nbodykit-tpu on PyTorch: the FFTPower main path on one CUDA device.

A second package beside the JAX one (``nbodykit_tpu``), with the same
module names so a reader can find the counterpart of each module. It
imports ``torch``, numpy and scipy, and nothing of JAX.

Device rule: every entry point (``ParticleMesh``, the catalogs,
``convert``) runs on ``cuda`` unless the caller asks for the CPU, with
``device='cpu'`` or ``set_options(device='cpu')``. Without CUDA and
without that request an entry point raises; it never carries on
quietly on the CPU.

Hand-written Hopper kernels (``csrc/*.cu``, built by ``_build.py`` at
first use) carry the mxu paint's tile deposit, the radix counting
sort's rank pass (also the segsum paint's ordering) and the threefry
draws (JAX's values, so a seed gives
the JAX package's catalog). A wrapper launches its kernel for a CUDA
tensor and uses the kernel's plain PyTorch version only for a CPU
tensor.
"""

import logging
import numbers
import time
from contextlib import contextmanager

__version__ = "0.1.0"

_default_options = {
    # default resampler window
    'resampler': 'cic',
    # local deposit kernel (ops/paint.py): 'scatter' (chunked
    # index_add_), 'mxu' (tile-bucketed deposit), 'sort' (one sort,
    # doubling run sums, unique scatter), 'segsum' (one sort, segment
    # sums), 'streams' (replica-mesh scatter chains) or 'auto': 'mxu'
    # on a CUDA device, 'scatter' on the CPU
    'paint_method': 'auto',
    # stable ordering engine of the mxu bucketing and the segsum paint:
    # 'argsort', 'radix' (ops/radix.py) or 'auto': 'radix' on a CUDA
    # device, 'argsort' on the CPU
    'paint_order': 'auto',
    # replica meshes of the 'streams' paint (an int >= 1, clamped to
    # the window's s^3 offsets) or 'auto': 4, the JAX package's value
    # on a cold tune cache
    'paint_streams': 'auto',
    # dtype of the meshes to_mesh() and the FFT algorithms make from a
    # catalog: 'f4', 'f8', 'bf16' (bfloat16 storage, f32 compute) or
    # 'auto': 'f4', the JAX package's value on a cold tune cache
    'mesh_dtype': 'f4',
    # bucket-capacity slack of the 'mxu' paint
    'paint_bucket_slack': 2.0,
    # slack factor of fixed-capacity particle exchange buffers, accepted
    # for the JAX package's option set: there only its tuner's search
    # space reads it, and exchange capacities default to the exact
    # counts times 1.05 (parallel/exchange.py), as here
    'exchange_slack': 1.25,
    # wire format of the distributed FFT's all-to-all
    # (parallel/dfft.py): 'none' (the complex payload), 'bf16' (the
    # planes in bfloat16, re-widened to f32 on receipt), 'int16'
    # (planes quantized against one f32 scale a source rank) or 'auto':
    # 'none', the JAX package's value on a cold tune cache
    'a2a_compress': 'none',
    # particles per index_add_ pass of the 'scatter' paint
    'paint_chunk_size': 1024 * 1024 * 16,
    # device of the entry points: None means 'cuda'; 'cpu' runs on the
    # CPU (the tests' choice)
    'device': None,
    # verify each bigfile part file's byte-sum checksum on its first
    # read (io/bigfile.py); a mismatch raises ChecksumMismatch. False
    # skips verification
    'io_verify_checksums': True,
}

_global_options = dict(_default_options)


class set_options(object):
    """Set global options, as a plain call or as a ``with`` block that
    restores the previous values on exit (the JAX package's
    ``set_options``, restricted to the options this port reads)."""

    def __init__(self, **kwargs):
        _check_keys(kwargs)
        self.old = dict(_global_options)
        _global_options.update(kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        _global_options.clear()
        _global_options.update(self.old)


@contextmanager
def option_scope(**overrides):
    """Override options for the block and restore the full option dict
    on exit, whatever was set inside it."""
    _check_keys(overrides)
    saved = dict(_global_options)
    _global_options.update(overrides)
    try:
        yield
    finally:
        _global_options.clear()
        _global_options.update(saved)


# the values an option may take, where the port checks them
_CHOICES = {
    'paint_method': ('auto', 'scatter', 'mxu', 'sort', 'segsum', 'streams'),
    'paint_order': ('auto', 'argsort', 'radix'),
    'mesh_dtype': ('auto', 'f4', 'f8', 'bf16'),
    'a2a_compress': ('auto', 'none', 'bf16', 'int16'),
}


def _check_keys(kwargs):
    for key, value in kwargs.items():
        if key not in _default_options:
            raise KeyError('invalid option: %r (valid: %s)'
                           % (key, sorted(_default_options)))
        if key in _CHOICES and value not in _CHOICES[key]:
            raise ValueError('invalid %s %r (choose %s)'
                             % (key, value, '/'.join(_CHOICES[key])))
        if key == 'paint_streams' and value != 'auto' and (
                isinstance(value, bool)
                or not isinstance(value, numbers.Integral)
                or value < 1):
            raise ValueError("invalid paint_streams %r (an int >= 1 or "
                             "'auto')" % (value,))


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``device`` if given,
    else the ``device`` option, else ``cuda``. Raises when CUDA is asked
    for (explicitly or by default) and absent."""
    import torch
    if device is None:
        device = _global_options['device']
    if device is None:
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to the entry point "
            "or call nbodykit_tpu_torch.set_options(device='cpu') to run "
            "on the CPU")
    if device.type not in ('cuda', 'cpu'):
        raise ValueError("unsupported device %r (choose 'cuda' or 'cpu')"
                         % (str(device),))
    if device.type == 'cuda' and device.index is None:
        # the index tensors report, so devices compare equal
        device = torch.device('cuda', torch.cuda.current_device())
    return device


# paint methods torch.autograd differentiates as they run; grad mode
# demotes any other to 'scatter' (the JAX package's
# tune/resolve.py DIFFERENTIABLE_PAINT)
DIFFERENTIABLE_PAINT = frozenset({'scatter'})

# the replica meshes of paint_streams='auto' (the JAX tuner's cold
# cache, tune/resolve.py FALLBACKS)
DEFAULT_PAINT_STREAMS = 4


def resolve_mesh_dtype():
    """The ``mesh_dtype`` option as a concrete token: ``'auto'`` is
    ``'f4'``, the JAX tuner's cold-cache answer."""
    dtype = _global_options['mesh_dtype']
    return 'f4' if dtype == 'auto' else dtype


def resolve_paint(device, differentiable=False):
    """The effective paint configuration on ``device``: current options
    with every ``'auto'`` resolved (no tuner: ``mxu`` + ``radix`` on a
    CUDA device, ``scatter`` + ``argsort`` on the CPU, 4 streams).
    ``source`` is ``'default'`` when the method was ``'auto'``, else
    ``'explicit'``.

    ``differentiable=True`` is the grad-mode resolution: a method
    outside :data:`DIFFERENTIABLE_PAINT` (the mxu deposit has no
    backward) is demoted to ``'scatter'``, with ``source`` set to
    ``'grad-fallback'``, the demoted method in ``winner_name`` and one
    warning logged, as the JAX package's resolver does."""
    cuda = device.type == 'cuda'
    method = _global_options['paint_method']
    source = 'default' if method == 'auto' else 'explicit'
    if method == 'auto':
        method = 'mxu' if cuda else 'scatter'
    order = _global_options['paint_order']
    if order == 'auto':
        order = 'radix' if cuda else 'argsort'
    streams = _global_options['paint_streams']
    if streams == 'auto':
        streams = DEFAULT_PAINT_STREAMS
    cfg = {'paint_method': method, 'paint_order': order,
           'paint_bucket_slack': _global_options['paint_bucket_slack'],
           'paint_chunk_size': _global_options['paint_chunk_size'],
           'paint_streams': int(streams), 'source': source}
    if differentiable and method not in DIFFERENTIABLE_PAINT:
        cfg['winner_name'] = method
        cfg['paint_method'] = 'scatter'
        cfg['source'] = 'grad-fallback'
        logging.getLogger('nbodykit_tpu_torch.tune').warning(
            "grad-mode paint resolution: demoting %r (not natively "
            "differentiable) to 'scatter' for this call "
            "(tune.grad_fallback)", method)
    return cfg


# ---------------------------------------------------------------------------
# logging (the JAX package's ``setup_logging`` and ``timer``)
# ---------------------------------------------------------------------------

_logging_handler = None


def setup_logging(log_level="info"):
    """Send log records to stderr stamped with the wall-clock time
    elapsed since this call, as ``[ elapsed ] level name: msg``."""
    levels = {
        "info": logging.INFO,
        "debug": logging.DEBUG,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }

    logger = logging.getLogger()
    t0 = time.time()

    class Formatter(logging.Formatter):
        def format(self, record):
            s1 = ('[ %09.2f ] ' % (time.time() - t0))
            return s1 + logging.Formatter.format(self, record)

    fmt = Formatter(fmt='%(levelname)s %(name)s: %(message)s')

    global _logging_handler
    if _logging_handler is None:
        _logging_handler = logging.StreamHandler()
        logger.addHandler(_logging_handler)

    _logging_handler.setFormatter(fmt)
    logger.setLevel(levels[log_level])


@contextmanager
def timer(name, logger=None):
    """Log the wall-clock time of the enclosed block as
    ``"<name>: <seconds> s"`` (to ``logger``, else the ``timer``
    logger). The time is the host's: work queued on a CUDA device is
    counted only as far as the block waits for it."""
    t0 = time.time()
    yield
    msg = "%s: %.3f s" % (name, time.time() - t0)
    (logger or logging.getLogger('timer')).info(msg)


@contextmanager
def profile(path=None, host=False):
    """Trace the enclosed block with ``torch.profiler`` (the card's
    kernels as well as the host when CUDA is present) and write a
    Chrome trace to ``path`` on exit (default: ``nbodykit-torch-trace
    .json`` in the system's temporary directory). Yields the path;
    ``host`` is accepted for the JAX signature (the host is always
    traced)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    if path is None:
        path = os.path.join(tempfile.gettempdir(),
                            'nbodykit-torch-trace.json')
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)

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
first use) carry the mxu paint's tile deposit and the radix counting
sort's rank pass. A wrapper launches its kernel for a CUDA tensor and
uses the kernel's plain PyTorch version only for a CPU tensor.
"""

from contextlib import contextmanager

__version__ = "0.1.0"

_default_options = {
    # default resampler window
    'resampler': 'cic',
    # local deposit kernel: 'scatter' (chunked index_add_), 'mxu'
    # (tile-bucketed deposit; ops/paint.py) or 'auto': 'mxu' on a CUDA
    # device, 'scatter' on the CPU
    'paint_method': 'auto',
    # stable ordering engine of the mxu bucketing: 'argsort', 'radix'
    # (ops/radix.py) or 'auto': 'radix' on a CUDA device, 'argsort'
    # on the CPU
    'paint_order': 'auto',
    # bucket-capacity slack of the 'mxu' paint
    'paint_bucket_slack': 2.0,
    # particles per index_add_ pass of the 'scatter' paint
    'paint_chunk_size': 1024 * 1024 * 16,
    # device of the entry points: None means 'cuda'; 'cpu' runs on the
    # CPU (the tests' choice)
    'device': None,
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


def _check_keys(kwargs):
    for key in kwargs:
        if key not in _default_options:
            raise KeyError('invalid option: %r (valid: %s)'
                           % (key, sorted(_default_options)))


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


def resolve_paint(device):
    """The effective paint configuration on ``device``: current options
    with every ``'auto'`` resolved (no tuner: ``mxu`` + ``radix`` on a
    CUDA device, ``scatter`` + ``argsort`` on the CPU)."""
    cuda = device.type == 'cuda'
    method = _global_options['paint_method']
    if method == 'auto':
        method = 'mxu' if cuda else 'scatter'
    order = _global_options['paint_order']
    if order == 'auto':
        order = 'radix' if cuda else 'argsort'
    return {'paint_method': method, 'paint_order': order,
            'paint_bucket_slack': _global_options['paint_bucket_slack'],
            'paint_chunk_size': _global_options['paint_chunk_size']}

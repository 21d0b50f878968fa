"""The radix counting sort's rank pass: Hopper kernel and plain version.

Replaces the Pallas TPU kernel ``nbodykit_tpu/ops/radix_pallas.py``
``_rank_kernel`` (and its XLA twin ``ops/radix.py:_pass_rank_hist``):

    rank[i] = #{j < i : digit[j] == digit[i]},   hist[d] = #{digit == d}

for int32 digits in [0, D), D <= 1024.

The TPU kernel carries a running per-digit base across its sequential
grid. CTAs on Hopper run in no order, so ``csrc/radix_rank.cu`` is a
single-pass counting rank with decoupled look-back: each CTA takes a
chunk of ``KERNEL_CHUNK`` digits from an atomic ticket, ranks it stably
within its warps (peer masks from one ``__ballot_sync`` per digit bit,
``__popc(mask & lanemask_lt)``, per-warp counts scanned across warps in
warp order), publishes its per-digit chunk totals behind a status word
and looks back over the lower chunks' status words for its per-digit
base. It reads each digit once and writes each rank once; the last
chunk's inclusive prefix is ``hist``. The result is bit-identical to
the plain version. Nothing is padded, so no histogram correction is
needed.

Bound on the H100: bytes. A pass reads n int32 digits and writes n
int32 ranks and D int32 counts; it does no arithmetic worth counting.
Beside that each chunk of ``KERNEL_CHUNK`` digits writes 2 * D int32
counts (D / 4096 bytes per digit byte: 1.6% at D = 65) and a status
word, which :func:`rank_plan` sizes; the C entry point clears the status
words on the stream.

The wrapper does not check the digits' values, which would cost a
reduction and a host round trip per pass: the kernel counts digits
outside [0, D) on the device and :func:`raise_on_bad_digits` raises on
that count where the caller synchronizes anyway.
"""

import ctypes

import torch

# digits per chunk (one CTA) and threads per CTA of the kernel;
# csrc/radix_rank.cu RANK_CHUNK and RANK_THREADS must match
KERNEL_CHUNK = 8192
KERNEL_THREADS = 512
MAX_DIGITS = 1024


def pad_digits(digit, D, chunk):
    """Pad a digit stream to a chunk multiple with sentinel digit D-1.
    Returns (padded (nch, chunk) int32, npad); the sentinel's count must
    be corrected by ``hist[D-1] -= npad`` (the JAX package's contract,
    kept for the plain version)."""
    n = digit.shape[0]
    nch = max(1, -(-n // chunk))
    npad = nch * chunk - n
    dig_p = torch.cat([digit.to(torch.int32),
                       torch.full((npad,), D - 1, dtype=torch.int32,
                                  device=digit.device)]).reshape(nch, chunk)
    return dig_p, npad


def pass_rank_hist_plain(digit, D, chunk=4096):
    """Plain PyTorch rank pass (the JAX ``_pass_rank_hist``): one-hot
    cumulative counts per chunk plus per-digit totals carried across
    chunks. Exact in integers.

    digit : (n,) int32 in [0, D). Returns (rank (n,) int32,
    hist (D,) int32)."""
    n = digit.shape[0]
    dig_p, npad = pad_digits(digit, D, chunk)
    cols = torch.arange(D, dtype=torch.int32, device=digit.device)
    base = torch.zeros(D, dtype=torch.int64, device=digit.device)
    ranks = []
    for d_c in dig_p:
        O = (d_c[:, None] == cols).to(torch.int32)          # (C, D)
        cumO = torch.cumsum(O, dim=0)
        # the one-hot picks cumO[i, d_i]: inclusive count -> exclusive
        rank_in = (cumO * O).sum(dim=1) - 1
        ranks.append(base[d_c.long()] + rank_in)
        base = base + cumO[-1]
    rank = torch.cat(ranks)[:n].to(torch.int32)
    hist = base.clone()
    hist[D - 1] -= npad
    return rank, hist.to(torch.int32)


_bad = {}


def _bad_counter(device):
    """The device's int32 count of digits outside [0, D) seen by rank
    passes since :func:`raise_on_bad_digits` last read it."""
    flag = _bad.get(device)
    if flag is None:
        flag = _bad[device] = torch.zeros((), dtype=torch.int32,
                                          device=device)
    return flag


def raise_on_bad_digits(device):
    """Raise if a rank pass on ``device`` met a digit outside [0, D)
    since the last call, and reset the count. It reads one device int,
    so call it where the caller synchronizes anyway (the paint calls it
    where it reads its bucket-overflow count). A no-op off CUDA, where
    the rank pass is the plain version."""
    device = torch.device(device)
    if device.type != 'cuda':
        return
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    flag = _bad.get(device)
    if flag is None:
        return
    nbad = int(flag)
    if nbad:
        flag.zero_()
        raise ValueError("%d rank-pass digits lay outside [0, D); their "
                         "ranks are undefined" % nbad)


_fn = []


def _rank_fn():
    if not _fn:
        from .._build import load
        fn = load('radix_rank').nbk_rank_pass
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def rank_plan(n, D):
    """Launch geometry of the rank kernel for n digits of alphabet D:
    ``chunk`` (digits per CTA), ``ctas`` (one per chunk, at least one),
    ``threads``, ``smem_bytes`` (dynamic shared memory per CTA: the
    chunk, per-warp counts and two D-vectors), ``scratch_words`` (int64
    words of scratch: a 16-byte ticket, a 4-byte status word per chunk
    padded to 16 bytes, then each chunk's D aggregate and D inclusive
    int32 counts) and ``clear_bytes`` (the ticket and the status words,
    cleared before each pass)."""
    n, D = int(n), int(D)
    ctas = max(1, -(-n // KERNEL_CHUNK))
    clear = 16 + -(-4 * ctas // 16) * 16
    warps = KERNEL_THREADS // 32
    return dict(chunk=KERNEL_CHUNK, ctas=ctas, threads=KERNEL_THREADS,
                smem_bytes=4 * (KERNEL_CHUNK + (warps + 2) * D),
                scratch_words=-(-(clear + 8 * ctas * D) // 8),
                clear_bytes=clear)


def rank_pass_launch(digit, D, rank, hist, scratch):
    """Launch the rank kernel into preallocated outputs on the current
    stream, with no checks: ``digit`` (n,) int32, ``rank`` (n,) int32,
    ``hist`` (D,) int32 and ``scratch`` (``rank_plan(n, D)
    ['scratch_words']``,) int64, all contiguous on one CUDA device,
    n >= 1. :func:`pass_rank_hist_cuda` checks and allocates, then calls
    this."""
    from .._build import check
    stream = torch.cuda.current_stream(digit.device).cuda_stream
    check('radix_rank', _rank_fn()(
        digit.data_ptr(), rank.data_ptr(), hist.data_ptr(),
        scratch.data_ptr(), _bad_counter(digit.device).data_ptr(),
        digit.shape[0], D, stream))
    pass_rank_hist_cuda.launches += 1


def pass_rank_hist_cuda(digit, D):
    """Rank pass on the CUDA kernel (``csrc/radix_rank.cu``). Same
    contract as :func:`pass_rank_hist_plain`; bit-identical output.

    digit : (n,) contiguous int32 CUDA tensor with values in [0, D),
    1 <= D <= 1024. The values are not checked here, which would cost a
    reduction and a host round trip per pass: the kernel skips a digit
    outside [0, D) and counts it on the device, and
    :func:`raise_on_bad_digits` raises on that count."""
    if not isinstance(digit, torch.Tensor) or digit.device.type != 'cuda':
        raise ValueError("pass_rank_hist_cuda takes a CUDA tensor")
    if digit.dtype != torch.int32 or digit.dim() != 1 \
            or not digit.is_contiguous():
        raise ValueError("digit must be a contiguous 1-D int32 tensor, "
                         "got %s %s" % (digit.dtype, tuple(digit.shape)))
    D = int(D)
    if not 1 <= D <= MAX_DIGITS:
        raise ValueError("the rank kernel takes 1 <= D <= %d, got %d"
                         % (MAX_DIGITS, D))
    n = digit.shape[0]
    if n >= 2 ** 31:
        raise ValueError("the rank kernel takes n < 2**31, got %d" % n)
    rank = torch.empty(n, dtype=torch.int32, device=digit.device)
    if n == 0:
        return rank, torch.zeros(D, dtype=torch.int32, device=digit.device)
    hist = torch.empty(D, dtype=torch.int32, device=digit.device)
    scratch = torch.empty(rank_plan(n, D)['scratch_words'],
                          dtype=torch.int64, device=digit.device)
    rank_pass_launch(digit, D, rank, hist, scratch)
    return rank, hist


pass_rank_hist_cuda.launches = 0


def pass_rank_hist(digit, D):
    """Rank pass dispatched on the tensor's device: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if digit.device.type == 'cpu':
        return pass_rank_hist_plain(digit, D)
    if digit.device.type == 'cuda':
        return pass_rank_hist_cuda(digit.to(torch.int32).contiguous(), D)
    raise ValueError("no rank pass for device %s" % digit.device)

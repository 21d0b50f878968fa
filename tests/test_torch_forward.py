"""The differentiable forward model through the PyTorch port and the JAX
package on the same seeded numpy inputs: the window derivatives at
their kinks, LPT, the KDK stepper and the painted density, the
gradients of the field-level loss (at the zero leaf, where every
particle sits on a node), the paint adjoint as a
``torch.autograd.Function`` and the custom-VJP paints (sort, segsum,
streams) against ``jax.grad``, the grad-mode paint resolution, the growth
table, the inference metrics and Adam's recovery, all in f8; and the
32^3 "recovery beats FFTRecon" contract on the port alone.

The JAX side compiles each program once (~5-10 s), so its results are
cached by module-level functions and shared between tests.
"""

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu
import nbodykit_tpu_torch
import nbodykit_tpu.forward as J
import nbodykit_tpu_torch.forward as T
from nbodykit_tpu.ops import window as jwin
from nbodykit_tpu.pmesh import ParticleMesh as JPM
from nbodykit_tpu_torch import convert
from nbodykit_tpu_torch.forward.adjoint import PaintAdjoint
from nbodykit_tpu_torch.ops import window as twin
from nbodykit_tpu_torch.pmesh import ParticleMesh as TPM

# 16^3 cells in a box of 64: cell units are pos / 4, exact, so the zero
# leaf puts every lattice particle exactly on a node (the window kinks)
N, BOX, STEPS = 16, 64.0, 2
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _on_cpu():
    # one intra-op thread: the forward model is many small ops, and the
    # thread pools of parallel test workers slow each by milliseconds
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


def rel(a, b):
    a, b = an(a), an(b)
    return np.abs(a - b).max() / np.abs(a).max()


# ---------------------------------------------------------------------------
# the window ops at their kinks

def _points(s):
    """Exact nodes, half-nodes and interior points, both signs of the
    offset, for a window of support s."""
    base = np.array([3.0, 3.5, 3.25, 3.75, 0.0, 0.5, 7.999, 5.125])
    return np.concatenate([base, base + 1.0 / 3, -base])


@pytest.mark.parametrize('resampler', ['nnb', 'cic', 'tsc', 'pcs'])
def test_window_weights_differentiate_as_jax_at_kinks(resampler):
    s = twin.window_support(resampler)
    x = _points(s)
    c = np.random.RandomState(s).normal(size=(x.size, s))

    def jloss(xx):
        return jnp.sum(jnp.asarray(c) * jwin.window_weights(xx, resampler)[1])
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    idx, w = twin.window_weights(xt, resampler)
    # nnb's weights are constant: no graph, a zero gradient
    gt = torch.autograd.grad((torch.as_tensor(c) * w).sum(), xt)[0] \
        if w.requires_grad else torch.zeros_like(xt)
    jidx, jw = jwin.window_weights(jnp.asarray(x), resampler)
    # values as before, derivatives JAX's (a tie of max(t, 0) splits
    # the gradient in half, |x| has derivative 1 at 0)
    np.testing.assert_array_equal(an(idx), np.asarray(jidx))
    np.testing.assert_allclose(an(w), np.asarray(jw), rtol=0, atol=1e-15)
    np.testing.assert_allclose(an(gt), gj, rtol=0, atol=1e-12)
    # the analytic derivative companion used by the readout adjoint
    didx, dw = twin.window_weights_grad(torch.as_tensor(x), resampler)
    jdidx, jdw = jwin.window_weights_grad(jnp.asarray(x), resampler)
    np.testing.assert_array_equal(an(didx), np.asarray(jdidx))
    np.testing.assert_allclose(an(dw), np.asarray(jdw), rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# the JAX package's results, computed once

@functools.lru_cache(maxsize=None)
def jax_model():
    return J.ForwardModel(N, N ** 3, BoxSize=BOX, pm_steps=STEPS,
                          dtype='f8')


def port_model():
    return T.ForwardModel(N, N ** 3, BoxSize=BOX, pm_steps=STEPS,
                          dtype='f8', device='cpu')


@functools.lru_cache(maxsize=None)
def jax_run():
    """Truth modes, the ZA and 2LPT start, the evolved particles and the
    observed density of the 16^3 model (one compiled program)."""
    m = jax_model()
    modes = m.linear_modes(3)

    def run(modes):
        lpt1 = J.lpt_init(m.lattice, modes, a=0.1, order=1)
        lpt2 = J.lpt_init(m.lattice, modes, a=0.1, order=2)
        return lpt1, lpt2, m.evolve(modes), m.density(modes)
    return modes, jax.jit(run)(modes)


def leaves():
    """The zero leaf and a seeded random one."""
    rng = np.random.RandomState(5)
    return {'zero': np.zeros((N,) * 3), 'random': 0.3 * rng.normal(
        size=(N,) * 3)}


@functools.lru_cache(maxsize=None)
def jax_grads():
    m = jax_model()
    obs = jax_run()[1][3]
    vg = jax.jit(jax.value_and_grad(J.make_loss(m, obs, noise_std=0.5)))
    return {k: vg(jnp.asarray(w)) for k, w in leaves().items()}


@functools.lru_cache(maxsize=None)
def jax_recover():
    m = jax_model()
    obs = jax_run()[1][3]
    return J.recover(m, obs, steps=5, lr=0.05, noise_std=0.5)


def test_lpt_evolve_density_match_jax():
    jmodes, (lpt1, lpt2, (jpos, jmom), jdens) = jax_run()
    m = port_model()
    modes = m.linear_modes(3)
    assert rel(jmodes, modes) <= RTOL
    # the state carried across gives the same start
    modes_x = convert.modes_from_numpy(np.asarray(jmodes), m)
    assert rel(jmodes, modes_x) <= 1e-15
    for order, (jx, jp) in ((1, lpt1), (2, lpt2)):
        x, p = T.lpt_init(m.lattice, modes_x, a=0.1, order=order)
        assert rel(jx, x) <= RTOL and rel(jp, p) <= RTOL
    pos, mom = m.evolve(modes_x)
    assert rel(jpos, pos) <= RTOL and rel(jmom, mom) <= RTOL
    dens = m.density(modes_x)
    assert dens.shape == (N,) * 3
    assert np.abs(an(dens) - np.asarray(jdens)).max() \
        <= RTOL * np.abs(np.asarray(jdens)).max()
    assert abs(float(dens.mean()) - 1.0) < 1e-12


@pytest.mark.parametrize('leaf', ['zero', 'random'])
def test_loss_gradient_matches_jax(leaf):
    jval, jg = jax_grads()[leaf]
    m = port_model()
    obs = torch.as_tensor(np.asarray(jax_run()[1][3]))
    loss = T.make_loss(m, obs, noise_std=0.5)
    w = convert.white_from_numpy(leaves()[leaf], m).requires_grad_(True)
    val = loss(w)
    g, = torch.autograd.grad(val, w)
    assert abs(float(val.detach()) - float(jval)) <= RTOL * abs(float(jval))
    assert np.abs(an(g) - np.asarray(jg)).max() \
        <= RTOL * np.abs(np.asarray(jg)).max()


def test_recover_matches_jax():
    jw, jlosses = jax_recover()
    m = port_model()
    obs = torch.as_tensor(np.asarray(jax_run()[1][3]))
    w, losses = T.recover(m, obs, steps=5, lr=0.05, noise_std=0.5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9, atol=0)
    assert losses[-1] < losses[0]
    assert rel(jw, w) <= 1e-9


# ---------------------------------------------------------------------------
# the paint adjoint

def _paint_case(resampler):
    rng = np.random.RandomState(42)
    pos = rng.uniform(0.0, 100.0, (64, 3))
    mass = 1.0 + 0.5 * rng.random_sample(64)
    tgt = rng.normal(size=(8, 8, 8))
    return pos, mass, tgt


@pytest.mark.parametrize('resampler', ['cic', 'tsc'])
def test_paint_adjoint_function(resampler):
    """The autograd.Function (scatter forward, readout backward) against
    native autograd through the scatter paint, JAX's custom_vjp of the
    segsum paint, and central differences."""
    pos, mass, tgt = _paint_case(resampler)
    tpm = TPM(8, 100.0, dtype='f8', device='cpu')
    native, cfg = T.make_paint(tpm, 64, resampler, method='scatter')
    assert cfg['adjoint_mode'] == 'native' and native.method == 'scatter'

    def run(p, m):
        return tpm.paint(p, m, resampler=resampler)

    def grads(paint):
        p = torch.tensor(pos, requires_grad=True)
        m = torch.tensor(mass, requires_grad=True)
        out = paint(p, m)
        return torch.autograd.grad((out * torch.as_tensor(tgt)).sum(),
                                   (p, m)), out

    (gp, gm), out = grads(lambda p, m: PaintAdjoint.apply(
        p, m, run, tpm, resampler))
    (np_, nm), nout = grads(native)
    assert torch.equal(out, nout)
    np.testing.assert_allclose(an(gp), an(np_), rtol=0, atol=1e-12)
    np.testing.assert_allclose(an(gm), an(nm), rtol=0, atol=1e-12)

    jpm = JPM(Nmesh=8, BoxSize=100.0, dtype='f8')
    jpaint, jcfg = J.make_paint(jpm, 64, resampler, method='segsum')
    assert jcfg['adjoint_mode'] == 'custom_vjp'
    jgp, jgm = jax.grad(lambda p, m: jnp.sum(jnp.asarray(tgt) * jpaint(p, m)),
                        argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(mass))
    np.testing.assert_allclose(an(gp), np.asarray(jgp), rtol=0, atol=1e-12)
    np.testing.assert_allclose(an(gm), np.asarray(jgm), rtol=0, atol=1e-12)

    # central differences along a seeded direction (eps 1e-6, f8)
    d = np.random.RandomState(1).normal(size=pos.shape)
    d /= np.sqrt((d * d).sum())
    eps = 1e-6

    def f(p):
        return float((run(torch.as_tensor(p), torch.as_tensor(mass))
                      * torch.as_tensor(tgt)).sum())
    fd = (f(pos + eps * d) - f(pos - eps * d)) / (2 * eps)
    dot = float((an(gp) * d).sum())
    assert abs(fd - dot) <= 1e-5 * max(abs(fd), abs(dot), 1e-10)


@pytest.mark.parametrize('method', ['sort', 'segsum', 'streams'])
def test_custom_vjp_paints_match_jax_grad(method):
    """``make_paint(method=...)`` for each paint JAX wraps in
    ``jax.custom_vjp``: mode 'custom_vjp', the method's value, and the
    position and mass gradients of torch.autograd against ``jax.grad``
    through JAX's ``make_paint(method=...)``, within 1e-10 relative in
    f8 (the same readout formula; the values sum in the same order)."""
    pos, mass, tgt = _paint_case('cic')
    tpm = TPM(8, 100.0, dtype='f8', device='cpu')
    jpm = JPM(Nmesh=8, BoxSize=100.0, dtype='f8')
    paint, cfg = T.make_paint(tpm, 64, 'cic', method=method)
    jpaint, jcfg = J.make_paint(jpm, 64, 'cic', method=method)
    assert cfg['adjoint_mode'] == jcfg['adjoint_mode'] == 'custom_vjp'
    assert paint.method == cfg['paint_method'] == method
    p = torch.tensor(pos, requires_grad=True)
    m = torch.tensor(mass, requires_grad=True)
    # the pinned method runs whatever the options say at the call
    with nbodykit_tpu_torch.set_options(paint_method='mxu'):
        out = paint(p, m)
    gp, gm = torch.autograd.grad((out * torch.as_tensor(tgt)).sum(), (p, m))
    jout = jpaint(jnp.asarray(pos), jnp.asarray(mass))
    jgp, jgm = jax.grad(
        lambda a, b: jnp.sum(jnp.asarray(tgt) * jpaint(a, b)),
        argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(mass))
    assert rel(jout, out) <= RTOL
    assert rel(jgp, gp) <= RTOL and rel(jgm, gm) <= RTOL
    # the native scatter gradient at these displaced positions
    native, _ = T.make_paint(tpm, 64, 'cic', method='scatter')
    ngp, ngm = torch.autograd.grad(
        (native(p, m) * torch.as_tensor(tgt)).sum(), (p, m))
    assert rel(ngp, gp) <= RTOL and rel(ngm, gm) <= RTOL


def test_grad_mode_paint_resolution_as_jax(caplog):
    """mxu has no backward: grad mode demotes it to scatter, openly, in
    both packages; pinning it raises."""
    saved = dict(nbodykit_tpu._global_options)
    try:
        nbodykit_tpu.set_options(paint_method='mxu')
        jcfg, jmode = J.resolve_forward_paint(
            JPM(Nmesh=8, BoxSize=100.0, dtype='f8'), 64)
    finally:
        nbodykit_tpu._global_options.clear()
        nbodykit_tpu._global_options.update(saved)
    tpm = TPM(8, 100.0, dtype='f8', device='cpu')
    with nbodykit_tpu_torch.set_options(paint_method='mxu'):
        with caplog.at_level(logging.WARNING):
            cfg, mode = T.resolve_forward_paint(tpm, 64)
        paint, pcfg = T.make_paint(tpm, 64, 'cic')
    for key in ('paint_method', 'source', 'winner_name'):
        assert cfg[key] == jcfg[key], key
    assert (cfg['paint_method'], cfg['source'], cfg['winner_name'], mode) \
        == ('scatter', 'grad-fallback', 'mxu', jmode)
    assert any("demoting 'mxu'" in r.getMessage() for r in caplog.records)
    # the paint runs the method it reports, whatever the options say later
    assert paint.method == pcfg['paint_method'] == 'scatter'
    with nbodykit_tpu_torch.set_options(paint_method='mxu'):
        out = paint(torch.zeros((4, 3), dtype=torch.float64))
    assert float(out.sum()) == pytest.approx(4.0)
    # 'auto' is mxu on the card, so the card's forward model demotes too
    cuda = nbodykit_tpu_torch.resolve_paint(torch.device('cuda'),
                                            differentiable=True)
    assert (cuda['paint_method'], cuda['source']) == ('scatter',
                                                      'grad-fallback')
    for make in (J.make_paint, T.make_paint):
        pm = JPM(Nmesh=8, BoxSize=100.0, dtype='f8') \
            if make is J.make_paint else tpm
        with pytest.raises(ValueError, match='adjoint contract'):
            make(pm, 64, 'cic', method='mxu')


# ---------------------------------------------------------------------------
# growth, the prefactors, and the inference metrics

def test_growth_table_and_prefactors_match_jax():
    for om in (0.3, 1.0):
        jg, tg = J.GrowthTable(om), T.GrowthTable(om)
        for a in (0.1, 0.33, 0.77, 1.0):
            for f in ('D1', 'f1', 'D2', 'f2', 'E'):
                assert getattr(tg, f)(a) == pytest.approx(
                    getattr(jg, f)(a), rel=1e-12), (om, a, f)
        for a0, a1 in ((0.1, 0.4), (0.5, 1.0)):
            assert tg.dkick(a0, a1) == pytest.approx(jg.dkick(a0, a1),
                                                     rel=1e-12)
            assert tg.ddrift(a0, a1) == pytest.approx(jg.ddrift(a0, a1),
                                                      rel=1e-12)
    for a0, a1 in ((0.1, 0.55), (0.55, 1.0)):
        assert T.dkick(a0, a1) == J.dkick(a0, a1)
        assert T.ddrift(a0, a1) == J.ddrift(a0, a1)
    # the LCDM start at 8^3 through the table's growth
    jm = J.ForwardModel(8, pm_steps=1, order=2, omega_m=0.3, dtype='f8',
                        BoxSize=32.0)
    tm = T.ForwardModel(8, pm_steps=1, order=2, omega_m=0.3, dtype='f8',
                        BoxSize=32.0, device='cpu')
    jmodes = jm.linear_modes(4)
    jx, jp = J.lpt_init(jm.lattice, jmodes, a=0.1, growth=jm.growth)
    x, p = T.lpt_init(tm.lattice, convert.modes_from_numpy(
        np.asarray(jmodes), tm), a=0.1, growth=tm.growth)
    assert rel(jx, x) <= RTOL and rel(jp, p) <= RTOL


def test_inference_metrics_match_jax():
    rng = np.random.RandomState(11)
    jpm = JPM(Nmesh=8, BoxSize=100.0, dtype='f8')
    tpm = TPM(8, 100.0, dtype='f8', device='cpu')
    a, b = (jpm.r2c(jnp.asarray(rng.normal(size=(8, 8, 8))))
            for _ in range(2))
    ta, tb = (torch.as_tensor(np.asarray(x)) for x in (a, b))
    for (jk, jv, jn), (k, v, n) in (
            (J.binned_power(jpm, a), T.binned_power(tpm, ta)),
            (J.cross_correlation(jpm, a, b), T.cross_correlation(tpm, ta,
                                                                 tb))):
        np.testing.assert_allclose(an(k), np.asarray(jk), rtol=1e-15)
        np.testing.assert_allclose(an(v), np.asarray(jv), rtol=1e-12)
        np.testing.assert_array_equal(an(n), np.asarray(jn))
    for kmax in (None, 0.2):
        assert float(T.mean_cross_correlation(tpm, ta, tb, kmax)) == \
            pytest.approx(float(J.mean_cross_correlation(jpm, a, b, kmax)),
                          rel=1e-12)
    # the linear start inverts the modes-from-white map
    jm = J.ForwardModel(8, dtype='f8', BoxSize=32.0, pm_steps=1)
    tm = T.ForwardModel(8, dtype='f8', BoxSize=32.0, pm_steps=1,
                        device='cpu')
    obs = 1.0 + 0.1 * rng.normal(size=(8, 8, 8))
    assert rel(J.linear_init(jm, jnp.asarray(obs)),
               T.linear_init(tm, torch.as_tensor(obs))) <= RTOL
    with pytest.raises(ValueError, match='nmesh'):
        T.linear_init(T.ForwardModel(16, 8 ** 3, BoxSize=100.0,
                                     device='cpu'),
                      torch.ones((16,) * 3, dtype=torch.float64))
    assert sorted(T.__all__) == sorted(J.__all__)


def test_recovery_beats_fftrecon_small():
    """32^3: linear-start Adam recovery of the initial field beats
    FFTRecon (LGS) on whole-field cross-correlation with the truth (the
    JAX package's contract, on the port alone)."""
    model = T.ForwardModel(32, 32 ** 3, BoxSize=1000.0, pm_steps=2,
                           dtype='f8', device='cpu')
    truth = model.linear_modes(0)
    obs = model.density(truth)
    w, losses = T.recover(model, obs, steps=80, lr=0.1, noise_std=0.1,
                          white0=T.linear_init(model, obs))
    assert losses[-1] < losses[0]
    lat = model.lattice
    r_rec = float(T.mean_cross_correlation(
        lat, model.modes_from_white(w), truth))
    pos, _ = model.evolve(truth)
    base = T.fftrecon_baseline(model, pos)
    r_base = float(T.mean_cross_correlation(lat, base, truth))
    assert r_rec > r_base, \
        "recovered r=%.4f does not beat FFTRecon r=%.4f" % (r_rec, r_base)

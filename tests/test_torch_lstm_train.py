"""The port's training-path LSTM ops on the CPU against the JAX reference:
the plain versions of the three kernels of ``csrc/lstm.cu``
against the Pallas kernels they replace (interpret mode), and the
gradients of the two autograd Functions against ``jax.grad`` of the XLA
scan, with the loss functions and tolerances of ``tests/test_lstm_vjp.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.ops import bilstm_layer as jax_bilstm_layer
from phones_las_tpu.ops import init_lstm_params as jax_init_lstm_params
from phones_las_tpu.ops import lstm_layer as jax_lstm_layer
from phones_las_tpu.ops.lstm import (
    _recurrence_pallas,
    _recurrence_pallas_bwd,
    _recurrence_pallas_residual,
)

from phones_las_torch.ops import lstm as L
from phones_las_torch.ops.masking import length_mask
from tests.torch_threads import one_thread

one_thread()

B, T, D, U = 3, 11, 6, 8
LENS = {11: np.array([11, 7, 4]), 70: np.array([70, 33, 9])}
# float32: sums in another order than the reference's; bf16: the bounds
# the port's kernels are held to on the card (residuals and the VJP looser)
TOL = {"highest": 1e-5, "bf16": 2e-2}
RES_TOL = {"highest": 1e-5, "bf16": 3e-2}
VJP_TOL = {"highest": 1e-5, "bf16": 3e-2}


def _inputs(t, seed):
    rs = np.random.RandomState(seed)
    xp = rs.randn(t, B, 4 * U).astype(np.float32)
    wh = (rs.randn(U, 4 * U) * 0.3).astype(np.float32)
    mask = np.asarray(length_mask(torch.from_numpy(LENS[t]), t).t())
    return xp, mask, wh, rs


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(_np(x).copy())


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_plain_matches_pallas_interpret(reverse, prec):
    _check_recurrence(reverse, prec, T)


def _check_recurrence(reverse, prec, t):
    xp, mask, wh, _ = _inputs(t, 0)
    ref_out, (rh, rc) = _recurrence_pallas(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse, interpret=True, prec=prec
    )
    out, (h, c) = L.recurrence(_t(xp), _t(mask), _t(wh), 1.0, reverse, prec)
    for got, want in ((out, ref_out), (h, rh), (c, rc)):
        _close(got, want, TOL[prec])
    assert L.recurrence.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_residual_plain_matches_pallas_interpret(reverse, prec):
    _check_recurrence_residual(reverse, prec, T)


def _check_recurrence_residual(reverse, prec, t):
    xp, mask, wh, _ = _inputs(t, 1)
    ref = _recurrence_pallas_residual(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse, interpret=True, prec=prec
    )
    (got,) = L.recurrence_residual([_t(xp)], _t(mask), [_t(wh)], 1.0, [reverse], prec)
    assert got[1].dtype == got[2].dtype == (torch.bfloat16 if prec == "bf16" else torch.float32)
    for i, (g, w) in enumerate(zip(got, ref)):
        _close(g, w, RES_TOL[prec] if i in (1, 2) else TOL[prec])


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_bwd_plain_matches_pallas_interpret(reverse, prec):
    _check_recurrence_bwd(reverse, prec, T)


def _check_recurrence_bwd(reverse, prec, t):
    xp, mask, wh, rs = _inputs(t, 2)
    _, hprev, cprev, _, _ = _recurrence_pallas_residual(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse, interpret=True, prec=prec
    )
    dout = rs.randn(t, B, U).astype(np.float32)
    dh, dc = rs.randn(B, U).astype(np.float32), rs.randn(B, U).astype(np.float32)
    ref_dxp, ref_dwh = _recurrence_pallas_bwd(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), hprev, cprev, jnp.asarray(dout),
        jnp.asarray(dh), jnp.asarray(dc), reverse=reverse, interpret=True, prec=prec,
    )
    rdt = torch.bfloat16 if prec == "bf16" else torch.float32
    ((dxp, dwh),) = L.recurrence_bwd(
        [_t(xp)], _t(mask), [_t(wh)], [_t(hprev).to(rdt)], [_t(cprev).to(rdt)], [_t(dout)],
        [_t(dh)], [_t(dc)], 1.0, [reverse], prec,
    )
    for got, want in ((dxp, ref_dxp), (dwh, ref_dwh)):
        want = _np(want)
        err = float(np.abs(got.numpy() - want).max()) / max(float(np.abs(want).max()), 1e-6)
        assert err <= VJP_TOL[prec], err
    # masked steps (past each row's length) pass no gradient into xp
    assert float(dxp[LENS[t][2]:, 2].abs().max()) == 0.0


def test_plain_kernels_multiblock_match_pallas_interpret():
    """T = 70 spans several of the reference kernels' time blocks."""
    _check_recurrence(True, "highest", 70)
    _check_recurrence_residual(False, "highest", 70)
    _check_recurrence_bwd(True, "highest", 70)


def _torch_lstm(p, requires_grad=True):
    t = L.LSTMParams(p.wx.shape[0], p.wh.shape[0])
    with torch.no_grad():
        for name in ("wx", "wh", "b"):
            getattr(t, name).copy_(_t(getattr(p, name)))
            getattr(t, name).requires_grad_(requires_grad)
    return t


def _setup(t, seed=0):
    p = jax_init_lstm_params(jax.random.PRNGKey(seed), D, U)
    p = p._replace(b=jnp.asarray(np.random.RandomState(seed).randn(4 * U) * 0.1, jnp.float32))
    x = np.random.RandomState(seed + 1).randn(B, t, D).astype(np.float32)
    return p, x, LENS[t]


def _weights(n, shape):
    return np.cos(np.arange(n)).reshape(shape).astype(np.float32)


def _uni_loss_jax(reverse, prec=None):
    def loss(p, x, lens):
        out, (h, c) = jax_lstm_layer(p, x, lens, reverse=reverse, implementation="xla", precision=prec)
        return (
            jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape)))
            + 2.0 * jnp.sum(h * h)
            + jnp.sum(jnp.sin(c))
        )

    return loss


def _uni_loss_torch(p, x, lens, reverse, prec):
    out, (h, c) = L.lstm_layer(p, x, lens, reverse=reverse, prec=prec)
    w = torch.from_numpy(_weights(out.numel(), tuple(out.shape)))
    return torch.sum(out * w) + 2.0 * torch.sum(h * h) + torch.sum(torch.sin(c))


@pytest.mark.parametrize("t,tol", [(T, 2e-4), (70, 5e-4)])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_function_grads_match_jax(reverse, t, tol):
    p, x, lens = _setup(t)
    ref_loss = _uni_loss_jax(reverse)
    ref_val = float(ref_loss(p, jnp.asarray(x), jnp.asarray(lens)))
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(p, jnp.asarray(x), jnp.asarray(lens))

    tp = _torch_lstm(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = _uni_loss_torch(tp, tx, torch.from_numpy(lens), reverse, "highest")
    assert loss.grad_fn is not None
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_val, rtol=1e-5, atol=1e-5)
    for got, want in ((tp.wx.grad, gp.wx), (tp.wh.grad, gp.wh), (tp.b.grad, gp.b), (tx.grad, gx)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol, atol=tol)


def test_recurrence_function_bf16_close_to_f32():
    p, x, lens = _setup(T)
    gp = jax.grad(_uni_loss_jax(False))(p, jnp.asarray(x), jnp.asarray(lens))
    tp = _torch_lstm(p)
    _uni_loss_torch(tp, torch.from_numpy(x), torch.from_numpy(lens), False, "bf16").backward()
    for got, want in ((tp.wx.grad, gp.wx), (tp.wh.grad, gp.wh), (tp.b.grad, gp.b)):
        want = _np(want)
        assert float(np.abs(got.numpy() - want).max()) / max(float(np.abs(want).max()), 1e-6) < 3e-2


def _bidir_loss_jax(params, x, lens, prec=None):
    out, ((hf, cf), (hb, cb)) = jax_bilstm_layer(params[0], params[1], x, lens, implementation="xla", precision=prec)
    return jnp.sum(out**2) + jnp.sum(hf * cb) + jnp.sum(hb * cf)


@pytest.mark.parametrize("t,tol", [(T, 3e-4), (70, 5e-4)])
def test_bidir_function_grads_match_jax(t, tol):
    pf, x, lens = _setup(t, 0)
    pb, _, _ = _setup(t, 5)
    xj, lj = jnp.asarray(x), jnp.asarray(lens)
    ref_val = float(_bidir_loss_jax((pf, pb), xj, lj))
    g_ref, gx_ref = jax.grad(_bidir_loss_jax, argnums=(0, 1))((pf, pb), xj, lj)

    tf_, tb = _torch_lstm(pf), _torch_lstm(pb)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, ((hf, cf), (hb, cb)) = L.bilstm_layer(tf_, tb, tx, torch.from_numpy(lens))
    loss = torch.sum(out**2) + torch.sum(hf * cb) + torch.sum(hb * cf)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_val, rtol=1e-5)
    for tp, jp in ((tf_, g_ref[0]), (tb, g_ref[1])):
        for name in ("wx", "wh", "b"):
            np.testing.assert_allclose(
                getattr(tp, name).grad.numpy(), _np(getattr(jp, name)), rtol=tol, atol=tol
            )
    np.testing.assert_allclose(tx.grad.numpy(), _np(gx_ref), rtol=tol, atol=tol)


def test_bidir_function_bf16_close_to_f32():
    pf, x, lens = _setup(T, 0)
    pb, _, _ = _setup(T, 5)
    g_ref = jax.grad(_bidir_loss_jax)((pf, pb), jnp.asarray(x), jnp.asarray(lens))
    tf_, tb = _torch_lstm(pf), _torch_lstm(pb)
    out, ((hf, cf), (hb, cb)) = L.bilstm_layer(tf_, tb, torch.from_numpy(x), torch.from_numpy(lens), prec="bf16")
    (torch.sum(out**2) + torch.sum(hf * cb) + torch.sum(hb * cf)).backward()
    for tp, jp in ((tf_, g_ref[0]), (tb, g_ref[1])):
        for name in ("wx", "wh", "b"):
            want = _np(getattr(jp, name))
            got = getattr(tp, name).grad.numpy()
            assert float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6) < 3e-2


def test_layers_without_grad_take_the_primal_and_unused_state_grads_are_zeros():
    """No grad: the primal (no Function node). Under grad, a loss of the
    outputs alone gives the backward zero cotangents for the final state."""
    p, x, lens = _setup(T)
    tp = _torch_lstm(p)
    with torch.no_grad():
        out_ng, _ = L.lstm_layer(tp, torch.from_numpy(x), torch.from_numpy(lens))
    out, (h, c) = L.lstm_layer(tp, torch.from_numpy(x), torch.from_numpy(lens))
    assert out_ng.grad_fn is None and out.grad_fn is not None
    torch.testing.assert_close(out.detach(), out_ng, rtol=0, atol=0)
    out.sum().backward()
    assert torch.isfinite(tp.wh.grad).all()


def test_init_lstm_params_fan_in_rule():
    g = torch.Generator().manual_seed(0)
    p = L.init_lstm_params(40, 16, g)
    limit = np.sqrt(6.0 / (40 + 16 + 64))
    for w in (p.wx, p.wh):
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert float(p.b.abs().max()) == 0.0
    q = L.init_lstm_params(40, 16, torch.Generator().manual_seed(0))
    assert torch.equal(p.wx, q.wx) and torch.equal(p.wh, q.wh)


def test_resolve_rnn_precision_rule():
    assert L.resolve_rnn_precision("highest") == "highest"
    assert L.resolve_rnn_precision("bf16") == "bf16"
    for amb in ("default", "fastest", "bfloat16"):
        assert L.resolve_rnn_precision(amb) == "bf16"
    assert L.resolve_rnn_precision("high") == "highest"
    assert L.resolve_rnn_precision(None) == "highest"

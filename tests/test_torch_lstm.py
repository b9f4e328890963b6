"""The port's LSTM ops (plain PyTorch path, CPU) against the JAX
reference: ``bilstm_layer`` against the Pallas path in interpret mode,
``lstm_layer`` against the XLA scan, and the pyramid/mask helpers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.ops import bilstm_layer as jax_bilstm_layer
from phones_las_tpu.ops import init_lstm_params
from phones_las_tpu.ops import lstm_layer as jax_lstm_layer
from phones_las_tpu.ops import pyramid_reduce as jax_pyramid_reduce

from phones_las_torch.ops.lstm import (
    LSTMParams,
    bidir_recurrence,
    bidir_recurrence_plain,
    bilstm_layer,
    lstm_layer,
)
from phones_las_torch.ops.masking import length_mask
from phones_las_torch.ops.pyramid import pyramid_reduce
from tests.torch_threads import one_thread

one_thread()

B, T, D, U = 3, 11, 6, 8
LENS = np.array([11, 7, 4])
# float32: sums in another order than XLA's; bf16: the JAX test's own
# bound for the bf16 recurrent dot (tests/test_lstm_ops.py)
TOL = {"highest": 1e-5, "bf16": 2e-2}


def _torch_params(p):
    t = LSTMParams(p.wx.shape[0], p.wh.shape[0])
    with torch.no_grad():
        for name in ("wx", "wh", "b"):
            getattr(t, name).copy_(torch.tensor(np.asarray(getattr(p, name))))
    return t


def _setup(seed):
    pf = init_lstm_params(jax.random.PRNGKey(seed), D, U)
    pb = init_lstm_params(jax.random.PRNGKey(seed + 1), D, U)
    # a non-zero bias, so the bias path is exercised too
    pf = pf._replace(b=jnp.asarray(np.random.RandomState(seed).randn(4 * U) * 0.1, jnp.float32))
    x = np.random.RandomState(seed).randn(B, T, D).astype(np.float32)
    return pf, pb, x


@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_bilstm_matches_jax_pallas_interpret(prec):
    pf, pb, x = _setup(0)
    ref_out, ((rhf, rcf), (rhb, rcb)) = jax_bilstm_layer(
        pf, pb, jnp.asarray(x), jnp.asarray(LENS), implementation="pallas", precision=prec
    )
    got_out, ((hf, cf), (hb, cb)) = bilstm_layer(
        _torch_params(pf), _torch_params(pb), torch.from_numpy(x), torch.from_numpy(LENS), prec=prec
    )
    tol = TOL[prec]
    for got, ref in ((got_out, ref_out), (hf, rhf), (cf, rcf), (hb, rhb), (cb, rcb)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol
        )
    assert np.abs(got_out.numpy()[2, 4:]).max() == 0.0  # zero past the length


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax_xla(reverse):
    pf, _, x = _setup(4)
    ref_out, (rh, rc) = jax_lstm_layer(pf, jnp.asarray(x), jnp.asarray(LENS), reverse=reverse)
    out, (h, c) = lstm_layer(_torch_params(pf), torch.from_numpy(x), torch.from_numpy(LENS), reverse=reverse)
    for got, ref in ((out, ref_out), (h, rh), (c, rc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bidir_recurrence_cpu_runs_plain_and_checks_prec():
    rs = np.random.RandomState(2)
    xpf, xpb = (torch.from_numpy(rs.randn(T, B, 4 * U).astype(np.float32)) for _ in range(2))
    whf, whb = (torch.from_numpy(rs.randn(U, 4 * U).astype(np.float32) * 0.2) for _ in range(2))
    mask = length_mask(torch.from_numpy(LENS), T).transpose(0, 1).contiguous()
    got = bidir_recurrence(xpf, xpb, mask, whf, whb)
    want = bidir_recurrence_plain(xpf, xpb, mask, whf, whb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="prec"):
        bidir_recurrence(xpf, xpb, mask, whf, whb, prec="high")


def test_pyramid_and_mask_match_jax():
    x = np.random.RandomState(3).randn(2, 7, 4).astype(np.float32)
    lens = np.array([7, 3])
    rx, rl = jax_pyramid_reduce(jnp.asarray(x), jnp.asarray(lens))
    gx, gl = pyramid_reduce(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    assert gx.shape == (2, 4, 8) and gl.tolist() == [4, 2]
    m = length_mask(torch.tensor([0, 2, 5]), 4)
    np.testing.assert_array_equal(m.numpy(), [[0, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1]])

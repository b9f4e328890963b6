"""What the port's two cluster kernels leave to Python, on the CPU: the
regrouping of ``wh`` by unit slice, the forward kernel's decomposition
(unit slices × batch tiles) emulated in plain PyTorch against the plain
recurrence and the JAX reference, the decoder's grouping of rows against
the ungrouped decode and JAX ``greedy_decode``, and the wrappers' choice
of cluster size and tile from a shape."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import init_las
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.ops.lstm import _recurrence_pallas_residual, _recurrence_xla

from phones_las_torch.decode import fused_greedy as FG
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.ops import lstm as L
from phones_las_torch.utils.param_io import config_from_dict, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

# the emulation against the plain loop: the same float32 sums cut into
# slices; against JAX: the tolerances of tests/test_torch_lstm.py (float32
# sums in another order than XLA's; the JAX test's own bf16 bound)
EMU_TOL = 1e-6
JAX_TOL = {"highest": 1e-5, "bf16": 2e-2}
JAX_RES_TOL = {"highest": 1e-5, "bf16": 3e-2}

T, B, U = 9, 19, 64  # B: two full tiles of 8 and a ragged one; one of 16 and a ragged one


@pytest.mark.parametrize("u", [32, 64, 256])
@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_regroup_wh_round_trip(c, u):
    wh = torch.from_numpy(np.random.RandomState(u + c).randn(u, 4 * u).astype(np.float32))
    wg = L.regroup_wh(wh, c)
    us = u // c
    assert wg.shape == (c, u, 4 * us) and wg.is_contiguous()
    assert torch.equal(L.ungroup_wh(wg), wh)
    # slice s, local column g·Us + j is wh's column g·U + s·Us + j
    s, g, j = c - 1, 2, us - 1
    assert torch.equal(wg[s, :, g * us + j], wh[:, g * u + s * us + j])
    # the tensor-core layout: k contiguous, padded to a multiple of 16
    wt = L._kernel_wh(wh, c, "bf16")
    assert wt.shape == (c, 4 * us, -(-u // 16) * 16) and wt.dtype == torch.bfloat16
    assert torch.equal(wt[s, g * us + j, :u], wh[:, g * u + s * us + j].to(torch.bfloat16))
    # the decoder's slicing of a cell's weights is the same regrouping
    assert torch.equal(FG.column_slices(wh, c, gates=4), wg)


def _lstm_inputs(seed):
    rs = np.random.RandomState(seed)
    xp = rs.randn(T, B, 4 * U).astype(np.float32)
    wh = (rs.randn(U, 4 * U) * 0.2).astype(np.float32)
    lens = rs.randint(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return xp, mask, wh


def cluster_recurrence_emulated(xp_tm, mask_tm, wh, forget_bias, reverse, prec="highest",
                                cluster=8, bt=8, save_res=False):
    """The forward kernel's decomposition in plain PyTorch → (out, hprev or
    None, cprev or None, h, c), as ``ops/lstm.py::_recurrence_loop``: batch tiles of
    ``bt`` rows (the last one ragged), and within a tile ``cluster``
    blocks, each computing the gates of its unit slice from the regrouped
    wh and the full h, updating its own c and h, and the slices reassembled
    into the full h for the next step."""
    t, b, four_u = xp_tm.shape
    u = four_u // 4
    us = u // cluster
    wg = L._dot_operand(L.regroup_wh(wh, cluster), prec)  # [C, U, 4·Us]
    out = torch.empty((t, b, u), dtype=torch.float32)
    hprev = torch.empty((t, b, u), dtype=L._res_dtype(prec)) if save_res else None
    cprev = torch.empty_like(hprev) if save_res else None
    hfin, cfin = torch.empty((b, u)), torch.empty((b, u))
    for r0 in range(0, b, bt):
        rows = slice(r0, min(b, r0 + bt))
        n = rows.stop - r0
        h_full = torch.zeros((n, u))  # every block's copy of the tile's h
        c_sl = [torch.zeros((n, us)) for _ in range(cluster)]
        for tt in L._time_order(t, reverse):
            if save_res:
                hprev[tt, rows] = h_full
                cprev[tt, rows] = torch.cat(c_sl, dim=-1)
            m = mask_tm[tt, rows][:, None]
            h_new_full = torch.empty_like(h_full)
            for s in range(cluster):
                units = slice(s * us, (s + 1) * us)
                # this block's columns of xp[t]: gate g at g·U + s·Us
                xs = xp_tm[tt, rows].reshape(n, 4, u)[:, :, units].reshape(n, 4 * us)
                gates = xs + torch.matmul(L._dot_operand(h_full, prec), wg[s])
                h_new, c_new = L._cell_math(gates, c_sl[s], forget_bias)
                h_new_full[:, units] = m * h_new + (1.0 - m) * h_full[:, units]
                c_sl[s] = m * c_new + (1.0 - m) * c_sl[s]
                out[tt, rows, units] = m * h_new
            h_full = h_new_full
        hfin[rows], cfin[rows] = h_full, torch.cat(c_sl, dim=-1)
    return out, hprev, cprev, hfin, cfin


@pytest.mark.parametrize("cluster,bt", [(1, 8), (4, 8), (8, 16), (16, 24)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_cluster_emulation_matches_plain_and_jax(prec, reverse, cluster, bt):
    xp, mask, wh = _lstm_inputs(3)
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    out, _, _, h, c = cluster_recurrence_emulated(txp, tmask, twh, 1.0, reverse, prec, cluster, bt)
    pout, (ph, pc) = L.recurrence_plain(txp, tmask, twh, 1.0, reverse, prec)
    ref_out, (rh, rc) = _recurrence_xla(jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), 1.0, reverse, prec)
    for got, plain, ref in ((out, pout, ref_out), (h, ph, rh), (c, pc, rc)):
        # bf16: a sum in another order can move a rounding of h by one bf16 step
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=EMU_TOL if prec == "highest" else 1e-2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=JAX_TOL[prec], atol=JAX_TOL[prec])


@pytest.mark.parametrize("cluster,bt", [(2, 8), (8, 16)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_cluster_emulation_residuals_match_plain_and_pallas(prec, reverse, cluster, bt):
    xp, mask, wh = _lstm_inputs(4)
    txp, tmask, twh = torch.from_numpy(xp), torch.from_numpy(mask), torch.from_numpy(wh)
    got = cluster_recurrence_emulated(txp, tmask, twh, 1.0, reverse, prec, cluster, bt, save_res=True)
    (plain,) = L.recurrence_residual_plain([txp], tmask, [twh], 1.0, [reverse], prec)
    ref = _recurrence_pallas_residual(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse, interpret=True, prec=prec
    )
    rdt = torch.bfloat16 if prec == "bf16" else torch.float32
    assert got[1].dtype == got[2].dtype == rdt
    for i, (g, p, r) in enumerate(zip(got, plain, ref)):
        res = i in (1, 2)
        emu_tol = EMU_TOL if prec == "highest" else (3e-2 if res else 1e-2)
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(), rtol=0, atol=emu_tol)
        tol = JAX_RES_TOL[prec] if res else JAX_TOL[prec]
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=tol, atol=tol)


V, BOS, EOS, M = 11, 1, 2, 16


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _speller(num_layers):
    """The small model of tests/test_torch_greedy.py: JAX params and the port's."""
    sp = dict(
        vocab_size=V, embedding_dim=8, num_layers=num_layers, units=16, memory_dim=M,
        attention_type="bahdanau", attention_units=16, attention_layer_size=16,
        bos_id=BOS, eos_id=EOS,
    )
    jcfg = JaxLASConfig(listener=JaxListenerConfig(input_dim=120, num_layers=1, units=M // 2),
                        speller=JaxSpellerConfig(**sp))
    jparams = init_las(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(_flat(jparams), tcfg, device="cpu")


def greedy_decode_grouped_plain(params, cfg, memory, enc_mask, max_steps, rows):
    """The decoder kernel's grouping in plain PyTorch: the batch cut into
    groups of ``rows``, the last one padded (rows with no valid encoder
    position, dropped afterwards), each group decoded on its own and
    stopping on its own → (tokens, lengths)."""
    b = memory.shape[0]
    toks = []
    for r0 in range(0, b, rows):
        mem, mask = memory[r0:r0 + rows], enc_mask[r0:r0 + rows]
        n = mem.shape[0]
        if n < rows:
            mem = torch.cat([mem, mem.new_zeros((rows - n, *mem.shape[1:]))])
            mask = torch.cat([mask, mask.new_zeros((rows - n, mask.shape[1]))])
        tok, _ = FG.greedy_decode_fused_plain(params, cfg, mem, mask, max_steps)
        toks.append(tok[:n])
    tokens = torch.cat(toks)
    return tokens, FG.decoded_lengths(tokens, cfg.eos_id)


@pytest.mark.parametrize("num_layers,b,rows", [(2, 5, 8), (2, 11, 8), (1, 19, 8), (2, 7, 4), (1, 8, 8), (2, 1, 8)])
def test_grouped_decode_matches_ungrouped_and_jax(num_layers, b, rows):
    jcfg, jp, tcfg, tp = _speller(num_layers)
    rs = np.random.RandomState(b)
    t_enc, steps = 13, 9
    mem = rs.randn(b, t_enc, M).astype(np.float32)
    lens = rs.randint(4, t_enc + 1, b)
    mask = (np.arange(t_enc)[None, :] < lens[:, None]).astype(np.float32)
    tm, tk = torch.from_numpy(mem), torch.from_numpy(mask)
    tok, ln = greedy_decode_grouped_plain(tp.speller, tcfg.speller, tm, tk, steps, rows)
    ptok, pln = FG.greedy_decode_fused_plain(tp.speller, tcfg.speller, tm, tk, steps)
    ref_tok, ref_len, _ = jax_greedy_decode(jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=steps)
    assert tok.shape == (b, steps)
    np.testing.assert_array_equal(tok.numpy(), ptok.numpy())
    np.testing.assert_array_equal(ln.numpy(), pln.numpy())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ref_len))


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_column_slices(c):
    rs = np.random.RandomState(c)
    w = torch.from_numpy(rs.randn(12, 32).astype(np.float32))
    sl = FG.column_slices(w, c)
    assert sl.shape == (c, 12, 32 // c) and sl.is_contiguous()
    assert torch.equal(sl[c - 1], w[:, 32 - 32 // c:])
    bias = torch.arange(4 * 32.0)
    bs = FG.column_slices(bias, c, gates=4)
    n = 32 // c
    assert bs.shape == (c, 4 * n)
    assert bs[c - 1].tolist() == [g * 32 + (c - 1) * n + j for g in range(4) for j in range(n)]
    with pytest.raises(ValueError):
        FG.column_slices(w, 5)


FLAGSHIP_U = 256


@pytest.mark.parametrize(
    "b,nd,prec,max_active,want",
    [
        # the listener's serving shape: 16 clusters of 8 rows fit in one wave, or 8 of 16 rows
        (64, 2, "highest", 16, (8, 8, 8, True)),
        (64, 2, "highest", 8, (8, 16, 4, True)),
        (64, 2, "bf16", 16, (8, 8, 1, True)),
        # the training shape and the ops API's
        (32, 2, "highest", 16, (8, 8, 8, True)),
        (32, 1, "highest", 16, (8, 8, 8, True)),
        (32, 1, "bf16", 2, (8, 16, 1, True)),
        # small and ragged batches
        (1, 1, "highest", 16, (8, 8, 8, True)),
        (7, 2, "highest", 16, (8, 8, 8, True)),
        # more rows than one wave holds: the largest tile
        (512, 2, "highest", 16, (8, 16, 4, True)),
        # nothing known of the card: the largest tile that fits
        (64, 2, "highest", None, (8, 16, 4, True)),
        (7, 2, "highest", None, (8, 8, 8, True)),
    ],
)
def test_forward_plan_flagship(b, nd, prec, max_active, want):
    seen = []

    def active(c, bt, ks):
        seen.append((c, bt))
        return max_active

    plan = L.forward_plan(b, FLAGSHIP_U, nd, prec, None if max_active is None else active)
    assert tuple(plan[:4]) == want
    assert plan.smem == L.forward_smem_bytes(FLAGSHIP_U, plan.cluster, plan.bt, plan.ksplit, prec == "bf16")
    assert plan.smem <= L.SMEM_MAX
    # the same arguments give the same plan: nothing is read but the shape
    assert L.forward_plan(b, FLAGSHIP_U, nd, prec, None if max_active is None else active) == plan


@pytest.mark.parametrize(
    "u,prec,want",
    [
        (8, "highest", (1, True)),  # slices of 8 units: only the whole of U = 8
        (40, "highest", (1, True)),
        (40, "bf16", (1, True)),
        (248, "highest", (1, True)),  # 31 · 8 units: no cluster cut holds wh (984 KB): the grid layout
        (248, "bf16", (1, True)),
        (64, "highest", (8, True)),
        (128, "highest", (8, True)),
        (16, "bf16", (2, True)),
    ],
)
def test_forward_plan_other_widths(u, prec, want):
    plan = L.forward_plan(20, u, 2, prec, lambda *a: 16)
    assert (plan.cluster, plan.resident) == want and (plan.grid is not None) == (u == 248)
    assert u % plan.cluster == 0 and (u // plan.cluster) % 8 == 0
    assert plan.smem <= L.SMEM_MAX


@pytest.mark.parametrize("u", [0, 12, 260])
def test_forward_plan_refuses(u):
    with pytest.raises(ValueError):
        L.forward_plan(4, u, 1)


@pytest.mark.parametrize("b,groups", [(1, 1), (7, 1), (8, 1), (9, 2), (64, 8)])
def test_decoder_plan_flagship(b, groups):
    cfg = SpellerConfig(vocab_size=26, embedding_dim=128, num_layers=2, units=256, memory_dim=512,
                        attention_units=256, attention_layer_size=256)
    assert FG.decoder_plan(b, cfg) == FG.DecoderPlan(8, FG.GROUP_ROWS, groups)


@pytest.mark.parametrize(
    "units,attention_units,layer,want",
    [(16, 16, 16, 4), (256, 256, 24, 2), (36, 256, 256, 1), (64, 32, 64, 8)],
)
def test_decoder_plan_other_widths(units, attention_units, layer, want):
    cfg = SpellerConfig(embedding_dim=8, units=units, memory_dim=16, attention_units=attention_units,
                        attention_layer_size=layer)
    assert FG.decoder_plan(3, cfg).cluster == want


def test_decoder_plan_refuses_odd_widths():
    with pytest.raises(ValueError, match="multiples of 4"):
        FG.decoder_plan(3, SpellerConfig(embedding_dim=6, units=16, memory_dim=16, attention_units=16,
                                         attention_layer_size=16))
    with pytest.raises(ValueError):
        FG.decoder_plan(0, SpellerConfig(embedding_dim=8, units=16, memory_dim=16, attention_units=16,
                                         attention_layer_size=16))

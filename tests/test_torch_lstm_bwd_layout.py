"""What the VJP's cluster kernel leaves to Python, on the CPU: its
decomposition (unit slices × batch tiles, the dot ``dgates @ whᵀ`` cut by
k over the blocks, the partial dh of every unit added in rank order, the
six factors computed ahead of the step) emulated in plain PyTorch on the
layouts the kernel reads, against the plain VJP, ``jax.grad`` of the XLA
scan and the Pallas VJP kernel in interpret mode; and the wrapper's
choice of cluster size, tile and k split from a shape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.ops.lstm import _recurrence_pallas_bwd, _recurrence_pallas_residual, _recurrence_xla

from phones_las_torch.ops import lstm as L
from tests.torch_threads import one_thread

one_thread()

# max |got − want| over max |want|: float32 sums in another order; bf16 the
# bound the port's VJP kernel is held to on the card
TOL = {"highest": 1e-5, "bf16": 3e-2}

T, B, U = 9, 19, 64  # B: two full tiles of 8 and a ragged one; one of 16 and a ragged one


def _inputs(seed, prec, reverse):
    """xp, mask (ragged lengths), wh, the residuals of the reference's own
    forward kernel, and the three cotangents."""
    rs = np.random.RandomState(seed)
    xp = rs.randn(T, B, 4 * U).astype(np.float32)
    wh = (rs.randn(U, 4 * U) * 0.2).astype(np.float32)
    lens = rs.randint(1, T + 1, B)
    lens[0], lens[1] = T, 1
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    _, hprev, cprev, _, _ = _recurrence_pallas_residual(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), reverse=reverse, interpret=True, prec=prec
    )
    dout = rs.randn(T, B, U).astype(np.float32)
    dh, dc = rs.randn(B, U).astype(np.float32), rs.randn(B, U).astype(np.float32)
    return xp, mask, wh, hprev, cprev, dout, dh, dc


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / max(float(np.abs(want).max()), 1e-6)


def cluster_bwd_emulated(xp, mask, wh, hprev, cprev, dout, dhfin, dcfin, forget_bias, reverse,
                         prec="highest", cluster=8, bt=8):
    """The VJP kernels' decomposition in plain PyTorch → (dxp, dwh).

    The gates of all steps are one product; then, per batch tile of ``bt``
    rows (the last one ragged) and per step in the opposite order to the
    forward, each of ``cluster`` blocks forms the gate gradients of its
    unit slice from factors that do not depend on dh, multiplies them by
    its slice of whᵀ (``_kernel_wht``'s layout) into a partial dh of all
    U units, and every block adds the partials of its own units in rank
    order; dWh is one product over all rows."""
    t, b, four_u = xp.shape
    u = four_u // 4
    us = u // cluster
    wt = L._kernel_wht(wh, cluster, prec).float()  # f32 [C, 4Us, U]; bf16 [C, Up, 4Us]
    hp = L._dot_operand(hprev.float(), prec)
    gates_all = xp + torch.matmul(hp, L._dot_operand(wh, prec))
    dxp = torch.zeros_like(xp)
    for r0 in range(0, b, bt):
        rows = slice(r0, min(b, r0 + bt))
        n = rows.stop - r0
        keep_dh = [dhfin[rows, s * us:(s + 1) * us].clone() for s in range(cluster)]
        dc = [dcfin[rows, s * us:(s + 1) * us].clone() for s in range(cluster)]
        recv = None  # recv[owner][sender]: partial dh of the owner's units
        for tt in L._time_order(t, not reverse):
            m = mask[tt, rows][:, None]
            sent = []
            for s in range(cluster):
                units = slice(s * us, (s + 1) * us)
                gi, gf, gg, go = (gates_all[tt, rows].reshape(n, 4, u)[:, k, units] for k in range(4))
                cp = cprev[tt, rows, units].float()
                # ahead of the step: nothing here depends on dh or dc
                si, sf = torch.sigmoid(gi), torch.sigmoid(gf + forget_bias)
                sg, so = torch.tanh(gg), torch.sigmoid(go)
                tch = torch.tanh(sf * cp + si * sg)
                f_i, f_f, f_g, f_o = sg * si * (1 - si), cp * sf * (1 - sf), si * (1 - sg * sg), tch * so * (1 - so)
                f_a = so * (1 - tch * tch)
                # the step: dh of this block's units, the kept part plus the partials in rank order
                dh = keep_dh[s]
                if recv is not None:
                    for part in recv[s]:
                        dh = dh + part
                dh_tot = m * (dout[tt, rows, units] + dh)
                dc_new = m * dc[s] + dh_tot * f_a
                dg = torch.cat([dc_new * f_i, dc_new * f_f, dc_new * f_g, dh_tot * f_o], dim=-1)  # [n, 4Us]
                keep_dh[s] = (1 - m) * dh
                dc[s] = (1 - m) * dc[s] + dc_new * sf
                dxp[tt, rows].reshape(n, 4, u)[:, :, units] = dg.reshape(n, 4, us)
                dgd = L._dot_operand(dg, prec)
                partial = dgd @ wt[s] if prec != "bf16" else (dgd @ wt[s].t())[:, :u]
                sent.append(partial)  # [n, U]: this block's k part of dh for every unit
            recv = [[sent[r][:, s * us:(s + 1) * us] for r in range(cluster)] for s in range(cluster)]
    dwh = torch.matmul(hp.reshape(-1, u).t(), L._dot_operand(dxp, prec).reshape(-1, four_u))
    return dxp, dwh


@pytest.mark.parametrize("cluster,bt", [(1, 8), (4, 8), (8, 16), (16, 24)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("prec", ["highest", "bf16"])
def test_bwd_cluster_emulation_matches_plain_pallas_and_jax_grad(prec, reverse, cluster, bt):
    xp, mask, wh, hprev, cprev, dout, dh, dc = _inputs(5, prec, reverse)
    rdt = torch.bfloat16 if prec == "bf16" else torch.float32
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32).copy())
    args = (t(xp), t(mask), t(wh), t(hprev).to(rdt), t(cprev).to(rdt), t(dout), t(dh), t(dc))
    dxp, dwh = cluster_bwd_emulated(*args, 1.0, reverse, prec, cluster, bt)
    ((pdxp, pdwh),) = L.recurrence_bwd_plain(*[[a] if i != 1 else a for i, a in enumerate(args)], 1.0, [reverse], prec)
    ref_dxp, ref_dwh = _recurrence_pallas_bwd(
        jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(wh), hprev, cprev, jnp.asarray(dout),
        jnp.asarray(dh), jnp.asarray(dc), reverse=reverse, interpret=True, prec=prec,
    )

    def loss(xp_, wh_):
        out, (h, c) = _recurrence_xla(xp_, jnp.asarray(mask), wh_, 1.0, reverse, prec)
        return jnp.sum(out * dout) + jnp.sum(h * dh) + jnp.sum(c * dc)

    jdxp, jdwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wh))
    for got, plain, ref, jg in ((dxp, pdxp, ref_dxp, jdxp), (dwh, pdwh, ref_dwh, jdwh)):
        assert _rel(got.numpy(), plain.numpy()) <= TOL[prec]
        assert _rel(got.numpy(), ref) <= TOL[prec]
        assert _rel(got.numpy(), jg) <= TOL[prec]
    # masked steps pass no gradient into xp
    assert float((dxp * (1.0 - t(mask))[:, :, None]).abs().max()) == 0.0


@pytest.mark.parametrize("c,u", [(1, 32), (2, 32), (4, 32), (1, 40), (1, 256), (2, 256), (4, 256), (8, 256)])
def test_kernel_wht_layout(c, u):
    wh = torch.from_numpy(np.random.RandomState(u + c).randn(u, 4 * u).astype(np.float32))
    us = u // c
    wt = L._kernel_wht(wh, c, "highest")
    assert wt.shape == (c, 4 * us, u) and wt.is_contiguous() and wt.dtype == torch.float32
    # slice s, row g·Us + j is column g·U + s·Us + j of wh: a row of whᵀ
    s, g, j = c - 1, 3, us - 1
    assert torch.equal(wt[s, g * us + j], wh[:, g * u + s * us + j])
    # it is the forward's slice, transposed
    assert torch.equal(wt, L.regroup_wh(wh, c).transpose(1, 2))
    wb = L._kernel_wht(wh, c, "bf16")
    up = -(-u // 16) * 16
    assert wb.shape == (c, up, 4 * us) and wb.is_contiguous() and wb.dtype == torch.bfloat16
    assert torch.equal(wb[s, :u, g * us + j], wh[:, g * u + s * us + j].to(torch.bfloat16))
    if up > u:
        assert float(wb[:, u:].float().abs().max()) == 0.0


FLAGSHIP_U = 256


@pytest.mark.parametrize(
    "b,nd,prec,max_active,want",
    [
        # the training shape: 8 clusters of 8 rows fit in one wave
        (32, 2, "highest", 15, (8, 8, 4, True)),
        (32, 2, "bf16", 30, (8, 8, 1, True)),
        (32, 1, "highest", 15, (8, 8, 4, True)),
        # 64 rows, both directions: 16 clusters of 8 rows are one too many
        (64, 2, "highest", 15, (8, 16, 1, True)),
        (64, 2, "bf16", 30, (8, 8, 1, True)),
        # small and ragged batches
        (1, 1, "highest", 15, (8, 8, 4, True)),
        (13, 2, "highest", 15, (8, 8, 4, True)),
        # more rows than one wave holds: the largest tile
        (512, 2, "highest", 15, (8, 16, 1, True)),
        # nothing known of the card: the largest tile that fits
        (32, 2, "highest", None, (8, 16, 1, True)),
        (7, 2, "highest", None, (8, 8, 4, True)),
    ],
)
def test_backward_plan_flagship(b, nd, prec, max_active, want):
    active = None if max_active is None else (lambda plan: max_active)
    plan = L.backward_plan(b, FLAGSHIP_U, nd, prec, active)
    assert tuple(plan[:4]) == want
    assert plan.smem == L.backward_smem_bytes(FLAGSHIP_U, plan.cluster, plan.bt, plan.ksplit, plan.resident, prec == "bf16")
    assert plan.smem <= L.SMEM_MAX
    # the same arguments give the same plan: nothing is read but the shape
    assert L.backward_plan(b, FLAGSHIP_U, nd, prec, active) == plan


@pytest.mark.parametrize(
    "u,prec,want",
    [
        (8, "highest", (1, True)),  # slices of 8 units: only the whole of U = 8
        (40, "highest", (1, True)),
        (40, "bf16", (1, True)),
        (248, "highest", (1, False)),  # 31 · 8 units: one block, and whᵀ (984 KB) streams
        (248, "bf16", (1, False)),
        (64, "highest", (8, True)),
        (128, "highest", (8, True)),
        (16, "bf16", (2, True)),
    ],
)
def test_backward_plan_other_widths(u, prec, want):
    plan = L.backward_plan(20, u, 2, prec, lambda plan: 15)
    assert (plan.cluster, plan.resident) == want
    assert u % plan.cluster == 0 and (u // plan.cluster) % 8 == 0
    assert 1 <= plan.ksplit <= min(16, u // plan.cluster)  # at least 4 k a part
    assert plan.smem <= L.SMEM_MAX


@pytest.mark.parametrize("u", [0, 12, 260])
def test_backward_plan_refuses(u):
    with pytest.raises(ValueError):
        L.backward_plan(4, u, 1)


@pytest.mark.parametrize("prec", ["highest", "bf16"])
@pytest.mark.parametrize("bt", [8, 16])
def test_backward_smem_bytes_at_the_flagship_width(bt, prec):
    """The byte count, part by part, at U = 256, C = 8: what the plan may
    spend of a block's 232,448 bytes."""
    bf16 = prec == "bf16"
    us, nc, u = 32, 128, 256
    w = 256 * (nc + 8) * 2 if bf16 else nc * u * 4
    dg = 16 * (nc + 8) * 2 if bf16 else bt * nc * 4
    for ks in (1, 2, 4):
        if bf16 and ks > 1:
            continue
        want = w + 2 * bt * u * 4 + dg + ks * bt * u * 4 + L.BWD_RING * (bt * 7 * us + bt) * 4 + 2 * bt * us * 4
        assert L.backward_smem_bytes(u, 8, bt, ks, True, bf16) == want
    # a float32 tile of 16 rows fits only with the k range unsplit
    if not bf16 and bt == 16:
        assert L.backward_smem_bytes(u, 8, 16, 2, True, False) > L.SMEM_MAX
        assert L.backward_smem_bytes(u, 8, 16, 1, True, False) <= L.SMEM_MAX

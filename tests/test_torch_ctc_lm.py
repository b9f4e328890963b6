"""The port's CTC decoding and n-gram LM fusion (plain PyTorch, CPU)
against the JAX reference: the prefix DP (init, scores, update) on random
padded log-probs, the sequential oracle and the full-sequence check of
the reference's CTC tests, joint CTC and LM-fused beams, the LM fit and
file format, ``collapse``, ``ctc_frame_ids`` and ``rescore_beams``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.decode import ctc as jctc
from phones_las_tpu.decode import lm as jlm

from phones_las_torch.decode import beam_decode
from phones_las_torch.decode import ctc as C
from phones_las_torch.decode import lm as LM

from test_torch_beam import _assert_results_equal, _memory, _models
from tests.torch_threads import one_thread

one_thread()

BOS, EOS = 1, 2


def _padded_lp(b=2, t=9, v=7, seed=0):
    rs = np.random.RandomState(seed)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rs.randn(b, t, v) * 1.5, jnp.float32), axis=-1))
    lens = np.array([t, t - 3, 4][:b])
    valid = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return lp, valid


def _close(got, ref, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_affine_log_scan_matches_sequential_loop():
    rs = np.random.RandomState(1)
    la = torch.from_numpy(np.log(rs.rand(3, 2, 37)).astype(np.float32))
    lb = torch.from_numpy((rs.randn(3, 2, 37) * 3).astype(np.float32))
    lb[..., 5] = -1e9
    got = C._affine_log_scan(la, lb).double()
    x = torch.full((3, 2), -np.inf, dtype=torch.float64)
    for t in range(37):
        x = torch.logaddexp(x + la[..., t].double(), lb[..., t].double())
        np.testing.assert_allclose(got[..., t].numpy(), x.numpy(), rtol=1e-5, atol=1e-4)
    ref = jctc._affine_log_scan(jnp.asarray(la.numpy()), jnp.asarray(lb.numpy()))
    _close(got.float(), ref)


def test_prefix_dp_matches_jax_on_padded_batch():
    """Three steps of scores and updates with K = 3 beams, a repeated
    label, a finished (frozen) beam and padded frames."""
    lp, valid = _padded_lp(b=3)
    b, t, v = lp.shape
    k = 3
    j_state = jctc.ctc_prefix_init(jnp.asarray(lp), jnp.asarray(valid), k)
    state = C.ctc_prefix_init(torch.from_numpy(lp), torch.from_numpy(valid), k)
    for name in ("lrn", "lrb", "psi"):
        _close(getattr(state, name), getattr(j_state, name))
    j_lp, t_lp = jnp.asarray(lp), torch.from_numpy(lp)
    j_valid, t_valid = jnp.asarray(valid), torch.from_numpy(valid)
    rs = np.random.RandomState(2)
    prev = np.full((b, k), BOS, np.int64)
    for step in range(3):
        psi_j = jctc.ctc_prefix_scores(j_state, j_lp, jnp.exp(j_lp), j_valid, jnp.asarray(prev), EOS, BOS)
        psi = C.ctc_prefix_scores(state, t_lp, torch.exp(t_lp), t_valid, torch.from_numpy(prev), EOS, BOS)
        _close(psi, psi_j)
        tok = rs.randint(3, v, (b, k))
        tok[0, 1] = prev[0, 1] if step else tok[0, 1]  # a repeated label
        flat_idx = np.arange(k)[None, :] * v + tok
        frozen = np.zeros((b, k), bool)
        frozen[1, 2] = step == 2
        j_state = jctc.ctc_prefix_update(
            j_state, psi_j.reshape(b, k * v), jnp.asarray(flat_idx), jnp.asarray(tok),
            jnp.asarray(prev), jnp.asarray(frozen), j_lp, j_valid)
        state = C.ctc_prefix_update(
            state, psi.reshape(b, k * v), torch.from_numpy(flat_idx), torch.from_numpy(tok),
            torch.from_numpy(prev), torch.from_numpy(frozen), t_lp, t_valid)
        for name in ("lrn", "lrb", "psi"):
            _close(getattr(state, name), getattr(j_state, name))
        prev = tok


def _oracle_prefix(lp, n_valid, path, eos, bos):
    """Textbook sequential CTC prefix scores (the reference test's
    oracle): row i holds log ψ(path[:i] · c) for every c."""
    p = np.exp(np.asarray(lp, np.float64))
    t_all, v = p.shape
    rn = np.zeros(t_all + 1)
    rb = np.zeros(t_all + 1)
    rb[0] = 1.0
    for t in range(1, t_all + 1):
        rb[t] = rb[t - 1] * (p[t - 1, 0] if t <= n_valid else 1.0)
    last = bos
    rows = []
    for c in list(path) + [eos]:
        row = np.full(v, np.log(1e-300))
        for cand in range(v):
            if cand in (0, bos):
                continue
            if cand == eos:
                row[cand] = np.log(max(rn[n_valid] + rb[n_valid], 1e-300))
                continue
            s = 0.0
            for t in range(1, n_valid + 1):
                phi = rb[t - 1] + (0.0 if cand == last else rn[t - 1])
                s += phi * p[t - 1, cand]
            row[cand] = np.log(max(s, 1e-300))
        rows.append(row)
        if c == eos:
            break
        rn2 = np.zeros(t_all + 1)
        rb2 = np.zeros(t_all + 1)
        for t in range(1, t_all + 1):
            if t <= n_valid:
                phi = rb[t - 1] + (0.0 if c == last else rn[t - 1])
                rn2[t] = (rn2[t - 1] + phi) * p[t - 1, c]
                rb2[t] = (rb2[t - 1] + rn2[t - 1]) * p[t - 1, 0]
            else:
                rn2[t], rb2[t] = rn2[t - 1], rb2[t - 1]
        rn, rb, last = rn2, rb2, c
    return rows


def _walk(lp, valid, path):
    """Drive the port's prefix DP along ``path`` with one beam → the ψ
    rows of each step."""
    v = lp.shape[-1]
    state = C.ctc_prefix_init(lp, valid, 1)
    prev = torch.tensor([[BOS]])
    rows = []
    for c in list(path) + [EOS]:
        psi = C.ctc_prefix_scores(state, lp, torch.exp(lp), valid, prev, EOS, BOS)
        rows.append(psi[0, 0].double().numpy())
        if c == EOS:
            break
        tok = torch.tensor([[c]])
        state = C.ctc_prefix_update(state, psi.reshape(1, v), tok, tok, prev, torch.tensor([[False]]), lp, valid)
        prev = tok
    return rows


def test_prefix_scores_match_sequential_oracle():
    rs = np.random.RandomState(3)
    t_all, v, n_valid = 7, 9, 5
    lp = torch.log_softmax(torch.from_numpy((rs.randn(1, t_all, v) * 1.5).astype(np.float32)), dim=-1)
    valid = torch.tensor([[1.0] * n_valid + [0.0] * (t_all - n_valid)])
    path = [4, 4, 7, 3]  # includes a repeated label (the rb-only branch)
    oracle = _oracle_prefix(lp[0].numpy(), n_valid, path, EOS, BOS)
    for got, want in zip(_walk(lp, valid, path), oracle):
        real = want > -600  # CTC-reachable candidates (-690 = the oracle's log 0)
        np.testing.assert_allclose(got[real], want[real], rtol=2e-4, atol=2e-4)
        assert (got[~real] < -600).all()


def test_prefix_full_sequence_matches_ctc_loss():
    """After a whole label sequence, ψ(eos) is the complete-sequence CTC
    log prob: −F.ctc_loss, and −optax's as the reference test holds."""
    import optax

    rs = np.random.RandomState(11)
    t_all, v = 8, 6
    labels = [3, 5, 5, 4]
    lp = torch.log_softmax(torch.from_numpy(rs.randn(1, t_all, v).astype(np.float32)), dim=-1)
    psi_eos = _walk(lp, torch.ones(1, t_all), labels)[-1][EOS]
    loss = Fn.ctc_loss(lp.transpose(0, 1), torch.tensor([labels]), torch.tensor([t_all]),
                       torch.tensor([len(labels)]), blank=0, reduction="none")
    np.testing.assert_allclose(psi_eos, -float(loss[0]), rtol=1e-4, atol=1e-4)
    ref = optax.ctc_loss(jnp.asarray(lp.numpy()), jnp.zeros((1, t_all)), jnp.asarray([labels], jnp.int32),
                         jnp.zeros((1, len(labels))), blank_id=0)
    np.testing.assert_allclose(psi_eos, -float(ref[0]), rtol=1e-4, atol=1e-4)


def _ctc_lp(b, t, v, seed=4):
    rs = np.random.RandomState(seed)
    return np.array(jax.nn.log_softmax(jnp.asarray(rs.randn(b, t, v) * 2.0, jnp.float32), axis=-1))


@pytest.mark.parametrize("alpha", [0.7, 0.3])
def test_joint_ctc_beam_matches_jax(alpha):
    jcfg, jp, cfg, params = _models()
    mem, mask = _memory(b=2, t=6)
    lp = _ctc_lp(2, 6, jcfg.vocab_size)
    ref = jax_beam_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), 6, beam_width=3,
                          ctc_logp=jnp.asarray(lp), ctc_alpha=alpha)
    with torch.no_grad():
        got = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, beam_width=3,
                          ctc_logp=torch.from_numpy(lp), ctc_alpha=alpha)
    _assert_results_equal(got, ref)


def test_joint_beam_follows_ctc_preference():
    """α near 0 follows the CTC head; α = 1 disables the joint branch."""
    _, _, cfg, params = _models()
    mem, mask = (torch.from_numpy(x) for x in _memory())
    logits = np.full((2, 5, cfg.vocab_size), -8.0, np.float32)
    logits[:, :2, 4] = 8.0  # CTC insists on a single token 4
    logits[:, 2:, 0] = 8.0
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    with torch.no_grad():
        base = beam_decode(params, cfg, mem, mask, 6, beam_width=3)
        same = beam_decode(params, cfg, mem, mask, 6, beam_width=3, ctc_logp=lp, ctc_alpha=1.0)
        joint = beam_decode(params, cfg, mem, mask, 6, beam_width=3, ctc_logp=lp, ctc_alpha=0.05)
    _assert_results_equal(same, base._replace(**{f: getattr(base, f).numpy() for f in base._fields}), tol=0.0)
    assert joint.lengths.tolist() == [1, 1] and joint.tokens[:, 0].tolist() == [4, 4]
    assert torch.isfinite(joint.scores).all()


def _corpus():
    rs = np.random.RandomState(5)
    return [rs.randint(3, 8, rs.randint(1, 6)).astype(np.int32) for _ in range(40)]


@pytest.mark.parametrize("order", [2, 3])
def test_lm_fit_and_files_match_jax(order, tmp_path):
    got = LM.fit_ngram_lm(_corpus(), 8, BOS, EOS, order=order)
    ref = jlm.fit_ngram_lm(_corpus(), 8, BOS, EOS, order=order)
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "lm.npz")
    LM.save_lm(path, got, [f"t{i}" for i in range(8)])
    np.testing.assert_array_equal(jlm.load_lm(path), got)
    np.testing.assert_array_equal(LM.load_lm(path), got)
    jpath = str(tmp_path / "jlm.npz")
    jlm.save_lm(jpath, ref)
    np.testing.assert_array_equal(LM.load_lm(jpath), ref)
    prev1 = np.array([[4, 0, 7]])
    prev2 = np.array([[3, 1, 7]])
    np.testing.assert_array_equal(
        LM.lm_step_scores(torch.from_numpy(got), torch.from_numpy(prev1), torch.from_numpy(prev2)).numpy(),
        np.asarray(jlm.lm_step_scores(jnp.asarray(ref), jnp.asarray(prev1), jnp.asarray(prev2))),
    )


@pytest.mark.parametrize("order,alpha", [(2, 1.0), (3, 1.0), (3, 0.7)])
def test_lm_fused_beam_matches_jax(order, alpha):
    jcfg, jp, cfg, params = _models()
    mem, mask = _memory(b=2, t=6)
    table = LM.fit_ngram_lm(_corpus(), jcfg.vocab_size, BOS, EOS, order=order)
    lp = _ctc_lp(2, 6, jcfg.vocab_size)
    kw = dict(lm_weight=0.3, ctc_alpha=alpha)
    ref = jax_beam_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), 6, beam_width=4,
                          lm_logp=jnp.asarray(table), ctc_logp=jnp.asarray(lp), **kw)
    with torch.no_grad():
        got = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, beam_width=4,
                          lm_logp=torch.from_numpy(table), ctc_logp=torch.from_numpy(lp), **kw)
        plain = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, beam_width=4)
        zero = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, beam_width=4,
                           lm_logp=torch.from_numpy(table), lm_weight=0.0)
    _assert_results_equal(got, ref)
    for field in plain._fields:
        torch.testing.assert_close(getattr(zero, field), getattr(plain, field), rtol=0, atol=0)


def test_collapse_and_frame_ids_match_jax():
    from test_torch_attention_variants import _models as las_models

    jcfg, jp, tcfg, tp = las_models()
    assert tp.ctc_w is None
    rs = np.random.RandomState(6)
    ctc_w = rs.randn(16, jcfg.speller.vocab_size).astype(np.float32)
    ctc_b = rs.randn(jcfg.speller.vocab_size).astype(np.float32)
    jp = jp._replace(ctc_w=jnp.asarray(ctc_w), ctc_b=jnp.asarray(ctc_b))
    tp.ctc_w = torch.nn.Parameter(torch.from_numpy(ctc_w), requires_grad=False)
    tp.ctc_b = torch.nn.Parameter(torch.from_numpy(ctc_b), requires_grad=False)
    mem = rs.randn(3, 10, 16).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([10, 6, 3])[:, None]).astype(np.float32)
    ids = C.ctc_frame_ids(tp, torch.from_numpy(mem), torch.from_numpy(mask))
    ref = jctc.ctc_frame_ids(jp, jnp.asarray(mem), jnp.asarray(mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
    lens = mask.sum(1).astype(np.int32)
    assert C.collapse(ids.numpy(), lens) == jctc.collapse(np.asarray(ref), lens)
    assert C.collapse(np.array([[0, 4, 4, 0, 4, 5, 5, 0]]), np.array([7])) == [[4, 4, 5]]
    from phones_las_torch.models.las import ctc_logp

    np.testing.assert_allclose(
        ctc_logp(tp, torch.from_numpy(mem)).numpy(),
        np.asarray(jax.nn.log_softmax(jnp.asarray(mem) @ jp.ctc_w + jp.ctc_b, axis=-1)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lp_alpha", [0.0, 0.6])
def test_rescore_beams_matches_jax(lp_alpha):
    rs = np.random.RandomState(7)
    b, k, s, t, v = 2, 4, 6, 9, 7
    logits = rs.randn(b, t, v).astype(np.float32) * 2
    mask = (np.arange(t)[None, :] < np.array([t, 6])[:, None]).astype(np.float32)
    lens = np.array([[3, 0, 5, 2], [1, 4, 6, 2]], np.int32)  # beam 1 of row 0 is empty
    toks = rs.randint(3, v, (b, k, s)).astype(np.int32)
    for i in range(b):
        for j in range(k):
            toks[i, j, lens[i, j]:] = EOS
    toks[1, 2, :] = 4  # six equal labels need eleven frames: unreachable in six
    lens[1, 2] = 6
    logp = rs.randn(b, k).astype(np.float32) - 5
    fin = np.array([[True, True, False, True], [False, True, True, True]])
    best_j, comb_j = jctc.rescore_beams(jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(toks), jnp.asarray(lens),
                                        jnp.asarray(logp), 0.7, beam_finished=jnp.asarray(fin), length_penalty=lp_alpha)
    best, comb = C.rescore_beams(torch.from_numpy(logits), torch.from_numpy(mask), torch.from_numpy(toks),
                                 torch.from_numpy(lens), torch.from_numpy(logp), 0.7,
                                 beam_finished=torch.from_numpy(fin), length_penalty=lp_alpha)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    reach = np.ones((b, k), bool)
    reach[1, 2] = False
    np.testing.assert_allclose(comb.numpy()[reach], np.asarray(comb_j)[reach], rtol=1e-4, atol=1e-4)
    # the unreachable hypothesis takes the −1e7 floor: it ranks last among the finished
    assert comb[1, 2] < comb[1][torch.tensor([False, True, False, True])].min()

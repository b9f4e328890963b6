"""The port's speller, attention and greedy decoders (plain PyTorch path,
CPU) against the JAX reference: tokens equal to JAX ``greedy_decode`` and
to the Pallas ``greedy_decode_fused`` in interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.decode.pallas_greedy import greedy_decode_fused as jax_greedy_decode_fused
from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import init_las
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.speller import embed_tokens as jax_embed_tokens
from phones_las_tpu.models.speller import init_speller_carry as jax_init_carry
from phones_las_tpu.models.speller import speller_step as jax_speller_step
from phones_las_tpu.ops.attention import attention_scores as jax_attention_scores
from phones_las_tpu.ops.attention import init_attention_params
from phones_las_tpu.ops.attention import precompute_keys as jax_precompute_keys
from phones_las_tpu.utils.param_io import config_from_dict as jax_config_from_dict

from phones_las_torch.decode.fused_greedy import greedy_decode_fused, supports
from phones_las_torch.decode.greedy import greedy_decode, greedy_decode_steps
from phones_las_torch.models.speller import SpellerConfig, embed_tokens, init_speller_carry, speller_step
from phones_las_torch.ops.attention import AttentionParams, attention_scores, precompute_keys
from phones_las_torch.utils.param_io import config_from_dict, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

V, BOS, EOS = 11, 1, 2
M = 16


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _models(num_layers=2, **speller_kw):
    """JAX LAS params of a small config and the same weights in the port."""
    sp = dict(
        vocab_size=V, embedding_dim=8, num_layers=num_layers, units=16, memory_dim=M,
        attention_type="bahdanau", attention_units=16, attention_layer_size=16,
        bos_id=BOS, eos_id=EOS,
    )
    sp.update(speller_kw)
    jcfg = JaxLASConfig(listener=JaxListenerConfig(input_dim=120, num_layers=1, units=M // 2),
                        speller=JaxSpellerConfig(**sp))
    codes = None
    if jcfg.speller.binf_mode != "none":
        codes = np.random.RandomState(9).randint(0, 2, (V, jcfg.speller.num_binf)).astype(np.float32)
    jparams = init_las(jax.random.PRNGKey(0), jcfg, binf_codes=codes)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tparams = params_from_numpy(_flat(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _memory(b, t, seed=0):
    mem = np.random.RandomState(seed).randn(b, t, M).astype(np.float32)
    lens = np.minimum(np.random.RandomState(seed + 1).randint(4, t + 1, b), t)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return mem, mask


@pytest.mark.parametrize("num_layers,b,steps", [(2, 5, 9), (1, 3, 6)])
def test_greedy_tokens_match_jax(num_layers, b, steps):
    jcfg, jp, tcfg, tp = _models(num_layers)
    mem, mask = _memory(b, 13)
    ref_tok, ref_len, _ = jax_greedy_decode(jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=steps)
    fused_tok, fused_len = jax_greedy_decode_fused(
        jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=steps, interpret=True
    )
    tm, tk = torch.from_numpy(mem), torch.from_numpy(mask)
    got_tok, got_len, _ = greedy_decode(tp.speller, tcfg.speller, tm, tk, steps)
    kern_tok, kern_len = greedy_decode_fused(tp.speller, tcfg.speller, tm, tk, steps)
    for tok, ln in ((got_tok, got_len), (kern_tok, kern_len)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(fused_tok))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(ref_len))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(fused_len))


def test_fused_masked_softmax_matches_pallas_on_empty_row():
    """A row with no valid encoder position: the fused kernel's softmax
    gives zero weights (the reference kernel's semantics), not uniform."""
    jcfg, jp, tcfg, tp = _models(2)
    mem, mask = _memory(3, 7, seed=4)
    mask[1] = 0.0
    ref, _ = jax_greedy_decode_fused(
        jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=5, interpret=True
    )
    got, _ = greedy_decode_fused(tp.speller, tcfg.speller, torch.from_numpy(mem), torch.from_numpy(mask), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_alignments_and_supports():
    jcfg, jp, tcfg, tp = _models(1)
    mem, mask = _memory(2, 6, seed=5)
    _, _, ref_al = jax_greedy_decode(
        jp.speller, jcfg.speller, jnp.asarray(mem), jnp.asarray(mask), max_steps=4, return_alignments=True
    )
    _, _, al = greedy_decode_steps(
        tp.speller, tcfg.speller, torch.from_numpy(mem), torch.from_numpy(mask), 4, return_alignments=True
    )
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), rtol=1e-5, atol=1e-6)
    assert supports(tcfg.speller)
    assert not supports(SpellerConfig(attention_type="luong"))
    assert not supports(SpellerConfig(attention_layer_size=0))
    assert not supports(SpellerConfig(binf_mode="logits"))


def test_speller_step_binf_head_matches_jax():
    jcfg, jp, tcfg, tp = _models(2, num_binf=5, binf_mode="head")
    mem, mask = _memory(3, 8, seed=6)
    keys_j = jax_precompute_keys(jp.speller.attention, jnp.asarray(mem))
    carry_j = jax_init_carry(jcfg.speller, 3, 8)
    tok = np.array([1, 4, 7])
    carry_j, logits_j, ex_j = jax_speller_step(
        jp.speller, jcfg.speller, carry_j, jax_embed_tokens(jp.speller, jcfg.speller, jnp.asarray(tok)),
        keys_j, jnp.asarray(mem), jnp.asarray(mask),
    )
    tm = torch.from_numpy(mem)
    carry = init_speller_carry(tcfg.speller, 3, 8)
    carry, logits, ex = speller_step(
        tp.speller, tcfg.speller, carry, embed_tokens(tp.speller, tcfg.speller, torch.from_numpy(tok)),
        precompute_keys(tp.speller.attention, tm), tm, torch.from_numpy(mask),
    )
    for got, ref in ((logits, logits_j), (ex["binf_logits"], ex_j["binf_logits"]),
                     (ex["probs"], ex_j["probs"]), (carry.attn_vec, carry_j.attn_vec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["bahdanau", "bahdanau_norm", "luong", "luong_scaled"])
def test_attention_scores_match_jax(variant):
    q_dim = a_dim = 12
    jp = init_attention_params(jax.random.PRNGKey(3), variant, q_dim, M, a_dim)
    if variant == "bahdanau_norm":  # non-trivial bias and gain
        jp = jp._replace(b=jnp.linspace(-0.5, 0.5, a_dim), g=jnp.asarray(0.7))
    tp = AttentionParams(variant, q_dim, M, a_dim)
    with torch.no_grad():
        for name in ("wq", "wk", "v", "b", "score_bias", "g"):
            leaf = getattr(jp, name)
            assert (leaf is None) == (getattr(tp, name) is None), name
            if leaf is not None:
                getattr(tp, name).copy_(torch.tensor(np.asarray(leaf)))
    rs = np.random.RandomState(7)
    mem, mask = _memory(3, 9, seed=8)
    query = rs.randn(3, q_dim).astype(np.float32)
    ref = jax_attention_scores(jp, variant, jnp.asarray(query),
                               jax_precompute_keys(jp, jnp.asarray(mem)), jnp.asarray(mask))
    got = attention_scores(tp, variant, torch.from_numpy(query),
                           precompute_keys(tp, torch.from_numpy(mem)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_monotonic_attention_not_ported_yet():
    """Ported since: a monotonic variant needs its previous alignment, and
    from the dirac start with zero scores the recursion gives
    p_choose · cumprod(1 − p_choose) = 0.5, 0.25, 0.125 (the tests against
    JAX are in ``test_torch_attention_variants.py``)."""
    tp = AttentionParams("bahdanau_monotonic", 4, 4, 4)
    assert tp.score_bias is not None
    args = (tp, "bahdanau_monotonic", torch.zeros(1, 4), torch.zeros(1, 3, 4), torch.ones(1, 3))
    with pytest.raises(ValueError, match="prev_align"):
        attention_scores(*args)
    probs = attention_scores(*args, prev_align=torch.tensor([[1.0, 0.0, 0.0]]))
    torch.testing.assert_close(probs, torch.tensor([[0.5, 0.25, 0.125]]))


def test_config_round_trip_matches_jax_loader():
    jcfg, _, tcfg, _ = _models(2)
    d = dataclasses.asdict(jcfg)
    assert dataclasses.asdict(config_from_dict(d)) == dataclasses.asdict(jax_config_from_dict(d)) == d
    assert dataclasses.asdict(tcfg) == d

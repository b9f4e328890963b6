"""The port's attention variants and speller modes on the CPU against the
JAX reference: every attention variant on 2-D and beamed queries (the
monotonic ones in parallel and hard mode, with and without the
decode-time bias), the monotonic dirac start, the binf 'logits' and
'embedding' modes, and ``compute_loss`` with its gradients for these
configurations."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.speller import embed_tokens as jax_embed_tokens
from phones_las_tpu.models.speller import init_speller_carry as jax_init_carry
from phones_las_tpu.models.speller import speller_step as jax_speller_step
from phones_las_tpu.models.speller import teacher_forced_decode as jax_teacher_forced
from phones_las_tpu.ops.attention import _raw_scores as jax_raw_scores
from phones_las_tpu.ops.attention import attention_context as jax_attention_context
from phones_las_tpu.ops.attention import attention_scores as jax_attention_scores
from phones_las_tpu.ops.attention import init_attention_params
from phones_las_tpu.ops.attention import precompute_keys as jax_precompute_keys

from phones_las_torch.models import las as L
from phones_las_torch.models.speller import (
    embed_tokens,
    init_speller_carry,
    speller_step,
    teacher_forced_decode,
)
from phones_las_torch.ops.attention import (
    AttentionParams,
    attention_context,
    attention_scores,
    precompute_keys,
)
from phones_las_torch.utils.param_io import config_from_dict, named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

V, BOS, EOS, F_BINF = 11, 1, 2, 6
M = 16
BASES = ("bahdanau", "bahdanau_norm", "luong", "luong_scaled")


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _attention(variant, a_dim=12):
    """JAX attention params of ``variant`` (non-trivial bias, gain and
    score bias) and the same leaves in the port."""
    jp = init_attention_params(jax.random.PRNGKey(3), variant, a_dim, M, a_dim)
    if jp.b is not None:
        jp = jp._replace(b=jnp.linspace(-0.5, 0.5, a_dim), g=jnp.asarray(0.7))
    if jp.score_bias is not None:
        jp = jp._replace(score_bias=jnp.asarray(-0.3))
    tp = AttentionParams(variant, a_dim, M, a_dim)
    with torch.no_grad():
        for name in ("wq", "wk", "v", "b", "score_bias", "g"):
            leaf = getattr(jp, name)
            assert (leaf is None) == (getattr(tp, name) is None), name
            if leaf is not None:
                getattr(tp, name).copy_(torch.tensor(np.asarray(leaf)))
    return jp, tp


def _memory(b, t, seed=0):
    mem = np.random.RandomState(seed).randn(b, t, M).astype(np.float32)
    lens = np.random.RandomState(seed + 1).randint(3, t + 1, b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return mem, mask


def _prev_align(shape, hard, seed):
    """A previous alignment: a one-hot position (hard mode) or a random
    distribution over the positions."""
    rs = np.random.RandomState(seed)
    if hard:
        pos = rs.randint(0, shape[-1] // 2, shape[:-1])
        return np.eye(shape[-1], dtype=np.float32)[pos]
    a = rs.rand(*shape).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


def _check_attention(variant, beamed, mode="parallel", bias=0.0):
    jp, tp = _attention(variant)
    b, t, k, q_dim = 3, 9, 4, 12
    mem, mask = _memory(b, t, seed=8)
    q_shape = (b, k, q_dim) if beamed else (b, q_dim)
    query = np.random.RandomState(7).randn(*q_shape).astype(np.float32)
    monotonic = variant.endswith("_monotonic")
    kw_j, kw_t = {}, {}
    if monotonic:
        prev = _prev_align(q_shape[:-1] + (t,), mode == "hard", seed=9)
        kw_j = dict(prev_align=jnp.asarray(prev), monotonic_mode=mode, monotonic_bias=bias)
        kw_t = dict(prev_align=torch.from_numpy(prev), monotonic_mode=mode, monotonic_bias=bias)
    keys_j = jax_precompute_keys(jp, jnp.asarray(mem))
    if mode == "hard":
        # the decisions s > 0 are compared bit for bit: move the score
        # bias until every score is at least 1e-3 away from 0
        base = variant[: -len("_monotonic")]
        raw = np.asarray(jax_raw_scores(jp, base, jnp.asarray(query), keys_j)) + bias
        sb = next(x for x in -0.3 + 0.0137 * np.arange(50) if np.abs(raw + x).min() > 1e-3)
        jp = jp._replace(score_bias=jnp.asarray(sb, jnp.float32))
        with torch.no_grad():
            tp.score_bias.fill_(float(jp.score_bias))
    ref = jax_attention_scores(jp, variant, jnp.asarray(query), keys_j, jnp.asarray(mask), **kw_j)
    got = attention_scores(tp, variant, torch.from_numpy(query),
                           precompute_keys(tp, torch.from_numpy(mem)), torch.from_numpy(mask), **kw_t)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ctx_ref = jax_attention_context(ref, jnp.asarray(mem))
    ctx = attention_context(got, torch.from_numpy(mem))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beamed", [False, True])
@pytest.mark.parametrize("variant", BASES)
def test_softmax_attention_matches_jax(variant, beamed):
    _check_attention(variant, beamed)


@pytest.mark.parametrize("bias", [0.0, 0.4])
@pytest.mark.parametrize("mode", ["parallel", "hard"])
@pytest.mark.parametrize("beamed", [False, True])
@pytest.mark.parametrize("base", BASES)
def test_monotonic_attention_matches_jax(base, beamed, mode, bias):
    _check_attention(base + "_monotonic", beamed, mode, bias)


def test_sigmoid_noise_draws_from_the_generator():
    """Noise changes the alignment, and the same generator seed gives the
    same draw (the bits cannot match JAX's, so only the rule is held)."""
    _, tp = _attention("bahdanau_monotonic")
    mem, mask = _memory(2, 7, seed=3)
    keys = precompute_keys(tp, torch.from_numpy(mem))
    query = torch.randn(2, 12, generator=torch.Generator().manual_seed(0))
    prev = torch.from_numpy(_prev_align((2, 7), False, seed=4))
    run = lambda noise, seed: attention_scores(
        tp, "bahdanau_monotonic", query, keys, torch.from_numpy(mask), prev_align=prev,
        sigmoid_noise=noise, generator=torch.Generator().manual_seed(seed),
    )
    torch.testing.assert_close(run(1.0, 5), run(1.0, 5), rtol=0, atol=0)
    assert not torch.allclose(run(1.0, 5), run(1.0, 6))
    assert not torch.allclose(run(1.0, 5), run(0.0, 5))
    torch.testing.assert_close(run(0.0, 5), run(0.0, 6), rtol=0, atol=0)


def _models(attention_type="bahdanau", binf_mode="none", listener_layers=1):
    """JAX LAS params of a small config and the same weights in the port."""
    num_binf = F_BINF if binf_mode != "none" else 0
    sp = JaxSpellerConfig(
        vocab_size=V, embedding_dim=8, num_layers=2, units=16, memory_dim=M,
        attention_type=attention_type, attention_units=16, attention_layer_size=16,
        bos_id=BOS, eos_id=EOS, binf_mode=binf_mode, num_binf=num_binf,
    )
    jcfg = JaxLASConfig(listener=JaxListenerConfig(input_dim=120, num_layers=listener_layers, units=M // 2),
                        speller=sp)
    codes = None
    if num_binf:
        codes = np.random.RandomState(9).randint(0, 2, (V, num_binf)).astype(np.float32)
    jparams = jax_init_las(jax.random.PRNGKey(0), jcfg, binf_codes=codes)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tparams = params_from_numpy(_flat(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("variant", ["bahdanau_monotonic", "luong_monotonic", "bahdanau"])
def test_init_carry_dirac_start(variant):
    jcfg, _, tcfg, _ = _models(variant)
    ref = jax_init_carry(jcfg.speller, 3, 7)
    got = init_speller_carry(tcfg.speller, 3, 7)
    np.testing.assert_array_equal(got.alignment.numpy(), np.asarray(ref.alignment))
    assert float(got.alignment.sum()) == (3.0 if variant.endswith("_monotonic") else 0.0)


@pytest.mark.parametrize("beamed", [False, True])
@pytest.mark.parametrize("binf_mode", ["logits", "embedding"])
def test_binf_speller_step_matches_jax(binf_mode, beamed):
    jcfg, jp, tcfg, tp = _models("bahdanau", binf_mode)
    assert tp.speller.binf_codes is not None
    b, t = 3, 8
    mem, mask = _memory(b, t, seed=6)
    tok = np.array([[1, 4, 7], [5, 2, 9], [3, 3, 10]])[:, : 3 if beamed else 1]
    tok = tok if beamed else tok[:, 0]
    shape = tok.shape
    emb_j = jax_embed_tokens(jp.speller, jcfg.speller, jnp.asarray(tok))
    emb = embed_tokens(tp.speller, tcfg.speller, torch.from_numpy(tok))
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), rtol=1e-5, atol=1e-6)

    reshape_j = lambda x: x.reshape(*shape, *x.shape[1:])
    carry_j = jax.tree.map(reshape_j, jax_init_carry(jcfg.speller, int(np.prod(shape)), t))
    carry = init_speller_carry(tcfg.speller, int(np.prod(shape)), t)
    carry = type(carry)(
        tuple((h.reshape(*shape, -1), c.reshape(*shape, -1)) for h, c in carry.states),
        carry.attn_vec.reshape(*shape, -1), carry.alignment.reshape(*shape, -1),
    )
    keys_j = jax_precompute_keys(jp.speller.attention, jnp.asarray(mem))
    tm = torch.from_numpy(mem)
    for _ in range(2):  # two steps, the second from a non-zero carry
        carry_j, logits_j, ex_j = jax_speller_step(
            jp.speller, jcfg.speller, carry_j, emb_j, keys_j, jnp.asarray(mem), jnp.asarray(mask))
        carry, logits, ex = speller_step(
            tp.speller, tcfg.speller, carry, emb, precompute_keys(tp.speller.attention, tm), tm,
            torch.from_numpy(mask))
        assert sorted(ex) == sorted(ex_j)  # 'binf_logits' in 'logits' mode only
        pairs = [(ex[key], ex_j[key]) for key in ex_j] + [(logits, logits_j), (carry.attn_vec, carry_j.attn_vec)]
        for got, ref in pairs:
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _loss_batch(seed=0):
    rs = np.random.RandomState(seed)
    lens = np.array([4000, 2900, 3500], np.int32)
    audio = np.zeros((3, 4000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rs.randn(n) * 2000
    targets = rs.randint(4, V, (3, 6)).astype(np.int32)
    tl = np.array([6, 4, 5], np.int32)
    for i, n in enumerate(tl):
        targets[i, n - 1] = EOS
    return {"audio": audio, "audio_lengths": lens, "targets": targets, "target_lengths": tl}


@pytest.mark.parametrize("attention_type,binf_mode", [
    ("bahdanau_monotonic", "none"),
    ("luong_monotonic", "none"),
    ("bahdanau", "logits"),
    ("bahdanau", "embedding"),
    ("bahdanau_monotonic", "embedding"),
])
def test_compute_loss_and_grads_match_jax(attention_type, binf_mode):
    """``compute_loss(train=False)`` (no noise) and every gradient leaf
    against ``jax.value_and_grad``, each within 1e-4 of its largest
    magnitude; and the teacher-forced alignments of the monotonic
    recursion."""
    jcfg, jp, tcfg, tp = _models(attention_type, binf_mode, listener_layers=2)
    batch = _loss_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = lambda p: jax_compute_loss(p, jcfg, jb, train=False, implementation="xla")[0]
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    mask = L.trainable_filter(tp)
    for key, t in named_leaves(tp):
        t.requires_grad_(mask[key])
    loss, aux = L.compute_loss(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    ref = _flat(ref_grads)
    checked = 0
    for key, t in named_leaves(tp):
        if not t.requires_grad:
            continue
        want, got = ref[key], t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, (key, float(np.abs(got - want).max()), scale)
        checked += 1
    assert checked == len(ref) - (1 if binf_mode != "none" else 0) - 2  # less codes, CMVN stats
    if attention_type.endswith("_monotonic"):
        from phones_las_tpu.models.las import encode as jax_encode

        mem_j, _, mask_j = jax_encode(jp, jcfg, jb["audio"], jb["audio_lengths"])
        dec_in = np.concatenate([np.full((3, 1), BOS, np.int32), batch["targets"][:, :-1]], axis=1)
        tf = jax.jit(lambda p, d, m, k: jax_teacher_forced(p, jcfg.speller, d, m, k)[1])
        probs_j = tf(jp.speller, jnp.asarray(dec_in), mem_j, mask_j)
        np.testing.assert_allclose(aux["attention"].detach().numpy(), np.asarray(probs_j), rtol=1e-4, atol=1e-5)


def test_teacher_forced_monotonic_noise_uses_generator():
    """With a generator the monotonic recursion gets the config's noise
    (alignments move); without one it is the noiseless recursion."""
    _, _, tcfg, tp = _models("bahdanau_monotonic")
    mem, mask = _memory(2, 9, seed=11)
    dec_in = torch.tensor([[BOS, 4, 5, 6], [BOS, 7, 8, 2]])
    tm, tk = torch.from_numpy(mem), torch.from_numpy(mask)
    with torch.no_grad():
        _, plain, _ = teacher_forced_decode(tp.speller, tcfg.speller, dec_in, tm, tk)
        _, noisy, _ = teacher_forced_decode(tp.speller, tcfg.speller, dec_in, tm, tk,
                                            generator=torch.Generator().manual_seed(1))
        _, again, _ = teacher_forced_decode(tp.speller, tcfg.speller, dec_in, tm, tk,
                                            generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(plain, noisy)
    torch.testing.assert_close(noisy, again, rtol=0, atol=0)
    assert float(noisy[tk[:, None, :].expand_as(noisy) == 0].abs().max()) == 0.0  # padding never selected


@pytest.mark.parametrize("binf_mode", ["logits", "embedding"])
def test_params_from_numpy_carries_binf_codes(binf_mode):
    """The static code matrix travels with the weights (it is data, not
    trainable), and an artifact without it fails loudly."""
    jcfg, jp, tcfg, tp = _models("bahdanau", binf_mode)
    np.testing.assert_array_equal(tp.speller.binf_codes.numpy(), np.asarray(jp.speller.binf_codes))
    assert tp.speller.embedding.shape == jp.speller.embedding.shape
    assert not L.trainable_filter(tp)[".speller.binf_codes"]
    flat = _flat(jp)
    del flat[".speller.binf_codes"]
    with pytest.raises(KeyError, match="binf_codes"):
        params_from_numpy(flat, tcfg, device="cpu")

"""The port's training slice on the CPU against the JAX reference: the
loss and every gradient leaf of the committed checkpoint, each loss head
on a tiny model, the optimizer against the optax chain, and the train
path's randomness (dropout, scheduled sampling) and ``Trainer`` rules."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import binf_sigmoid_loss as jax_binf_loss
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import ctc_head_loss as jax_ctc_head_loss
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.models.las import masked_ce_loss as jax_masked_ce_loss
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.train.state import TrainConfig as JaxTrainConfig
from phones_las_tpu.train.state import make_optimizer as jax_make_optimizer
from phones_las_tpu.train.state import mask_grads as jax_mask_grads
from phones_las_tpu.utils.param_io import load_params_npz

from phones_las_torch.models import las as L
from phones_las_torch.models.listener import dropout
from phones_las_torch.models.speller import teacher_forced_decode
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import (
    Optimizer,
    TrainConfig,
    apply_updates,
    create_train_state,
    mask_grads,
)
from phones_las_torch.utils.param_io import config_from_dict, load_artifact, named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
CKPT = os.path.join(ASSETS, "ckpt.npz")
EOS = 2


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _eval_batch(n):
    """The first ``n`` eval-set utterances with targets = refs + <eos>."""
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    lens = data["lengths"][:n]
    refs = data["refs"][:n]
    ref_lens = (refs >= 0).sum(axis=1)
    targets = np.zeros((n, int(ref_lens.max()) + 1), np.int32)
    for i, r in enumerate(refs):
        targets[i, : ref_lens[i]] = r[: ref_lens[i]]
        targets[i, ref_lens[i]] = EOS
    return {
        "audio": data["audio"][:n, : int(lens.max())],
        "audio_lengths": lens.astype(np.int32),
        "targets": targets,
        "target_lengths": (ref_lens + 1).astype(np.int32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _trainable_params(flat, cfg):
    params = params_from_numpy(flat, cfg, device="cpu")
    mask = L.trainable_filter(params)
    for key, t in named_leaves(params):
        t.requires_grad_(mask[key])
    return params


def _assert_grads_match(params, jax_grads, tol):
    ref = _flat(jax_grads)
    checked = 0
    for key, t in named_leaves(params):
        if not t.requires_grad:
            continue
        want = ref[key]
        got = t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= tol * scale, (key, float(np.abs(got - want).max()), scale)
        checked += 1
    return checked


def test_checkpoint_loss_and_grads_match_jax():
    """The committed checkpoint, 4 eval utterances, train=False: the loss
    and every gradient leaf against jax.value_and_grad of the XLA path,
    each leaf within 1e-4 of its largest magnitude, the loss within 1e-4."""
    batch = _eval_batch(4)
    jparams, jcfg = load_params_npz(CKPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = lambda p: jax_compute_loss(p, jcfg, jb, train=False, implementation="xla")[0]
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)

    _, cfg, _ = load_artifact(CKPT, device="cpu")
    params = _trainable_params(_flat(jparams), cfg)
    loss, aux = L.compute_loss(params, cfg, _torch_batch(batch), train=False)
    loss.backward()
    # the loss is small (≈ 1.7e-3: the checkpoint fits these utterances),
    # so float32 rounding of the logits shows at about 3e-5 relative
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    # listener 3 layers × 2 directions × (wx, wh, b); speller: embedding, 2
    # cells × 3, attention wq/wk/v, attention layer, out_w, out_b
    assert _assert_grads_match(params, ref_grads, 1e-4) == 18 + 13
    assert params.cmvn_mean.grad is None and not params.cmvn_mean.requires_grad


def _tiny_jax_cfg(**kw):
    base = dict(
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=8),
        speller=JaxSpellerConfig(
            vocab_size=11, embedding_dim=6, num_layers=2, units=8, memory_dim=16,
            attention_units=8, attention_layer_size=8, num_binf=5, binf_mode="head",
        ),
        grapheme_speller=JaxSpellerConfig(
            vocab_size=9, embedding_dim=4, num_layers=1, units=8, memory_dim=16,
            attention_units=8, attention_layer_size=8,
        ),
        multitask_weight=0.7, binf_weight=0.5, ctc_weight=0.3, label_smoothing=0.1,
    )
    base.update(kw)
    return JaxLASConfig(**base)


def _tiny_batch(seed=0, b=3):
    rs = np.random.RandomState(seed)
    lens = np.array([8000, 5600, 4000][:b], np.int32)
    audio = np.zeros((b, 8000), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = rs.randn(n) * 2000
    t_lens = np.array([6, 4, 1][:b], np.int32)  # the last row: only <eos>
    g_lens = np.array([5, 7, 3][:b], np.int32)
    targets = rs.randint(3, 11, (b, 6)).astype(np.int32)
    g_targets = rs.randint(3, 9, (b, 7)).astype(np.int32)
    for i in range(b):
        targets[i, t_lens[i] - 1], targets[i, t_lens[i]:] = EOS, 0
        g_targets[i, g_lens[i] - 1], g_targets[i, g_lens[i]:] = EOS, 0
    return {
        "audio": audio, "audio_lengths": lens, "targets": targets, "target_lengths": t_lens,
        "grapheme_targets": g_targets, "grapheme_lengths": g_lens,
    }


def _binf_codes(v=11, f=5, seed=3):
    return (np.random.RandomState(seed).rand(v, f) > 0.5).astype(np.float32)


def _tiny_models(seed=0, **kw):
    jcfg = _tiny_jax_cfg(**kw)
    jparams = jax_init_las(jax.random.PRNGKey(seed), jcfg, binf_codes=_binf_codes())
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, _trainable_params(_flat(jparams), cfg)


def test_multitask_loss_heads_and_grads_match_jax():
    """Phone CE with label smoothing, binf head, CTC head (one row with an
    empty transcript) and grapheme head on a tiny model: train=True with
    no randomness (dropout 0, no generator) so label smoothing is on."""
    jcfg, jparams, cfg, params = _tiny_models()
    batch = _tiny_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_compute_loss(p, jcfg, jb, train=True, implementation="xla"), has_aux=True
    ))(jparams)
    loss, aux = L.compute_loss(params, cfg, _torch_batch(batch), train=True)
    loss.backward()
    for k in ("phone_loss", "binf_loss", "ctc_loss", "grapheme_loss", "loss"):
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert _assert_grads_match(params, ref_grads, 1e-4) > 20


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_masked_ce_loss_matches_jax(smoothing):
    rs = np.random.RandomState(1)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    targets = rs.randint(0, 11, (3, 7)).astype(np.int32)
    mask = (np.arange(7)[None] < np.array([[7], [3], [0]])).astype(np.float32)
    ref = jax_masked_ce_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask), smoothing)
    got = L.masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask), smoothing)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_binf_and_ctc_losses_match_jax():
    rs = np.random.RandomState(2)
    z = (rs.randn(3, 6, 5) * 3).astype(np.float32)
    targets = rs.randint(0, 11, (3, 6)).astype(np.int32)
    mask = (np.arange(6)[None] < np.array([[6], [2], [4]])).astype(np.float32)
    codes = _binf_codes()
    ref = jax_binf_loss(jnp.asarray(z), jnp.asarray(targets), jnp.asarray(codes), jnp.asarray(mask))
    got = L.binf_sigmoid_loss(*(torch.from_numpy(a) for a in (z, targets, codes, mask)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)

    jcfg, jparams, cfg, params = _tiny_models()
    memory = rs.randn(3, 9, 16).astype(np.float32)
    enc_mask = (np.arange(9)[None] < np.array([[9], [6], [4]])).astype(np.float32)
    ctc_targets = np.array([[4, 5, 5, 6, EOS], [7, EOS, 0, 0, 0], [EOS, 0, 0, 0, 0]], np.int32)
    t_lens = np.array([5, 2, 1], np.int32)
    ref = jax_ctc_head_loss(jparams, jcfg, jnp.asarray(memory), jnp.asarray(enc_mask),
                            jnp.asarray(ctc_targets), jnp.asarray(t_lens))
    got = L.ctc_head_loss(params, cfg, *(torch.from_numpy(a) for a in (memory, enc_mask, ctc_targets, t_lens)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def _grads_tree(jparams, seed, scale):
    """Random gradients with the pytree structure of ``jparams``."""
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(rs.randn(*np.shape(x)).astype(np.float32) * scale) for x in leaves]
    )


def test_optimizer_three_steps_match_optax():
    """Clip (the first step's norm above clip_norm), Adam, warmup and
    decay against the reference's optax chain with mask_grads; CMVN stats
    and binf codes never move."""
    jcfg, jparams, cfg, _ = _tiny_models()
    kw = dict(learning_rate=3e-3, warmup_steps=2, lr_decay_rate=0.5, lr_decay_steps=1, clip_norm=5.0)
    tx = jax_make_optimizer(JaxTrainConfig(**kw))
    opt_state, jp = tx.init(jparams), jparams
    jax_step = jax.jit(lambda g, s, p: tx.update(jax_mask_grads(g, p), s, p))

    params = params_from_numpy(_flat(jparams), cfg, device="cpu")
    keys = [k for k, _ in named_leaves(params)]
    leaves = [t for _, t in named_leaves(params)]
    before = {k: t.clone() for k, t in named_leaves(params)}
    opt = Optimizer(TrainConfig(**kw))
    state = opt.init(leaves)
    for step, scale in enumerate((1.0, 0.01, 0.1)):
        g = _grads_tree(jparams, step, scale)
        updates, opt_state = jax_step(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

        tg = mask_grads({k: torch.from_numpy(v.copy()) for k, v in _flat(g).items()}, params)
        upd, state = opt.update([tg[k] for k in keys], state)
        apply_updates(leaves, upd)
    ref = _flat(jp)
    for key, t in named_leaves(params):
        np.testing.assert_allclose(t.detach().numpy(), ref[key], rtol=0, atol=1e-6, err_msg=key)
        assert float((t - before[key]).abs().max()) > 0 or key in (".cmvn_mean", ".cmvn_std", ".speller.binf_codes")
    for key in (".cmvn_mean", ".cmvn_std", ".speller.binf_codes"):
        assert torch.equal(dict(named_leaves(params))[key], before[key]), key


def test_train_without_randomness_equals_eval():
    """train=True with dropout 0, sampling 0 and no smoothing is train=False."""
    _, _, cfg, params = _tiny_models(
        label_smoothing=0.0,
        speller=dataclasses.replace(_tiny_jax_cfg().speller, sampling_probability=0.0),
    )
    batch = _torch_batch(_tiny_batch())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a, _ = L.compute_loss(params, cfg, batch, train=True, generator=g)
        b, _ = L.compute_loss(params, cfg, batch, train=False)
    assert a.item() == b.item()


def test_dropout_keep_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.2, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.25))
    assert not torch.equal(dropout(x, 0.2, g), y)  # fresh masks from the generator


def test_scheduled_sampling_mixes_sampled_tokens():
    _, _, cfg, params = _tiny_models()
    rs = np.random.RandomState(4)
    memory = torch.from_numpy(rs.randn(3, 9, 16).astype(np.float32))
    enc_mask = torch.ones(3, 9)
    dec_in = torch.from_numpy(rs.randint(3, 11, (3, 12)))
    sc = cfg.speller
    with torch.no_grad():
        ref, _, _ = teacher_forced_decode(params.speller, sc, dec_in, memory, enc_mask)
        run = lambda seed, sp: teacher_forced_decode(
            params.speller, sc, dec_in, memory, enc_mask,
            generator=torch.Generator().manual_seed(seed), sampling_probability=sp,
        )[0]
        mixed, again, none = run(0, 1.0), run(0, 1.0), run(0, 0.0)
    torch.testing.assert_close(mixed[:, 0], ref[:, 0], rtol=0, atol=0)  # nothing sampled before step 0
    assert not torch.allclose(mixed[:, 1:], ref[:, 1:])
    torch.testing.assert_close(mixed, again, rtol=0, atol=0)
    torch.testing.assert_close(none, ref, rtol=0, atol=0)


def test_trainer_fit_lowers_loss_and_evaluates():
    jcfg = _tiny_jax_cfg(
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=8, dropout=0.2),
        speller=dataclasses.replace(_tiny_jax_cfg().speller, sampling_probability=0.1),
    )
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tr = Trainer(cfg, TrainConfig(num_steps=3, learning_rate=1e-2, log_every=1), binf_codes=_binf_codes(), device="cpu")
    codes = tr.state.params.speller.binf_codes.clone()
    batch = _tiny_batch()
    logs = []
    tr.fit(iter([batch] * 5), log_fn=logs.append)
    assert [m["step"] for m in logs] == [1, 2, 3] and tr.state.step == 3
    losses = [m["loss"] for m in logs]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert torch.equal(tr.state.params.speller.binf_codes, codes)
    ev = tr.evaluate([batch], max_steps=4)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["per"] and ev["ref_tokens"] == 5 + 3
    assert "cer" in ev and ev["cap_hit_rate"] <= 1.0
    assert tr.decode_cap(batch) == 25  # 49 frames → 25 encoder frames


def test_trainer_warm_start_and_trainable_leaves():
    params, cfg, _ = load_artifact(CKPT, device="cpu")
    tr = Trainer(cfg, TrainConfig(), device="cpu")
    tr.warm_start(params)
    src = dict(named_leaves(params))
    for key, t in named_leaves(tr.state.params):
        assert torch.equal(t.detach(), src[key]), key
        assert t.requires_grad == (key not in (".cmvn_mean", ".cmvn_std")), key


def test_init_las_layout_matches_jax():
    jcfg = _tiny_jax_cfg()
    ref = _flat(jax_init_las(jax.random.PRNGKey(0), jcfg, binf_codes=_binf_codes()))
    params = L.init_las(config_from_dict(dataclasses.asdict(jcfg)), seed=0, binf_codes=_binf_codes())
    got = dict(named_leaves(params))
    assert sorted(got) == sorted(ref)
    for key, leaf in ref.items():
        assert tuple(got[key].shape) == leaf.shape, key
        # zero where the reference initialises zeros, random elsewhere
        assert (float(np.abs(leaf).max()) == 0.0) == (float(got[key].abs().max()) == 0.0), key
    np.testing.assert_array_equal(got[".speller.binf_codes"].numpy(), _binf_codes())


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict(dataclasses.asdict(_tiny_jax_cfg()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig(), binf_codes=_binf_codes())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg, TrainConfig(), _binf_codes())

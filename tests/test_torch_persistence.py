"""The port's persistence on the CPU: its artifact writer against the JAX
loader, CMVN stats, presets and their binding to a data dir, the TIMIT
scoring fold (all against the JAX package), and its own checkpoints:
keep-N and save-every, bitwise resume with dropout on, averaging,
warm start, and the workdir ``Transcriber`` against its own export."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from phones_las_tpu.cli.common import resolve_preset as jax_resolve_preset
from phones_las_tpu.cli.common import timit_score_fold as jax_timit_score_fold
from phones_las_tpu.data.ipa import TIMIT_FOLD_39, fold_timit as jax_fold_timit
from phones_las_tpu.frontend.cmvn import CmvnStats as JaxCmvnStats
from phones_las_tpu.frontend.specaugment import SpecAugmentConfig as JaxSpecAugmentConfig
from phones_las_tpu.models import LASConfig as JaxLASConfig
from phones_las_tpu.models import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.utils.config import PRESETS as JAX_PRESETS
from phones_las_tpu.utils.param_io import load_artifact as jax_load_artifact

from phones_las_torch import api
from phones_las_torch.cli.common import apply_cmvn_to_params, load_data_dir, resolve_preset, timit_score_fold
from phones_las_torch.data.ipa import fold_timit
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.frontend.cmvn import CmvnStats
from phones_las_torch.train.checkpoint import CheckpointManager, load_averaged_params, load_params_for_warm_start
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import TrainConfig
from phones_las_torch.utils.config import PRESETS, dump_preset
from phones_las_torch.utils.param_io import (
    config_from_dict,
    load_params_npz,
    named_leaves,
    params_from_numpy,
    save_params_npz,
)
from tests.torch_threads import one_thread

one_thread()


def _jax_cfg(multitask=False):
    cfg = JaxLASConfig(
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=16),
        speller=JaxSpellerConfig(vocab_size=12, embedding_dim=8, num_layers=1, units=16, memory_dim=32,
                                 attention_units=16, attention_layer_size=16),
        ctc_weight=0.3,
    )
    if multitask:
        cfg = dataclasses.replace(
            cfg,
            grapheme_speller=JaxSpellerConfig(vocab_size=9, embedding_dim=8, num_layers=1, units=16,
                                              memory_dim=32, attention_units=16, attention_layer_size=16),
            specaugment=JaxSpecAugmentConfig(),
        )
    return cfg


@pytest.mark.parametrize("multitask", [False, True])
def test_saved_artifact_loads_in_jax(tmp_path, multitask):
    """Leaves bitwise equal to the JAX model they came from, the config
    equal, extras carried; the multitask + SpecAugment config round-trips."""
    jcfg = _jax_cfg(multitask)
    jparams = jax_init_las(jax.random.PRNGKey(3), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(flat, cfg, device="cpu")
    path = str(tmp_path / "m.npz")
    save_params_npz(path, params, cfg, extras={"vocab": ["a", "b"], "step": 7})
    got, got_cfg, extras = jax_load_artifact(path)
    assert got_cfg == jcfg and extras == {"vocab": ["a", "b"], "step": 7}
    la, lb = jax.tree.leaves(jparams), jax.tree.leaves(got)
    assert len(la) == len(lb) == len(flat)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back, back_cfg = load_params_npz(path, device="cpu")
    assert back_cfg == cfg
    for (k, a), (_, b) in zip(named_leaves(params), named_leaves(back)):
        assert torch.equal(a, b), k


def test_cmvn_stats_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    frames = [rs.randn(50, 120) * 3 + 1, rs.randn(30, 120)]
    s, js = CmvnStats.zeros(120), JaxCmvnStats.zeros(120)
    for f in frames:
        s.update(f, length=40)
        js.update(f, length=40)
    assert s.count == js.count == 70
    np.testing.assert_array_equal(s.mean, js.mean)
    np.testing.assert_array_equal(s.std, js.std)
    s.save(str(tmp_path / "c.json"))
    js2 = JaxCmvnStats.load(str(tmp_path / "c.json"))
    js.save(str(tmp_path / "j.json"))
    s2 = CmvnStats.load(str(tmp_path / "j.json"))
    for a in (js2, s2):
        np.testing.assert_array_equal(a.sum, s.sum)
        np.testing.assert_array_equal(a.sumsq, s.sumsq)
    assert s.sum.dtype == np.float64


@pytest.fixture()
def data_dir(tmp_path):
    """The prepared data dir of ``tests/test_presets.py``."""
    d = str(tmp_path / "data")
    os.makedirs(d)
    Vocab(["a", "ʃ", "i", "sil"]).save(os.path.join(d, "vocab.txt"))
    Vocab(list("abc") + ["<space>"]).save(os.path.join(d, "grapheme_vocab.txt"))
    stats = CmvnStats.zeros(120)
    stats.update(np.random.RandomState(0).randn(50, 120))
    stats.save(os.path.join(d, "cmvn.json"))
    return d


OVERRIDES = {
    "batch_size": 4, "num_steps": 7, "encoder_layers": 3, "encoder_units": 24, "decoder_units": 20,
    "attention_type": "bahdanau_monotonic", "monotonic_mode": "hard", "dropout": 0.3,
    "sampling_probability": 0.25, "clip_norm": 1.0, "ctc_weight": 0.3, "frontend_precision": "high",
    "specaugment": {"freq_masks": 1, "time_mask_ratio": 0.1}, "buckets": (16000, 32000), "checkpoint_every": None,
}


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_resolve_preset_matches_jax(name, data_dir):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for overrides in ({"batch_size": 4, "num_steps": 7}, OVERRIDES):
        preset, vocab, gvocab, cmvn, codes = resolve_preset(name, data_dir, overrides)
        jpreset, jvocab, jgvocab, jcmvn, jcodes = jax_resolve_preset(name, data_dir, overrides)
        assert dataclasses.asdict(preset) == dataclasses.asdict(jpreset)
        assert vocab.tokens == jvocab.tokens and gvocab.tokens == jgvocab.tokens
        np.testing.assert_array_equal(cmvn.mean, jcmvn.mean)
        assert (codes is None) == (jcodes is None)
        if codes is not None:
            np.testing.assert_array_equal(codes, jcodes)
    with pytest.raises(ValueError, match="unknown config override"):
        resolve_preset(name, data_dir, {"bogus_key": 1})


def test_timit_fold_and_cmvn_params_match_jax(data_dir, tmp_path):
    arpa = sorted(set(TIMIT_FOLD_39) | {v for v in TIMIT_FOLD_39.values() if v} | {"iy", "ih", "m"})
    for vocab, ipa in ((Vocab(arpa), False), (Vocab(["a", "ʃ", "i", "sil", "ɾ̃", "n", "ʔ", "ə", "ʌ"]), True)):
        got = timit_score_fold(vocab, ipa)
        assert got == jax_timit_score_fold(vocab, ipa) and len(got) > 2
    assert fold_timit(arpa) == jax_fold_timit(arpa)
    _, _, cmvn = load_data_dir(data_dir)
    preset, *_ = resolve_preset("timit_phone_las", data_dir, {"encoder_units": 8, "decoder_units": 8})
    tr = Trainer(preset.model, preset.train, device="cpu")
    p = apply_cmvn_to_params(tr.state.params, cmvn)
    assert p is tr.state.params
    np.testing.assert_allclose(p.cmvn_mean.numpy(), cmvn.mean.astype(np.float32))
    np.testing.assert_allclose(p.cmvn_std.numpy(), cmvn.std.astype(np.float32))
    dump_preset(preset, str(tmp_path / "preset.json"))
    assert json.load(open(tmp_path / "preset.json"))["name"] == "timit_phone_las"


def _tiny_cfg(vocab_size=12, dropout=0.2):
    jcfg = dataclasses.replace(
        _jax_cfg(),
        listener=JaxListenerConfig(input_dim=120, num_layers=2, units=8, dropout=dropout),
        speller=JaxSpellerConfig(vocab_size=vocab_size, embedding_dim=4, num_layers=1, units=8, memory_dim=16,
                                 attention_units=8, attention_layer_size=8, sampling_probability=0.1),
        specaugment=JaxSpecAugmentConfig(freq_masks=1, freq_mask_width=6, time_masks=1, time_mask_ratio=0.2),
    )
    return config_from_dict(dataclasses.asdict(jcfg))


def _batches(n, seed=0, b=3, vocab_size=12):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = np.array([8000, 6400, 4000][:b], np.int32)
        audio = (rs.randn(b, 8000) * 2000).astype(np.float32)
        targets = rs.randint(4, vocab_size, (b, 6)).astype(np.int32)
        targets[:, -1] = 2
        out.append({"audio": audio, "audio_lengths": lens, "targets": targets,
                    "target_lengths": np.full((b,), 6, np.int32)})
    return out


def _leaves(params):
    return {k: t.detach().clone() for k, t in named_leaves(params)}


def test_checkpoint_manager_policy(tmp_path):
    """orbax's save decision (the first step offered to an empty workdir;
    then never at or below the latest step, forced or every save_every),
    keep-N deleting the oldest, atomic step directories."""
    tr = Trainer(_tiny_cfg(), TrainConfig(), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, save_every=3)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    saved = [s for s in range(1, 8) if mgr.save(s, tr.state)]
    assert saved == [1, 3, 6] and mgr.all_steps() == [3, 6]
    assert not mgr.save(6, tr.state, force=True) and not mgr.save(5, tr.state, force=True)
    assert mgr.save(7, tr.state, epoch=4, force=True)
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7
    assert sorted(os.listdir(mgr.directory)) == ["6", "7"]  # no temporary directory left behind
    _, epoch = mgr.restore(tr.state)
    assert epoch == 4 and tr.state.step == 7
    _, meta = mgr.read(6)
    assert meta == {"step": 6, "epoch": 0}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tr.state)


def test_restore_names_a_misshapen_or_missing_leaf(tmp_path):
    wd = str(tmp_path / "run")
    tr = Trainer(_tiny_cfg(), TrainConfig(), device="cpu")
    CheckpointManager(wd, save_every=1).save(1, tr.state)
    other = Trainer(_tiny_cfg(vocab_size=13), TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match=r"\.speller\.embedding"):
        CheckpointManager(wd).restore(other.state)
    arrays, _ = CheckpointManager(wd).read()
    del arrays["nu.speller.out_b"]
    path = os.path.join(wd, "checkpoints", "1", "state.npz")
    np.savez(path, **arrays)
    with pytest.raises(KeyError, match=r"nu\.speller\.out_b"):
        CheckpointManager(wd).restore(tr.state)


def test_resume_takes_the_uninterrupted_step_bitwise(tmp_path):
    """Dropout, scheduled sampling and SpecAugment on: a run stopped at
    step 2 and resumed from its checkpoint takes a 3rd step bitwise equal
    to the uninterrupted run's (params, Adam moments, generator)."""
    cfg, tc = _tiny_cfg(), TrainConfig(num_steps=3, learning_rate=1e-2, log_every=1)
    b = _batches(3)
    whole = Trainer(cfg, tc, device="cpu")
    whole.fit(iter(b), log_fn=lambda m: None)
    wd = str(tmp_path / "run")
    first = Trainer(cfg, tc, wd, device="cpu")
    first.fit(iter(b[:2]), log_fn=lambda m: None)  # saved at its first step and at its end
    assert first.ckpt.all_steps() == [1, 2]
    resumed = Trainer(cfg, tc, wd, device="cpu")
    assert resumed.state.step == 2 and resumed.start_epoch == 0
    resumed.fit(iter(b[2:]), log_fn=lambda m: None)
    assert resumed.state.step == whole.state.step == 3 and resumed.ckpt.all_steps() == [1, 2, 3]
    want = _leaves(whole.state.params)
    for k, t in _leaves(resumed.state.params).items():
        assert torch.equal(t, want[k]), k
    for a, c in zip(resumed.state.opt_state.nu, whole.state.opt_state.nu):
        assert torch.equal(a, c)
    assert torch.equal(resumed.state.generator.get_state(), whole.state.generator.get_state())
    assert not torch.equal(whole.state.params.listener.layers[0][0].wh, first.state.params.listener.layers[0][0].wh)


def test_average_of_k_is_the_leafwise_mean(tmp_path):
    wd = str(tmp_path / "run")
    tr = Trainer(_tiny_cfg(), TrainConfig(), device="cpu")
    base = _leaves(tr.state.params)
    mgr = CheckpointManager(wd, save_every=1)
    for step, shift in enumerate((0.0, 1.0, 5.0), start=1):
        with torch.no_grad():
            for k, t in named_leaves(tr.state.params):
                t.copy_(base[k] + shift)
        mgr.save(step, tr.state)
    avg, used = load_averaged_params(wd, tr.state, last_k=3)
    assert used == [1, 2, 3]
    for k, t in named_leaves(avg):
        torch.testing.assert_close(t, base[k] + 2.0, rtol=1e-6, atol=1e-6)
        assert not t.requires_grad
    assert load_averaged_params(wd, tr.state, last_k=10)[1] == [1, 2, 3]
    last, used = load_averaged_params(wd, tr.state, last_k=1)
    assert used == [3]
    for k, t in named_leaves(last):
        assert torch.equal(t, base[k] + 5.0), k


def test_encoder_warm_start_across_vocabs(tmp_path):
    wd = str(tmp_path / "src")
    src = Trainer(_tiny_cfg(vocab_size=10), TrainConfig(seed=0), device="cpu")
    with torch.no_grad():
        src.state.params.cmvn_mean.add_(3.0)
    CheckpointManager(wd, save_every=1).save(1, src.state)
    tgt = Trainer(_tiny_cfg(vocab_size=27), TrainConfig(seed=7), device="cpu")
    before = _leaves(tgt.state.params)
    out = load_params_for_warm_start(wd, tgt.state, scope="encoder", target_params=tgt.state.params)
    srcl = _leaves(src.state.params)
    for k, t in named_leaves(out):
        enc = k.startswith(".listener.") or k.startswith(".cmvn")
        assert torch.equal(t, srcl[k] if enc else before[k]), k
    np.testing.assert_allclose(out.cmvn_mean.numpy(), 3.0)
    assert all(torch.equal(t, before[k]) for k, t in named_leaves(tgt.state.params))  # target untouched
    full = load_params_for_warm_start(wd, src.state)
    assert all(torch.equal(t, srcl[k]) for k, t in named_leaves(full))
    deeper = Trainer(dataclasses.replace(_tiny_cfg(27), listener=dataclasses.replace(_tiny_cfg().listener, num_layers=3)),
                     TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="layer-count"):
        load_params_for_warm_start(wd, deeper.state, scope="encoder", target_params=deeper.state.params)


def _workdir(tmp_path, data_dir, steps=3):
    """A tiny timit_multitask run trained for ``steps`` steps by the port,
    checkpointing every step, with its config.json as the CLI writes it."""
    wd = str(tmp_path / "run")
    os.makedirs(wd)
    overrides = {"encoder_units": 8, "decoder_units": 8, "attention_units": 8, "embedding_dim": 4,
                 "attention_layer_size": 8, "num_steps": steps, "checkpoint_every": 1, "ctc_weight": 0.3,
                 "max_target_len": 12, "buckets": [8000, 16000]}
    with open(os.path.join(wd, "config.json"), "w") as f:
        json.dump({"preset": "timit_multitask", "data": data_dir, "overrides": overrides, "precision": None}, f)
    preset, vocab, gvocab, cmvn, codes = resolve_preset("timit_multitask", data_dir, overrides)
    tr = Trainer(preset.model, preset.train, wd, binf_codes=codes, device="cpu")
    apply_cmvn_to_params(tr.state.params, cmvn)
    rs = np.random.RandomState(1)
    batches = []
    for _ in range(steps):
        bt = _batches(1, seed=rs.randint(1000), vocab_size=len(vocab))[0]
        bt["grapheme_targets"] = np.array([[4, 5, 6, 2], [5, 6, 2, 0], [7, 2, 0, 0]], np.int32)
        bt["grapheme_lengths"] = np.array([4, 3, 2], np.int32)
        batches.append(bt)
    tr.fit(iter(batches), log_fn=lambda m: None)
    return wd, tr


def test_workdir_transcriber_equals_its_export(tmp_path, data_dir, monkeypatch):
    wd, tr = _workdir(tmp_path, data_dir)
    pcm = list((np.random.RandomState(5).randn(3, 12000) * 3000).astype(np.int16))
    for kw in ({}, {"beam_width": 3}, {"average_checkpoints": 2}):
        t = api.Transcriber(wd, device="cpu", **kw)
        assert t.step == 3 and t.max_steps == 12 and t.train_max_samples == 16000
        out = str(tmp_path / f"export{len(kw)}{sorted(kw)}.npz")
        extras = t.export_artifact(out)
        assert extras["step"] == 3 and extras["buckets"] == [8000, 16000]
        a = api.Transcriber.from_artifact(out, device="cpu", beam_width=t.beam)
        assert a.train_max_samples == t.train_max_samples and a.vocab.tokens == t.vocab.tokens
        got = t.transcribe_batch(pcm)
        assert got == a.transcribe_batch(pcm) and len(got) == 3
    avg = api.Transcriber(wd, device="cpu", average_checkpoints=2)
    last = dict(named_leaves(tr.state.params))
    assert any(not torch.equal(t, last[k]) for k, t in named_leaves(avg.params) if t.dtype.is_floating_point)
    g = api.Transcriber(wd, device="cpu", head="grapheme")
    assert g.vocab.tokens[-1] == "<space>" and len(g.transcribe_batch(pcm[:1])) == 1
    ctc = api.Transcriber(wd, device="cpu", beam_width=2, ctc_joint=0.7)
    assert len(ctc.transcribe_batch(pcm[:1])) == 1
    with pytest.raises(ValueError, match="2 devices asked for, but only 1 cpu"):
        api.Transcriber(wd, device="cpu", data_parallel=2)
    dp = api.Transcriber(wd, data_parallel=2, devices=["cpu", "cpu"])
    assert dp.data_parallel == 2 and dp.transcribe_batch(pcm) == api.Transcriber(wd, device="cpu").transcribe_batch(pcm)
    with pytest.raises(ValueError, match="beam"):
        api.Transcriber(wd, device="cpu", beam_width=0, ctc_joint=0.7)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with open(os.path.join(empty, "config.json"), "w") as f:
        json.dump({"preset": "timit_phone_las", "data": data_dir}, f)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        api.Transcriber(empty, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Transcriber(wd)  # device=None means CUDA

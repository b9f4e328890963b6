"""The rest of the port's ``Trainer`` against the JAX ``Trainer``: ``fit``
over a ``DataSource`` (per-step losses and final leaves), the epoch
bookkeeping of checkpoints and resume, the greedy eval leg with the
grapheme head's WER and the attention image, beam-8 eval of the committed
checkpoint, and ``decode_cap`` with a ratio."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.train.loop import Trainer as JaxTrainer
from phones_las_tpu.train.state import TrainConfig as JaxTrainConfig
from phones_las_tpu.utils.param_io import load_params_npz

from phones_las_torch.data.pipeline import DataSource, PipelineConfig
from phones_las_torch.data.synthetic import synth_grapheme_inventory, write_synth_corpus
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import TrainConfig
from phones_las_torch.utils.param_io import config_from_dict, load_artifact, named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "phones_las_tpu", "assets", "bench", "ckpt.npz")
EVAL_SET = os.path.join(REPO, "phones_las_tpu", "assets", "bench", "eval_set.npz")
N_PHONES = 6
BATCH = 4
N_UTTS = 14  # 3 full batches an epoch at one bucket; two utterances dropped
SEP_ID = Vocab(synth_grapheme_inventory()).encode(["|"])[0]


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _jax_cfg(multitask=False):
    """A small LAS over the tone corpus's vocabulary, without randomness
    in training (no dropout, no sampling, no SpecAugment)."""
    v = N_PHONES + 4
    speller = JaxSpellerConfig(vocab_size=v, embedding_dim=6, num_layers=2, units=12, memory_dim=24,
                               attention_units=10, attention_layer_size=12)
    extra = {}
    if multitask:
        extra = dict(
            grapheme_speller=JaxSpellerConfig(vocab_size=len(synth_grapheme_inventory()) + 4, embedding_dim=5,
                                              num_layers=1, units=10, memory_dim=24, attention_units=8,
                                              attention_layer_size=10),
            multitask_weight=0.6,
        )
    return JaxLASConfig(listener=JaxListenerConfig(input_dim=120, num_layers=2, units=12), speller=speller, **extra)


def _pair(jcfg, jtc: JaxTrainConfig, workdir_jax=None, workdir_port=None, **kw):
    """A JAX trainer and a port trainer (CPU) holding the same params."""
    jt = JaxTrainer(jcfg, jtc, workdir_jax, implementation="xla", **kw)
    pt = Trainer(config_from_dict(dataclasses.asdict(jcfg)), TrainConfig(**dataclasses.asdict(jtc)), workdir_port,
                 device="cpu", **kw)
    if pt.state.step == 0:
        pt.warm_start(params_from_numpy(_flat(jt.state.params), pt.model_cfg, device="cpu"))
    return jt, pt


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    path, vocab = write_synth_corpus(str(d / "train.plu"), n_utts=N_UTTS, n_phones=N_PHONES, seed=11,
                                     graphemes=True, n_phones_range=(2, 6))
    return path, vocab


def _pipe(vocab, **kw):
    base = dict(batch_size=BATCH, buckets=(16000,), max_target_len=8, max_grapheme_len=30,
                eos_id=vocab.eos_id, pad_id=vocab.pad_id, seed=4)
    base.update(kw)
    return PipelineConfig(**base)


class Recording:
    """A ``DataSource`` that notes the ``utt_ids`` of every batch it hands
    out, by epoch."""

    def __init__(self, src):
        self.src, self.seen = src, []

    def epoch(self, epoch=0, prefetch=4):
        for b in self.src.epoch(epoch, prefetch):
            self.seen.append((epoch, list(b["utt_ids"])))
            yield b

    def repeat(self, start_epoch=0):
        return self.src.repeat(start_epoch)


def test_fit_over_datasource_matches_jax(corpus):
    """Two epochs and a half over the same source: every step's loss
    within 1e-5 relative, every final leaf within 1e-4 of its largest
    magnitude, and the same batches in the same order.

    Adam's ε is 1e-3 here, not 1e-8. Some gradient elements of this model
    are ~1e-9 (against ~1e-3 for the largest), and Adam divides each by
    √v + ε: at ε = 1e-8 such an element steps by about ±lr with a sign that
    follows float32 rounding, so two correct implementations part by up to
    lr a step on it (6e-3 of the leaf's largest magnitude after 7 steps,
    measured). The optimizer itself is held to optax at the default ε in
    ``tests/test_torch_train.py``."""
    path, vocab = corpus
    jtc = JaxTrainConfig(num_steps=7, log_every=1, learning_rate=3e-3, adam_eps=1e-3, eval_every=10**6,
                         checkpoint_every=10**6)
    jt, pt = _pair(_jax_cfg(), jtc)
    src = DataSource([path], _pipe(vocab))
    assert src.native is not None
    jlog, plog = [], []
    jsrc, psrc = Recording(src), Recording(src)
    jt.fit(jsrc, log_fn=jlog.append)
    pt.fit(psrc, log_fn=plog.append)
    assert pt.state.step == int(jt.state.step) == 7
    assert [m["step"] for m in plog] == [m["step"] for m in jlog] == list(range(1, 8))
    for a, b in zip(plog, jlog):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    assert psrc.seen == jsrc.seen and {e for e, _ in psrc.seen} == {0, 1, 2}
    want = _flat(jt.state.params)
    for key, t in named_leaves(pt.state.params):
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        assert float(np.abs(t.detach().numpy() - want[key]).max()) <= 1e-4 * scale, key


def _saves(trainer):
    """Spy on the checkpoint manager: the (step, epoch) of each save."""
    out, save = [], trainer.ckpt.save

    def spy(step, state, epoch=0, force=False):
        wrote = save(step, state, epoch=epoch, force=force)
        if wrote:
            out.append((int(step), int(epoch)))
        return wrote

    trainer.ckpt.save = spy
    return out


@pytest.mark.parametrize("num_steps,every", [(3, 3), (5, 3)], ids=["save_at_epoch_end", "final_save"])
def test_epoch_resume_matches_jax(corpus, tmp_path, num_steps, every):
    """For one schedule both packages save the same (step, epoch) pairs,
    resume at the same ``start_epoch`` (a save at the last step of epoch e
    records e, and the run resumed from it replays epoch e from its first
    batch; the final save records the epoch after the last one run), and
    the resumed runs see the same batches."""
    path, vocab = corpus
    src = DataSource([path], _pipe(vocab))
    per_epoch = len(list(src.epoch(0)))
    assert per_epoch == 3
    jtc = JaxTrainConfig(num_steps=num_steps, log_every=100, checkpoint_every=every, eval_every=10**6)
    wj, wp = str(tmp_path / "jax"), str(tmp_path / "port")
    jt, pt = _pair(_jax_cfg(), jtc, wj, wp)
    saves = (_saves(jt), _saves(pt))
    jt.fit(src, log_fn=lambda m: None)
    pt.fit(src, log_fn=lambda m: None)
    assert saves[0] == saves[1] == [(1, 0), (3, 0)] + ([(5, 2)] if num_steps == 5 else [])
    more = dataclasses.replace(jtc, num_steps=num_steps + 2)
    jr, pr = _pair(_jax_cfg(), more, wj, wp)
    assert pr.state.step == int(jr.state.step) == num_steps
    assert pr.start_epoch == jr.start_epoch == (0 if num_steps == 3 else 2)
    jsrc, psrc = Recording(src), Recording(src)
    jr.fit(jsrc, log_fn=lambda m: None)
    pr.fit(psrc, log_fn=lambda m: None)
    assert psrc.seen == jsrc.seen
    epoch = pr.start_epoch
    trained = [ids for _, ids in psrc.seen][:2]
    assert trained == [b["utt_ids"] for b in src.epoch(epoch)][:2]


class Writer:
    def __init__(self):
        self.scalars, self.images = {}, {}

    def write_scalars(self, step, values):
        self.scalars.setdefault(step, {}).update(values)

    def write_images(self, step, images):
        self.images.setdefault(step, {}).update(images)


def test_greedy_eval_with_wer_and_image_matches_jax(corpus):
    """``fit``'s eval leg on a multitask config with the grapheme stream's
    word break, after 4 steps: every key of JAX's result, counts equal,
    rates and the loss within 1e-5; the writer's scalars under the same
    names, and the attention image of the first batch's row 0 within
    1e-5."""
    path, vocab = corpus
    jtc = JaxTrainConfig(num_steps=4, log_every=2, learning_rate=1e-2, eval_every=4, checkpoint_every=10**6)
    jt, pt = _pair(_jax_cfg(multitask=True), jtc, grapheme_word_sep_id=SEP_ID)
    src = DataSource([path], _pipe(vocab, shuffle=False, drop_remainder=False))
    (jw, jlog), (pw, plog) = (Writer(), []), (Writer(), [])
    jt.fit(src, eval_batches_fn=lambda: src.epoch(0), writer=jw, log_fn=jlog.append)
    pt.fit(src, eval_batches_fn=lambda: src.epoch(0), writer=pw, log_fn=plog.append)
    [want], [got] = ([m for m in log if m["tag"] == "eval"] for log in (jlog, plog))
    assert sorted(got) == sorted(want) and got["step"] == want["step"] == 4
    assert {"wer", "ref_words", "cer", "grapheme_ref_tokens", "cap_hit_rate"} <= set(got)
    for k, v in want.items():
        if isinstance(v, (int, str)):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)
    assert sorted(pw.scalars) == sorted(jw.scalars) == [2, 4]
    assert sorted(pw.scalars[4]) == sorted(jw.scalars[4])
    assert pw.scalars[4]["eval/wer"] == got["wer"]
    img, ref = pw.images[4]["attention_alignment"], np.asarray(jw.images[4]["attention_alignment"])
    assert img.shape == ref.shape and img.shape[-1] == 1 and img.ndim == 4
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=0)
    assert 0.0 <= img.min() and img.max() == 1.0


def _eval_batches(n):
    data = np.load(EVAL_SET, allow_pickle=False)
    refs = data["refs"][:n]
    ref_lens = (refs >= 0).sum(axis=1)
    targets = np.zeros((n, int(ref_lens.max()) + 1), np.int32)
    for i, r in enumerate(refs):
        targets[i, : ref_lens[i]] = r[: ref_lens[i]]
        targets[i, ref_lens[i]] = 2
    batch = {"audio": data["audio"][:n], "audio_lengths": data["lengths"][:n].astype(np.int32),
             "targets": targets, "target_lengths": (ref_lens + 1).astype(np.int32), "num_real": n}
    return [batch], int(data["decode_cap"][0])


def test_beam8_eval_of_the_checkpoint_matches_jax():
    """Beam-8 ``evaluate`` of the committed checkpoint on 16 eval-set
    utterances, at the eval set's decode cap: PER, token and utterance
    counts and cap hits equal, the loss within 1e-5."""
    jparams, jcfg = load_params_npz(CKPT)
    params, cfg, _ = load_artifact(CKPT, device="cpu")
    jt = JaxTrainer(jcfg, JaxTrainConfig(), implementation="xla")
    jt.state = jt.state._replace(params=jparams)
    pt = Trainer(cfg, TrainConfig(), device="cpu")
    pt.warm_start(params)
    batches, cap = _eval_batches(16)
    want = jt.evaluate(batches, cap, beam_width=8)
    got = pt.evaluate(batches, cap, beam_width=8)
    assert sorted(got) == sorted(want) == ["cap_hit_rate", "loss", "per", "ref_tokens"]
    assert got["per"] == want["per"] and got["ref_tokens"] == want["ref_tokens"]
    assert got["cap_hit_rate"] == want["cap_hit_rate"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + 1e-7
    assert got["per"] < 0.1


@pytest.mark.parametrize("ratio", [0.5, 1.0, 1.7])
def test_decode_cap_ratio_matches_jax(ratio):
    jcfg = _jax_cfg()
    jt = JaxTrainer(jcfg, JaxTrainConfig(), implementation="xla", decode_cap_ratio=ratio)
    pt = Trainer(config_from_dict(dataclasses.asdict(jcfg)), TrainConfig(), device="cpu", decode_cap_ratio=ratio)
    for samples in (1600, 16000, 32000, 160000):
        batch = {"audio": np.zeros((2, samples), np.int16)}
        assert pt.decode_cap(batch) == jt.decode_cap(batch), samples
        assert pt.decode_cap({"audio": torch.zeros(2, samples, dtype=torch.int16)}) == jt.decode_cap(batch)
    assert (pt.eval_beam_width, pt.default_decode_steps, pt.grapheme_word_sep_id) == (0, 100, None)

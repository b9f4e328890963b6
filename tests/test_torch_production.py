"""Production (bf16) mode on the CPU against the JAX reference: the greedy
loop's recurrent dot at the configured precision, the long-regime
artifact re-saved with ``matmul_precision='default'`` decoded greedily
and with beam 8 (all 8 beams) and scored teacher-forced, against JAX
under ``jax.default_matmul_precision('default')``; and the scope that
carries the mode to the non-recurrent GEMMs."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu import api as japi
from phones_las_tpu.data.speechlike import make_phonotactics, speechlike_phone_inventory, synth_speech_utterance
from phones_las_tpu.data.vocab import Vocab as JaxVocab
from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.utils.param_io import load_artifact as jax_load_artifact

from phones_las_torch import api
from phones_las_torch.decode import beam_decode
from phones_las_torch.decode import greedy as G
from phones_las_torch.models import las as L
from phones_las_torch.models import speller as S
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import TrainConfig
from phones_las_torch.utils.device import matmul_precision_scope
from phones_las_torch.utils.param_io import load_artifact, save_params_npz
from tests.torch_threads import one_thread

one_thread()

GATE = os.path.join(os.path.dirname(__file__), "goldens", "long_gate.npz")
LOGIT_TOL = 3e-3  # teacher-forced logits, absolute (9.4e-3 with the loop left float32)
BEAM_K = 8


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """The long-gate artifact re-saved by the port with
    ``matmul_precision='default'``, and two utterances of its language
    with their reference phones."""
    params, cfg, extras = load_artifact(GATE, device="cpu")
    path = str(tmp_path_factory.mktemp("prod") / "long_gate_default.npz")
    save_params_npz(path, params, dataclasses.replace(cfg, matmul_precision="default"), extras=extras)
    vocab = JaxVocab(speechlike_phone_inventory())
    lang = make_phonotactics(1234)
    rng = np.random.RandomState(9001)
    utts = [
        synth_speech_utterance(rng, vocab, f"gate-{i}", model=lang, n_syllables_range=(22, 28),
                               word_syllables=(1, 3), snr_db_range=(8.0, 30.0))
        for i in range(2)
    ]
    return path, [u.audio for u in utts], [np.asarray(u.targets) for u in utts]


def test_greedy_loop_runs_recurrent_dot_at_prec(monkeypatch):
    """Under prec='bf16' every recurrent dot of the speller-step loop runs
    bf16 (greedy_decode on CPU tensors takes the loop)."""
    params, cfg, _ = load_artifact(GATE, device="cpu")
    seen = []

    def recording(h, wh, prec):
        seen.append(prec)
        return rec_dot(h, wh, prec)

    rec_dot = S.rec_dot
    monkeypatch.setattr(S, "rec_dot", recording)
    memory = torch.from_numpy(np.random.RandomState(0).randn(2, 30, 192).astype(np.float32))
    mask = torch.ones(2, 30)
    with torch.no_grad():
        G.greedy_decode_steps(params.speller, cfg.speller, memory, mask, 5, prec="bf16")
        assert seen == ["bf16"] * 5
        seen.clear()
        G.greedy_decode(params.speller, cfg.speller, memory, mask, 4, prec="bf16")
        assert seen == ["bf16"] * 4
        seen.clear()
        G.greedy_decode(params.speller, cfg.speller, memory, mask, 3)
    assert seen == ["highest"] * 3


def test_production_artifact_loads_in_both(production):
    path, _, _ = production
    t = api.Transcriber.from_artifact(path, device="cpu")
    assert t.model_cfg.matmul_precision == "default" and t.prec == "bf16"
    _, jcfg, _ = jax_load_artifact(path)
    assert jcfg.matmul_precision == "default"


@pytest.mark.parametrize("beam", [0, BEAM_K])
def test_production_transcriber_matches_jax(production, beam):
    path, audio, _ = production
    got = api.Transcriber.from_artifact(path, device="cpu", beam_width=beam).transcribe_batch(audio)
    want = japi.Transcriber.from_artifact(path, beam_width=beam).transcribe_batch(audio)
    assert got == want
    assert min(len(h) for h in got) > 40


def _batch(audio, targets, eos=2):
    n = max(len(a) for a in audio)
    pcm = np.zeros((len(audio), n), np.float32)
    for i, a in enumerate(audio):
        pcm[i, : len(a)] = a
    s = max(len(t) for t in targets) + 1
    tg = np.zeros((len(targets), s), np.int32)
    for i, t in enumerate(targets):
        tg[i, : len(t)] = t
        tg[i, len(t)] = eos
    return {
        "audio": pcm, "audio_lengths": np.asarray([len(a) for a in audio], np.int32),
        "targets": tg, "target_lengths": np.asarray([len(t) + 1 for t in targets], np.int32),
    }


def test_production_beam_and_logits_match_jax(production):
    """All 8 beams' tokens equal JAX's; teacher-forced logits within
    LOGIT_TOL absolute of JAX's, both in production mode."""
    path, audio, targets = production
    batch = _batch(audio, targets)
    params, cfg, extras = load_artifact(path, device="cpu")
    jparams, jcfg, _ = jax_load_artifact(path)
    jparams = jax.tree.map(jnp.asarray, jparams)  # the loader returns host arrays
    steps = int(extras["max_target_len"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("default"):
        mem, _, mask = jax_encode(jparams, jcfg, jb["audio"], jb["audio_lengths"])
        jres = jax_beam_decode(jparams.speller, jcfg.speller, mem, mask, steps, beam_width=BEAM_K)
        _, jaux = jax_compute_loss(jparams, jcfg, jb, train=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
        memory, _, enc_mask = L.encode(params, cfg, tb["audio"], tb["audio_lengths"], prec="bf16")
        res = beam_decode(params.speller, cfg.speller, memory, enc_mask, steps, beam_width=BEAM_K, prec="bf16")
        _, aux = L.compute_loss(params, cfg, tb, train=False, prec="bf16")
    np.testing.assert_array_equal(res.beam_tokens.numpy(), np.asarray(jres.beam_tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    got, want = aux["logits"].numpy(), np.asarray(jaux["logits"])
    err = float(np.abs(got - want).max())
    print(f"teacher-forced logits, production mode: max |port - JAX| = {err:.3e}")
    assert err <= LOGIT_TOL, err
    assert float(np.abs(want).max()) > 5.0  # the logits are not trivially small


@pytest.mark.parametrize("mode,tf32", [("highest", False), ("default", True), ("high", True)])
def test_matmul_precision_scope_sets_and_restores(mode, tf32):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for outer in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = outer
        with matmul_precision_scope(mode):
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is outer and torch.backends.cudnn.allow_tf32 is outer
        with pytest.raises(KeyError):
            with matmul_precision_scope(mode):
                raise KeyError("restored on the way out")
        assert torch.backends.cuda.matmul.allow_tf32 is outer and torch.backends.cudnn.allow_tf32 is outer
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_entry_points_enter_the_scope(monkeypatch, production):
    """Transcriber._decode and Trainer.evaluate run inside the config's
    scope: TF32 is on while production mode decodes, and off again after."""
    path, audio, _ = production
    flags = []
    real = G.greedy_decode_steps

    def spy(*a, **kw):
        flags.append((torch.backends.cuda.matmul.allow_tf32, kw.get("prec")))
        return real(*a, **kw)

    monkeypatch.setattr(G, "greedy_decode_steps", spy)
    torch.backends.cuda.matmul.allow_tf32 = False
    t = api.Transcriber.from_artifact(path, device="cpu")
    t.transcribe_batch([audio[0][:16000]])
    assert flags == [(True, "bf16")] and torch.backends.cuda.matmul.allow_tf32 is False
    tr = Trainer(t.model_cfg, TrainConfig(), device="cpu")
    tr.warm_start(t.params)
    ev = tr.evaluate([_batch([audio[0][:16000]], [np.array([5, 6, 7])])], max_steps=3)
    assert flags[1:] == [(True, "bf16")] and np.isfinite(ev["loss"])
    assert torch.backends.cuda.matmul.allow_tf32 is False

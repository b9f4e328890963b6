"""The port's entry points (``phones_las_torch.entry``) and tools
(``phones_las_torch.tools``) against the reference's
``__graft_entry__.py`` and ``tools/*.py`` on the CPU: ``entry()``'s
tokens on the reference's weights; ``dryrun_multichip`` over gloo ranks;
the bench assets of a port workdir against the reference script's
construction, read by both packages; the export tool; ``decode_stats``
and ``sample_lm_text`` byte for byte; the long-form streams and both
long-form tools."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as ref_entry
from phones_las_tpu.cli.common import resolve_preset as jax_resolve_preset
from phones_las_tpu.data import speechlike as jax_speechlike
from phones_las_tpu.data.records import RecordReader as JaxRecordReader
from phones_las_tpu.data.vocab import Vocab as JaxVocab
from phones_las_tpu.train.loop import Trainer as JaxTrainer
from phones_las_tpu.utils.param_io import load_artifact as jax_load_artifact
from phones_las_tpu.utils.param_io import load_params_npz as jax_load_params_npz

from phones_las_torch.api import Transcriber
from phones_las_torch.cli.common import resolve_preset
from phones_las_torch.data.prep_common import finalize_split_dir
from phones_las_torch.data.records import RecordReader
from phones_las_torch.data.speechlike import write_speechlike_corpus
from phones_las_torch.entry import dryrun_multichip, entry, flagship_cfg
from phones_las_torch.tools import (
    decode_stats,
    export_artifact,
    longform_debug,
    longform_eval,
    make_bench_assets,
    sample_lm_text,
)
from phones_las_torch.train.checkpoint import CheckpointManager
from phones_las_torch.train.loop import Trainer
from phones_las_torch.utils.param_io import load_params_npz, named_leaves, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = {"encoder_layers": 2, "encoder_units": 8, "decoder_units": 8, "attention_units": 8,
             "embedding_dim": 4, "attention_layer_size": 8, "max_target_len": 24}


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _ref_tool(name):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _ref_main(mod, argv) -> str:
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        return _stdout(mod.main)
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A speechlike data dir (8 train, 6 test utterances) and a workdir of
    a tiny ``timit_phone_las`` (its own CLI's config.json) holding one
    checkpoint of the port."""
    root = tmp_path_factory.mktemp("bench_assets")
    data = str(root / "data")
    os.makedirs(data)
    _, vocab = write_speechlike_corpus(os.path.join(data, "train.plu"), n_utts=8, seed=0)
    write_speechlike_corpus(os.path.join(data, "test.plu"), n_utts=6, seed=1)
    finalize_split_dir(data, vocab, cmvn_from=os.path.join(data, "train.plu"), meta={"corpus": "speechlike"},
                       device="cpu")
    wd = str(root / "run")
    os.makedirs(wd)
    with open(os.path.join(wd, "config.json"), "w") as f:
        json.dump({"preset": "timit_phone_las", "data": data, "overrides": OVERRIDES, "precision": None}, f)
    preset = resolve_preset("timit_phone_las", data, OVERRIDES)[0]
    tr = Trainer(preset.model, preset.train, device="cpu")
    CheckpointManager(wd, save_every=1).save(1, tr.state)
    return SimpleNamespace(data=data, workdir=wd, params=tr.state.params, vocab=vocab)


def test_entry_equals_the_reference():
    """``entry(device='cpu')``: the reference's audio and lengths, and on
    the reference's ``PRNGKey(0)`` weights carried across, its tokens and
    lengths (parity); on the port's own init, tokens of shape [4, 100]."""
    fn, (params, audio, lengths) = entry(device="cpu")
    jfn, (jp, jaudio, jlengths) = ref_entry.entry()
    np.testing.assert_array_equal(audio.numpy(), jaudio)
    np.testing.assert_array_equal(lengths.numpy(), jlengths)
    carried = params_from_numpy(_flat(jp), flagship_cfg(), device="cpu")
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jfn)(jp, jaudio, jlengths)
    got = fn(carried, audio, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tokens, lens = fn(params, audio, lengths)
    assert tokens.shape == (4, 100) and lens.shape == (4,)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_over_gloo(n, monkeypatch):
    """n ranks sharing the CPU over gloo: data 1 × model 2, data 2 ×
    model 2; the sharded step within the reference's bounds of the
    unsharded one and the sharded beam-8 decode token-equal (both held
    inside ``dryrun_multichip``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks inherit it
    result = dryrun_multichip(n, devices=["cpu"] * n)
    assert result["mesh"] == {"data": n // 2, "model": 2} and result["backend"] == "gloo"
    assert result["beam8_decode_token_equal"] and np.isfinite(result["loss"])
    with pytest.raises(ValueError, match=f"need {n + 1} devices"):
        dryrun_multichip(n + 1, devices=["cpu"] * n)


def test_make_bench_assets_equals_the_reference(run, tmp_path):
    """The eval-set arrays equal, array for array, to the reference
    script's construction over the same record file (its ``decode_cap``
    rule); ``ckpt.npz`` loads in both packages to the checkpoint's leaves
    and one config."""
    out = str(tmp_path / "assets")
    make_bench_assets.main(["--workdir", run.workdir, "--n-utts", "4", "--out", out, "--device", "cpu"])

    # tools/make_bench_assets.py's construction, with the reference's reader and decode cap
    jpreset = jax_resolve_preset("timit_phone_las", run.data, dict(OVERRIDES))[0]
    reader = JaxRecordReader(os.path.join(run.data, "test.plu"))
    n = min(4, len(reader))
    utts = [reader[i] for i in range(n)]
    s_max = max(u.audio.shape[0] for u in utts)
    l_max = max(u.targets.shape[0] for u in utts) + 1
    audio = np.zeros((n, s_max), np.float32)
    lengths = np.zeros((n,), np.int32)
    refs = np.full((n, l_max), -1, np.int32)
    for i, u in enumerate(utts):
        audio[i, : u.audio.shape[0]] = u.audio.astype(np.float32)
        lengths[i] = u.audio.shape[0]
        refs[i, : u.targets.shape[0]] = u.targets
    cap = JaxTrainer.decode_cap(SimpleNamespace(model_cfg=jpreset.model, decode_cap_ratio=1.0), {"audio": audio})
    want = {"audio": audio, "lengths": lengths, "refs": refs, "decode_cap": np.array([cap], np.int32)}
    with np.load(os.path.join(out, "eval_set.npz")) as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)

    ckpt = os.path.join(out, "ckpt.npz")
    jp, jcfg = jax_load_params_npz(ckpt)
    params, cfg = load_params_npz(ckpt, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(jpreset.model)
    jflat, saved = _flat(jp), dict(named_leaves(run.params))
    for key, t in named_leaves(params):
        np.testing.assert_array_equal(t.numpy(), jflat[key], err_msg=key)
        np.testing.assert_array_equal(t.numpy(), saved[key].detach().numpy(), err_msg=key)


def test_export_artifact_tool(run, tmp_path):
    """The export tool writes the workdir's params and decode metadata,
    read by the reference's ``load_artifact``."""
    out = str(tmp_path / "model.npz")
    said = _stdout(export_artifact.main, ["--workdir", run.workdir, "--out", out, "--device", "cpu"])
    assert said.startswith(f"wrote {out}: ") and "step 1," in said
    jp, _, extras = jax_load_artifact(out)
    assert extras["step"] == 1 and extras["vocab"] == list(run.vocab.tokens)
    jflat = _flat(jp)
    for key, t in named_leaves(run.params):
        np.testing.assert_array_equal(t.detach().numpy(), jflat[key], err_msg=key)


def test_decode_stats_output_equals_the_reference(run, tmp_path):
    """The same TSV against the same records: byte-identical reports, with
    and without a step cap."""
    utts = list(RecordReader(os.path.join(run.data, "test.plu")))
    vocab = run.vocab
    refs = [vocab.decode(u.targets) for u in utts]
    hyps = [refs[0], refs[1][1:], refs[2] + refs[2][:1] * 20, [], refs[4][::-1], refs[5]]
    tsv = tmp_path / "hyps.tsv"
    tsv.write_text("# a comment line\n" + "".join(f"{u.utt_id}\t{' '.join(h)}\n" for u, h in zip(utts, hyps)))
    ref_tool = _ref_tool("decode_stats")
    for extra in ([], ["--cap", "12", "--slack", "4"]):
        argv = ["--tsv", str(tsv), "--records", os.path.join(run.data, "test.plu"), *extra]
        want = _ref_main(ref_tool, argv)
        assert want.startswith("utts=6 ")
        assert _stdout(decode_stats.main, argv) == want


def test_sample_lm_text_equals_the_reference(tmp_path):
    """The same seeds write the same file, byte for byte, and print the same line."""
    out = str(tmp_path / "lm.txt")
    ref_tool = _ref_tool("sample_lm_text")
    for extra in ([], ["--words", "1", "3", "--syllables", "3", "7", "--seed", "5"]):
        argv = ["--out", out, "--n", "40", *extra]
        said = _ref_main(ref_tool, argv)
        with open(out, "rb") as f:
            want = f.read()
        os.remove(out)
        assert _stdout(sample_lm_text.main, argv) == said
        with open(out, "rb") as f:
            assert f.read() == want


def test_longform_streams_equal_the_reference():
    """``synth_streams`` draws the reference tool's streams: audio, phone
    targets and token times equal for the same seeds."""
    got = list(longform_eval.synth_streams(2, 12, (1, 3), 31, 1234, (8.0, 30.0)))
    vocab = JaxVocab(jax_speechlike.speechlike_phone_inventory())
    model = jax_speechlike.make_phonotactics(1234)
    rng = np.random.RandomState(31)
    for i, u in enumerate(got):
        w = jax_speechlike.synth_speech_utterance(rng, vocab, f"stream-{i}", model=model, n_syllables_range=(12, 12),
                                                  word_syllables=(1, 3), snr_db_range=(8.0, 30.0))
        assert u.utt_id == w.utt_id
        for k in ("audio", "targets", "token_times"):
            np.testing.assert_array_equal(getattr(u, k), getattr(w, k), err_msg=k)


def test_longform_tools_run(run):
    """Both long-form tools over one short stream through the workdir's
    ``Transcriber`` on the CPU: ``longform_eval``'s stitched PER equals
    the one computed here from ``transcribe_long``."""
    args = ["--workdir", run.workdir, "--streams", "1", "--stream-syllables", "6", "--device", "cpu"]
    said = _stdout(longform_eval.main, args + ["--window", "2", "--overlap", "0.5"])
    (u,) = longform_eval.synth_streams(1, 6, (1, 3), 31, 1234, (8.0, 30.0))
    hyp = Transcriber(run.workdir, device="cpu").transcribe_long(u.audio, window_seconds=2, overlap_seconds=0.5)
    ref = run.vocab.decode(u.targets)
    ids = {t: i for i, t in enumerate(run.vocab.tokens)}
    per = longform_eval._edit_distance([ids[x] for x in hyp], [ids[x] for x in ref]) / len(ref)
    assert said.splitlines()[-1].endswith(f"stitched PER {per:.4f}"), said
    debug = _stdout(longform_debug.main, args + ["--window", "1.5", "--overlap", "0.5"])
    assert "=== totals ===" in debug and "stitched PER" in debug

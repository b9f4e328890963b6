"""The port's command lines on the CPU (``--device cpu``): prepare → train
→ infer → transcribe → lm through ``main([...])``; the workdir's
``config.json`` read by the JAX package's ``resolve_preset`` gives the
port's model config; ``cli.lm`` writes the JAX CLI's file; infer's
beam options give the JAX package's hypotheses; and the multi-device
flags work."""

import dataclasses
import json
import os
import re
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest

from phones_las_tpu.cli import lm as jax_lm_cli
from phones_las_tpu.cli.common import resolve_preset as jax_resolve_preset

from phones_las_torch.api import Transcriber
from phones_las_torch.cli import infer, lm, prepare, serve, train, transcribe
from phones_las_torch.cli.common import resolve_preset
from phones_las_torch.data.audio_io import write_wav
from phones_las_torch.data.pipeline import DataSource
from phones_las_torch.data.records import RecordReader
from phones_las_torch.train.loop import Trainer
from tests.torch_threads import one_thread, subprocess_env

one_thread()

CPU = ["--device", "cpu"]
TRAIN = ["--preset", "timit_phone_las", "--num-steps", "3", "--batch-size", "4", "--checkpoint-every", "2",
         "--encoder-layers", "2", "--encoder-units", "16", "--decoder-units", "16", "--embedding-dim", "8",
         "--attention-units", "16", "--max-target-len", "12", "--ctc-weight", "0.3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A synthetic data dir and a workdir trained 3 steps with a CTC head
    (checkpoints 1, 2 and 3)."""
    root = tmp_path_factory.mktemp("cli")
    data, wd = str(root / "d"), str(root / "w")
    prepare.main(["synthetic", "--out", data, "--n-utts", "12", "--n-phones", "4", *CPU])
    train.main(["--data", data, "--workdir", wd, *TRAIN, *CPU])
    return data, wd


def _footer(out: str):
    m = re.search(r"^# (\d+) utterances, PER=([0-9.]+) \((\d+)/(\d+)\)", out, re.M)
    assert m, out
    return int(m.group(1)), float(m.group(2)), int(m.group(3)), int(m.group(4))


def test_prepare_train_infer_transcribe(run, tmp_path, capsys):
    data, wd = run
    assert sorted(os.listdir(data)) == ["cmvn.json", "meta.json", "test.plu", "test.plu.idx", "train.plu",
                                        "train.plu.idx", "vocab.txt"]
    assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == ["1", "2", "3"]
    capsys.readouterr()
    tsv = str(tmp_path / "hyps.tsv")
    infer.main(["--workdir", wd, "--data", os.path.join(data, "test.plu"), "--beam-width", "0",
                "--output", tsv, *CPU])
    n, per, dist, toks = _footer(capsys.readouterr().out)
    utts = list(RecordReader(os.path.join(data, "test.plu")))
    with open(tsv) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert n == len(utts) == len(rows) == 8 and [r[0] for r in rows] == [u.utt_id for u in utts]
    # the footer's PER is the Trainer's greedy eval at the same cap
    cfg = json.load(open(os.path.join(wd, "config.json")))
    preset, *_ = resolve_preset(cfg["preset"], cfg["data"], cfg["overrides"])
    tr = Trainer(preset.model, preset.train, wd, device="cpu")
    eval_cfg = dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False)
    ev = tr.evaluate(DataSource([os.path.join(data, "test.plu")], eval_cfg).epoch(0),
                     max_steps=preset.pipeline.max_target_len)
    assert (per, toks) == (round(ev["per"], 4), ev["ref_tokens"])

    wavs = []
    for u in utts[:4]:
        wavs.append(str(tmp_path / f"{u.utt_id}.wav"))
        write_wav(wavs[-1], u.audio, 16000)
    transcribe.main(["--workdir", wd, *wavs, *CPU])
    lines = capsys.readouterr().out.splitlines()
    want = Transcriber(wd, device="cpu").transcribe_files(wavs)
    assert lines == [f"{p}\t{' '.join(t)}" for p, t in zip(wavs, want)]
    transcribe.main(["--workdir", wd, "--long-form", "--window-seconds", "0.6", "--overlap-seconds", "0.2",
                     wavs[0], *CPU])
    long = Transcriber(wd, device="cpu").transcribe_long(
        utts[0].audio, window_seconds=0.6, overlap_seconds=0.2)
    assert capsys.readouterr().out.splitlines() == [f"{wavs[0]}\t{' '.join(long)}"]


def _jax_infer(artifact, wd, data, lm_path, beam, rescore, joint, lm_weight):
    """The JAX infer CLI's decode (``phones_las_tpu/cli/infer.py``'s
    ``infer_fn``) of the params in ``artifact`` over the batches of the
    data dir, as the workdir's preset cuts them, all in JAX →
    [(utt_id, hypothesis)] in the CLI's order."""
    import jax
    import jax.numpy as jnp

    from phones_las_tpu.api import _ctc_logp
    from phones_las_tpu.data.pipeline import DataSource as JaxDataSource
    from phones_las_tpu.data.vocab import Vocab as JaxVocab
    from phones_las_tpu.decode import beam_decode
    from phones_las_tpu.decode.ctc import rescore_beams
    from phones_las_tpu.decode.lm import load_lm
    from phones_las_tpu.models.las import encode
    from phones_las_tpu.utils.param_io import load_artifact

    params, cfg, extras = load_artifact(artifact)
    vocab, max_steps = JaxVocab(list(extras["vocab"])), int(extras["max_target_len"])
    lm_logp = None if lm_path is None else jnp.asarray(load_lm(lm_path))

    @jax.jit
    def fn(params, audio, lengths):
        with jax.default_matmul_precision(cfg.matmul_precision):
            memory, _, enc_mask = encode(params, cfg, audio, lengths, implementation="xla")
            res = beam_decode(
                params.speller, cfg.speller, memory, enc_mask, max_steps, beam_width=beam,
                lm_logp=lm_logp, lm_weight=lm_weight,
                ctc_logp=_ctc_logp(params, memory, joint), ctc_alpha=1.0 if joint is None else joint,
            )
            if rescore is None:
                return res.tokens, res.lengths
            best, _ = rescore_beams(
                memory @ params.ctc_w + params.ctc_b, enc_mask, res.beam_tokens, res.beam_lengths,
                res.beam_logp, rescore, beam_finished=res.beam_finished,
            )
            rows = jnp.arange(best.shape[0])
            return res.beam_tokens[rows, best], res.beam_lengths[rows, best]

    wd_cfg = json.load(open(os.path.join(wd, "config.json")))
    preset, *_ = jax_resolve_preset(wd_cfg["preset"], wd_cfg["data"], wd_cfg["overrides"])
    paths = sorted(os.path.join(data, f) for f in os.listdir(data) if f.endswith(".plu"))
    source = JaxDataSource(paths, dataclasses.replace(preset.pipeline, shuffle=False, drop_remainder=False))
    hyps = []
    for batch in source.epoch(0):
        toks, lens = (np.asarray(x) for x in fn(params, batch["audio"], batch["audio_lengths"]))
        for i in range(batch["num_real"]):
            hyps.append((batch["utt_ids"][i], " ".join(vocab.decode(toks[i][: lens[i]]))))
    return hyps


@pytest.mark.parametrize("opts", [
    ["--beam-width", "2", "--average-checkpoints", "2"],
    ["--beam-width", "2", "--ctc-rescore", "0.7"],
    ["--beam-width", "2", "--ctc-joint", "0.7", "--lm", "LM"],
], ids=["beam_avg", "ctc_rescore", "ctc_joint_lm"])
def test_infer_decode_options(run, tmp_path, capsys, opts):
    """Each beam option's hypotheses, row by row, equal the JAX package's
    decode (beam, joint-CTC α, LM, n-best CTC rescoring as its infer CLI
    composes them) of the same params, read from the port's artifact of
    the workdir (averaged where the CLI averages)."""
    data, wd = run
    lm_path = str(tmp_path / "lm.npz") if "--lm" in opts else None
    opts = [lm_path if o == "LM" else o for o in opts]
    if lm_path:
        lm.main(["--data", data, "--out", lm_path, "--order", "2"])
    capsys.readouterr()
    infer.main(["--workdir", wd, "--data", data, *opts, *CPU])
    out = capsys.readouterr().out
    n, per, _, _ = _footer(out)
    assert n == 20 and np.isfinite(per)  # both splits of the data dir
    avg = 2 if "--average-checkpoints" in opts else 1
    if avg > 1:
        assert "averaged 2 checkpoints: steps [2, 3]" in out
    ours = [tuple(line.split("\t", 1)) for line in out.splitlines() if "\t" in line and not line.startswith("#")]
    assert len(ours) == 20
    artifact = str(tmp_path / "model.npz")
    Transcriber(wd, device="cpu", average_checkpoints=avg).export_artifact(artifact)
    num = lambda flag: float(opts[opts.index(flag) + 1]) if flag in opts else None
    theirs = _jax_infer(artifact, wd, data, lm_path, 2, num("--ctc-rescore"), num("--ctc-joint"), 0.3)
    assert ours == theirs


def test_config_json_replays_in_both_packages(run):
    """``config.json`` resolved by the JAX package's ``resolve_preset``
    gives the same preset as the port's, and its ``resolved`` record is
    that preset."""
    _, wd = run
    with open(os.path.join(wd, "config.json")) as f:
        cfg = json.load(f)
    assert set(cfg) == {"preset", "data", "overrides", "precision", "resolved"}
    assert cfg["overrides"]["ctc_weight"] == 0.3 and cfg["overrides"]["max_target_len"] == 12
    preset, *_ = resolve_preset(cfg["preset"], cfg["data"], cfg["overrides"])
    jpreset, *_ = jax_resolve_preset(cfg["preset"], cfg["data"], cfg["overrides"])
    assert dataclasses.asdict(preset) == dataclasses.asdict(jpreset)
    assert cfg["resolved"] == json.loads(json.dumps(dataclasses.asdict(preset), default=str))


def test_checkpoint_of_another_device_type_serves(run, tmp_path, capsys):
    """Fault C4: a checkpoint written on the card holds a CUDA generator's
    state (16 bytes; the CPU's holds 5056). Resuming it on the CPU still
    refuses, but the workdir ``Transcriber`` and the infer CLI read its
    params alone, so it decodes here."""
    data, wd = run
    other = str(tmp_path / "w")
    shutil.copytree(wd, other)
    path = os.path.join(other, "checkpoints", "3", "state.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["generator"] = np.zeros(16, np.uint8)
    np.savez(path, **arrays)
    cfg = json.load(open(os.path.join(wd, "config.json")))
    preset, *_ = resolve_preset(cfg["preset"], cfg["data"], cfg["overrides"])
    with pytest.raises(ValueError, match="generator"):
        Trainer(preset.model, preset.train, other, device="cpu")
    clip = next(iter(RecordReader(os.path.join(data, "test.plu")))).audio
    t = Transcriber(other, beam_width=0, device="cpu")
    assert t.step == 3 and t.transcribe(clip) == Transcriber(wd, beam_width=0, device="cpu").transcribe(clip)
    test = os.path.join(data, "test.plu")
    outs = []
    for w in (wd, other):
        capsys.readouterr()
        infer.main(["--workdir", w, "--data", test, "--beam-width", "0", *CPU])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and _footer(outs[1])[0] == 8


@pytest.mark.parametrize("order", [2, 3])
def test_lm_file_matches_jax(run, tmp_path, order):
    data, _ = run
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    lm.main(["--data", data, "--out", ours, "--order", str(order)])
    jax_lm_cli.main(["--data", data, "--out", theirs, "--order", str(order)])
    a, b = np.load(ours, allow_pickle=True), np.load(theirs, allow_pickle=True)  # files this test wrote
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cli,argv,item", [
    (train, ["--mesh"], "A8"),
    (train, ["--multihost"], "A8"),
    (train, ["--mesh", "--devices", "cpu,cpu", "--model-parallel", "2"], "A8"),
    (infer, ["--mesh"], "A8"),
    (serve, ["--replicas", "2", "--devices", "cpu,cpu"], "A8"),
    (serve, ["--data-parallel", "0", "--devices", "cpu,cpu"], "A8"),
])
def test_not_ported_flags_raise(run, cli, argv, item, tmp_path, capfd, monkeypatch):
    """The multi-device flags, which raised until ROADMAP ``item`` ported
    them, now work: ``train --mesh`` (its ranks started by the command,
    here one, then two on the CPU with a model axis of 2), ``--multihost``
    without a launcher (the 1 × 1 mesh), ``infer --mesh`` to the lines of
    the plain infer, and ``serve`` over replicas or data-parallel shards,
    answering a request."""
    assert item == "A8"
    data, wd = run
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in subprocess_env().items():  # the ranks' environment: one OpenMP thread
        monkeypatch.setenv(k, v)
    if cli is train:
        out_wd = str(tmp_path / "w")
        train.main(["--data", data, "--workdir", out_wd, *TRAIN, "--num-steps", "1", *argv, *CPU])
        out = capfd.readouterr().out
        assert ("mesh=1x2" if "--model-parallel" in argv else "mesh=1x1") in out and "'tag': 'train'" in out
        assert os.listdir(os.path.join(out_wd, "checkpoints")) == ["1"]
    elif cli is infer:
        test = os.path.join(data, "test.plu")
        capfd.readouterr()
        infer.main(["--workdir", wd, "--data", test, "--beam-width", "0", *CPU])
        plain = capfd.readouterr().out
        infer.main(["--workdir", wd, "--data", test, "--beam-width", "0", *argv, *CPU])
        assert capfd.readouterr().out == plain and _footer(plain)[0] == 8
    else:
        made, make = [], serve.make_server
        monkeypatch.setattr(serve, "make_server", lambda *a, **k: made.append(make(*a, **k)) or made[-1])
        th = threading.Thread(target=serve.main, daemon=True, args=([
            "--workdir", wd, "--host", "127.0.0.1", "--port", "0", "--max-batch", "2", "--beam-width", "0",
            "--long-form-threshold-s", "0", *argv, *CPU],))
        th.start()
        deadline = time.time() + 180  # a server that never comes up ends the wait
        while not made and th.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        assert made, "the server did not come up"
        server, worker = made[0]
        try:
            assert (len(worker.replicas), worker.t.data_parallel) == ((2, 1) if "--replicas" in argv else (1, 2))
            clip = next(iter(RecordReader(os.path.join(data, "test.plu")))).audio
            port = server.server_address[1]
            req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe?raw=1", data=clip.tobytes())
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())["tokens"]
            assert got == Transcriber(wd, beam_width=0, device="cpu").transcribe(clip)
        finally:
            server.shutdown()
            th.join(60)
        assert not th.is_alive()


@pytest.mark.parametrize("argv,missing", [
    (["librispeech", "--root", "r", "--targets", "phone", "--g2p-model", "bundled"], "train-clean-100"),
    (["common_voice", "--root", "r", "--langs", "en", "--g2p-model", "bundled"], "validated.tsv"),
])
def test_g2p_corpora_prepare_reads_their_tree(tmp_path, argv, missing):
    """``prepare librispeech|common_voice`` are ported: they load the G2P
    model and then fail on the missing corpus tree, not as unported."""
    with pytest.raises(FileNotFoundError, match=missing):
        prepare.main(argv + ["--out", str(tmp_path / "o")] + CPU)


def test_only_the_auto_implementation(run, capsys):
    data, wd = run
    with pytest.raises(SystemExit) as e:
        train.main(["--data", data, "--workdir", wd, "--implementation", "xla", *CPU])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err

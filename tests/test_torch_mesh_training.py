"""The port's mesh ``Trainer`` and its multi-process entry points on the
CPU, mirroring ``tests/test_mesh_training.py`` and
``tests/test_multihost_sim.py``: a mesh trainer (data 2 × model 2, four
ranks over gloo) equals the plain trainer step for step and in its eval,
the multitask and binf trees shard as well, a resumed mesh trainer keeps
Adam's state, two processes feeding their own slices of the epoch plan
agree, and ``train --mesh``/``--multihost`` run through the command line."""

import dataclasses
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from phones_las_torch.cli import infer as infer_cli
from phones_las_torch.cli import prepare as prepare_cli
from phones_las_torch.cli import train as train_cli
from phones_las_torch.data.pipeline import DataSource, PipelineConfig
from phones_las_torch.data.synthetic import synth_grapheme_inventory, write_synth_corpus
from phones_las_torch.data.vocab import Vocab
from phones_las_torch.models.las import LASConfig
from phones_las_torch.models.listener import ListenerConfig
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import TrainConfig
from tests.torch_rank_child import REPO, finish_ranks, results, start_ranks
from tests.torch_threads import one_thread, subprocess_env

one_thread()

CPU = ["--device", "cpu"]
TINY = ["--encoder-layers", "2", "--encoder-units", "16", "--decoder-units", "16", "--embedding-dim", "8",
        "--attention-units", "16"]


def _tiny_cfg(vocab_size: int) -> LASConfig:
    return LASConfig(
        listener=ListenerConfig(input_dim=120, num_layers=2, units=16),
        speller=SpellerConfig(vocab_size=vocab_size, embedding_dim=8, num_layers=1, units=16, memory_dim=32,
                              attention_units=16, attention_layer_size=16),
    )


def _pipe(vocab, **kw) -> PipelineConfig:
    return PipelineConfig(batch_size=8, buckets=(24000,), max_target_len=12, eos_id=vocab.eos_id,
                          pad_id=vocab.pad_id, shuffle=False, drop_remainder=False, **kw)


def _job(name, cfg, tc, pipe, records, data, model, **kw) -> dict:
    return dict(mode="trainer", name=name, data=data, model=model, cfg=dataclasses.asdict(cfg),
                train=dataclasses.asdict(tc), pipe=dataclasses.asdict(pipe), records=records, **kw)


def _plain(cfg, tc, pipe, records, codes=None):
    """The plain trainer over the same batches → (train losses, eval)."""
    tr = Trainer(cfg, tc, device="cpu", binf_codes=codes)
    losses = []
    tr.fit(DataSource([records], pipe).repeat(), log_fn=lambda m: losses.append(m["loss"]))
    ev = tr.evaluate(DataSource([records], dataclasses.replace(pipe, shuffle=False, drop_remainder=False)).epoch(0))
    return losses, ev


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mesh trainer of this file, started at once as two worlds: four
    ranks (data 2 × model 2) train the tiny config 4 steps, then the
    multitask + binf-head config 2 steps; two ranks (data 2) restore a
    workdir, then feed their own slices of an epoch plan. The plain
    references run while the ranks do → {job name: (each rank's result,
    the plain reference)}."""
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    path, vocab = write_synth_corpus(str(tmp / "train.plu"), n_utts=16, n_phones=6)
    cfg = _tiny_cfg(len(vocab))  # vocab 10: every sharded axis divides model 2
    tc = TrainConfig(num_steps=4, log_every=1, eval_every=10**9, checkpoint_every=10**9)

    gpath, gphones = write_synth_corpus(str(tmp / "g.plu"), n_utts=16, n_phones=6, graphemes=True)
    gvocab = Vocab(synth_grapheme_inventory())
    codes = np.random.RandomState(0).randint(0, 2, (len(gphones), 6)).astype(np.float32)
    base = _tiny_cfg(len(gphones))
    mcfg = dataclasses.replace(
        base, speller=dataclasses.replace(base.speller, binf_mode="head", num_binf=6),
        grapheme_speller=dataclasses.replace(base.speller, vocab_size=len(gvocab)),
        multitask_weight=0.5, binf_weight=1.0,
    )
    mtc = dataclasses.replace(tc, num_steps=2)
    mpipe = _pipe(gphones, max_grapheme_len=24)

    rpath, rvocab = write_synth_corpus(str(tmp / "resume.plu"), n_utts=16, n_phones=5)
    rcfg, wd = _tiny_cfg(len(rvocab)), str(tmp / "wd")
    rtc = TrainConfig(num_steps=3, log_every=10**9, eval_every=10**9, checkpoint_every=1, keep_checkpoints=1)
    Trainer(rcfg, rtc, wd, device="cpu").fit(DataSource([rpath], _pipe(rvocab)).repeat(), log_fn=lambda m: None)

    hpath, hvocab = write_synth_corpus(str(tmp / "mh.plu"), n_utts=48, n_phones=5, n_phones_range=(3, 20))
    hpipe = PipelineConfig(batch_size=4, buckets=(24000, 48000), max_target_len=24, eos_id=hvocab.eos_id,
                           pad_id=hvocab.pad_id, shuffle=True)
    htc = TrainConfig(num_steps=3, log_every=1, eval_every=10**9, checkpoint_every=10**9)

    procs = {
        4: start_ranks([_job("plain", cfg, tc, _pipe(vocab), path, 2, 2),
                        _job("multi", mcfg, mtc, mpipe, gpath, 2, 2, binf_codes=codes.tolist())], 4, str(tmp), "w4"),
        2: start_ranks([_job("resume", rcfg, rtc, _pipe(rvocab), rpath, 2, 1, workdir=wd),
                        _job("multihost", _tiny_cfg(len(hvocab)), htc, hpipe, hpath, 2, 1, local_batches=True)],
                       2, str(tmp), "w2"),
    }
    refs = {"plain": _plain(cfg, tc, _pipe(vocab), path), "multi": _plain(mcfg, mtc, mpipe, gpath, codes)}
    outs = {w: finish_ranks(p) for w, p in procs.items()}
    names = {"plain": 4, "multi": 4, "resume": 2, "multihost": 2}
    return {n: (results(outs[w], n), refs.get(n)) for n, w in names.items()}


def test_mesh_trainer_matches_plain_trainer_and_multitask_binf(mesh_runs):
    """Four ranks (data 2 × model 2) against the plain trainer: the
    tiny config 4 steps and its eval, and the multitask + binf-head config
    2 steps (its grapheme speller and binf leaves shard too)."""
    ranks, (ref_losses, ref_eval) = mesh_runs["plain"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5, atol=1e-5)
        assert abs(r["eval"]["per"] - ref_eval["per"]) < 1e-9
        assert abs(r["eval"]["loss"] - ref_eval["loss"]) < 1e-4
        assert r["eval"]["ref_tokens"] == ref_eval["ref_tokens"]
    ranks, (m_losses, _) = mesh_runs["multi"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], m_losses, rtol=1e-5, atol=1e-5)


def test_mesh_trainer_resume_preserves_adam_state(mesh_runs):
    """A mesh trainer restores the whole state of a workdir and cuts it to
    its slices, Adam's moments included (not re-initialised)."""
    for r in mesh_runs["resume"][0]:
        assert r["start_step"] == 3 and r["nu_max"] > 0


def test_two_process_training(mesh_runs):
    """Two processes, each feeding its own slice of a mixed-bucket epoch
    plan (``DataSource(shard=)``, ``local_batches``): both report the same
    global losses and the same eval, summed over the processes."""
    res = mesh_runs["multihost"][0]
    assert len(res[0]["losses"]) == 3 and all(np.isfinite(res[0]["losses"]))
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["eval"] == res[1]["eval"] and res[0]["eval"]["ref_tokens"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("mesh_cli") / "d")
    prepare_cli.main(["synthetic", "--out", data, "--n-utts", "16", "--n-phones", "4", *CPU])
    return data


def test_multihost_cli_entry(data_dir, tmp_path):
    """``train --multihost`` through the command line in two processes
    that a launcher's environment joins (the torch launcher's variables,
    on a local port), sharing one workdir."""
    env = subprocess_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
                         PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "phones_las_torch.cli.train", "--preset", "timit_phone_las", "--data",
             data_dir, "--workdir", str(tmp_path / "w"), "--multihost", "--num-steps", "2", "--eval-every",
             "2", "--batch-size", "4", *TINY, *CPU],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=dict(env, RANK=str(r)), cwd=REPO, text=True,
        )
        for r in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"train --multihost failed:\n{out}\n{err[-3000:]}"
        outs.append(out)
    assert "'loss':" in outs[0] and "final eval" in outs[0]
    assert outs[1] == ""  # rank 1 trains silently
    assert sorted(os.listdir(tmp_path / "w" / "checkpoints")) == ["1", "2"]


def test_train_cli_mesh_flag(data_dir, tmp_path, capfd, monkeypatch):
    """``train --mesh`` starts its ranks itself (two on the CPU here); the
    mesh-trained checkpoint restores into the plain infer path, and
    ``infer --mesh`` splits each batch over two devices to the same lines."""
    for k, v in subprocess_env().items():  # the ranks' environment: one OpenMP thread
        monkeypatch.setenv(k, v)
    wd = str(tmp_path / "w")
    train_cli.main(["--preset", "timit_phone_las", "--data", data_dir, "--workdir", wd, "--num-steps", "2",
                    "--batch-size", "8", "--mesh", "--devices", "cpu,cpu", "--model-parallel", "2", *TINY, *CPU])
    out = capfd.readouterr().out
    assert "mesh=1x2" in out and "'tag': 'train'" in out and "final eval" in out
    assert not [n for n in os.listdir(wd) if n.startswith(".rendezvous")]
    test = os.path.join(data_dir, "test.plu")
    infer_cli.main(["--workdir", wd, "--data", test, "--batch-size", "8", *CPU])
    plain = capfd.readouterr().out
    infer_cli.main(["--workdir", wd, "--data", test, "--batch-size", "8", "--mesh", "--devices", "cpu,cpu", *CPU])
    assert capfd.readouterr().out == plain and re.search(r"PER=", plain)

"""The port's bench (``phones_las_torch.bench``) and its flagship config
against the reference's ``bench.py`` and ``__graft_entry__.py`` on the
CPU: the config field by field, the audio, the baseline's front-end and
the FLOP model exactly; the rows' forward (greedy, beam-8, joint CTC,
Luong) and training step on JAX's own tiny init carried across; the
accuracy row's PER on the eval set; the worker protocol in tiny mode,
and its rows erroring without a card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import bench as ref_bench
from __graft_entry__ import _flagship_cfg
from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.decode import greedy_decode as jax_greedy_decode
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.train.metrics import edit_distance_stats as jax_edit_distance_stats
from phones_las_tpu.train.state import TrainConfig as JaxTrainConfig
from phones_las_tpu.train.state import create_train_state as jax_create_train_state
from phones_las_tpu.train.state import make_optimizer
from phones_las_tpu.train.state import mask_grads as jax_mask_grads
from phones_las_tpu.utils.param_io import load_params_npz as jax_load_params_npz

from phones_las_torch import bench
from phones_las_torch.entry import flagship_cfg
from phones_las_torch.train.state import TrainConfig, create_train_state
from phones_las_torch.utils.param_io import copy_arrays_, named_leaves, params_from_numpy
from tests.torch_threads import one_thread, subprocess_env

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
STEPS = 10  # the tiny mode's decode steps
ADAM_FLAT = 1e-7  # a gradient element this small meets Adam's eps: its update is held to lr
ROW_FIELDS = {
    "parity": ("value_parity", "rtf_x_parity"),
    "production": ("value_production", "rtf_x_production"),
    "beam8_production": ("value_beam8_production",),
    "beam8_ctcjoint_production": ("value_beam8_ctcjoint_production",),
    "beam8_luong_production": ("value_beam8_luong_production",),
    "train_parity": ("value_train_step_ms_parity",),
    "train_production": ("value_train_step_ms_production",),
}


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _jax_cfg(tiny=True, ctc_joint=False, attention=None):
    """The reference row's configuration (``bench.py::bench_tpu_beam``)."""
    cfg = _flagship_cfg(tiny=tiny)
    if attention:
        cfg = dataclasses.replace(cfg, speller=dataclasses.replace(cfg.speller, attention_type=attention))
    if ctc_joint:
        cfg = dataclasses.replace(cfg, ctc_weight=0.3)
    return cfg


def _audio():
    audio = (np.random.RandomState(3).randn(2, 8000) * 2000).astype(np.float32)
    return audio, np.array([8000, 5600], np.int32)


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_cfg_equals_the_reference(tiny):
    assert dataclasses.asdict(flagship_cfg(tiny)) == dataclasses.asdict(_flagship_cfg(tiny))
    assert dataclasses.asdict(bench.row_cfg("parity", tiny=tiny)) == dataclasses.asdict(_flagship_cfg(tiny))


def test_audio_baseline_frontend_and_flop_model_equal_the_reference():
    """Exact equality: ``make_audio``, the baseline's numpy front-end and
    the analytic FLOP model (beam 1 and 8, the training step)."""
    assert (bench.SECONDS, bench.N_SAMPLES, bench.DECODE_STEPS, bench.VOCAB) == (
        ref_bench.SECONDS, ref_bench.N_SAMPLES, ref_bench.DECODE_STEPS, ref_bench.VOCAB)
    np.testing.assert_array_equal(bench.make_audio(3, seed=5), ref_bench.make_audio(3, seed=5))
    sig = bench.make_audio(1)[0, :24000]
    np.testing.assert_array_equal(bench._np_frontend(sig), ref_bench._np_frontend(sig))
    for k in (1, 8):
        assert bench.flagship_flops_per_utt(k) == ref_bench.flagship_flops_per_utt(k)
    assert bench.train_flops_per_utt() == ref_bench.train_flops_per_utt()
    assert bench.train_flops_per_utt(50) == ref_bench.train_flops_per_utt(50)
    # the MFU divides by the H100 SXM's dense bf16 peak, not the reference's TPU constant
    assert bench.mfu(1000.0) == 1000.0 * ref_bench.flagship_flops_per_utt()["total"] / 989e12


@pytest.mark.parametrize("beam,attention,ctc", [
    (0, None, False), (0, "luong", False),
    (8, None, False), (8, None, True), (8, "luong", False), (8, "luong", True),
])
def test_row_forward_equals_the_reference(beam, attention, ctc):
    """``make_infer`` on JAX's tiny init carried across: tokens and
    lengths equal to the reference row's composition (encode, then
    greedy_decode or beam_decode with the CTC head's log-softmax), parity."""
    jcfg = _jax_cfg(ctc_joint=ctc, attention=attention)
    jp = jax_init_las(jax.random.PRNGKey(0), jcfg)
    cfg = bench.row_cfg("parity", ctc_joint=ctc, attention=attention, tiny=True)
    params = params_from_numpy(_flat(jp), cfg, device="cpu")
    audio, lens = _audio()

    @jax.jit
    def infer(jp, audio, lens):
        with jax.default_matmul_precision("highest"):
            memory, _, enc_mask = jax_encode(jp, jcfg, audio, lens, implementation="xla")
            if not beam:
                return jax_greedy_decode(jp.speller, jcfg.speller, memory, enc_mask, max_steps=STEPS)[:2]
            ctc_logp = jax.nn.log_softmax(memory @ jp.ctc_w + jp.ctc_b, axis=-1) if ctc else None
            res = jax_beam_decode(jp.speller, jcfg.speller, memory, enc_mask, max_steps=STEPS, beam_width=beam,
                                  ctc_logp=ctc_logp)
        return res.tokens, res.lengths

    want = infer(jp, jnp.asarray(audio), jnp.asarray(lens))
    got = bench.make_infer(cfg, params, steps=STEPS, beam_width=beam, ctc_joint=ctc)(
        torch.from_numpy(audio), torch.from_numpy(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_train_step_equals_the_reference():
    """One tiny ``make_train_step`` step from the reference's
    ``create_train_state(PRNGKey(0))`` params (no dropout or sampling in
    the flagship config): the loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest magnitude, every leaf after the
    clipped Adam within 1e-5 of the reference's step. Where the
    reference's gradient is below 1e-7, Adam divides it by about its eps
    (1e-8): float32 rounding of such an element moves its first update
    by up to lr, so those elements are held to lr (1e-3), the most one
    step can move them (on this batch all are below 1.5e-10)."""
    jcfg, tcfg = _flagship_cfg(tiny=True), JaxTrainConfig()
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg, tcfg, None)
    tx = make_optimizer(tcfg)
    batch = bench.train_batch(2, steps=6, samples=8000)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        with jax.default_matmul_precision("highest"):
            return jax_compute_loss(p, jcfg, jbatch, train=True, rng=jax.random.PRNGKey(1), implementation="xla")

    (want_loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jstate.params)
    grads = jax_mask_grads(grads, jstate.params)
    updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
    want = _flat(optax.apply_updates(jstate.params, updates))
    want_grads = _flat(grads)

    cfg = bench.row_cfg("parity", tiny=True)
    state = create_train_state(cfg, TrainConfig(), device="cpu")
    with torch.no_grad():
        copy_arrays_(named_leaves(state.params), _flat(jstate.params))
    loss = bench.make_train_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert state.step == 1 and state.opt_state.count == 1
    for key, t in named_leaves(state.params):
        g = want_grads[key]
        if t.grad is not None:
            assert np.abs(t.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max(), key
        d = np.abs(t.detach().numpy() - want[key])
        flat = np.abs(g) < ADAM_FLAT
        assert d[~flat].max(initial=0.0) <= 1e-5 and d[flat].max(initial=0.0) <= TrainConfig().learning_rate, key


def test_accuracy_row_equals_the_reference():
    """``eval_set_per`` on the first 8 eval-set utterances: greedy and
    beam-8 PER equal to JAX's encode + greedy_decode / beam_decode +
    edit_distance_stats at the eval set's decode cap."""
    n = 8
    got = bench.eval_set_per(os.path.join(ASSETS, "ckpt.npz"), os.path.join(ASSETS, "eval_set.npz"), "cpu", n=n)
    jp, jcfg = jax_load_params_npz(os.path.join(ASSETS, "ckpt.npz"))
    with np.load(os.path.join(ASSETS, "eval_set.npz")) as d:
        audio, lens, refs, cap = d["audio"][:n], d["lengths"][:n], d["refs"][:n], int(d["decode_cap"][0])
    @jax.jit
    def run(jp, audio, lens):
        with jax.default_matmul_precision("highest"):
            memory, _, enc_mask = jax_encode(jp, jcfg, audio, lens, implementation="xla")
            g_tok, g_len, _ = jax_greedy_decode(jp.speller, jcfg.speller, memory, enc_mask, max_steps=cap)
            res = jax_beam_decode(jp.speller, jcfg.speller, memory, enc_mask, max_steps=cap, beam_width=8)
        return g_tok, g_len, res.tokens, res.lengths

    g_tok, g_len, b_tok, b_len = run(jp, jnp.asarray(audio, jnp.float32), jnp.asarray(lens))
    ref_lens, ref_ids = (refs >= 0).sum(1), np.where(refs >= 0, refs, 0)
    want = [
        (lambda e, t: e / max(t, 1))(*jax_edit_distance_stats(np.asarray(tok), np.asarray(tl), ref_ids, ref_lens))
        for tok, tl in ((g_tok, g_len), (b_tok, b_len))
    ]
    assert got == tuple(want)


def _run_bench(*args, **env):
    return subprocess.run([sys.executable, "-m", "phones_las_torch.bench", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=subprocess_env(PLU_BENCH_TINY="1", **env))


def test_forced_failure_prints_every_other_row():
    """The reference's self-test: a row forced to fail is reported in
    ``errors``, every other row is in the one JSON line, exit 0."""
    r = _run_bench("--device", "cpu", PLU_BENCH_FORCE_FAIL="beam8_parity", PLU_BENCH_ATTEMPTS="1")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    assert out["errors"] == ["beam8_parity: RuntimeError: forced failure (PLU_BENCH_FORCE_FAIL)"]
    assert "value_beam8_parity" not in out
    for row, keys in ROW_FIELDS.items():
        for key in keys:
            assert out[key] > 0, (row, key)
    assert out["value"] == out["value_parity"] and "fp32-parity" in out["unit"] and "card" in out["unit"]
    assert out["greedy_steps_run_parity"] == out["greedy_steps_run_production"] == STEPS
    assert out["cpu_baseline_utt_per_s"] > 0 and out["mfu_parity"] > 0
    assert {"card", "power_limit"} <= set(out) and "mfu_train_parity" not in out  # no train MFU in tiny mode
    assert set(out["launches"]) == set(bench.ROW_ORDER) - {"beam8_parity"}
    assert not any(out["launches"].values())  # the plain versions count no launch


def test_rows_error_without_a_card():
    """Without ``--device cpu`` and with no card, every row of the worker
    errors (the accuracy row too); none runs on the CPU."""
    assert not torch.cuda.is_available()
    r = _run_bench("--gpu-worker")
    assert r.returncode == 0, r.stderr[-3000:]
    errs = [json.loads(line[7:]) for line in r.stdout.splitlines() if line.startswith("ROWERR ")]
    assert [e["row"] for e in errs] == bench.ROW_ORDER
    assert all("no CUDA device" in e["error"] for e in errs)
    assert not [line for line in r.stdout.splitlines() if line.startswith("ROW ")]

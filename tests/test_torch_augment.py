"""The port's training augmentation on the CPU against the JAX reference:
SpecAugment's masks and output on the very uniforms JAX draws (split
from the same keys as the reference splits them), the frequency warp's
positions and output given α, the order in which ``encode`` applies both
on the state's one generator, and the long-gate configuration training
with its SpecAugment."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.frontend import freq_warp as jfw
from phones_las_tpu.frontend import specaugment as jsa

from phones_las_torch.frontend import freq_warp as fw
from phones_las_torch.frontend import specaugment as sa
from phones_las_torch.models import las as L
from phones_las_torch.models.listener import listen
from phones_las_torch.train.loop import Trainer
from phones_las_torch.train.state import TrainConfig
from phones_las_torch.utils.param_io import load_artifact
from tests.torch_threads import one_thread

one_thread()

GATE = os.path.join(os.path.dirname(__file__), "goldens", "long_gate.npz")
BINS = 40


def _jax_uniforms(key, b, m):
    """The (u_w, u_s) that the reference's ``_interval_masks`` draws from ``key``."""
    kw, ks = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (b, m)))) for k in (kw, ks))


def _feats(b, t, d, seed=0):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32) + 3.0


@pytest.mark.parametrize("seed", range(4))
def test_interval_masks_match_jax(seed):
    b, m, total = 6, 3, 70
    key = jax.random.PRNGKey(seed)
    span = np.array([70, 35, 9, 1, 0, 64], np.float32)
    widths = np.array([10, 50, 4, 3, 2, 80], np.float32)  # the last is clipped to its span
    want = np.asarray(jsa._interval_masks(key, m, jnp.asarray(widths), jnp.asarray(span), total, b))
    got = sa._interval_masks(_jax_uniforms(key, b, m), torch.from_numpy(widths), torch.from_numpy(span), total)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, n in enumerate(span.astype(int)):
        assert want[row, n:].all()  # cells at or past the span are never masked


SA_CONFIGS = {
    "default": jsa.SpecAugmentConfig(),
    "long_gate": jsa.SpecAugmentConfig(freq_masks=1, freq_mask_width=6, time_masks=1,
                                       time_mask_width=50, time_mask_ratio=0.1),
    "wide": jsa.SpecAugmentConfig(freq_masks=3, freq_mask_width=12, time_masks=4,
                                  time_mask_width=100, time_mask_ratio=0.5),
    "freq_only": jsa.SpecAugmentConfig(time_masks=0),
}


@pytest.mark.parametrize("name", sorted(SA_CONFIGS))
def test_apply_specaugment_matches_jax(name):
    jcfg = SA_CONFIGS[name]
    cfg = sa.SpecAugmentConfig(**dataclasses.asdict(jcfg))
    b, t = 5, 180
    x = _feats(b, t, 3 * BINS)
    lens = np.array([180, 120, 40, 7, 150], np.int32)
    for s in range(3):
        rng = jax.random.PRNGKey(100 + s)
        want = np.asarray(jsa.apply_specaugment(rng, jnp.asarray(x), jnp.asarray(lens), jcfg, BINS))
        k_f, k_t = jax.random.split(rng)
        got = sa.apply_specaugment(
            torch.from_numpy(x), torch.from_numpy(lens), cfg, BINS,
            freq_uniforms=_jax_uniforms(k_f, b, cfg.freq_masks),
            time_uniforms=_jax_uniforms(k_t, b, cfg.time_masks),
        )
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == 0).any() or name == "freq_only"


def test_specaugment_generator_draws_and_rules():
    cfg = sa.SpecAugmentConfig(freq_masks=1, freq_mask_width=6, time_masks=1, time_mask_width=50,
                               time_mask_ratio=0.1)
    x = torch.from_numpy(_feats(3, 100, 3 * BINS))
    lens = torch.tensor([100, 60, 30])
    g = torch.Generator().manual_seed(4)
    got = sa.apply_specaugment(x, lens, cfg, BINS, generator=g)
    g2 = torch.Generator().manual_seed(4)
    fu = sa.draw_uniforms(3, 1, g2)
    tu = sa.draw_uniforms(3, 1, g2)  # frequency draws first, then time
    want = sa.apply_specaugment(x, lens, cfg, BINS, freq_uniforms=fu, time_uniforms=tu)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        sa.apply_specaugment(x, lens, cfg, BINS)
    with pytest.raises(ValueError, match="multiple"):
        sa.apply_specaugment(x, lens, cfg, 7, generator=g)


@pytest.mark.parametrize("num_bins", [40, 13])
def test_warp_positions_match_jax(num_bins):
    alpha = np.array([0.8, 0.9, 0.97, 1.0, 1.03, 1.1, 1.25], np.float32)
    want = np.asarray(jfw.warp_positions(jnp.asarray(alpha), num_bins))
    got = fw.warp_positions(torch.from_numpy(alpha), num_bins).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3], np.arange(num_bins, dtype=np.float32))  # α = 1: identity


@pytest.mark.parametrize("max_warp", [0.1, 0.2])
def test_apply_freq_warp_matches_jax(max_warp):
    b, t = 4, 50
    x = _feats(b, t, 3 * BINS, seed=1)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jfw.apply_freq_warp(rng, jnp.asarray(x), max_warp, BINS))
    alpha = jax.random.uniform(rng, (b,), minval=1.0 - max_warp, maxval=1.0 + max_warp)
    got = fw.apply_freq_warp(torch.from_numpy(x), max_warp, BINS, alpha=torch.from_numpy(np.array(alpha)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    g = torch.Generator().manual_seed(1)
    a = fw.draw_alpha(10000, max_warp, g)
    assert float(a.min()) >= 1 - max_warp and float(a.max()) < 1 + max_warp and abs(float(a.mean()) - 1) < 0.01


def _gate():
    params, cfg, _ = load_artifact(GATE, device="cpu")
    return params, cfg


def _pcm(b, n, seed=0):
    return torch.from_numpy((np.random.RandomState(seed).randn(b, n) * 2000).astype(np.float32))


def test_encode_train_path_applies_warp_then_specaugment():
    """encode(train=True) with a generator equals the manual chain on a
    generator of the same seed: α, then the SpecAugment draws, then the
    listener's dropout masks; train=False, or no generator, leaves the
    features alone."""
    params, cfg = _gate()
    cfg = dataclasses.replace(cfg, freq_warp=0.1)
    audio, lens = _pcm(2, 16000), torch.tensor([16000, 11000], dtype=torch.int32)
    with torch.no_grad():
        mem, enc_lens, _ = L.encode(params, cfg, audio, lens, train=True, generator=torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(3)
        feats, flens = L.featurize(params, cfg, audio, lens)
        feats = fw.apply_freq_warp(feats, 0.1, BINS, generator=g)
        feats = sa.apply_specaugment(feats, flens, cfg.specaugment, BINS, generator=g)
        want, _ = listen(params.listener, cfg.listener, feats, flens, train=True, generator=g)
        torch.testing.assert_close(mem, want, rtol=0, atol=0)
        plain, _, _ = L.encode(params, cfg, audio, lens)
        no_dropout = dataclasses.replace(cfg, listener=dataclasses.replace(cfg.listener, dropout=0.0))
        no_gen, _, _ = L.encode(params, no_dropout, audio, lens, train=True)
        sa_off, _, _ = L.encode(params, dataclasses.replace(cfg, specaugment=None, freq_warp=0.0), audio, lens)
    torch.testing.assert_close(plain, sa_off, rtol=0, atol=0)
    torch.testing.assert_close(no_gen, plain, rtol=0, atol=0)
    assert not torch.allclose(mem, plain)
    mfcc = dataclasses.replace(cfg, cmvn=False, frontend=dataclasses.replace(cfg.frontend, feature_type="mfcc"))
    with pytest.raises(ValueError, match="feature_type='mfcc'"):
        L.encode(params, mfcc, audio, lens, train=True, generator=torch.Generator())


def test_long_gate_config_trains_with_specaugment():
    """The long-gate configuration (its SpecAugment, dropout 0.2,
    scheduled sampling 0.1, monotonic attention, CTC head) trains on the
    CPU: 4 steps of Trainer.train_step on one batch, losses finite and
    falling."""
    _, cfg = _gate()
    assert cfg.specaugment is not None and cfg.specaugment.time_mask_ratio == 0.1
    tr = Trainer(cfg, TrainConfig(learning_rate=3e-3, seed=1), device="cpu")
    rs = np.random.RandomState(2)
    n = 24000
    batch = {
        "audio": (rs.randn(3, n) * 2000).astype(np.float32),
        "audio_lengths": np.array([n, 20000, 16000], np.int32),
        "targets": np.concatenate([rs.randint(4, 26, (3, 9)), np.full((3, 1), 2)], axis=1).astype(np.int32),
        "target_lengths": np.full((3,), 10, np.int32),
    }
    losses = [float(tr.train_step(batch)["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert tr.state.step == 4

"""The port's front-end (plain PyTorch path, CPU) against the JAX
reference: ``extract_features`` and the Pallas ``extract_features_pallas``
in interpret mode, on the same seeded PCM with uneven lengths, and
against the float64 NumPy oracle of the reference's own tests."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from phones_las_tpu.frontend.cmvn import apply_cmvn as jax_apply_cmvn
from phones_las_tpu.frontend.features import FrontendConfig as JaxFrontendConfig
from phones_las_tpu.frontend.features import extract_features as jax_extract_features
from phones_las_tpu.frontend.features import num_frames as jax_num_frames
from phones_las_tpu.frontend.pallas_frontend import extract_features_pallas

from phones_las_torch.frontend import features as F
from phones_las_torch.frontend.cmvn import apply_cmvn
from phones_las_torch.frontend.fused_frontend import (
    extract_features_fused,
    fused_logmel,
    fused_logmel_plain,
)
from tests import oracle_features as oracle
from tests.torch_threads import one_thread

one_thread()

# float32 sums over 400-sample frames in another order than XLA's: the
# bound the reference's own Pallas-vs-XLA front-end test uses
TOL = 1e-4


def _batch(lens, pad_to, seed=0):
    batch = np.zeros((len(lens), pad_to), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = np.random.RandomState(seed + i).randn(n) * 2000
    return batch


def _cfgs(**kw):
    return JaxFrontendConfig(**kw), F.FrontendConfig(**kw)


@pytest.mark.parametrize("window", ["rect", "hamming"])
@pytest.mark.parametrize("feature_type", ["logmel", "mfcc"])
def test_features_match_jax(feature_type, window):
    """Each row against JAX's features and against the float64 NumPy oracle
    (``tests/oracle_features.py``), both within TOL.

    The MFCC lifter multiplies c11 by 12, and with it the float32 rounding
    of the log-mel below it: on an AMD EPYC host (AVX-512) XLA's c11 lies
    3.4e-4 from the float64 value where the port's lies 4.5e-5 from it. So
    the oracle is the reference everywhere, and JAX wherever it lies within
    half the bound of the exact value (at most 1 % of the elements do not)."""
    jcfg, tcfg = _cfgs(feature_type=feature_type, window=window)
    lens = [8000, 5000, 6789]
    x = _batch(lens, 8000)
    ref = np.asarray(jax_extract_features(jnp.asarray(x), jcfg, sample_lengths=jnp.asarray(lens)))
    sl = torch.tensor(lens)
    plain = F.extract_features(torch.from_numpy(x), tcfg, sample_lengths=sl).numpy()
    fused = extract_features_fused(torch.from_numpy(x), tcfg, sample_lengths=sl).numpy()
    assert plain.shape == fused.shape == ref.shape
    winfunc = np.hamming if window == "hamming" else None
    for i, n in enumerate(lens):
        fl = jax_num_frames(n, jcfg)
        exact = oracle.full_frontend(x[i, :n].astype(np.float64), feature_type, winfunc=winfunc)[:fl]
        close = np.abs(ref[i, :fl] - exact) <= (TOL + TOL * np.abs(exact)) / 2
        assert close.mean() >= 0.99, close.mean()
        for got in (plain[i, :fl], fused[i, :fl]):
            np.testing.assert_allclose(got, exact, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got[close], ref[i, :fl][close], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("feature_type", ["logmel", "mfcc"])
def test_fused_matches_pallas_interpret(feature_type):
    jcfg, tcfg = _cfgs(feature_type=feature_type)
    lens = [6000, 4321, 5000]
    x = _batch(lens, 6000, seed=3)
    ref = np.asarray(extract_features_pallas(
        jnp.asarray(x), jcfg, sample_lengths=jnp.asarray(lens), interpret=True
    ))
    got = extract_features_fused(torch.from_numpy(x), tcfg, sample_lengths=torch.tensor(lens)).numpy()
    assert got.shape == ref.shape
    for i, n in enumerate(lens):
        fl = jax_num_frames(n, jcfg)
        np.testing.assert_allclose(got[i, :fl], ref[i, :fl], rtol=TOL, atol=TOL)


def test_fused_logmel_cpu_runs_plain_version():
    cfg = F.FrontendConfig()
    x = torch.from_numpy(_batch([4000, 3000], 4000, seed=5))
    t = F.frames_for_samples(4000, cfg)
    lm, en = fused_logmel(x, cfg, t)
    plm, pen = fused_logmel_plain(x, cfg, t)
    assert lm.shape == (2, t, cfg.num_mel) and en.shape == (2, t)
    assert torch.equal(lm, plm) and torch.equal(en, pen)


def test_fused_logmel_rejects_other_devices():
    cfg = F.FrontendConfig()
    x = torch.zeros((1, 4000), device="meta")
    with pytest.raises(ValueError, match="CUDA or all on the CPU"):
        fused_logmel(x, cfg, F.frames_for_samples(4000, cfg))


def test_num_frames_and_cmvn_match_jax():
    jcfg, tcfg = _cfgs()
    for n in (1, 400, 401, 560, 16000, 26176):
        assert F.num_frames(n, tcfg) == jax_num_frames(n, jcfg)
    lens = np.array([1, 400, 401, 561, 16000])
    got = F.num_frames(torch.from_numpy(lens), tcfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_num_frames(jnp.asarray(lens), jcfg)))

    rs = np.random.RandomState(0)
    feats = rs.randn(2, 5, 6).astype(np.float32)
    mean, std = rs.randn(6).astype(np.float32), (rs.rand(6) + 0.5).astype(np.float32)
    ref = np.asarray(jax_apply_cmvn(jnp.asarray(feats), mean, std))
    got = apply_cmvn(torch.from_numpy(feats), torch.from_numpy(mean), torch.from_numpy(std)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

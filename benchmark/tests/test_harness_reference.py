"""The plain reference against the port's plain path at tiny widths, and
the counts against hand-worked values."""

import math

import numpy as np
import pytest
import torch

from benchmark import counts, program, reference, traffic, weights
from benchmark.tests.tiny import tiny_cell, tiny_config


def _inputs(cfg, seed=3):
    mix = tiny_cell().mix
    pool = traffic.make_pool(mix, seed, "cpu")
    utts = pool.calls[0]
    n = traffic.padded(max(len(u) for u in utts), 32000)
    pcm = torch.zeros((len(utts), n))
    for i, u in enumerate(utts):
        pcm[i, : len(u)] = torch.from_numpy(u.astype(np.float32))
    lens = torch.tensor([len(u) for u in utts])
    w = weights.make_weights(cfg, seed, "cpu")
    w[".cmvn_mean"], w[".cmvn_std"] = reference.feature_stats(pcm, lens, cfg["frontend"])
    return pcm, lens, w


def _port_params(cfg, w, numerics="parity"):
    from phones_las_torch.models.las import LASParams
    from phones_las_torch.utils.param_io import named_leaves

    pcfg = program.las_config(cfg, numerics)
    params = LASParams(pcfg, device="cpu")
    with torch.no_grad():
        for key, t in named_leaves(params):
            t.copy_(w[key])
    return pcfg, params


def _close(a, b, rel):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rel * scale, (float((a - b).abs().max()), scale)


def test_features_match_the_port():
    from phones_las_torch.frontend.features import extract_features

    cfg = tiny_config()
    pcm, lens, _ = _inputs(cfg)
    pcfg = program.las_config(cfg, "parity")
    ours, flens = reference.features(pcm, lens, cfg["frontend"])
    theirs = extract_features(pcm, pcfg.frontend, sample_lengths=lens)
    assert ours.shape == theirs.shape
    _close(ours, theirs, 1e-5)
    assert flens.tolist() == [reference.frame_count(int(n), 400, 160) for n in lens]


def test_listener_and_speller_match_the_port():
    from phones_las_torch.models.las import encode
    from phones_las_torch.models.speller import teacher_forced_decode

    cfg = tiny_config()
    pcm, lens, w = _inputs(cfg)
    pcfg, params = _port_params(cfg, w)
    with torch.no_grad():
        memory, enc_lens, enc_mask = encode(params, pcfg, pcm, lens)
        feats, flens = reference.features(pcm, lens, cfg["frontend"])
        feats = (feats - w[".cmvn_mean"]) / w[".cmvn_std"]
        ours, our_lens = reference.listen(feats, flens, w, 3, 1.0, reference.EXACT)
        assert our_lens.tolist() == enc_lens.tolist()
        _close(ours, memory, 1e-5)
        toks = torch.randint(4, 34, (len(lens), 9), generator=torch.Generator().manual_seed(0))
        inputs = torch.cat([torch.full_like(toks[:, :1], 1), toks[:, :-1]], dim=1)
        theirs, _, _ = teacher_forced_decode(params.speller, pcfg.speller, inputs, memory, enc_mask)
        mine = reference.speller_logits(memory, enc_lens, inputs, w, cfg["speller"], 1.0, reference.EXACT)
        _close(mine, theirs, 1e-5)
        whole = reference.forward(pcm, lens, toks, w, cfg)
        _close(whole, theirs, 1e-5)


def test_the_ports_greedy_tokens_have_no_gap():
    """Greedy tokens of the port's plain path are the reference's best at
    every position, within float32 rounding, and never a special."""
    from phones_las_torch.decode.greedy import greedy_decode
    from phones_las_torch.models.las import encode

    cfg = tiny_config()
    pcm, lens, w = _inputs(cfg, seed=5)
    pcfg, params = _port_params(cfg, w)
    with torch.no_grad():
        memory, _, enc_mask = encode(params, pcfg, pcm, lens)
        toks, out_lens, _ = greedy_decode(params.speller, pcfg.speller, memory, enc_mask, 15)
    assert out_lens.tolist() == [15] * len(lens)
    assert int(toks.min()) >= weights.SPECIALS
    logits = reference.forward(pcm, lens, toks.long(), w, cfg)
    gaps = reference.served_gaps(logits, toks, out_lens.tolist(), cfg["speller"]["eos_id"])
    assert float(gaps.max()) <= 1e-4
    # a row cut short ended on <eos>, whose bias keeps it far below the best
    cut = reference.served_gaps(logits, toks, [15, 15, 7, 15][: len(lens)], 2)
    assert float(cut.max()) > 100.0


@pytest.mark.parametrize("kind,bits", [("tf32", 10), ("bf16", 7)])
def test_rounding_keeps_the_mantissa_bits(kind, bits):
    x = torch.randn(1000) * 100
    r = reference.ROUNDERS[kind](x)
    rel = ((r - x).abs() / x.abs()).max()
    assert 2.0 ** -(bits + 2) < rel <= 2.0 ** -(bits + 1) * 1.0001


def test_fp8_rounding_is_coarse_with_its_scale():
    x = torch.randn(1000) * 1e-3
    r = reference.round_fp8(x)
    assert float(((r - x).abs() / x.abs().clamp_min(1e-5)).median()) < 2.0 ** -3
    assert float(((r - x).abs()).max()) > 0


def test_frames_and_layer_lengths():
    fe = tiny_config()["frontend"]
    assert counts.frames(160000, fe) == 999
    assert counts.frames(280000, fe) == 1749
    assert counts.frames(400, fe) == 1
    assert counts.layer_lengths(1749, 4) == [1749, 875, 438, 219]
    assert counts.layer_lengths(999, 3) == [999, 500, 250]


def test_listener_counts_by_hand():
    cfg = tiny_config(units=256)
    lis = counts.listener([160000], cfg)
    # 2 directions x (999 + 500 + 250) steps x (2·256·1024 + 4·256 + 10·256)
    assert lis["recurrence"]["flops"] == 2 * 1749 * (524288 + 1024 + 2560)
    # xp read (4U) and out written (U) a step, float32, and wh once a layer-direction
    assert lis["recurrence"]["bytes"] == 2 * (1749 * 4 * 1280) + 3 * 2 * 4 * 256 * 1024
    # projections: layer 1 from 120 features, layers 2-3 from 1024
    assert lis["projection"]["flops"] == 2 * (999 * (2 * 120 * 1024 + 1024) + 750 * (2 * 1024 * 1024 + 1024))


def test_decoder_counts_by_hand():
    cfg = tiny_config(units=256)
    cfg["speller"].update(embedding_dim=128, memory_dim=512, attention_units=256, attention_layer_size=256)
    dec = counts.decoder([160000], [200], cfg)
    step = (2 * (128 + 256 + 256) * 1024 + 14 * 256  # cell 1
            + 2 * 512 * 1024 + 14 * 256  # cell 2
            + 2 * 256 * 256  # query
            + 4 * 250 * 256 + 3 * 250  # scores, softmax
            + 2 * 250 * 512  # context
            + 2 * 768 * 256  # attention layer
            + 2 * 256 * 34 + 2 * 34)  # logits, argmax
    assert step == 3420978
    assert dec["steps"]["flops"] == 200 * step
    assert dec["keys"]["flops"] == 2 * 250 * 512 * 256


def test_frontend_counts_an_fft_and_the_mel_nonzeros():
    from phones_las_torch.frontend.features import FrontendConfig, mel_filterbank

    fe = tiny_config()["frontend"]
    nnz = int(np.count_nonzero(mel_filterbank(FrontendConfig())))
    got = counts.frontend([160000], fe)
    assert got["flops"] == 999 * (2.5 * 512 * 9 + 3 * 257 + 2 * nnz + 40)
    assert got["bytes"] == 4 * (160000 + 999 * 41)


def test_roofline_takes_the_larger_bound():
    w = {"flops": 67e12 * 0.002, "bytes": 3.35e12 * 0.001}
    assert math.isclose(counts.roofline_s(w, 67e12, 3.35e12), 0.002)
    assert math.isclose(counts.roofline_s(w, 989e12, 3.35e12), 0.001)

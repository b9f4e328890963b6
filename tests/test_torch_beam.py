"""The port's beam search (plain PyTorch, CPU) against the JAX reference:
an eager per-utterance oracle, width 1 against greedy, every field of
``BeamResult`` (all K beams) against JAX ``beam_decode`` on small models
(length penalty, ties with V ≤ K, monotonic attention, binf logits), and
beam-8 of the committed checkpoint on the committed eval set."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from phones_las_tpu.decode import beam_decode as jax_beam_decode
from phones_las_tpu.models.las import LASConfig as JaxLASConfig
from phones_las_tpu.models.las import encode as jax_encode
from phones_las_tpu.models.las import init_las
from phones_las_tpu.models.listener import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models.speller import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.utils.param_io import load_params_npz

from phones_las_torch.decode import beam_decode
from phones_las_torch.decode.beam import topk_stable
from phones_las_torch.decode.greedy import greedy_decode_steps
from phones_las_torch.models.las import encode
from phones_las_torch.models.speller import embed_tokens, init_speller_carry, speller_step
from phones_las_torch.ops.attention import precompute_keys
from phones_las_torch.utils.metrics import edit_distance_stats, per_from_stats
from phones_las_torch.utils.param_io import config_from_dict, load_artifact, params_from_numpy
from tests.torch_threads import one_thread

one_thread()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "phones_las_tpu", "assets", "bench")
CKPT = os.path.join(ASSETS, "ckpt.npz")
EVAL_BEAM8_PER = 0.0319  # the reference's beam-8 PER on the eval set
V, BOS, EOS, M = 8, 1, 2, 10


def _flat(params):
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _models(vocab=V, **speller_kw):
    """A tiny speller (the reference's decode-test shape) in JAX and the
    same weights in the port → (jax cfg, jax params, port cfg, port params)."""
    sp = dict(
        vocab_size=vocab, embedding_dim=6, num_layers=2, units=8, memory_dim=M,
        attention_type="bahdanau", attention_units=7, attention_layer_size=9,
        bos_id=BOS, eos_id=EOS,
    )
    sp.update(speller_kw)
    if sp["attention_type"].startswith("luong"):
        sp["attention_units"] = sp["units"]
    jcfg = JaxLASConfig(listener=JaxListenerConfig(input_dim=120, num_layers=1, units=M // 2),
                        speller=JaxSpellerConfig(**sp))
    codes = None
    if jcfg.speller.binf_mode != "none":
        codes = np.random.RandomState(9).randint(0, 2, (vocab, jcfg.speller.num_binf)).astype(np.float32)
    jp = init_las(jax.random.PRNGKey(0), jcfg, binf_codes=codes)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg.speller, jp.speller, tcfg.speller, params_from_numpy(_flat(jp), tcfg, device="cpu").speller


def _memory(b=2, t=5):
    mem = np.random.RandomState(0).randn(b, t, M).astype(np.float32)
    mask = np.array([[1] * t, [1, 1, 1] + [0] * (t - 3)][:b], np.float32)
    return mem, mask


def _assert_results_equal(got, ref, tol=1e-4):
    """Integer fields (tokens, lengths, finished flags, peaks) identical
    for every beam; scores and log-probs within ``tol`` (relative 1e-6
    for the −1e9-scale entries of impossible beams)."""
    for field in got._fields:
        g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert g.shape == r.shape, field
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=tol, err_msg=field)
        else:
            np.testing.assert_array_equal(g, r, err_msg=field)


def _oracle_beam(params, cfg, mem, mask, max_steps, k):
    """Per-utterance eager beam search mirroring beam_decode's semantics
    (the reference test's oracle, on the port's ``speller_step``)."""
    out_tokens, out_lens = [], []
    v = cfg.vocab_size
    for n in range(mem.shape[0]):
        mem_n, mask_n = mem[n : n + 1], mask[n : n + 1]
        keys = precompute_keys(params.attention, mem_n)
        beams = [{"carry": init_speller_carry(cfg, 1, mem.shape[1]), "toks": [], "logp": 0.0,
                  "fin": False, "len": 0, "prev": BOS}]
        beams += [dict(beams[0], logp=-1e9) for _ in range(k - 1)]
        for _ in range(max_steps):
            cands = []
            for bm in beams:
                if bm["fin"]:
                    step_lp = np.full(v, -1e9)
                    step_lp[EOS] = 0.0
                    new_carry = bm["carry"]
                else:
                    emb = embed_tokens(params, cfg, torch.tensor([bm["prev"]]))
                    new_carry, logits, _ = speller_step(params, cfg, bm["carry"], emb, keys, mem_n, mask_n)
                    step_lp = torch.log_softmax(logits[0], dim=-1).numpy()
                for c in range(v):
                    cands.append((bm["logp"] + step_lp[c], bm, c, new_carry))
            cands.sort(key=lambda x: -x[0])
            beams = [
                {"carry": carry, "toks": bm["toks"] + [c], "logp": lp, "fin": bm["fin"] or c == EOS,
                 "len": bm["len"] + (0 if (bm["fin"] or c == EOS) else 1), "prev": c}
                for lp, bm, c, carry in cands[:k]
            ]
        fin_beams = [bm for bm in beams if bm["fin"]] or beams
        best = max(fin_beams, key=lambda bm: bm["logp"])
        out_tokens.append(best["toks"])
        out_lens.append(best["len"])
    return out_tokens, out_lens


def test_beam_matches_eager_oracle_and_jax():
    jcfg, jp, cfg, params = _models()
    mem, mask = _memory()
    with torch.no_grad():
        res = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, beam_width=3)
        ref_toks, ref_lens = _oracle_beam(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 6, 3)
    for n in range(2):
        np.testing.assert_array_equal(res.tokens[n].numpy(), ref_toks[n])
    np.testing.assert_array_equal(res.lengths.numpy(), ref_lens)
    _assert_results_equal(res, jax_beam_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), 6, beam_width=3))


def test_beam_width1_equals_greedy():
    _, _, cfg, params = _models()
    mem, mask = (torch.from_numpy(x) for x in _memory())
    with torch.no_grad():
        g_toks, g_lens, g_aligns = greedy_decode_steps(params, cfg, mem, mask, 6, return_alignments=True)
        res = beam_decode(params, cfg, mem, mask, 6, beam_width=1)
    np.testing.assert_array_equal(res.tokens.numpy(), g_toks.numpy())
    np.testing.assert_array_equal(res.lengths.numpy(), g_lens.numpy())
    # the backtraced attention peaks are greedy's alignment argmax
    np.testing.assert_array_equal(res.peaks.numpy(), torch.argmax(g_aligns, dim=-1).numpy())


@pytest.mark.parametrize("speller_kw,k,steps,lp", [
    ({}, 4, 7, 0.6),  # length penalty
    ({"vocab": 5}, 8, 6, 0.0),  # V ≤ K: impossible candidates tie and fill beams
    ({"vocab": 6, "num_layers": 1}, 8, 5, 0.6),
    ({"attention_type": "bahdanau_monotonic"}, 3, 6, 0.0),
    ({"attention_type": "bahdanau_monotonic", "monotonic_mode": "hard", "monotonic_bias": 0.2}, 3, 6, 0.0),
    ({"attention_type": "luong_scaled"}, 3, 6, 0.0),
    ({"binf_mode": "logits", "num_binf": 4}, 3, 6, 0.0),
    ({"binf_mode": "embedding", "num_binf": 4}, 3, 6, 0.0),
])
def test_beam_all_beams_match_jax(speller_kw, k, steps, lp):
    jcfg, jp, cfg, params = _models(**speller_kw)
    mem, mask = _memory(b=2, t=6)
    with torch.no_grad():
        got = beam_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), steps,
                          beam_width=k, length_penalty=lp)
    ref = jax_beam_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), steps, beam_width=k, length_penalty=lp)
    _assert_results_equal(got, ref)


def test_topk_stable_ranks_ties_by_index():
    x = torch.tensor([[0.0, -1e9, 3.0, -1e9, 3.0, -1e9], [-1e9] * 6])
    vals, idx = topk_stable(x, 4)
    np.testing.assert_array_equal(idx.numpy(), [[2, 4, 0, 1], [0, 1, 2, 3]])
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def test_checkpoint_eval_set_beam8_matches_jax_xla():
    """Beam-8 of the committed checkpoint on all 64 eval utterances: every
    beam's tokens, lengths, finished flags and the best beam's peaks equal
    to JAX's XLA path, scores within 1e-4, PER 0.0319."""
    data = np.load(os.path.join(ASSETS, "eval_set.npz"), allow_pickle=False)
    cap = int(data["decode_cap"][0])
    jparams, jcfg = load_params_npz(CKPT)

    @jax.jit
    def run(p, audio, lengths):
        memory, _, mask = jax_encode(p, jcfg, audio, lengths, implementation="xla")
        return jax_beam_decode(p.speller, jcfg.speller, memory, mask, cap, beam_width=8)

    ref = run(jparams, data["audio"], data["lengths"])
    params, cfg, _ = load_artifact(CKPT, device="cpu")
    with torch.no_grad():
        mem, _, mask = encode(params, cfg, torch.from_numpy(data["audio"]), torch.from_numpy(data["lengths"]))
        got = beam_decode(params.speller, cfg.speller, mem, mask, cap, beam_width=8)
    assert got.beam_tokens.shape == (64, 8, cap)
    _assert_results_equal(got, ref)
    refs = data["refs"]
    per = per_from_stats(*edit_distance_stats(
        got.tokens.numpy(), got.lengths.numpy(), np.where(refs >= 0, refs, 0), (refs >= 0).sum(axis=1)
    ))
    assert round(per, 4) == EVAL_BEAM8_PER


@pytest.mark.parametrize("speller_kw", [
    {"attention_type": "bahdanau_monotonic"},
    {"attention_type": "luong_monotonic", "monotonic_mode": "hard"},
    {"binf_mode": "logits", "num_binf": 4},
    {"binf_mode": "embedding", "num_binf": 4},
])
def test_greedy_loop_for_configs_the_kernel_refuses(speller_kw):
    """Greedy decoding of the configurations the fused decoder does not
    take runs the ``speller_step`` loop, with JAX's tokens and alignments."""
    from phones_las_tpu.decode import greedy_decode as jax_greedy_decode

    from phones_las_torch.decode import greedy_decode
    from phones_las_torch.decode.fused_greedy import supports

    jcfg, jp, cfg, params = _models(**speller_kw)
    assert not supports(cfg)
    mem, mask = _memory(b=2, t=6)
    ref_tok, ref_len, ref_al = jax_greedy_decode(jp, jcfg, jnp.asarray(mem), jnp.asarray(mask), 7,
                                                 return_alignments=True)
    with torch.no_grad():
        tok, ln, al = greedy_decode(params, cfg, torch.from_numpy(mem), torch.from_numpy(mask), 7,
                                    return_alignments=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), rtol=1e-5, atol=1e-5)

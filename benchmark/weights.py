"""Seeded weights of a configuration, made on the device in two draws.

The leaves are named by the artifact's paths (``.listener.layers[l][d].wx``,
``.speller.cells[i].wh``, ...), which is how both the program's artifact
and the reference read them. Initialisation follows the model's own rules
(TF1 defaults): LSTM kernels glorot-uniform over the concatenated
[D + U, 4U] kernel, other matrices glorot-uniform, the attention's v
uniform in ±sqrt(3 / A), the embedding N(0, 1), biases zero. The output
bias of the four special tokens (<pad>, <sos>, <eos>, <unk>) is
``SPECIAL_BIAS``, so every row decodes its cap of tokens and each token
served is a character (what a trained model ends with is not what random
weights end with; see PERF.md §4). CMVN statistics are the features' own
(``reference.feature_stats``), set by the caller.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SPECIAL_BIAS = -1000.0
SPECIALS = 4


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, kind, scale) of every leaf, in a fixed order; kind is
    'uniform' (±scale), 'normal' (std scale), 'zeros' or 'out_b'."""
    li, sp = cfg["listener"], cfg["speller"]
    specs = []
    d, u = li["input_dim"], li["units"]
    for l in range(li["num_layers"]):
        lim = math.sqrt(6.0 / (d + u + 4 * u))
        for k in range(2):
            p = f".listener.layers[{l}][{k}]"
            specs += [(f"{p}.wx", (d, 4 * u), "uniform", lim), (f"{p}.wh", (u, 4 * u), "uniform", lim),
                      (f"{p}.b", (4 * u,), "zeros", 0.0)]
        d = 4 * u
    su, e, a, m, al, v = (sp[k] for k in ("units", "embedding_dim", "attention_units", "memory_dim",
                                          "attention_layer_size", "vocab_size"))
    glorot = lambda r, c: math.sqrt(6.0 / (r + c))
    specs.append((".speller.embedding", (v, e), "normal", 1.0))
    din = e + al
    for i in range(sp["num_layers"]):
        lim = math.sqrt(6.0 / (din + su + 4 * su))
        p = f".speller.cells[{i}]"
        specs += [(f"{p}.wx", (din, 4 * su), "uniform", lim), (f"{p}.wh", (su, 4 * su), "uniform", lim),
                  (f"{p}.b", (4 * su,), "zeros", 0.0)]
        din = su
    specs += [
        (".speller.attention.wq", (su, a), "uniform", glorot(su, a)),
        (".speller.attention.wk", (m, a), "uniform", glorot(m, a)),
        (".speller.attention.v", (a,), "uniform", math.sqrt(3.0 / a)),
        (".speller.attention_layer", (su + m, al), "uniform", glorot(su + m, al)),
        (".speller.out_w", (al, v), "uniform", glorot(al, v)),
        (".speller.out_b", (v,), "out_b", 0.0),
    ]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf but the CMVN statistics, float32 on ``device``, from
    ``seed``: one uniform draw for all uniform leaves and one normal draw
    for the embedding, on a generator of that device."""
    specs = leaf_specs(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    n_uni = sum(math.prod(s) for _, s, k, _ in specs if k == "uniform")
    flat = torch.rand(n_uni, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, ofs = {}, 0
    for path, shape, kind, scale in specs:
        if kind == "uniform":
            n = math.prod(shape)
            out[path] = flat[ofs: ofs + n].view(shape).mul_(scale)
            ofs += n
        elif kind == "normal":
            out[path] = torch.randn(shape, generator=g, device=device).mul_(scale)
        else:
            t = torch.zeros(shape, device=device)
            if kind == "out_b":
                t[:SPECIALS] = SPECIAL_BIAS
            out[path] = t
    return out

"""The one traffic generator: a mix's file of parameters → the calls of a run.

A mix (``traffic/<name>.json``) gives the utterances a call carries
(``batch``), their lengths (``lengths``: ``fixed`` samples, or
``lognormal`` seconds with a mean, the σ of the log, a clip and a
``law_seed`` of its own), how many distinct calls a run cycles through
(``pool_calls``), the sound (``audio``) and the rate of speech
(``speech_rate``: characters, spaces counted, over seconds of a public
corpus), which sets the decode cap (``cap``). The lengths and which
utterances share a call come from the mix's ``law_seed`` alone, so every
run seed gives the same calls, and so the same work; the run's seed
orders the calls and the rows in them and draws the sound. The sound is
int16 PCM: noise whose level and spectral tilt change every
``segment_ms`` (log-normal level, a one-tap filter of random sign),
drawn on the device in one pass and fetched once.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


class Pool(NamedTuple):
    calls: List[List[np.ndarray]]  # each call's utterances, int16
    lengths: List[List[int]]  # samples of each


def call_lengths(mix: dict) -> List[List[int]]:
    """The samples of each utterance of each distinct call, in the law's
    own order (the same for every run seed)."""
    law, rate = mix["lengths"], mix["sample_rate"]
    n, b = mix["pool_calls"], mix["batch"]
    if law["law"] == "fixed":
        return [[int(law["samples"])] * b for _ in range(n)]
    if law["law"] == "lognormal":
        rs = np.random.RandomState(law["law_seed"])
        mu = math.log(law["mean_s"]) - law["sigma_log"] ** 2 / 2.0
        secs = np.clip(rs.lognormal(mu, law["sigma_log"], size=(n, b)), law["min_s"], law["max_s"])
        return [[int(round(s * rate)) for s in row] for row in secs]
    raise ValueError(f"unknown length law {law['law']!r}")


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def make_pool(mix: dict, seed: int, device) -> Pool:
    """The run's calls: ``call_lengths`` reordered by ``seed`` (calls and
    rows), each utterance's sound drawn from ``seed`` on ``device``."""
    order = np.random.RandomState(_seed(seed) % (1 << 32))
    lengths = [list(order.permutation(row)) for row in call_lengths(mix)]
    lengths = [lengths[i] for i in order.permutation(len(lengths))]
    lengths = [[int(x) for x in row] for row in lengths]
    total = sum(sum(row) for row in lengths)
    a = mix["audio"]
    seg = max(1, int(a["segment_ms"] * mix["sample_rate"] / 1000))
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed) ^ 0x5EED)
    nseg = -(-total // seg)
    level = torch.exp(a["level_sigma"] * torch.randn(nseg, generator=g, device=device)) * a["rms"]
    tilt = a["tilt"] * (2.0 * torch.rand(nseg, generator=g, device=device) - 1.0)
    noise = torch.randn(total + 1, generator=g, device=device)
    x = noise[1:] + tilt.repeat_interleave(seg)[:total] * noise[:-1]
    x = x * level.repeat_interleave(seg)[:total]
    pcm = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16).cpu().numpy()
    calls, ofs = [], 0
    for row in lengths:
        utts = []
        for n in row:
            utts.append(pcm[ofs: ofs + n])
            ofs += n
        calls.append(utts)
    return Pool(calls, lengths)


def cap(mix: dict) -> int:
    """The steps a call decodes: the characters the mix's rate of speech
    gives its longest utterance, rounded up (the artifact's
    ``max_target_len``)."""
    r = mix["speech_rate"]
    longest = max(max(row) for row in call_lengths(mix)) / mix["sample_rate"]
    return int(math.ceil(round(r["characters"] * longest / r["seconds"], 6)))


def padded(samples: int, quantum: int) -> int:
    """The length ``transcribe_batch`` pads a call to."""
    return -(-samples // quantum) * quantum

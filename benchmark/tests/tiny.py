"""A cell at a size a CPU test holds: a cell's files with tiny widths and
a short mix, for driving the harness on the port's plain path."""

import json
import os

from benchmark import run as R
from benchmark import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def tiny_config(units=16):
    cfg = load("benchmark/configs/las-3x256-char.json")
    cfg["listener"] = {"input_dim": 120, "num_layers": 3, "units": units}
    cfg["speller"].update(embedding_dim=8, units=units, memory_dim=2 * units, attention_units=units,
                          attention_layer_size=units)
    return cfg


def tiny_cell(mix_name="greedy-b32-17s.parity", limit=1e-3, cap=12, batch=4, check_rows=3, lognormal=True):
    """The metrics are those of the cell that runs ``mix_name``.
    ``lognormal``: lengths of 0.3-2.5 s, each call padded to its longest;
    else every utterance 1 s. The rate of speech is set so that the cap
    comes out as ``cap``."""
    mix = load(f"benchmark/traffic/{mix_name}.json")
    mix.update(batch=batch, pool_calls=3, check_rows=check_rows, cmvn_utterances=2)
    if lognormal:
        mix["lengths"] = {"law": "lognormal", "mean_s": 0.8, "sigma_log": 0.6, "min_s": 0.3, "max_s": 2.5,
                          "law_seed": 2620}
    else:
        mix["lengths"] = {"law": "fixed", "samples": 16000}
    longest = max(max(r) for r in traffic.call_lengths(mix)) / mix["sample_rate"]
    mix["speech_rate"] = {"characters": cap, "seconds": longest}
    assert traffic.cap(mix) == cap
    like = R.load_cell(next(w["name"] for w in load("BENCHMARK.json")["workloads"] if w["traffic"] == mix_name))
    return R.Cell("tiny", tiny_config(), mix, 1, {"logit_gap": limit}, like.end_to_end, like.per_layer)

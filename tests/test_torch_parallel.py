"""The port's ('data', 'model') mesh on the CPU: its sharding rules against
the JAX package's, and the sharded training step, run as 2 and 4 ranks
over gloo (``tests/torch_rank_child.py``, a ``file://`` rendezvous under
the test's directory), held to the port's unsharded step and to JAX's
sharded step on its faked 8-device mesh, from the same numpy weights and
the uneven batch of ``tests/test_parallel.py``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from phones_las_tpu.models import LASConfig as JaxLASConfig
from phones_las_tpu.models import ListenerConfig as JaxListenerConfig
from phones_las_tpu.models import SpellerConfig as JaxSpellerConfig
from phones_las_tpu.models.las import compute_loss as jax_compute_loss
from phones_las_tpu.models.las import init_las as jax_init_las
from phones_las_tpu.parallel import make_mesh as jax_make_mesh
from phones_las_tpu.parallel import param_sharding_rules as jax_rules
from phones_las_tpu.parallel import shard_batch as jax_shard_batch
from phones_las_tpu.parallel import shard_params as jax_shard_params
from phones_las_tpu.utils.param_io import load_artifact as jax_load_artifact

from phones_las_torch.models.las import LASConfig, compute_loss, init_las
from phones_las_torch.models.listener import ListenerConfig
from phones_las_torch.models.speller import SpellerConfig
from phones_las_torch.parallel import initialize_distributed, make_mesh, param_sharding_rules
from phones_las_torch.parallel.mesh import Mesh, local_rows, pick_devices, sharded_dims
from phones_las_torch.train.loop import Trainer, data_rank_seed
from phones_las_torch.train.state import TrainConfig
from phones_las_torch.utils.param_io import named_leaves, save_params_npz
from tests.test_parallel import _uneven_batch
from tests.torch_rank_child import finish_ranks, results, start_ranks
from tests.torch_threads import one_thread

one_thread()

LAYOUTS = [(2, 1), (2, 2)]
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5  # each leaf's max |d| over its max |g|, as tests/test_parallel.py
PARAM_TOL = 1e-6  # the leaves after one Adam step (lr 1e-3)


def _cfg(vocab: int, **speller) -> LASConfig:
    """2 × 16 BiLSTM, 1 × 16 speller: ``tests/test_parallel.py::_cfg``."""
    return LASConfig(
        listener=ListenerConfig(input_dim=120, num_layers=2, units=16),
        speller=SpellerConfig(vocab_size=vocab, embedding_dim=8, num_layers=1, units=16, memory_dim=32,
                              attention_units=16, attention_layer_size=16, **speller),
    )


def _jax_cfg(cfg: LASConfig) -> JaxLASConfig:
    return JaxLASConfig(
        listener=JaxListenerConfig(**dataclasses.asdict(cfg.listener)),
        speller=JaxSpellerConfig(**dataclasses.asdict(cfg.speller)),
        ctc_weight=cfg.ctc_weight,
    )


def _batch(vocab: int) -> dict:
    """``tests/test_parallel.py``'s uneven batch (vocab 12), its target
    ids kept below ``vocab``: audio and target lengths differ across shards."""
    b = _uneven_batch()
    b["targets"] = np.where(b["targets"] >= vocab, vocab - 1, b["targets"]).astype(np.int32)
    return b


def _unsharded(cfg, params, batch):
    """The port's unsharded step → (loss, {path: gradient}, {path: leaf after one update})."""
    tr = Trainer(cfg, TrainConfig(), device="cpu")
    tr.warm_start(params)
    loss, _ = tr.loss(batch, train=False)
    loss.backward()
    grads = {k: g.numpy() for k, g in tr.gradients().items()}
    tr.apply_gradients()
    return float(loss.detach()), grads, {k: t.detach().numpy().copy() for k, t in named_leaves(tr.state.params)}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-8)


def _dropout_cfg() -> LASConfig:
    """``_cfg(12)`` with listener dropout and scheduled sampling on."""
    cfg = _cfg(12, sampling_probability=0.3)
    return dataclasses.replace(cfg, listener=dataclasses.replace(cfg.listener, dropout=0.3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each layout's sharded step (vocab 12), 2 × 2 over vocab 13, and the
    draws of 2 × 2 with dropout on: the 2 × 2 jobs one after another in one
    world of four ranks, beside the 2 × 1 job's world of two
    → {(data, model, vocab): (cfg, params, artifact, rank 0's npz), "draws": (cfg, params, each rank's result)}."""
    tmp = str(tmp_path_factory.mktemp("mesh_step"))
    made, worlds = {}, {2: [], 4: []}
    for data, model, vocab in [(2, 1, 12), (2, 2, 12), (2, 2, 13)]:
        name = f"d{data}m{model}v{vocab}"
        cfg = _cfg(vocab)
        params = init_las(cfg, seed=3, device="cpu")
        art, bat, out = (os.path.join(tmp, name + ext) for ext in (".npz", "_batch.npz", "_out.npz"))
        save_params_npz(art, params, cfg)
        np.savez(bat, **_batch(vocab))
        worlds[data * model].append(dict(mode="step", name=name, data=data, model=model, artifact=art, batch=bat,
                                         out=out))
        made[(data, model, vocab)] = (cfg, params, art, out)
    art12, bat12 = worlds[4][0]["artifact"], worlds[4][0]["batch"]
    worlds[4].append(dict(mode="draws", name="draws", data=2, model=2, artifact=art12, batch=bat12, steps=2,
                          cfg=dataclasses.asdict(_dropout_cfg())))
    started = {w: start_ranks(jobs, w, tmp, f"world{w}") for w, jobs in worlds.items()}
    outs = {w: finish_ranks(procs) for w, procs in started.items()}
    res = {}
    for key, (cfg, params, art, out) in made.items():
        with np.load(out) as z:
            res[key] = (cfg, params, art, {k: z[k] for k in z.files})
    res["draws"] = (_dropout_cfg(), made[(2, 2, 12)][1], results(outs[4], "draws"))
    return res


@pytest.mark.parametrize("data,model", LAYOUTS)
def test_sharded_step_matches_unsharded(runs, data, model):
    """Loss, every gradient leaf and every leaf after one Adam update of
    the sharded step equal the unsharded step's, uneven shards and all."""
    cfg, params, _, got = runs[(data, model, 12)]
    loss, grads, updated = _unsharded(cfg, params, _batch(12))
    assert abs(float(got["loss"]) - loss) < LOSS_TOL * abs(loss)
    worst = max(_rel(g, got["grad" + k]) for k, g in grads.items())
    assert worst < GRAD_TOL, f"max relative grad deviation {worst}"
    for k, t in updated.items():
        np.testing.assert_allclose(got["param" + k], t, atol=PARAM_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("data,model", LAYOUTS)
def test_sharded_step_matches_jax_sharded(runs, data, model):
    """The port's sharded step against JAX's GSPMD step on the same mesh
    shape (faked CPU devices), from the same weights and batch."""
    cfg, _, art, got = runs[(data, model, 12)]
    jparams, jcfg, _ = jax_load_artifact(art)
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    step = jax.jit(jax.value_and_grad(lambda p, b: jax_compute_loss(p, jcfg, b, train=False)[0]))
    jloss, jgrads = step(jax_shard_params(jparams, mesh), jax_shard_batch(_batch(12), mesh))
    assert abs(float(got["loss"]) - float(jloss)) < LOSS_TOL * abs(float(jloss))
    flat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    trainable = {k for k in flat if k not in (".cmvn_mean", ".cmvn_std")}
    worst = max(_rel(flat[k], got["grad" + k]) for k in trainable)
    assert worst < GRAD_TOL, f"max relative grad deviation from JAX {worst}"


def test_sharded_loss_is_the_global_token_mean(runs):
    """The shards hold different token counts, so a mean of the per-rank
    means (what a plain data-parallel average gives) misses the global
    loss; the sharded loss divides by the global count and equals it."""
    cfg, params, _, got = runs[(2, 1, 12)]
    batch = _batch(12)
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()} for i in range(2)]
    counts = [int(h["target_lengths"].sum()) for h in halves]
    assert counts[0] != counts[1]
    whole = _unsharded(cfg, params, batch)[0]
    mean_of_means = float(np.mean([_unsharded(cfg, params, h)[0] for h in halves]))
    assert abs(mean_of_means - whole) > 10 * LOSS_TOL * whole
    assert abs(float(got["loss"]) - whole) < LOSS_TOL * whole


def test_odd_vocab_replicated_and_step_matches(runs):
    """Vocab 13 over model 2: the output head is replicated, not refused
    (``_compatible_spec``), and the sharded step still equals the unsharded."""
    cfg, params, _, got = runs[(2, 2, 13)]
    dims = sharded_dims(params, Mesh(2, 2, ["cpu"]))
    assert dims[".speller.out_w"] is None and dims[".speller.out_b"] is None
    assert dims[".speller.cells[0].wx"] == 1 and dims[".speller.attention.wk"] == 1
    loss, grads, updated = _unsharded(cfg, params, _batch(13))
    assert abs(float(got["loss"]) - loss) < LOSS_TOL * abs(loss)
    assert max(_rel(g, got["grad" + k]) for k, g in grads.items()) < GRAD_TOL
    for k, t in updated.items():
        np.testing.assert_allclose(got["param" + k], t, atol=PARAM_TOL, rtol=0, err_msg=k)


def test_data_ranks_draw_their_own_bits(runs):
    """Dropout and scheduled sampling on, data 2 × model 2, two steps: the
    ranks of a data row draw alike, the two data rows differently and anew
    each step, the forks live on the rank's device, the state's generator
    is the same on every rank, and the first step's global loss equals
    the sum of the plain losses of each data rank's rows, each drawn from
    that rank's seed and divided by the global token count."""
    cfg, params, ranks = runs["draws"]
    assert {r["fork_device"] for r in ranks} == {"cpu"}
    row0, row1 = ranks[0]["draws"], ranks[2]["draws"]
    assert ranks[1]["draws"] == row0 and ranks[3]["draws"] == row1
    assert row0[0] != row1[0] and row0[1] != row1[1] and row0[0] != row0[1]
    assert len({r["generator"] for r in ranks}) == 1
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)

    batch = _batch(12)
    total = torch.tensor(float(np.minimum(batch["target_lengths"], batch["targets"].shape[1]).sum()))
    tr = Trainer(cfg, TrainConfig(), device="cpu")
    tr.warm_start(params)
    ref = 0.0
    for d in range(2):
        rows = tr.device_batch({k: v[d * 4:(d + 1) * 4] for k, v in batch.items()})
        gen = torch.Generator().manual_seed(data_rank_seed(tr.state.generator, 0, d))
        loss, _ = compute_loss(tr.state.params, cfg, rows, train=True, generator=gen, prec=tr.prec,
                               global_count=lambda c: total)
        ref += float(loss.detach())
    assert abs(ranks[0]["losses"][0] - ref) < LOSS_TOL * abs(ref)


@pytest.mark.parametrize("speller", [{}, {"binf_mode": "head", "num_binf": 6}], ids=["plain", "binf_head"])
def test_sharding_rules_match_jax(speller):
    """Every leaf's sharded dimension is the one JAX's PartitionSpec names
    'model' on (the embedding, scalars, codes and CMVN replicated)."""
    cfg = dataclasses.replace(_cfg(12, **speller), ctc_weight=0.3)
    codes = np.random.RandomState(0).randint(0, 2, (12, 6)).astype(np.float32) if speller else None
    ours = param_sharding_rules(init_las(cfg, device="cpu", binf_codes=codes))
    jcfg = dataclasses.replace(_jax_cfg(cfg), speller=JaxSpellerConfig(**dataclasses.asdict(cfg.speller)))
    jparams = jax_init_las(jax.random.PRNGKey(0), jcfg, binf_codes=codes)
    specs = jax.tree_util.tree_flatten_with_path(jax_rules(jparams), is_leaf=lambda x: x is None or
                                                 type(x).__name__ == "PartitionSpec")[0]
    theirs = {}
    for path, spec in specs:
        if spec is not None:
            theirs[jax.tree_util.keystr(path)] = next((i for i, a in enumerate(spec) if a == "model"), None)
    assert ours == theirs


def test_local_rows_and_batch_sharding():
    """Contiguous rows a data rank, ``num_real`` cut to them; under
    ``local_batches`` the process's batch is its rows as it is."""
    batch = {"audio": np.arange(8 * 3).reshape(8, 3), "audio_lengths": np.arange(8),
             "targets": np.zeros((8, 2), np.int32), "target_lengths": np.ones(8, np.int32),
             "utt_ids": [str(i) for i in range(8)], "num_real": 5}
    mesh = Mesh(2, 1, ["cpu", "cpu"])
    mesh.rank = 1  # the second data rank's view
    rows = local_rows(batch, mesh)
    assert rows["audio_lengths"].tolist() == [4, 5, 6, 7] and rows["num_real"] == 1
    assert rows["utt_ids"] == batch["utt_ids"]  # not a per-row key of the device batch
    dev = Trainer(_cfg(12), TrainConfig(), device="cpu", mesh=mesh)._device_batch(batch)
    assert sorted(dev) == ["audio", "audio_lengths", "target_lengths", "targets"]
    assert dev["audio"].shape == (4, 3) and dev["audio"].device.type == "cpu"
    local = Mesh(2, 1, ["cpu", "cpu"], local_batches=True)
    assert Trainer(_cfg(12), TrainConfig(), device="cpu", mesh=local)._device_batch(batch)["audio"].shape == (8, 3)
    with pytest.raises(ValueError, match="split evenly"):
        local_rows({**batch, "audio": batch["audio"][:7]}, mesh)


def test_devices_and_distributed_setup(monkeypatch):
    """``pick_devices`` names the count it cannot meet and keeps repeats;
    with nothing configured ``initialize_distributed`` is the no-op and
    the mesh is 1 × 1; a half-configured launcher raises."""
    assert pick_devices(3, ["cpu"] * 3) == [torch.device("cpu")] * 3
    assert pick_devices(0, ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="2 devices asked for, but only 1 cpu"):
        pick_devices(2, device="cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    mesh = make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(2, 1, ["cpu", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="address, a world size and a rank"):
        initialize_distributed()

"""One rank of the port's mesh, for the multi-process tests (the port's
counterpart of ``multihost_child.py``).

    python tests/torch_rank_child.py RUN.json RANK

The run file holds the world size, a ``file://`` rendezvous under the
test's temporary directory and a list of jobs, each with its mode, name
and mesh shape (data × model = the world). Each rank joins a gloo process
group on the CPU with one torch thread and runs the jobs in order, each
on a mesh of its own, so that one start of the processes serves several
tests:

  * ``step``: loads an artifact (``save_params_npz``) and a batch (npz),
    runs one sharded step (``Trainer.loss(train=False)``, backward,
    ``gradients``, one Adam update) and rank 0 writes the global loss,
    every whole gradient leaf and every updated leaf (gathered) to
    ``out``;
  * ``draws``: the same artifact and batch with dropout and scheduled
    sampling on: before each of ``steps`` training steps the first values
    of the step's generator and the global loss, then a hash of the
    state's generator;
  * ``trainer``: a mesh ``Trainer`` (global batches from one
    ``DataSource``, or under ``local_batches`` each data rank's shard of
    it) trains ``steps`` steps, optionally from a workdir, then evaluates.

``draws`` and ``trainer`` print one ``RESULT name {json}`` line a rank.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(jobs: list, world: int, tmp: str, name: str) -> list:
    """Write the run of ``jobs`` over ``world`` ranks (with a fresh
    ``file://`` rendezvous under ``tmp``) and start one process a rank
    → the processes."""
    from tests.torch_threads import subprocess_env

    assert all(j["data"] * j["model"] == world for j in jobs)
    run = dict(jobs=jobs, world=world, repo=REPO, init=f"file://{os.path.join(tmp, name + '.rendezvous')}")
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(run, f)
    return [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=subprocess_env())
        for r in range(world)
    ]


def finish_ranks(procs: list, timeout: float = 240) -> list:
    """Wait for every rank (each must exit 0) → their standard outputs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"a rank failed:\n{out}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def results(outs: list, name: str) -> list:
    """Each rank's ``RESULT`` of job ``name``."""
    tag = f"RESULT {name} "
    return [json.loads(next(l for l in out.splitlines() if l.startswith(tag))[len(tag):]) for out in outs]


def main():
    run = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    sys.path.insert(0, run["repo"])

    import torch

    torch.set_num_threads(1)

    from phones_las_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(run["init"], run["world"], rank, backend="gloo")
    for job in run["jobs"]:
        mesh = make_mesh(job["data"], job["model"], ["cpu"] * run["world"],
                         local_batches=job.get("local_batches", False))
        {"step": run_step, "draws": run_draws, "trainer": run_trainer}[job["mode"]](job, mesh)


def _say(job, res) -> None:
    print("RESULT", job["name"], json.dumps(res), flush=True)


def run_step(job, mesh):
    import torch

    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import load_artifact, named_leaves

    params, cfg, _ = load_artifact(job["artifact"], device="cpu")
    with np.load(job["batch"]) as z:
        batch = {k: z[k] for k in z.files}
    tr = Trainer(cfg, TrainConfig(), device="cpu", mesh=mesh)
    tr.warm_start(params)
    loss, _ = tr.loss(batch, train=False)
    loss.backward()
    grads = tr.gradients()
    total = mesh.sum_data(loss.detach().clone())
    out = tr.apply_gradients(grads)
    whole = tr.whole_state()
    if mesh.rank == 0:
        arrays = {"loss": total.numpy(), "grad_norm": out["grad_norm"].numpy()}
        arrays.update({"grad" + k: g.numpy() for k, g in grads.items()})
        arrays.update({"param" + k: t.detach().numpy() for k, t in named_leaves(whole.params)})
        arrays.update({"nu" + k: v.numpy() for (k, _), v in zip(named_leaves(whole.params), whole.opt_state.nu)})
        np.savez(job["out"], **arrays)


def run_draws(job, mesh):
    import torch

    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import config_from_dict, load_artifact

    params, _, _ = load_artifact(job["artifact"], device="cpu")
    cfg = config_from_dict(job["cfg"])
    with np.load(job["batch"]) as z:
        batch = {k: z[k] for k in z.files}
    tr = Trainer(cfg, TrainConfig(), device="cpu", mesh=mesh)
    tr.warm_start(params)
    res = {"draws": [], "losses": [], "fork_device": str(tr._step_generator().device)}
    for _ in range(job["steps"]):
        res["draws"].append(torch.rand(4, generator=tr._step_generator()).tolist())
        res["losses"].append(float(tr.train_step(batch)["loss"]))
    res["generator"] = hashlib.sha1(tr.state.generator.get_state().numpy().tobytes()).hexdigest()
    _say(job, res)


def run_trainer(job, mesh):
    import dataclasses

    from phones_las_torch.data.pipeline import DataSource, PipelineConfig
    from phones_las_torch.train.loop import Trainer
    from phones_las_torch.train.state import TrainConfig
    from phones_las_torch.utils.param_io import config_from_dict

    cfg = config_from_dict(job["cfg"])
    tc = TrainConfig(**job["train"])
    pipe = PipelineConfig(**{**job["pipe"], "buckets": tuple(job["pipe"]["buckets"])})
    shard = (mesh.data_index, mesh.data) if mesh.local_batches else None
    codes = None if job.get("binf_codes") is None else np.asarray(job["binf_codes"], np.float32)
    tr = Trainer(cfg, tc, job.get("workdir"), device="cpu", mesh=mesh, binf_codes=codes)
    res = {"start_step": tr.state.step, "nu_max": max(float(v.abs().max()) for v in tr.state.opt_state.nu)}
    losses = []
    tr.fit(DataSource([job["records"]], pipe, shard=shard).repeat(),
           log_fn=lambda m: losses.append(m.get("loss")))
    res["losses"] = losses
    eval_pipe = dataclasses.replace(pipe, shuffle=False, drop_remainder=False)
    res["eval"] = tr.evaluate(DataSource([job["records"]], eval_pipe, shard=shard).epoch(0))
    _say(job, res)


if __name__ == "__main__":
    main()

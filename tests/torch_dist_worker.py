"""One rank of a torch.distributed gloo group on the CPU, for the port's
data-parallel and spatial tests (tests/test_torch_mesh.py,
tests/test_torch_trainer.py, tests/test_torch_spatial.py).
It imports pcf_torch and never jax, so that a rank starts in a few seconds.

    python tests/torch_dist_worker.py JOB RANK WORLD PORT IN OUT

Sets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) for a group on 127.0.0.1:PORT, reads the job's inputs from IN
(torch.save), runs JOB and torch.saves its result to OUT. `spawn` starts
the ranks and kills them at a deadline, so that a hung rendezvous fails its
test instead of stalling the suite; `start` starts them and returns at once,
so that a test computes its references while the ranks run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: str, world: int, payload, tmp_path, timeout: float = 240.0) -> list:
    """Run `job` on `world` ranks; each rank's result, in rank order. Raises
    when a rank fails or when the ranks have not all ended by `timeout`
    seconds (then every rank is killed)."""
    return start(job, world, payload, tmp_path, timeout)()


def start(job: str, world: int, payload, tmp_path, timeout: float = 240.0):
    """Start `job` on `world` ranks; returns wait(), which gives spawn's
    result (the deadline counts from now)."""
    import torch

    inp = os.path.join(str(tmp_path), f"{job}_in.pt")
    torch.save(payload, inp)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    outs = [os.path.join(str(tmp_path), f"{job}_out{r}.pt") for r in range(world)]
    logs = [open(os.path.join(str(tmp_path), f"{job}_rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), port, inp, outs[r]], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.time() + timeout

    def wait() -> list:
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [p for p in procs if p.poll() is None]
            for p in hung:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
        text = [open(f.name).read() for f in logs]
        if hung:
            raise TimeoutError(f"{job}: {len(hung)} of {world} ranks still running after "
                               f"{timeout} s, killed\n" + "\n".join(t[-3000:] for t in text))
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"{job}: rank {r} exited with {p.returncode}\n"
                                   f"{text[r][-6000:]}")
        return [torch.load(o, weights_only=False) for o in outs]

    return wait


def smooth_relus():
    """Every ReLU and leaky ReLU replaced by softplus, as
    tests/test_torch_train_step.py's fixture does in the port."""
    from torch.nn import functional as F

    softplus = F.softplus
    F.relu = lambda x, inplace=False: softplus(x)
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: (
        negative_slope * x + (1 - negative_slope) * softplus(x))


def _state(cfg, variables, iter_per_epoch=5):
    from pcf_torch.convert import load_jax_variables
    from pcf_torch.entry import build
    from pcf_torch.train.state import create_train_state, make_optimizer

    model = load_jax_variables(build(cfg, device="cpu"), variables)
    tx, _ = make_optimizer(cfg, iter_per_epoch)
    return create_train_state(model, tx)


def _after(state, metrics) -> dict:
    """A train step's metrics, gradients, and the model's state_dict after it."""
    return dict(metrics={k: v.clone() for k, v in metrics.items()},
                grads={k: q.grad.clone() for k, q in state.model.named_parameters()},
                state={k: v.clone() for k, v in state.model.state_dict().items()})


def job_steps(rank: int, world: int, p: dict) -> dict:
    """The eval step and one train step of the port over a mesh of `world`
    ranks, each on its own batch (p["batches"][rank]): the logits; the loss,
    metrics, gradients, parameters and BN statistics after the step. Then a
    step with DropPath on and no SyncBN (p["drop_cfg"]), its gradients; and
    a MaskedBatchNorm forward and backward on the rank's half of p["bn"]'s
    rows, its statistics summed over the ranks."""
    import torch
    import torch.distributed as dist

    from pcf_torch.nn.norm import MaskedBatchNorm, synced_batch_stats
    from pcf_torch.parallel.mesh import make_eval_step, make_mesh, make_train_step

    if p.get("smooth"):
        smooth_relus()
    dist.init_process_group("gloo")
    mesh = make_mesh(world)
    out = {}
    batch = p["batches"][rank]
    state = _state(p["cfg"], p["variables"])
    out["logits"] = make_eval_step(p["cfg"], mesh)(state, batch)
    state, m = make_train_step(p["cfg"], mesh)(state, batch, p["seed"])
    out["metrics"] = {k: v.clone() for k, v in m.items()}
    out["grads"] = {k: q.grad.clone() for k, q in state.model.named_parameters()}
    out["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}

    state = _state(p["drop_cfg"], p["variables"])
    make_train_step(p["drop_cfg"], mesh)(state, batch, p["seed"])
    out["drop_grads"] = {k: q.grad.clone() for k, q in state.model.named_parameters()}

    x, mask, w = (t.chunk(world)[rank] for t in p["bn"])
    x = x.clone().requires_grad_(True)
    bn = MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    with synced_batch_stats(mesh.group):
        y = bn(x, mask)
        (y * w).sum().backward()
    out["bn"] = dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                     bias_grad=bn.bias.grad, mean=bn.running_mean, var=bn.running_var)
    dist.destroy_process_group()
    return out


def job_main(rank: int, world: int, p: dict) -> dict:
    """trainer.main on this rank (it joins the group from the environment),
    then, when p["resume_epochs"] is set, again with that many epochs (a
    resume from rank 0's checkpoint): the parameters and BN statistics of
    each run's end, and the steps taken."""
    import torch.distributed as dist

    from pcf_torch.train import trainer

    out = {}
    cfg = p["cfg"]
    state = trainer.main(cfg.copy(), device="cpu")
    out["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    out["steps"] = state.step
    if p.get("resume_epochs"):
        cfg2 = cfg.copy()
        cfg2.total_epoches = p["resume_epochs"]
        state = trainer.main(cfg2, device="cpu")
        out["resumed_state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        out["resumed_steps"] = state.step
    dist.destroy_process_group()
    return out


def job_spatial(rank: int, world: int, p: dict) -> dict:
    """The spatial steps of the port (parallel/spatial.py) on a 1-D mesh of
    `world` ranks and a (2, world // 2) mesh. The eval step of each of
    p["evals"]'s (cfg, variables) on p["batch"], and of p["kernel_cfg"]'s
    model seeded with 0 (the kernels' route): the full logits. Then, every
    ReLU smooth: one train step of p["train_cfg"] on p["batch"] over the 1-D
    mesh, one over the 2-D mesh (batch p["batches2"][data index]), and the
    data-parallel step of p["dp_cfg"] (SyncBN) over this rank's data
    subgroup on the same two batches: the metrics and the state after each."""
    import torch.distributed as dist

    from pcf_torch.entry import build
    from pcf_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d, make_train_step
    from pcf_torch.parallel.spatial import make_spatial_eval_step, make_spatial_train_step

    dist.init_process_group("gloo")
    mesh, mesh2 = make_mesh(world), make_mesh_2d(2, world // 2)
    out = {"eval": {}}
    for name, (cfg, variables) in p["evals"].items():
        out["eval"][name] = make_spatial_eval_step(cfg, mesh)(_state(cfg, variables), p["batch"])
    kcfg = p["kernel_cfg"]
    out["kernel_eval"] = make_spatial_eval_step(kcfg, mesh)(build(kcfg, device="cpu", seed=0),
                                                            p["batch"])

    smooth_relus()
    cfg, variables, seed = p["train_cfg"], p["variables"], p["seed"]
    state, m = make_spatial_train_step(cfg, mesh)(_state(cfg, variables, 10), p["batch"], seed)
    out["train"] = _after(state, m)
    d = rank // (world // 2)
    state, m = make_spatial_train_step(cfg, mesh2)(_state(cfg, variables, 10),
                                                   p["batches2"][d], seed)
    out["train2d"] = _after(state, m)
    dp = Mesh(mesh2.data, mesh2.data, 2, d, mesh.device, (2,))
    state, m = make_train_step(p["dp_cfg"], dp)(_state(p["dp_cfg"], variables, 10),
                                                p["batches2"][d], seed)
    out["dp"] = _after(state, m)
    dist.destroy_process_group()
    return out


def job_spatial_main(rank: int, world: int, p: dict) -> dict:
    """trainer.main under spatial_train on this rank: what job_main gives,
    and every batch its spatial train steps were handed and their losses."""
    import torch.distributed as dist

    import pcf_torch.parallel.spatial as spatial
    from pcf_torch.train import trainer

    make = spatial.make_spatial_train_step
    seen = {"batches": [], "losses": []}

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch, seed):
            seen["batches"].append([t.clone() for t in batch.tensors()])
            state, metrics = step(state, batch, seed)
            seen["losses"].append(float(metrics["loss"]))
            return state, metrics

        return run

    spatial.make_spatial_train_step = recording
    state = trainer.main(p["cfg"].copy(), device="cpu")
    out = dict(seen, steps=state.step,
               state={k: v.clone() for k, v in state.model.state_dict().items()})
    dist.destroy_process_group()
    return out


JOBS = {"steps": job_steps, "main": job_main, "spatial": job_spatial,
        "spatial_main": job_spatial_main}


def main() -> int:
    job, rank, world, port, inp, out = sys.argv[1:]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world, LOCAL_RANK=rank)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    result = JOBS[job](int(rank), int(world), torch.load(inp, weights_only=False))
    torch.save(result, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

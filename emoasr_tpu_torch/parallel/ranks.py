"""Rank programs started as processes, for the multi-rank checks (the CPU
tests over gloo, `chip_smoke.py` on the card).

`Launch(world, workdir, jobs)` writes the jobs (each a dict of `program`,
`mesh_shape`, `mesh_axes`, and the program's arguments: `device`,
`backend`, ...) to `workdir`, starts `world` processes of

    python -m emoasr_tpu_torch.parallel.ranks <workdir> <rank> <world>

which meet through a file store in `workdir` (no TCP port), lay out each
job's mesh in turn, run its program on it and write `rank{r}.pt`;
`wait()` returns every rank's results ([rank][job]) and raises with a
rank's output if one fails or outlives its timeout (the caller works
meanwhile).  Every program also runs in the calling process with
`mesh=None`: the single-process reference of the same work.  The children
import the port only (one PyTorch thread each).  Programs and jobs run on
the card unless their `device` is "cpu".

Programs:

- `train_steps`: micro-steps of an ASR model (or an LM, `lm=True`) from
  `state_dict` (or the config's seed), set up as the trainers set it up
  (`train/loop.py::build_train_state`), through `train/step.py`, each rank on
  its rows; returns the global loss terms of every micro-step, the summed
  micro-gradient after the first one and its norm as the clip counts it,
  the whole `state_dict` after every update, the skip count, the kernels'
  launches, the shapes of the rank's parameters, its peak device memory
  (on the card), an eval loss, and on request a checkpoint written and
  read back on the mesh.
- `decode`: a model's beam or greedy decode of one batch with its rows
  split over every rank (the eval CLI's `--dp`), gathered on rank 0.
- `encode`: the encoder output of one batch's rows, gathered on rank 0.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.paths import REPO_ROOT


class Launch:
    """`world` rank processes running `jobs` one after another (see the
    module note); `wait()` gives every rank's results, [rank][job]."""

    def __init__(self, world: int, workdir: str, jobs: List[Dict]):
        self.world, self.workdir, self.jobs = world, workdir, jobs
        os.makedirs(workdir, exist_ok=True)
        for f in os.listdir(workdir):
            if f == "init" or f.startswith("rank"):
                os.remove(os.path.join(workdir, f))
        torch.save(jobs, os.path.join(workdir, "jobs.pt"))
        run_env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            run_env.pop(k, None)
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(os.path.join(workdir, f"log{r}.txt"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "emoasr_tpu_torch.parallel.ranks", workdir, str(r), str(world)],
                cwd=os.path.abspath(REPO_ROOT), env=run_env, stdout=log, stderr=subprocess.STDOUT))

    def wait(self, timeout: float = 300.0) -> List[List]:
        procs, deadline, failed = self.procs, time.time() + timeout, None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad or time.time() > deadline:
                    failed = bad[0] if bad else None
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                failed = bad[0] if bad else None
                if not bad:
                    return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                            for r in range(self.world)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        what = f"rank {failed} exited {procs[failed].returncode}" if failed is not None else f"timeout {timeout} s"
        r = 0 if failed is None else failed
        with open(os.path.join(self.workdir, f"log{r}.txt")) as f:
            tail = f.read()[-6000:]
        names = [j["program"] for j in self.jobs]
        raise RuntimeError(f"{names} on {self.world} ranks: {what}; rank {r}'s output:\n{tail}")


def _device(mesh, device) -> torch.device:
    """The mesh's device, else `device` (the card when None)."""
    return mesh.device if mesh is not None else resolve_device(device)


def _kernels():
    """The kernels a rank's training or decoding step runs: K4, K1, K2, K3,
    K7, K8."""
    from emoasr_tpu_torch.ops import attention, ctc_head, ctc_lattice, lstm_scan, rnnt_joint, topk

    return (attention.KERNEL, ctc_head.KERNEL, ctc_lattice.KERNEL, topk.KERNEL, rnnt_joint.KERNEL,
            lstm_scan.KERNEL)


def _kernel_counts() -> Dict[str, Dict[str, int]]:
    """Their launches by launcher."""
    return {k.name: {"all": k.launches, **k.counts} for k in _kernels()}


def _reset_counts() -> None:
    for k in _kernels():
        k.reset_counts()


def _to(batch: Dict, dev) -> Dict:
    return {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def train_steps(mesh, conf: Dict, batches: List[Dict], state_dict=None, lm: bool = False,
                num_total_steps: Optional[int] = None, eval_batch: Optional[Dict] = None,
                save_dir: Optional[str] = None, no_dropout: bool = False, device: Optional[str] = None) -> Dict:
    """Micro-steps on `batches` (see the module note); `no_dropout` turns
    off every dropout layer (BERT's rate is fixed)."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.parallel.tensor import full_tensors
    from emoasr_tpu_torch.train import checkpoint as ckpt
    from emoasr_tpu_torch.train.loop import build_train_state
    from emoasr_tpu_torch.train.optim import sharded_norm
    from emoasr_tpu_torch.train.step import make_eval_loss_step, make_train_step
    from emoasr_tpu_torch.train.train_lm import lm_loss

    dev = _device(mesh, device)
    cfg = config_from_dict(conf)
    state, gen = build_train_state(cfg, dev, mesh, state_dict, lm=lm)
    model = state.model
    if no_dropout:
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
    step = make_train_step(cfg, num_total_steps, **({"loss_fn": lm_loss} if lm else {}))
    plan = getattr(model, "tp_plan", {})
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    out: Dict = {"metrics": [], "params": [], "grads": None}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    for i, batch in enumerate(batches):
        m = step(state, _to(pmesh.shard_batch(mesh, batch), dev), gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0 and state.acc_grads and state.mini_step:
            grads = dict(zip(names, state.acc_grads))
            out["grads"] = _cpu(full_tensors(mesh, plan, grads) if mesh is not None else grads)
            # the clip's norm, each tensor-parallel share counted once
            norm = (sharded_norm(state.acc_grads, [n in plan for n in names], mesh.model_group) if plan
                    else torch.stack(torch._foreach_norm(state.acc_grads)).norm())
            out["grad_norm"] = float(norm)
        if state.mini_step == 0:
            out["params"].append(_cpu(ckpt.full_state_dict(model, mesh)))
    out["launches"] = _kernel_counts()
    out["skipped"], out["step"] = state.skipped, state.step
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}  # this rank's shares
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if eval_batch is not None:
        loss = make_eval_loss_step(cfg)(state, _to(pmesh.shard_batch(mesh, eval_batch), dev))
        out["eval_loss"] = {k: float(v) for k, v in pmesh.reduce_metrics(mesh, loss).items()}
    if save_dir is not None:
        out["roundtrip"] = _checkpoint_roundtrip(mesh, cfg, state, save_dir, lm, dev)
    return out


def _checkpoint_roundtrip(mesh, cfg, state, save_dir: str, lm: bool, dev) -> float:
    """Write `state` as `model.ep1` / `optim.ep1` (rank 0, gathered), read
    both back into a fresh state laid out alike; the largest difference of
    a parameter or a moment from the live ones."""
    from emoasr_tpu_torch.train import checkpoint as ckpt
    from emoasr_tpu_torch.train.loop import build_train_state

    mp, op = os.path.join(save_dir, "model.ep1"), os.path.join(save_dir, "optim.ep1")
    ckpt.save_checkpoint(mesh, mp, op, state)
    with torch.random.fork_rng(devices=[]):
        back, _ = build_train_state(cfg, dev, mesh, mp, op, lm=lm)
    diff = 0.0
    for a, b in zip(state.model.parameters(), back.model.parameters()):
        diff = max(diff, float((a.detach() - b.detach()).abs().max()))
    sa, sb = state.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            diff = max(diff, float((sa[i][k] - sb[i][k].to(sa[i][k].device)).abs().max()))
    return diff


def decode(mesh, conf: Dict, state_dict: Dict, xs: torch.Tensor, xlens: torch.Tensor, beam_width: int = 0,
           device: Optional[str] = None) -> Optional[tuple]:
    """One batch decoded with its rows split over every rank of `mesh`, as
    the eval CLI's `--dp` splits them (a mesh with a model axis is laid out
    again with all its ranks on `data`: each decodes with a whole copy);
    the (hyps, hyp_lens, scores) arrays on rank 0, None elsewhere."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import _decode_rows
    from emoasr_tpu_torch.models.asr import ASR

    dev = _device(mesh, device)
    if mesh is not None and mesh.model_size > 1:
        mesh = pmesh.make_mesh((mesh.world,), (pmesh.DATA,), device=dev, backend=mesh.backend,
                               rank=mesh.rank, world=mesh.world)
    cfg = config_from_dict(conf)
    set_matmul_precision(cfg.compute_dtype)
    model = ASR(cfg)
    model.load_state_dict(state_dict)
    fn = build_decode_fn(model, cfg, beam_width, device=dev)
    _reset_counts()
    rows = _decode_rows(fn, {"xs": xs.numpy(), "xlens": xlens.numpy()}, mesh)
    return None if rows is None else (rows, _kernel_counts())


def encode(mesh, conf: Dict, state_dict: Dict, xs: torch.Tensor, xlens: torch.Tensor,
           device: Optional[str] = None) -> Optional[tuple]:
    """The encoder output (eouts, elens) of one batch with its rows split
    over the data axis, gathered on rank 0 (None elsewhere)."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train.step import preprocess

    dev = _device(mesh, device)
    cfg = config_from_dict(conf)
    set_matmul_precision(cfg.compute_dtype)
    model = ASR(cfg)
    model.load_state_dict(state_dict)
    model.to(dev).eval()
    rows = slice(None) if mesh is None else pmesh.row_slice(mesh, xs.shape[0])
    with torch.no_grad():
        eouts, elens, _ = model.encode(*preprocess(cfg, xs[rows].to(dev), xlens[rows].to(dev)))
    mine = (eouts.cpu(), elens.cpu())
    if mesh is None:
        return mine
    parts = pmesh.gather_rows(mesh, mine)
    return None if parts is None else tuple(torch.cat([p[i] for p in parts]) for i in range(2))


PROGRAMS = {"train_steps": train_steps, "decode": decode, "encode": encode}


def _main(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    jobs = torch.load(os.path.join(workdir, "jobs.pt"), weights_only=False)
    init = f"file://{os.path.abspath(workdir)}/init"
    outs = []
    try:
        for job in jobs:
            job = dict(job)
            program, shape, axes = job.pop("program"), job.pop("mesh_shape"), job.pop("mesh_axes")
            mesh = pmesh.make_mesh(shape, axes, device=resolve_device(job.get("device")),
                                   backend=job.pop("backend", None), init_method=init, rank=rank, world=world)
            outs.append(PROGRAMS[program](mesh, **job))
        torch.save(outs, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

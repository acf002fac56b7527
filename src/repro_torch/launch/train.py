"""End-to-end training loop and entry point with fault tolerance.

The port of ``src/repro/launch/train.py``: it restores the newest
committed checkpoint if present, then trains with deterministic batches
(``TokenPipeline``), periodic atomic checkpoints, and crash-restart
(``--inject-failure-at`` proves the loop recovers).  With no mesh it
runs on one device; with ``mesh=`` (a ``DeviceMesh`` of the running
process group, every rank running the loop) the parameters and AdamW
moments are DTensors placed by ``rules.param_specs`` / ``opt_pspec``
(the reference's default ``tp=True``), the step runs sharded
(``training.train_step``): dense, vlm and moe compute tensor-parallel on
the mesh's ``model`` axis (``sharding.tp``), a restore places what it
loads on the mesh, and a moe config's "ep" policy runs its all-to-all
over the ``model`` axis.

On the card, at full width and depth:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --steps 100 --batch 4 --seq 2048 --attention blocked

On the CPU, at the reduced size the tests use:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --device cpu --steps 20 --batch 8 --seq 128

The attention of a trained model is ``"reference"`` or ``"blocked"``:
the flash kernels have no backward (the JAX package's has none either).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from ..configs import get_config, reduced
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models import init_params, moe
from ..models.transformer import param_shapes
from ..sharding import place, rules
from ..training.checkpoint import latest_step, restore, save
from ..training.optimizer import OptConfig, adamw_init
from ..training.train_step import make_steps

__all__ = ["SimulatedFailure", "TrainLoop", "main", "run_with_restarts"]


class SimulatedFailure(RuntimeError):
    pass


class TrainLoop:
    def __init__(self, cfg, *, batch: int, seq: int, ckpt_dir,
                 opt_cfg: OptConfig | None = None, save_every: int = 50,
                 microbatches: int = 1, compress_grads: bool = False,
                 seed: int = 0, device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for weights on "
                             f"{self.device}")
        self.mesh = mesh
        self.ckpt_dir = Path(ckpt_dir)
        self.save_every = save_every
        if mesh is not None:
            self.p_spec = rules.param_specs(cfg, param_shapes(cfg), mesh)
            self.o_spec = rules.opt_pspec(self.p_spec)
            moe.set_mesh(mesh)
        self.steps = make_steps(cfg, opt_cfg, microbatches=microbatches,
                                compress_grads=compress_grads, mesh=mesh)
        self.train_step = self.steps["train_step"]
        self.pipeline = TokenPipeline(DataConfig(
            batch=batch, seq_len=seq, vocab_size=cfg.vocab_size, seed=seed))
        self.state = None   # (model, opt)
        self.start_step = 0

    # -- state management ---------------------------------------------------
    def init_or_restore(self, seed: int = 0) -> int:
        """Weights from a seeded ``torch.Generator`` on the device and
        fresh moments, or the newest committed checkpoint's."""
        step = latest_step(self.ckpt_dir)
        model = init_params(
            self.cfg, torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        if self.mesh is not None:
            place.distribute_model(model, self.p_spec, self.mesh)
        model.requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()))
        if step is not None:
            like = {"params": model.state_dict(), "opt": opt}
            where = {} if self.mesh is None else dict(
                mesh=self.mesh, placements={
                    "params": rules.placements(self.mesh, self.p_spec),
                    "opt": {k: rules.placements(self.mesh, self.o_spec[k])
                            for k in ("m", "v")} | {"step": None}})
            tree = restore(self.ckpt_dir, step, like, device=self.device,
                           **where)
            model.load_state_dict(tree["params"])
            opt = tree["opt"]
            self.start_step = step
            print(f"[train] resumed from step {step}")
        self.state = (model, opt)
        return self.start_step

    def save_now(self, step: int) -> None:
        model, opt = self.state
        save(self.ckpt_dir, step, {"params": model.state_dict(), "opt": opt},
             extra_meta={"arch": self.cfg.name})

    # -- the loop ------------------------------------------------------------
    def run(self, total_steps: int, *, inject_failure_at: int | None = None,
            log_every: int = 10) -> list:
        if self.state is None:
            self.init_or_restore()
        model, opt = self.state
        losses = []
        t0 = time.time()
        for step in range(self.start_step, total_steps):
            batch = self.pipeline.host_slice(self.pipeline.batch_at(step))
            tb = {"tokens": torch.as_tensor(batch["tokens"],
                                            device=self.device)}
            if inject_failure_at is not None and step == inject_failure_at:
                raise SimulatedFailure(f"injected at step {step}")
            model, opt, metrics = self.train_step(model, opt, tb)
            self.state = (model, opt)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0 or step == total_steps - 1:
                dt = time.time() - t0
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt / max(1, step - self.start_step + 1):.2f}s/step)",
                      flush=True)
            if (step + 1) % self.save_every == 0 or step == total_steps - 1:
                self.save_now(step + 1)
        self.start_step = total_steps
        return losses


def run_with_restarts(make_loop, total_steps: int, *, max_restarts: int = 3,
                      inject_failure_at: int | None = None):
    """Supervisor: restart from the last committed checkpoint on failure —
    what a cluster-level job controller does on node loss."""
    losses = []
    restarts = 0
    inject = inject_failure_at
    while True:
        loop = make_loop()
        loop.init_or_restore()
        try:
            losses += loop.run(total_steps, inject_failure_at=inject)
            return losses, restarts
        except SimulatedFailure as e:
            print(f"[supervisor] {e}; restarting "
                  f"({restarts + 1}/{max_restarts})")
            restarts += 1
            inject = None
            if restarts > max_restarts:
                raise


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--attention", choices=("reference", "blocked"),
                    default="reference")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, attention_impl=args.attention)

    def make_loop():
        return TrainLoop(cfg, batch=args.batch, seq=args.seq,
                         ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                         microbatches=args.microbatches,
                         compress_grads=args.compress_grads,
                         device=args.device)

    losses, restarts = run_with_restarts(
        make_loop, args.steps, inject_failure_at=args.inject_failure_at)
    print(f"[train] done: {len(losses)} steps, restarts={restarts}, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()

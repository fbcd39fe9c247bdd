"""The training runtime on one device: train step, microbatch gradient
accumulation, checkpoint/restart.

Port of the JAX package's ``distributed/train_loop.py``.  ``Trainer``
wires together:
  * the model's train step: ``transformer.loss_and_grads`` (autograd;
    attention through ``layers.chunked_attention``), microbatch
    accumulation, and the optimizer's update of ``transformer.param_tree``
    (the JAX package's stacked layout) written into the model in place,
  * step-granular checkpoint/restart (async save, atomic publish; a
    preempted run resumes from its last complete checkpoint),
  * straggler monitoring,
  * deterministic data (restart replays the exact batch sequence).

The JAX package jits the step with in/out shardings over a device mesh and
donates the parameter and optimizer buffers; the ``Trainer`` runs on one
card, takes a ``device`` where the JAX package takes a ``mesh``, and
updates the model's own storage in place instead of donating.  The
optimizer state's specs on a mesh are ``_opt_specs``, which the dry run
(``launch/dryrun.py``) lays its sharded step out with.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.backend import default_device
from repro_torch.data.tokens import DataConfig, TokenSource
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.optimizer import Schedule, make_optimizer, tree_map
from repro_torch.distributed.straggler import StepMonitor
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class TrainConfig:
    steps: int = 20
    microbatches: int = 1
    checkpoint_every: int = 10
    checkpoint_dir: Optional[str] = None
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    compress_grads: bool = False
    seed: int = 0


def _accumulate_microbatches(loss_grad_fn, model, batch: dict, n_micro: int):
    """Split the step's batch into ``n_micro`` microbatches along the
    batch dim and accumulate their gradients in f32: (loss, metrics,
    grads), the loss the mean of the microbatch losses, the gradients
    their mean.  ``loss_grad_fn(model, batch) -> ((loss, metrics),
    grads)``."""
    if n_micro == 1:
        (loss, metrics), grads = loss_grad_fn(model, batch)
        return loss, metrics, grads

    def micro(x, i):
        b = x.shape[0] // n_micro
        return x[i * b : (i + 1) * b]

    gsum, loss_sum = None, 0.0
    for i in range(n_micro):
        (loss, _metrics), grads = loss_grad_fn(model, {k: micro(v, i) for k, v in batch.items()})
        if gsum is None:
            gsum = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        tree_map(lambda a, g: a.add_(g), gsum, grads)  # before the next call reuses grads
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g: g / n_micro, gsum)
    loss = loss_sum / n_micro
    return loss, {"nll": loss}, grads


class Trainer:
    def __init__(
        self,
        arch: ArchConfig,
        data_cfg: DataConfig,
        train_cfg: TrainConfig,
        device=None,
    ):
        self.arch, self.data_cfg, self.cfg = arch, data_cfg, train_cfg
        self.device = default_device(device)
        self.data = TokenSource(data_cfg, self.device)
        self.monitor = StepMonitor()
        self.ckpt = (
            Checkpointer(train_cfg.checkpoint_dir)
            if train_cfg.checkpoint_dir
            else None
        )
        sched = Schedule(
            peak_lr=train_cfg.peak_lr,
            warmup_steps=train_cfg.warmup_steps,
            total_steps=train_cfg.steps,
        )
        self.optimizer = make_optimizer(
            arch.optimizer, sched, compress=train_cfg.compress_grads
        )

    # ------------------------------------------------------------------
    def step(self, model: T.Transformer, opt: dict, batch: dict):
        """One step: gradients over ``cfg.microbatches`` microbatches, then
        the optimizer's update written into ``model``.  Returns (model,
        opt, metrics); the metrics stay on the device."""
        loss, metrics, grads = _accumulate_microbatches(
            T.loss_and_grads, model, batch, self.cfg.microbatches
        )
        new, opt = self.optimizer.update(T.param_tree(model), grads, opt)
        T.assign_params(model, new)
        return model, opt, dict(metrics, loss=loss)

    def init_state(self):
        """(model, optimizer state): weights drawn on the device from the
        seeded generator, the state zeros in the layout of
        ``param_tree``."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        model = T.init_params(self.arch, generator=gen, device=self.device)
        return model, self.optimizer.init(T.param_tree(model))

    def run(self, start_step: int = 0, params=None, opt=None, hooks=(),
            stop_after=None) -> dict:
        """Run to cfg.steps; resumable (restores the latest checkpoint if
        any).  ``params`` is the model.

        ``stop_after`` simulates a preemption: the loop exits after that
        many steps (checkpoints written on schedule still stand; a later
        run() resumes from the last complete one with the SAME config).
        """
        if params is None:
            if self.ckpt and self.ckpt.latest_step() is not None:
                params, opt, start_step = self.restore()
            else:
                params, opt = self.init_state()
        losses = []
        end = self.cfg.steps if stop_after is None else min(
            self.cfg.steps, start_step + stop_after
        )
        for step in range(start_step, end):
            batch = self.data.global_batch_at(step)
            self.monitor.start()
            params, opt, metrics = self.step(params, opt, batch)
            loss = float(metrics["loss"])  # the step's one read to the host
            self.monitor.stop()
            losses.append(loss)
            for h in hooks:
                h(step, loss, params)
            if self.ckpt and (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, {"params": T.param_tree(params), "opt": opt})
        if self.ckpt:
            # label with the last COMPLETED step (a preempted run must not
            # claim steps it never took)
            self.ckpt.save(end, {"params": T.param_tree(params), "opt": opt},
                           blocking=True)
        return {"losses": losses, "params": params, "opt": opt}

    def restore(self):
        """Load the latest checkpoint onto this trainer's device, whatever
        device wrote it: (model, optimizer state, step)."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        model = T.init_params(self.arch, generator=gen, device=self.device)
        params = T.param_tree(model)
        like = {"params": params,
                "opt": self.optimizer.init(tree_map(lambda p: p.to("meta"), params))}
        tree, step = self.ckpt.restore(like, device=self.device)
        T.assign_params(model, tree["params"])
        return model, tree["opt"], step


def _opt_specs(o_tree, p_tree, mesh):
    """Optimizer-state specs (``distributed/sharding.py``): a leaf under
    'm'/'v'/'vr'/'vc'/'ef' takes its parameter's rule at its own ndim, a
    scalar ('step') replicates, as in the JAX package.  Adafactor's
    factored 'vr'/'vc' leaves keep that quirk of the reference: the rule
    of a parameter of one more dimension, truncated, which need not fit
    their shape (``sharding.local_shape`` says where it does not
    divide)."""
    from repro_torch.distributed import sharding

    fsdp = sharding.dp_axes(mesh)

    def spec(names, leaf):
        inner = [n for n in names if n not in ("m", "v", "vr", "vc", "ef")]
        nd = len(leaf.shape) if hasattr(leaf, "shape") else 0
        if not inner or nd == 0:
            return ()
        return sharding._leaf_spec(inner, nd, fsdp)

    return sharding._map_with_path(spec, o_tree)

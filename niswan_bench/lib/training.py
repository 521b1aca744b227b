"""What a training runner is made of: the port's training step, the
reference in its place, the window, and the check of the first three steps.

Set-up builds one training step with its model and optimizer state and
drives it from the seed through its first three steps, through the
window's own call and feed on three different batches; the window then
goes on with the same object.  On a card the first step runs eagerly and
the next two are replays of the step's CUDA graph, as every step of the
window is.  The check lets the reference take the same three steps from
the same initial weights on the same batches, which it gathers itself in
its own order, and compares each step's loss and each leaf's change after
the three steps (``loss_gap``, ``change_gap``).

Each step's gradient, as Adam got it (worked out from its first moments
after that step and the one before), is compared with the reference's
gradient at the weights the system held before that step: the first step's
are the seed's, the later ones the system's own state.  Two trajectories
part by rounding alone, which Adam turns into lr-sized steps, so after one
step the reference's own gradients differ from the port's by as much as a
lower precision does at the first; at the system's weights they differ by
the step's own error.  ``grad_gap`` compares the first gradient's norms
leaf by leaf; ``grad_err``, over all three steps, the gradients themselves,
because a lower precision's errors cancel in a norm: the norm of their
difference over the reference's norm (no gap of norms is larger than
the norm of the difference).  On some seeds a whole gradient nearly cancels (its median leaf
10-100 times below the usual) while the rounding does not shrink with it,
so that norm is at least the traffic's ``grad_scale``, the usual size of a
first gradient's median leaf at the cell's configuration.
"""

from __future__ import annotations

import gc
from typing import List

import torch

from nasa_niswan_tpu_torch.models.registry import build_model
from nasa_niswan_tpu_torch.train.loop import make_optimizer, set_learning_rate
from nasa_niswan_tpu_torch.train.schedule import step_lr
from niswan_bench.lib import clock, compare, data, loop
from niswan_bench.reference.convlstm import Model, Trainer, params_tree

CHECKED_STEPS = 3


def bundle(config: dict):
    """The model as the training CLI builds it (``remat``: the whole-scan
    BPTT route)."""
    return build_model(config["model_name"], in_channels=config["in_channels"],
                       hidden_channels=tuple(config["hidden_channels"]),
                       kernel_sizes=tuple(config["kernel_sizes"]),
                       compute_dtype=config["compute_dtype"])


class PortSteps:
    """The system under test: ``step(*batch)`` of the port on ``params``
    with the configuration's Adam, and the optimizer's state."""

    def __init__(self, config, params, seed, device, make_step):
        self.params, self.state = params, None
        self.leaves = data.tree_leaves(params)
        self.optimizer = make_optimizer(params, config["learning_rate"], tuple(config["betas"]))
        self.step = make_step(bundle(config), self.optimizer)
        self.rng = torch.Generator(device=device).manual_seed(int(seed))
        self.config = config

    def __call__(self, *batch) -> torch.Tensor:
        self.state, metrics = self.step(self.params, self.state, *batch, rng=self.rng)
        return metrics["loss"]

    def set_epoch(self, epoch: int) -> None:
        step_size, gamma = self.config["step_lr"]
        set_learning_rate(self.optimizer,
                          step_lr(self.config["learning_rate"], step_size, gamma, epoch - 1))

    def first_moments(self) -> List[torch.Tensor]:
        """Adam's first moments; zeros for a leaf it holds none of."""
        return [self.optimizer.state.get(t, {}).get("exp_avg", torch.zeros_like(t))
                .detach().clone() for t in self.leaves]


class ControlSteps:
    """The reference at fp8 in the port's place; ``gather`` turns a
    batch of the feed into raw (x, y) on the device."""

    def __init__(self, config, params, stats, static, gather):
        self.trainer = Trainer(Model(params, config, stats, static, precision="fp8"),
                               config["learning_rate"], config["betas"])
        self.leaves = self.trainer.leaves
        self.gather = gather

    def __call__(self, *batch) -> torch.Tensor:
        return torch.tensor(self.trainer.step(*self.gather(*batch)))

    def set_epoch(self, epoch: int) -> None:
        pass  # the window of a control run stays in its first epoch

    def first_moments(self) -> List[torch.Tensor]:
        return self.trainer.first_moments()


class TrainRunner:
    """A subclass gives ``make_data(gen)``, ``make_port(model, optimizer)``
    (the port's step for its feed), ``feed(epoch)`` (the batches of an
    epoch, as the port takes them),
    ``gather(*batch)`` (a batch as raw device tensors, for the control) and
    ``reference_batches()`` (the checked steps' raw batches, which the
    reference gathers itself)."""

    def __init__(self, config, traffic, seed, device, system="port"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.system_name = system

    def setup(self):
        cfg = self.config
        self.phases = clock.Phases()
        gen = data.generator(self.seed, self.device)
        params = data.convlstm_params(gen, cfg, self.device, trainable=True)
        self.stats = data.normalizer_stats(gen, cfg["dynamic_channels"])
        n_static = cfg["in_channels"] - cfg["dynamic_channels"]
        self.static = data.static_fields(gen, n_static, cfg["grid"]) if n_static else None
        self.make_data(gen)
        self.initial = [t.detach().clone() for t in data.tree_leaves(params)]
        loop.sync(self.device)
        self.phases.mark("inputs")
        if self.system_name == "port":
            self.system = PortSteps(cfg, params, self.seed, self.device, self.make_port)
        else:
            self.system = ControlSteps(cfg, params, self.stats, self.static, self.gather)
        self.epoch, self.batches = 0, iter(())
        self.losses, self.moments, self.before = [], [], []
        for _ in range(CHECKED_STEPS):
            self.before.append([t.detach().clone() for t in self.system.leaves])
            self.losses.append(self._step())
            self.moments.append(self.system.first_moments())
        self.after = [t.detach().clone() for t in self.system.leaves]
        loop.sync(self.device)
        self.phases.mark("first steps")

    def _next(self):
        while True:
            try:
                return next(self.batches)
            except StopIteration:
                self.close_feed()
                self.epoch += 1
                self.system.set_epoch(self.epoch)
                self.batches = self.feed(self.epoch)

    def _step(self):
        return self.system(*self._next())

    def run(self, seconds=None, count=None, measured=True):
        n, wall = loop.closed_loop(lambda _: self._step(), self.device,
                                   seconds=seconds, count=count)
        return {"units": n, "wall_s": wall, "steps": n, "batch": self.config["batch_size"],
                "seq": self.config["sequence_length"]}

    def e2e(self, window):
        days = window["steps"] * window["batch"] * window["seq"] / self.config["steps_per_day"]
        return {"train_days_per_min": days / (window["wall_s"] / 60.0)}

    def close_feed(self):
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()

    def release(self):
        self.close_feed()
        self.batches = iter(())
        self.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        cfg = self.config
        trainer = Trainer(Model(params_tree([t.clone() for t in self.initial]), cfg,
                                self.stats, self.static),
                          cfg["learning_rate"], cfg["betas"])
        ref_losses, ref_grads = [], []
        for before, (x, y) in zip(self.before, self.reference_batches()):
            # the gradient at the weights the system held before this step
            # (its own state: the two trajectories part by rounding, and Adam
            # turns that into lr-sized steps), then the reference's own step
            weights = [t.clone().requires_grad_(True) for t in before]
            ref_grads.append(Model(params_tree(weights), cfg, self.stats,
                                   self.static).gradients(x, y))
            ref_losses.append(trainer.step(x, y))
        grads = compare.step_gradients(self.moments, cfg["betas"][0])
        grad = [compare.norms(g) for g in grads]
        ref_grad = [compare.norms(g) for g in ref_grads]
        moved = compare.moved_leaves(ref_grad[0])
        change = compare.norms(a - p for a, p in zip(self.after, self.initial))
        ref_change = compare.norms(a.detach() - p for a, p in zip(trainer.leaves, self.initial))
        grad_err = [compare.worst_leaf(
            compare.norms(p - r.to(p.device) for p, r in zip(g, rg)), rn,
            scale=self.traffic["grad_scale"]) for g, rg, rn in zip(grads, ref_grads, ref_grad)]
        grad_gap = [compare.leaf_norm_gap(n, rn) for n, rn in zip(grad, ref_grad)]
        values = {
            "loss_gap": max(compare.rel_gap(float(lp), lr)
                            for lp, lr in zip(self.losses, ref_losses)),
            "grad_gap": grad_gap[0],
            "grad_err": max(grad_err),
            "change_gap": compare.leaf_norm_gap(change, ref_change, moved),
        }
        self.readings = {"losses": [float(x) for x in self.losses], "ref_losses": ref_losses,
                         "grad_gap_by_step": grad_gap, "grad_err_by_step": grad_err,
                         "grad_norms": grad, "ref_grad_norms": ref_grad,
                         "change_norms": change, "ref_change_norms": ref_change,
                         "left_out": [i for i, m in enumerate(moved) if not m]}
        return values, CHECKED_STEPS

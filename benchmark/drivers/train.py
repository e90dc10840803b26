"""Train: the port's train step on one card, one step per call.

Set-up builds the model from the seed's weights, Adam (``make_optimizer``
with the traffic's lr and weight decay, no warmup: the window stands for
training past it) and ``make_train_step`` (BCE, no augmentation), and drives
that one state through its first ``check_steps`` steps by the window's own
call, on pool batches 0, 1, 2 (every row different). They warm up every
shape. From them it keeps what the check compares: each step's loss, the
per-leaf norm of the first gradient as Adam took it (its first moment
after one step over 1 - beta1) and, at the end of the last, the parameters
(copied to the host). The window goes on with the same state. Each call
copies the next pinned batch to the card and takes a step, which reads its
loss on the host (the port's non-finite skip).

The check draws the weights again and runs the reference's steps on the
same batches: the worst relative gap of the losses, and by the worst leaf
the gap of the norms of the first gradient and of the change after the
last step, each against the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change.
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark import aum, harness, traffic
from benchmark.reference import train as ref_train
from benchmark.reference.precision import rounding, set_exact_fp32

# Leaves whose reference gradient norm is below this share of the median
# leaf's do not count in the change.
STILL_LEAF = 1e-3


def hyper(tr: dict):
    from aum_tpu_torch.train import TrainHyperParams

    return TrainHyperParams(lr=tr["lr"], weight_decay=tr["weight_decay"], warmup=False)


def labels(tr: dict, classes: int, device) -> torch.Tensor:
    rows = torch.arange(tr["batch"], device=device) % classes
    return torch.nn.functional.one_hot(rows, classes).float()


class Session:
    def __init__(self, cell: dict, seed: int, device):
        from aum_tpu_torch.train import init_train_state, make_optimizer, make_train_step

        cfg, tr = cell["config_spec"], cell["traffic_spec"]
        self.device, self.tr = device, tr
        self.pool = traffic.make_pool(tr, cfg, seed, device)
        harness.log("pool drawn")
        model, self.param_shapes = aum.build_program(cfg, seed, device)
        harness.log("model built")
        hp = hyper(tr)
        self.state = init_train_state(model, make_optimizer(model.parameters(), hp))
        self.step = make_train_step(hp, tr["steps_per_epoch"], loss_type="BCE",
                                    generator=torch.Generator().manual_seed(seed))
        self.y = labels(tr, cfg["model"]["num_classes"], device)
        opt = self.state.optimizer.defaults
        if (tuple(opt["betas"]), opt["eps"]) != (tuple(tr["betas"]), tr["eps"]):
            raise ValueError(f"the port's Adam has betas {opt['betas']}, eps {opt['eps']}; the "
                             f"traffic states {tr['betas']}, {tr['eps']}")
        harness.settle(device)
        self.calls, self.losses = 0, []
        for i in range(tr["check_steps"]):
            self.call()
            if i == 0:
                self.grad1 = self._first_grad_norms()
        harness.log("first steps done")
        self.params = {k: v.detach().to("cpu", copy=True)
                       for k, v in self.state.model.state_dict().items()}

    def _first_grad_norms(self) -> dict:
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        names = {id(p): k for k, p in self.state.model.named_parameters()}
        # A leaf the step did not update has no moment: its norm reads 0.
        return {names[id(p)]: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                if "exp_avg" in opt.state[p] else 0.0
                for group in opt.param_groups for p in group["params"]}

    def call(self):
        x = self.pool[self.calls % self.pool.shape[0]].to(self.device, non_blocking=True)
        self.state, loss = self.step(self.state, {"x": x, "y": self.y})
        self.calls += 1
        self.losses.append(loss.item())
        return x.shape[0]

    def finish(self):
        steps = self.tr["check_steps"]
        out = {"pool": self.pool, "losses": self.losses[:steps], "grad1": self.grad1,
               "params": self.params, "param_shapes": self.param_shapes}
        failed = sum(not math.isfinite(v) for v in self.losses[steps:])
        del self.state, self.step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out, failed


def setup(cell: dict, seed: int, device) -> Session:
    return Session(cell, seed, device)


def reference(cell: dict, seed: int, out: dict, device, precision: str = "fp32",
              half_batch: bool = False) -> dict:
    cfg, tr = cell["config_spec"], cell["traffic_spec"]
    set_exact_fp32()
    params = aum.seeded_params(cfg, out["param_shapes"], seed, device)
    y = labels(tr, cfg["model"]["num_classes"], device)
    batches = [(out["pool"][i].to(device), y) for i in range(tr["check_steps"])]
    return ref_train.train_steps(params, cfg["model"], batches, lr=tr["lr"],
                                 betas=tuple(tr["betas"]), eps=tr["eps"],
                                 weight_decay=tr["weight_decay"], rnd=rounding(precision),
                                 half_batch=half_batch)


def leaf_gap(got: dict, want: dict, keys) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's want)."""
    median = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in keys)


def compare(got: dict, want: dict) -> dict:
    losses = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    floor = STILL_LEAF * statistics.median(want["raw_grad1"].values())
    moving = [k for k, v in want["raw_grad1"].items() if v >= floor]
    return {"loss_rel_err": losses,
            "grad1_norm_gap": leaf_gap(got["grad1"], want["grad1"], want["grad1"]),
            "change_norm_gap": leaf_gap(got["change"], want["change"], moving),
            "leaves_left_out": len(want["raw_grad1"]) - len(moving)}


def program_view(cell: dict, seed: int, out: dict, device) -> dict:
    """The program's numbers: its losses, first-gradient norms, and the norm
    of each leaf's change against the seed's weights drawn again."""
    start = aum.seeded_params(cell["config_spec"], out["param_shapes"], seed, device)
    change = {k: float((out["params"][k].to(device) - start[k]).norm()) for k in start}
    return {"losses": out["losses"], "grad1": out["grad1"], "change": change}


def check(cell: dict, seed: int, out: dict, device) -> dict:
    got = program_view(cell, seed, out, device)
    return compare(got, reference(cell, seed, out, device))


def control(cell: dict, seed: int, out: dict, device) -> dict:
    """The readings of the control and the planted fault, the reference in
    the program's place: "fp8" computed in fp8, "half_batch" the mean over
    half of each batch."""
    want = reference(cell, seed, out, device)
    return {"fp8": compare(reference(cell, seed, out, device, precision="fp8"), want),
            "half_batch": compare(reference(cell, seed, out, device, half_batch=True), want)}


def end_to_end(stats: dict) -> dict:
    return {"train_clips_per_s": (stats["clips"] / stats["window_s"], "clips/s"),
            "train_peak_mem_gib": (stats["memory_peak_bytes"] / 2 ** 30, "GiB")}

"""Optimizers and learning-rate schedulers by their YAML names (counterpart
of pytorch_ddp_resnet_tpu/utils/optim.py).

The YAML keys are torch class names and kwargs. The JAX package
reimplements each torch rule and checks it step for step against torch;
the port uses the torch classes themselves:

- ``get_optimizer(name, args)`` -> ``Optimizer``, whose ``init(params)``
  builds the ``torch.optim`` instance and whose ``update(opt, lr)`` sets
  the step's learning rate on every param group and steps, so the train
  step takes ``lr`` as the JAX step does.
- ``get_scheduler(name, args, base_lr)`` -> a host-side scheduler
  (``step``, ``get_lr``, ``last_epoch``), backed by the
  ``torch.optim.lr_scheduler`` class of that name on an optimizer of its
  own that holds one dummy parameter. The caller steps it per batch or per
  epoch (``scheduler_step_unit``).

Schedulers whose JAX version goes beyond the torch class's constructor
(LambdaLR's expression strings, plateau with the loss, cycled momentum,
warm restarts) raise NotImplementedError until ROADMAP.md Queue 1 item 2
ports them.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, Optional

import torch

NOT_PORTED = ("not ported yet (ROADMAP.md Queue 1 item 2, optimizers and "
              "schedulers)")

_OPTIMIZERS = ("SGD", "Adam", "AdamW", "RMSprop", "Adagrad", "NAdam",
               "Adadelta", "Adamax", "RAdam", "Rprop", "ASGD")
_SCHEDULERS = ("MultiStepLR", "StepLR", "ExponentialLR", "CosineAnnealingLR",
               "LinearLR", "ConstantLR")
_SCHEDULERS_NOT_PORTED = ("ReduceLROnPlateau", "LambdaLR", "OneCycleLR",
                          "CyclicLR", "CosineAnnealingWarmRestarts")


class Optimizer:
    """A torch optimizer class with its YAML kwargs, built per model."""

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = dict(args)
        self.cls = getattr(torch.optim, name)
        if name == "SGD" and self.args.get("nesterov") and (
                self.args.get("momentum", 0) <= 0
                or self.args.get("dampening", 0) != 0):
            raise ValueError("Nesterov momentum requires momentum > 0 and "
                             "zero dampening.")

    def init(self, params: Iterable[torch.nn.Parameter]
             ) -> torch.optim.Optimizer:
        args = dict(self.args)
        args.setdefault("lr", 0.0)  # the live rate is set per step
        return self.cls(params, **args)

    @staticmethod
    def update(opt: torch.optim.Optimizer, lr: float) -> None:
        """One optimizer step at this step's rate."""
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()


def get_optimizer(optimizer_cls_name: str,
                  optimizer_args: Optional[Dict[str, Any]] = None
                  ) -> Optimizer:
    if optimizer_cls_name not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {optimizer_cls_name!r}; "
                         f"available: {sorted(_OPTIMIZERS)}")
    return Optimizer(optimizer_cls_name, optimizer_args or {})


def base_lr_of(optimizer_args: Optional[Dict[str, Any]]) -> float:
    if not optimizer_args or "lr" not in optimizer_args:
        raise ValueError("optimizer_args must carry an 'lr' key.")
    return float(optimizer_args["lr"])


class LRScheduler:
    """A torch scheduler driven on its own one-parameter optimizer; its
    rate is read back for the real optimizer's next step."""

    def __init__(self, name: str, base_lr: float, args: Dict[str, Any]):
        self.base_lr = float(base_lr)
        self._holder = torch.optim.SGD(
            [torch.nn.Parameter(torch.zeros(1))], lr=self.base_lr)
        self._sched = getattr(torch.optim.lr_scheduler, name)(
            self._holder, **args)

    @property
    def last_epoch(self) -> int:
        return self._sched.last_epoch

    def step(self) -> None:
        with warnings.catch_warnings():
            # the holder optimizer never steps; torch warns about that order
            warnings.simplefilter("ignore", UserWarning)
            self._sched.step()

    def get_lr(self) -> float:
        return float(self._holder.param_groups[0]["lr"])


def get_scheduler(scheduler_cls_name: Optional[str],
                  scheduler_args: Optional[Dict[str, Any]],
                  base_lr: float) -> Optional[LRScheduler]:
    """Name+kwargs factory; 'None' disables. A ``base_lr`` key inside
    ``scheduler_args`` overrides the optimizer's lr."""
    if scheduler_cls_name in (None, "None"):
        return None
    if scheduler_cls_name in _SCHEDULERS_NOT_PORTED:
        raise NotImplementedError(f"{scheduler_cls_name}: {NOT_PORTED}")
    if scheduler_cls_name not in _SCHEDULERS:
        raise ValueError(
            f"Unknown scheduler {scheduler_cls_name!r}; available: "
            f"{sorted(_SCHEDULERS + _SCHEDULERS_NOT_PORTED)} or 'None'")
    args = dict(scheduler_args or {})
    base_lr = float(args.pop("base_lr", base_lr))
    return LRScheduler(scheduler_cls_name, base_lr, args)

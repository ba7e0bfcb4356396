"""Train-step factories (counterpart of pytorch_ddp_resnet_tpu/algos/
steps.py).

The train state is a dict with the JAX keys. Its tensors are the live
ones of the model and the optimizer, and a step updates them in place:

    {"params": {name: Parameter}, "model_state": {name: buffer},
     "opt_state": torch.optim.Optimizer}

A step takes ``x`` of shape (M, mb, ...): M microbatches, each augmented
on the device, run forward and backward with its gradients summed into
``.grad`` (``grad_reduction='sum'``, the reference's repeated
``loss.backward()``; ``'mean'`` divides by M), then one optimizer update
at the step's ``lr``. Randomness follows the JAX key chain: with M > 1
microbatch i uses ``key.fold_in(i)``; the augmentation draws from
``fold_in(·, 0)`` and the model from ``fold_in(·, 1)``. Metrics are
averaged over the microbatches and stay on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from pytorch_ddp_resnet_tpu_torch.ops.metrics import (
    compute_losses_and_metrics,
)


def init_train_state(model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """The model's own (already initialized) tensors and a new optimizer
    over its parameters."""
    return {
        "params": dict(model.named_parameters()),
        "model_state": dict(model.named_buffers()),
        "opt_state": optimizer.init(model.parameters()),
    }


def make_train_step(model: torch.nn.Module, optimizer,
                    num_microbatches: int = 1,
                    augment_fn: Optional[Callable] = None,
                    grad_reduction: str = "sum") -> Callable:
    """``train_step(train_state, x, y, lr, key) -> (train_state, metrics)``.
    augment_fn: ``(x_raw, key) -> x_float``, applied per microbatch."""
    if grad_reduction not in ("sum", "mean"):
        raise ValueError("grad_reduction must be 'sum' or 'mean'.")

    def train_step(train_state, x, y, lr, key):
        opt = train_state["opt_state"]
        model.train()
        opt.zero_grad(set_to_none=True)
        m = x.shape[0]
        if m != num_microbatches:
            raise ValueError(f"x carries {m} microbatches, the step was "
                             f"built for {num_microbatches}")
        per_mb = []
        for i in range(m):
            k = key if m == 1 else key.fold_in(i)
            xm = x[i]
            if augment_fn is not None:
                xm = augment_fn(xm, k.fold_in(0))
            logits = model(xm, key=k.fold_in(1))
            metrics = compute_losses_and_metrics(logits, y[i])
            metrics["loss"].backward()
            per_mb.append({n: v.detach() for n, v in metrics.items()})
        if grad_reduction == "mean" and m > 1:
            for p in train_state["params"].values():
                if p.grad is not None:
                    p.grad.div_(m)
        optimizer.update(opt, lr)
        metrics = {n: torch.stack([d[n] for d in per_mb]).mean()
                   for n in per_mb[0]}
        return train_state, metrics

    return train_step


def make_chunked_train_step(bound_step: Callable, root_key) -> Callable:
    """Run a pipeline-bound step over K staged feeds
    (``steps_per_dispatch``) as a plain loop. Step j's key is
    ``root_key.fold_in(step0 + j)``, the key the unchunked loop uses, and
    the per-step rates arrive as a length-K sequence, so the trajectory
    does not depend on K. (One dispatch per chunk, with CUDA graphs, waits
    for ROADMAP.md Queue 1 item 11.)

    bound_step: ``(ts, *feed, lr, key) -> (ts, metrics)``. Returns
    ``chunk_step(ts, feeds, lrs, step0) -> (ts, stacked_metrics)`` where
    each array of ``feeds`` has leading dim K."""

    def chunk_step(train_state, feeds, lrs, step0: int):
        per_step = []
        for j, lr in enumerate(lrs):
            feed = tuple(f[j] for f in feeds)
            train_state, m = bound_step(train_state, *feed, lr,
                                        root_key.fold_in(step0 + j))
            per_step.append(m)
        stacked = {n: torch.stack([m[n] for m in per_step])
                   for n in per_step[0]}
        return train_state, stacked

    return chunk_step

"""Carry weights from the JAX package to the port.

The JAX package keeps a model's weights as two pytrees of arrays,
``params`` and ``model_state``, keyed by the spine's layer names
('00_conv', '01_stack' -> 'block0' -> 'conv1', ...). The port's modules
carry the same names, so a pytree key path maps to a ``state_dict`` key by
joining with '.' and renaming the leaf:

    conv  w [K, K, Cin, Cout] (HWIO) -> weight [Cout, Cin, K, K] (OIHW)
    dense w [in, out]                -> weight [out, in]
    b                                -> bias
    BN scale, bias, mean, var, count -> the same names, one to one

``load_jax_train_state`` carries a whole JAX train state (``params``,
``model_state`` with the BN counts, and SGD's ``opt_state``: ``step`` and
the momentum buffers ``buf``, a pytree shaped like ``params``) into the
port's model and ``torch.optim.SGD``, so both packages take the same next
step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from pytorch_ddp_resnet_tpu_torch.utils.types import PyTree, StateDict


def _leaves(tree: PyTree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _convert_leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "w":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"unexpected weight rank {value.ndim}")
    if name == "b":
        return "bias", value
    return name, value


def state_dict_from_jax(params: PyTree, model_state: PyTree) -> StateDict:
    """JAX ``params``/``model_state`` pytrees (arrays convertible with
    ``np.asarray``) -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, model_state):
        for path, leaf in _leaves(tree):
            name, value = _convert_leaf(path[-1], np.asarray(leaf))
            key = ".".join(path[:-1] + (name,))
            if key in out:
                raise KeyError(f"duplicate key {key!r}")
            out[key] = torch.from_numpy(np.array(value))  # own, writable copy
    return out


def load_jax_train_state(train_state: Dict[str, Any],
                         jax_state: Dict[str, Any]) -> None:
    """Copy a JAX train state into the port's train state (algos/steps.py),
    in place. SGD only: the JAX ``opt_state`` is ``{"step"[, "buf"]}``; at
    step 0 torch's SGD holds no momentum buffer yet, as the JAX rule's
    first step ``buf = d_p``."""
    params = train_state["params"]
    with torch.no_grad():
        for name, t in state_dict_from_jax(jax_state["params"],
                                           jax_state["model_state"]).items():
            dst = params.get(name, train_state["model_state"].get(name))
            if dst is None:
                raise KeyError(f"{name!r} is not in the port's model")
            dst.copy_(t)
    opt = train_state["opt_state"]
    if not isinstance(opt, torch.optim.SGD):
        raise NotImplementedError(
            f"carrying {type(opt).__name__} state from JAX is not ported "
            f"yet (ROADMAP.md Queue 1 item 4)")
    opt.state.clear()
    jopt = jax_state["opt_state"]
    if int(np.asarray(jopt["step"])) > 0 and "buf" in jopt:
        for name, buf in state_dict_from_jax(jopt["buf"], {}).items():
            p = params[name]
            opt.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype)

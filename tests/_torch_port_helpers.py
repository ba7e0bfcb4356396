"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: build a JAX model with non-trivial BatchNorm statistics and carry
its weights into the port's model, and hand the port the JAX package's
random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu_torch.convert import state_dict_from_jax
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _randomize_bn(params, state, rng):
    """Replace every BatchNorm's identity init by random statistics, so the
    eval affines are not trivial."""
    for name, p in params.items():
        if not isinstance(p, dict):
            continue
        s = state.get(name, {})
        if "scale" in p and "mean" in s:
            c = p["scale"].shape[0]
            p["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            p["bias"] = jnp.asarray(rng.normal(0, 0.2, c), jnp.float32)
            s["mean"] = jnp.asarray(rng.normal(0, 0.2, c), jnp.float32)
            s["var"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
        else:
            _randomize_bn(p, s, rng)


def jax_model(spec, preact, use_proj, dtype="bfloat16", hw=8, seed=0):
    """(JAX model, params, state) with randomized BatchNorms."""
    model = JaxResNet(spec, preact=preact, use_proj=use_proj,
                      dropout_prob=0.0, compute_dtype=DTYPES[dtype][0])
    params, state = model.init(jax.random.PRNGKey(seed), (hw, hw, 3))
    params = jax.tree_util.tree_map(lambda a: a, params)  # fresh dicts
    state = jax.tree_util.tree_map(lambda a: a, state)
    _randomize_bn(params, state, np.random.default_rng(seed + 100))
    return model, params, state


def port_model(spec, preact, use_proj, params, state, dtype="bfloat16"):
    """The port's model on the CPU carrying the JAX weights."""
    model = ResNet(spec, preact, use_proj, 0.0,
                   compute_dtype=DTYPES[dtype][1], device="cpu")
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def images(n, hw=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


class JaxKey:
    """Stands in for the port's ``Key`` (utils/rng.py) and answers with the
    JAX package's draws: ``fold_in`` and ``split`` follow the JAX key
    chain, and each draw is the ``jax.random`` call the JAX code makes at
    that point. So the port, given ``JaxKey(k)`` where JAX was given ``k``,
    sees the same dropout bits, crop corners and flips."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def split(self, num=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def bits(self, shape, device):
        return torch.from_numpy(np.array(jax.random.bits(
            self.key, tuple(shape), jnp.uint8))).to(device)

    def dropout_seed(self, device):
        """The in-kernel dropout seed JAX draws (``blocks.py``
        ``_dropout_bits``): 32 random bits bitcast to int32."""
        return torch.tensor(int(jax.lax.bitcast_convert_type(
            jax.random.bits(self.key, (), jnp.uint32), jnp.int32)),
            dtype=torch.int32, device=device)

    def randint(self, shape, low, high, device):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, tuple(shape), low, high), np.int32)).to(device)

    def bernoulli(self, p, shape, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            self.key, p, tuple(shape)))).to(device)

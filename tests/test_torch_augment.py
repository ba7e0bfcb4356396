"""The port's training data path against the JAX package: the fused
gather+augment (ops/cuda/augment.py) against ``pallas_augment`` in
interpret mode, the pattern match that selects it, the stochastic
transforms and their fitting, the epoch sampler and the synthetic dataset.

Tolerances: the fused augment is bit-equal in bf16 (same f32 operations in
the same order, one rounding to bf16); the transform chain agrees to 1e-6
in f32 with the same draws (the same f32 operations; only XLA's and
torch's reductions differ in the fitted statistics, by ~1e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.data import datasets as jds
from pytorch_ddp_resnet_tpu.data import pipeline as jpipe
from pytorch_ddp_resnet_tpu.data import transforms as jtr
from pytorch_ddp_resnet_tpu.ops.pallas import augment as jaug
from pytorch_ddp_resnet_tpu_torch.data import datasets as tds
from pytorch_ddp_resnet_tpu_torch.data import pipeline as tpipe
from pytorch_ddp_resnet_tpu_torch.data import transforms as ttr
from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment as taug

from _torch_port_helpers import JaxKey

H = W = 16
C = 3
N = 32
B = 8
CPU = torch.device("cpu")


def _dataset(n=N, h=H, w=W):
    return np.random.default_rng(0).integers(0, 256, (n, h, w, C),
                                             dtype=np.uint8)


def _stats():
    rng = np.random.default_rng(1)
    return (rng.uniform(0.3, 0.7, (H, W, C)).astype(np.float32),
            rng.uniform(0.2, 0.5, (H, W, C)).astype(np.float32))


def _bf16_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("pad,crop", [(2, 16), (4, 12)])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_plain_augment_bit_equal_to_pallas(pad, crop, mirror, whiten):
    ds = _dataset()
    mean, std = _stats() if whiten else (np.zeros((H, W, C), np.float32),
                                         np.ones((H, W, C), np.float32))
    rng = np.random.default_rng(2)
    idx = rng.integers(0, N, B).astype(np.int32)
    top = rng.integers(0, H + 2 * pad - crop + 1, B).astype(np.int32)
    left = rng.integers(0, W + 2 * pad - crop + 1, B).astype(np.int32)
    flip = rng.integers(0, 2, B).astype(np.int32)
    inv_std = np.float32(1.0) / std
    out = jaug.pallas_augment(
        jnp.asarray(jaug.to_chw_planar(ds)), jnp.asarray(idx),
        jnp.asarray(top), jnp.asarray(left), jnp.asarray(flip),
        jnp.asarray(jaug.to_chw_planar(mean[None])[0]),
        jnp.asarray(jaug.to_chw_planar(inv_std[None])[0]),
        h=H, w=W, c=C, pad=pad, crop=crop, mirror=mirror, interpret=True)
    want = np.asarray(jaug.chw_planar_to_nhwc(out, C).astype(jnp.float32))
    got = taug.augment_batch(
        torch.from_numpy(ds), *(torch.from_numpy(a) for a in (
            idx, top, left, flip, mean, inv_std)),
        pad=pad, crop=crop, mirror=mirror)
    assert got.dtype == torch.bfloat16 and got.shape == (B, crop, crop, C)
    np.testing.assert_array_equal(_bf16_np(got), want)
    assert taug.launches["augment_batch"] == 0  # the CPU runs the plain one


def test_reference_rounds_once():
    """Why the port rounds ``x * (1/255) - mean`` once: the JAX kernel, as
    the tests run it on the CPU, does (XLA contracts the two into an FMA),
    and two f32 roundings give other bf16 outputs somewhere in a batch."""
    ds = _dataset()
    mean, std = _stats()
    idx = np.arange(N, dtype=np.int32)
    zeros = np.zeros(N, np.int32)
    inv_std = np.float32(1.0) / std
    out = jaug.pallas_augment(
        jnp.asarray(jaug.to_chw_planar(ds)), jnp.asarray(idx),
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(zeros),
        jnp.asarray(jaug.to_chw_planar(mean[None])[0]),
        jnp.asarray(jaug.to_chw_planar(inv_std[None])[0]),
        h=H, w=W, c=C, pad=0, crop=H, mirror=False, interpret=True)
    want = np.asarray(jaug.chw_planar_to_nhwc(out, C).astype(jnp.float32))
    x = ds.astype(np.float32) * np.float32(taug.INV_255)
    twice = torch.from_numpy((x - mean) * inv_std).to(torch.bfloat16)
    assert not np.array_equal(_bf16_np(twice), want)
    once = taug.augment_batch_plain(
        torch.from_numpy(ds), *(torch.from_numpy(a) for a in (
            idx, zeros, zeros, zeros, mean, inv_std)),
        pad=0, crop=H, mirror=False)
    np.testing.assert_array_equal(_bf16_np(once), want)


@pytest.mark.parametrize("mirror", [False, True])
def test_fused_augment_draws_match_jax(mirror):
    """make_pallas_augment_fn: the same key gives the same batch (the
    split(3) into top, left and flip)."""
    ds = _dataset()
    mean, std = _stats()
    jfn = jaug.make_pallas_augment_fn(ds, mean, std, flip_p=0.5, pad=2,
                                      crop=16, mirror=mirror, interpret=True)
    tfn = taug.make_pallas_augment_fn(ds, mean, std, flip_p=0.5, pad=2,
                                      crop=16, mirror=mirror, device=CPU)
    idx = np.arange(B, dtype=np.int32) * 3 % N
    key = jax.random.key(5)
    want = np.asarray(jfn(jnp.asarray(idx), key).astype(jnp.float32))
    got = tfn(torch.from_numpy(idx), JaxKey(key))
    np.testing.assert_array_equal(_bf16_np(got), want)


AUG_TRAIN = {"ToTensorTransform": {}, "StandardizeWhiteningTransform": {},
             "FlipTransform": {"p": 0.5},
             "PaddingTransform": {"pad_size": 2, "pad_type": "mirror"},
             "RandomCropTransform": {"crop_size": 16}}

PIPELINES = [
    ("standard", AUG_TRAIN, (H, W)),
    ("zero-mean, zero pad", {"ToTensorTransform": {},
                             "ZeroMeanWhiteningTransform": {},
                             "PaddingTransform": {"pad_size": 2,
                                                  "pad_type": "zero"},
                             "RandomCropTransform": {"crop_size": 12}},
     (H, W)),
    ("no whitening", {"ToTensorTransform": {}, "FlipTransform": {"p": 0.3}},
     (H, W)),
    ("to-tensor only", {"ToTensorTransform": {}}, (H, W)),
    ("no to-tensor", {"FlipTransform": {"p": 0.5}}, (H, W)),
    ("flip after crop", {"ToTensorTransform": {},
                         "RandomCropTransform": {"crop_size": 12},
                         "FlipTransform": {"p": 0.5}}, (H, W)),
    ("whitening after flip", {"ToTensorTransform": {},
                              "FlipTransform": {"p": 0.5},
                              "StandardizeWhiteningTransform": {}}, (H, W)),
    ("not square", AUG_TRAIN, (H, W + 4)),
]


@pytest.mark.parametrize("name,aug,hw", PIPELINES,
                         ids=[p[0] for p in PIPELINES])
def test_try_from_transforms_matches_jax(tmp_path, name, aug, hw):
    x = _dataset(h=hw[0], w=hw[1])
    y = np.zeros(N, np.int32)
    jt = jpipe.build_transforms(jds.ArrayDataset(x, y, 10), aug,
                                str(tmp_path / "jax"), is_train=True)
    tt = tpipe.build_transforms(tds.ArrayDataset(x, y, 10), aug,
                                str(tmp_path / "port"), is_train=True)
    jf = jaug.try_from_transforms(jt, x, interpret=True)
    tf = taug.try_from_transforms(tt, torch.from_numpy(x), CPU)
    assert (jf is None) == (tf is None)


def test_transform_chain_and_fit_match_jax(tmp_path):
    """build_transforms fits Standardize like JAX, saves the same file, and
    the chain with the same draws gives the same batch."""
    x, y = _dataset(n=64), np.zeros(64, np.int32)
    jt = jpipe.build_transforms(jds.ArrayDataset(x, y, 10), AUG_TRAIN,
                                str(tmp_path / "jax"), is_train=True,
                                fit_chunk=24)
    tt = tpipe.build_transforms(tds.ArrayDataset(x, y, 10), AUG_TRAIN,
                                str(tmp_path / "port"), is_train=True,
                                fit_chunk=24)
    js, ts = (jt["StandardizeWhiteningTransform"],
              tt["StandardizeWhiteningTransform"])
    np.testing.assert_allclose(ts.mean.numpy(), js.mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.stddev.numpy(), js.stddev, rtol=0,
                               atol=1e-6)
    name = "standardizewhiteningtransform_1.ckpt"
    with np.load(tmp_path / "jax" / name) as a, \
            np.load(tmp_path / "port" / name) as b:
        assert sorted(a.files) == sorted(b.files)
    # a fitted checkpoint is loaded, not refitted
    again = tpipe.build_transforms(tds.ArrayDataset(x, y, 10), AUG_TRAIN,
                                   str(tmp_path / "port"), is_train=True)
    assert torch.equal(again["StandardizeWhiteningTransform"].mean, ts.mean)

    key = jax.random.key(3)
    want = jtr.make_batch_augment_fn(list(jt.values()))(
        jnp.asarray(x[:B]), key)
    got = ttr.make_batch_augment_fn(list(tt.values()))(
        torch.from_numpy(x[:B]), JaxKey(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_explicit_draws():
    x = torch.arange(2 * 4 * 4 * 1, dtype=torch.float32).reshape(2, 4, 4, 1)
    flip = ttr.FlipTransform((4, 4, 1), p=0.5).apply_batch(
        x, flip=torch.tensor([True, False]))
    assert torch.equal(flip[0], x[0].flip(1)) and torch.equal(flip[1], x[1])
    crop = ttr.RandomCropTransform((4, 4, 1), 2).apply_batch(
        x, tops=torch.tensor([0, 2]), lefts=torch.tensor([1, 0]))
    assert torch.equal(crop[0], x[0, 0:2, 1:3])
    assert torch.equal(crop[1], x[1, 2:4, 0:2])
    with pytest.raises(ValueError, match="needs a key"):
        ttr.make_batch_augment_fn([ttr.FlipTransform((4, 4, 1), 0.5)])(x)


@pytest.mark.parametrize("n,batch,m,seed", [(50, 8, 1, 0), (37, 16, 2, 3),
                                            (5, 8, 4, 1)])
def test_epoch_sampler_matches_jax(n, batch, m, seed):
    js = jpipe.EpochSampler(n, batch, m, seed=seed)
    ts = tpipe.EpochSampler(n, batch, m, seed=seed)
    for epoch in (0, 1, 7):
        np.testing.assert_array_equal(ts.epoch_indices(epoch),
                                      js.epoch_indices(epoch))


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_spectral_bit_equal_to_jax(tmp_path, train):
    kw = dict(n_train=48, n_test=24, class_sep=0.3)
    a = jds.load_synthetic_spectral(str(tmp_path / "j"), train, **kw)
    b = tds.load_synthetic_spectral(str(tmp_path / "t"), train, **kw)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    # both write the same cache file name
    def npz(d):
        return [f for f in os.listdir(d) if f.endswith(".npz")]

    assert npz(tmp_path / "j") == npz(tmp_path / "t")

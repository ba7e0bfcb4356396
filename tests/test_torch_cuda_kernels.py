"""Card-only tests of the port's CUDA kernels (ops/cuda/conv3x3.py and
ops/cuda/augment.py): each kernel against its plain PyTorch version on the
same CUDA tensors.

Marked ``cuda``; without a card every test skips (decided in the fixture,
never at import). Run them on the machine with the card (no JAX there, so
without the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the s32 accumulator is exact in both versions, and the
epilogues use the same f32 operations in the same order, so int8 outputs
agree exactly except where a value lands on a rounding tie after a
different float contraction (allowed: 1 level on <= 0.1% of elements);
the bf16 conv sums in f32 in another order than the float64 plain
version, so outputs may differ by 1 bf16 ulp (2^-8 relative) on a small
share of elements. The augment kernel rounds exactly where its plain
version does (one FMA, one multiply, one bf16 rounding): bit-equal.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment as aug
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = [(32, 32, 8, 8, 2), (64, 96, 8, 8, 4), (32, 64, 6, 6, 3),
          (160, 160, 32, 32, 2),
          (320, 320, 16, 16, 4), (640, 640, 8, 8, 8)]


def _inputs(cin, cout, h, w, b, seed=0):
    rng = np.random.default_rng(seed)
    n = b * h * w
    xq = torch.from_numpy(rng.integers(-127, 128, (cin, n), dtype=np.int8))
    wq = torch.from_numpy(
        rng.integers(-127, 128, (cout, 9 * cin), dtype=np.int8))
    xf = torch.from_numpy(rng.standard_normal((cin, n), dtype=np.float32))
    wf = torch.from_numpy(
        rng.standard_normal((cout, 9 * cin), dtype=np.float32) * 0.05)
    vec = lambda s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(cout) * s).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((cout, n), dtype=np.float32))
    return xq, wq, xf, wf, vec, res


@pytest.mark.parametrize("cin,cout,h,w,b", SHAPES)
def test_bf16_kernel_matches_plain(dev, cin, cout, h, w, b):
    _, _, xf, wf, _, _ = _inputs(cin, cout, h, w, b)
    x = xf.to(dev, torch.bfloat16)
    wp = wf.to(dev, torch.bfloat16)
    got = k.conv3x3_bf16(x, wp, h=h, w_img=w).float()
    ref = k.conv3x3_bf16_plain(x, wp, h=h, w_img=w).float()
    torch.cuda.synchronize()
    ulp = ref.abs().clamp_min(1e-30) * 2.0 ** -7
    bad = (got - ref).abs() > ulp
    assert bad.float().mean().item() < 1e-3


@pytest.mark.parametrize("cin,cout,h,w,b", SHAPES)
@pytest.mark.parametrize("mode", ["int8", "bf16", "bf16+res", "dual"])
def test_requant_kernel_matches_plain(dev, cin, cout, h, w, b, mode):
    xq, wq, _, _, vec, res = _inputs(cin, cout, h, w, b, seed=1)
    xq, wq = xq.to(dev), wq.to(dev)
    scale = (vec(1.0).abs() * 1e-5).to(dev)
    shift = vec(0.5).to(dev)
    kw = dict(h=h, w_img=w, relu=mode != "bf16")
    args = [xq, wq, scale, shift]
    if mode in ("bf16+res", "dual"):
        args.append(res.to(dev, torch.bfloat16))
    if mode == "dual":
        args.append((vec(30.0).to(dev), vec(3.0).to(dev)))
    if mode == "int8":
        kw["inv_out_scale"] = 1.0 / 0.05
    before = k.launches["conv3x3_int8_requant"]
    got = k.conv3x3_int8_requant(*args, **kw)
    ref = k.conv3x3_int8_requant_plain(*args, **kw)
    torch.cuda.synchronize()
    assert k.launches["conv3x3_int8_requant"] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        d = (g.float() - r.float()).abs()
        if g.dtype == torch.int8:
            assert d.max().item() <= 1
            assert (d > 0).float().mean().item() <= 1e-3
        else:
            assert torch.equal(g, r), d.max().item()


def test_cuda_tensor_never_falls_back(dev):
    x = torch.zeros((16, 128), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((16, 9 * 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        k.conv3x3_bf16(x, w, h=8, w_img=8)


def _augment_inputs(dev, b, n=600, hw=32, c=3, pad=4, crop=32, seed=0):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, c),
                                         dtype=np.uint8)).to(dev)
    corner = hw + 2 * pad - crop + 1
    draws = [rng.integers(0, n, b), rng.integers(0, corner, b),
             rng.integers(0, corner, b), rng.integers(0, 2, b)]
    idx, top, left, flip = (torch.from_numpy(d.astype(np.int32)).to(dev)
                            for d in draws)
    mean = torch.from_numpy(rng.uniform(0.3, 0.7, (hw, hw, c)).astype(
        np.float32)).to(dev)
    std = rng.uniform(0.2, 0.3, (hw, hw, c)).astype(np.float32)
    inv_std = torch.from_numpy(np.float32(1.0) / std).to(dev)
    return data, idx, top, left, flip, mean, inv_std


@pytest.mark.parametrize("b", [128, 512])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_augment_kernel_matches_plain(dev, b, mirror, whiten):
    data, idx, top, left, flip, mean, inv_std = _augment_inputs(dev, b)
    if not whiten:
        mean, inv_std = torch.zeros_like(mean), torch.ones_like(inv_std)
    kw = dict(pad=4, crop=32, mirror=mirror)
    before = aug.launches["augment_batch"]
    got = aug.augment_batch(data, idx, top, left, flip, mean, inv_std, **kw)
    ref = aug.augment_batch_plain(data, idx, top, left, flip, mean, inv_std,
                                  **kw)
    torch.cuda.synchronize()
    assert aug.launches["augment_batch"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 32, 32, 3)
    assert torch.equal(got, ref)


def test_fused_augment_draws_on_the_card(dev):
    data, *_ = _augment_inputs(dev, 8)
    std = np.full((32, 32, 3), 0.25, np.float32)
    fused = aug.make_pallas_augment_fn(data, np.zeros_like(std), std, 0.5, 4,
                                       28, True, device=dev)
    idx = torch.arange(64, device=dev, dtype=torch.int32)
    got = fused(idx, Key(3))
    assert torch.equal(got, fused(idx, Key(3), fn=aug.augment_batch_plain))
    assert not torch.equal(got, fused(idx, Key(4)))


def test_augment_cuda_tensor_never_falls_back(dev):
    data, idx, top, left, flip, mean, inv_std = _augment_inputs(dev, 8)
    with pytest.raises(ValueError, match="int32"):
        aug.augment_batch(data, idx.long(), top, left, flip, mean, inv_std,
                          pad=4, crop=32, mirror=True)

"""Card-only tests of the port's CUDA kernels (ops/cuda/conv3x3.py): each
kernel against its plain PyTorch version on the same CUDA tensors.

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
share of elements.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

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

"""The port's differentiable 3x3 conv of the ``use_pallas_conv`` flag
(ops/cuda/conv3x3.py ``conv3x3_same``, ``conv3x3_wgrad``,
``pack_weights_dgrad``) against the JAX package's ``conv3x3_same`` and
``conv3x3_wgrad_lanes`` with ``interpret=True``, as
tests/test_pallas_conv.py runs them; the flag's gates layer for layer;
one whole train step through ``make_train_step``; and ``setup``.

Tolerances: in f32 the value and both gradients agree to 1e-4 (the
reference sums in f32, the plain versions in float64). In bf16 the value,
dx and dW (after dW's bf16 rounding, which both packages make in the
VJP) may differ by at most 2 bf16 ulps of the tensor's largest value: a
sum that lies at a bf16 rounding boundary may round the other way. The
train step is held as in tests/test_torch_qat_train.py: within twice the
JAX step's own distance from the exact f32 step, plus 1e-3 of the
tensor's norm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_ddp_resnet_tpu.algos import steps as jsteps
from pytorch_ddp_resnet_tpu.models.layers import Conv as JaxConv
from pytorch_ddp_resnet_tpu.models.layers import Sequential as JaxSequential
from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu.ops.pallas import conv as jconv
from pytorch_ddp_resnet_tpu.utils import optim as joptim
from pytorch_ddp_resnet_tpu_torch.algos.steps import (
    init_train_state,
    make_train_step,
)
from pytorch_ddp_resnet_tpu_torch.algos.train import setup
from pytorch_ddp_resnet_tpu_torch.convert import (
    load_jax_train_state,
    state_dict_from_jax,
)
from pytorch_ddp_resnet_tpu_torch.models.blocks import check_unported_flags
from pytorch_ddp_resnet_tpu_torch.models.layers import Conv
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

from _torch_port_helpers import JaxKey

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "models_dir",
                      "wrn-28-10-dropout_synthspectral-hard", "config.yaml")


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, dtype, name):
    """f32: 1e-4; bf16: 2 ulps of the tensor's largest value."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 2 * ulp, name


# --- the op --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 8, 16, 32, 48),     # multi-image tile, non-square, cin != cout
    (1, 8, 16, 16, 16),     # single image; padded to 32 channels
    (4, 8, 16, 160, 32),    # WRN stage-1 width
])
def test_conv3x3_same_matches_jax(dtype, b, h, w, cin, cout):
    """Value, dx and dW of the port's op against JAX's custom VJP on the
    same inputs."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, cin))
    w_hwio = rng.normal(size=(3, 3, cin, cout)) * 0.1
    dy = rng.normal(size=(b, h, w, cout))
    y, vjp = jax.vjp(lambda a, c: jconv.conv3x3_same(a, c, True),
                     jnp.asarray(x, jd), jnp.asarray(w_hwio, jd))
    jdx, jdw = vjp(jnp.asarray(dy, jd))

    xt = _t(x, td).requires_grad_()
    wt = _t(w_hwio.transpose(3, 2, 0, 1), td).requires_grad_()
    yt = k.conv3x3_same(xt, wt)
    yt.backward(_t(dy, td))
    assert yt.dtype == xt.grad.dtype == wt.grad.dtype == td
    _close(_np(yt.detach().float()), _np(y), dtype, "y")
    _close(_np(xt.grad.float()), _np(jdx), dtype, "dx")
    _close(_np(wt.grad.float().permute(2, 3, 1, 0)), _np(jdw), dtype, "dw")
    assert not k.launches  # CPU: plain versions only


@pytest.mark.parametrize("cin,cout", [(32, 48), (160, 32)])
def test_wgrad_plain_matches_jax(cin, cout):
    """``conv3x3_wgrad`` on the CPU (its plain version), HWIO [3, 3, Cin,
    Cout] as JAX's ``conv3x3_wgrad_lanes`` returns it, against that in
    f32."""
    rng = np.random.default_rng(2)
    b, h, w = 2, 8, 16
    x_cs = rng.normal(size=(cin, b * h * w)).astype(np.float32)
    dy_cs = rng.normal(size=(cout, b * h * w)).astype(np.float32)
    want = jconv.conv3x3_wgrad_lanes(jnp.asarray(x_cs), jnp.asarray(dy_cs),
                                     h=h, w_img=w, interpret=True)
    got = k.conv3x3_wgrad(torch.from_numpy(x_cs), torch.from_numpy(dy_cs),
                          h=h, w_img=w)
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_dgrad_packing_matches_jax():
    """rot180 with in/out swapped, at Cin != Cout (a transposition that
    square widths would hide)."""
    rng = np.random.default_rng(3)
    w_hwio = rng.normal(size=(3, 3, 24, 40)).astype(np.float32)
    want = np.asarray(jconv.pack_weights_dgrad(jnp.asarray(w_hwio)))
    got = k.pack_weights_dgrad(torch.from_numpy(
        w_hwio.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (24, 9 * 40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,h,w,c,admitted", [
    (2, 56, 56, 64, False),   # ResNet-50 stage 1: 6272-lane tile
    (8, 28, 28, 128, False),  # ResNet-50 stage 2
    (2, 32, 32, 160, True),   # WRN-28-10 stage 1
    (4, 24, 24, 16, True),    # a width and geometry JAX admits
])
def test_tile_picker_refuses_as_jax(b, h, w, c, admitted):
    """The JAX op raises ValueError from its lane-tile picker for the
    ImageNet geometries; the port raises the same from its copy, before
    any compute, and admits what JAX admits."""
    x = np.zeros((b, h, w, c), np.float32)
    w_hwio = np.zeros((3, 3, c, c), np.float32)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    if admitted:
        jconv._pick_tile(h * w, b * h * w, c)
        assert k.conv3x3_same(xt, wt).shape == (b, h, w, c)
        return
    with pytest.raises(ValueError, match="VMEM") as jerr:
        jconv.conv3x3_same(jnp.asarray(x), jnp.asarray(w_hwio), True)
    with pytest.raises(ValueError, match="VMEM") as terr:
        k.conv3x3_same(xt, wt)
    assert str(terr.value).split(" (")[0] in str(jerr.value)


@pytest.mark.parametrize("b,h,w,c,card", [
    (128, 32, 32, 160, True), (128, 16, 16, 320, True),
    (128, 8, 8, 640, True),   # WRN-28-10
    (128, 32, 32, 16, True), (128, 16, 16, 32, True),
    (128, 8, 8, 64, True),    # ResNet-v1-20
    (32, 64, 64, 64, True),   # rows of 64: one K step a row
    (32, 24, 24, 64, False),  # rows of 24: no whole rows in a K step
    (64, 12, 12, 64, False),  # rows of 12 likewise
])
def test_card_geometry_gap_is_named(b, h, w, c, card):
    """Geometries the JAX tile picker admits: the card's wgrad kernel
    takes the shipped ones and 64x64, and raises, naming the shape, for
    the others (ROADMAP Queue 3 item 6); it never computes something
    else."""
    jconv._pick_tile(h * w, b * h * w, c)
    n = b * h * w
    if card:
        k.check_wgrad_geometry("conv3x3_wgrad", -(-c // 32) * 32, n, h, w)
        return
    with pytest.raises(ValueError, match=f"image {h}x{w}"):
        k.check_wgrad_geometry("conv3x3_wgrad", c, n, h, w)


def test_op_refuses_mixed_dtypes_and_bad_weights():
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="weights"):
        k.conv3x3_same(x, torch.zeros(32, 16, 3, 3))
    with pytest.raises(ValueError, match="bfloat16"):
        k.conv3x3_same(x, torch.zeros(32, 32, 3, 3, dtype=torch.bfloat16))


# --- the flag in the models ------------------------------------------------------

SPECS = {
    "wrn-28-10": ("c3,160,3,1,1 r4 r4 r4 n a ap8,1,0 fc640,10", True, True),
    "resnet-v1-20": ("c3,16,3,1,1 n a r3 r3 r3 ap8,1,0 fc64,10", False,
                     False),
    "resnet-50": ("c3,64,7,2,3 n a mp3,2,1 b3,256,64,1 b4,512,128,2 "
                  "b6,1024,256,2 b3,2048,512,2 ap7,1,0 fc2048,1000", False,
                  True),
}


def _jax_convs(layers, prefix=""):
    """(dotted name, takes the kernel) of every conv of a JAX spine."""
    out = []
    for name, layer in layers:
        path = f"{prefix}{name}"
        if isinstance(layer, JaxSequential):
            out += _jax_convs(layer.layers, f"{path}.")
        elif isinstance(layer, JaxConv):
            out.append((path, layer.pallas and layer.kernel_size == 3
                        and layer.stride == 1 and layer.padding == 1))
        elif hasattr(layer, "_sublayers"):
            out += _jax_convs([(n, s) for n, s, _ in layer._sublayers()],
                              f"{path}.")
    return out


@pytest.mark.parametrize("arch", list(SPECS))
def test_conv_gates_match_jax(arch):
    """Layer for layer, the convs that take ``conv3x3_same`` under the
    flag are JAX's: the blocks' stride-1 3x3 convs, never the stem, a
    stride-2 conv or a 1x1; WRN-28-10 has 22."""
    spec, preact, proj = SPECS[arch]
    jmodel = JaxResNet(spec, preact=preact, use_proj=proj, dropout_prob=0.0,
                       pallas_conv=True)
    want = sorted(_jax_convs(jmodel.spine.layers))
    meta = ResNet(spec, preact, proj, 0.0, device="cpu", pallas_conv=True)
    got = sorted((name, m.pallas and m.kernel_size == 3 and m.stride == 1
                  and m.padding == 1)
                 for name, m in meta.named_modules() if isinstance(m, Conv))
    assert got == want
    if arch == "wrn-28-10":
        assert sum(taken for _, taken in got) == 22


def test_only_remat_is_unported():
    check_unported_flags(pallas_conv=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        check_unported_flags(remat=True)


# --- the whole step ------------------------------------------------------------

SPEC = "c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10"
SGD_ARGS = {"lr": 0.1, "momentum": 0.9, "dampening": 0.0, "nesterov": True,
            "weight_decay": 5e-4}
LR = 0.05


def _batch():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (1, 8)).astype(np.int32)
    return x, y


def _jax_train_step(**flags):
    """JAX's make_train_step from its init (bf16 with ``flags``, else the
    exact f32 step): (ts0, {loss, <state_dict name>, momentum/<name>})."""
    x, y = _batch()
    cd = jnp.bfloat16 if flags else jnp.float32
    model = JaxResNet(SPEC, preact=True, use_proj=True, dropout_prob=0.3,
                      compute_dtype=cd, **flags)
    opt = joptim.get_optimizer("SGD", SGD_ARGS)
    ts0 = jsteps.init_train_state(model, opt, jax.random.key(0), (8, 8, 3))
    ts1, metrics = jax.jit(jsteps.make_train_step(model, opt))(
        ts0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR),
        jax.random.key(2))
    out = {"loss": float(metrics["loss"])}
    for name, t in state_dict_from_jax(ts1["params"],
                                       ts1["model_state"]).items():
        out[name] = t.numpy()
    for name, t in state_dict_from_jax(ts1["opt_state"]["buf"], {}).items():
        out[f"momentum/{name}"] = t.numpy()
    return jax.device_get(ts0), out


def test_train_step_matches_jax(monkeypatch):
    """One bf16 step with ``pallas_conv`` from the JAX init, with the JAX
    draws: the three stride-1 3x3 convs of the two blocks run the op (the
    transition's stride-2 conv1 and the stem do not), and for every
    parameter, momentum buffer and BN statistic the port lies within twice
    the JAX step's own distance from the exact f32 step (plus 1e-3 of the
    tensor's norm)."""
    ts0, want = _jax_train_step(pallas_conv=True)
    exact = _jax_train_step()[1]
    x, y = _batch()
    model = ResNet(SPEC, True, True, 0.3, device="cpu", pallas_conv=True)
    opt = toptim.get_optimizer("SGD", SGD_ARGS)
    ts = init_train_state(model, opt)
    load_jax_train_state(ts, ts0)
    calls = {}
    for name in ("conv3x3_bf16_plain", "conv3x3_wgrad_plain"):
        orig = getattr(k, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(k, name, spy)
    ts, metrics = make_train_step(model, opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), LR,
        JaxKey(jax.random.key(2)))
    assert calls == {"conv3x3_bf16_plain": 6, "conv3x3_wgrad_plain": 3}
    got = {"loss": float(metrics["loss"])}
    for name, t in model.state_dict().items():
        got[name] = t.numpy()
    for name, p in ts["params"].items():
        got[f"momentum/{name}"] = (
            ts["opt_state"].state[p]["momentum_buffer"].numpy())
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= max(
        abs(want["loss"] - exact["loss"]), 1e-3)
    for name, ref in want.items():
        if name == "loss":
            continue
        if name.endswith("count"):
            assert int(got[name]) == int(ref) == 1, name
            continue
        d = np.linalg.norm(got[name].astype(np.float64) - ref)
        noise = np.linalg.norm(ref.astype(np.float64) - exact[name])
        assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[name]), name


def test_setup_trains_with_pallas_conv(tmp_path):
    """A small net of the -hard recipe with ``use_pallas_conv`` through
    setup, the pipeline and the fused augment: two steps move every
    parameter and count every BN, through the op (plain versions on the
    CPU)."""
    with open(RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg.update(use_pallas_augment=True, use_pallas_conv=True, batch_size=8,
               dataset_args={"class_sep": 0.3, "n_train": 40, "n_test": 16},
               architecture_spec="c3,32,3,1,1 r1 r1 n a ap16,1,0 fc64,10")
    run = tmp_path / "models_dir" / "run"
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    config = get_config(str(tmp_path / "models_dir"), "run",
                        data_dir=str(tmp_path / "data"), verbose=False)
    ls = setup(config, device="cpu", verbose=False)
    model = ls["model"]
    assert model.pallas_conv
    step = ls["pipeline"].bind_train_step(
        make_train_step(model, ls["optimizer"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    ts = ls["train_state"]
    before = {n: v.detach().clone() for n, v in ts["params"].items()}
    k.reset_launches()
    for gs, (_, (idx,)) in enumerate(ls["pipeline"].train_feed(0, budget=2)):
        ts, m = step(ts, idx, 0.1, Key(0).fold_in(gs))
        assert np.isfinite(float(m["loss"]))
    assert k.same_calls == {"forward": 6, "backward": 6}
    assert not k.launches  # CPU: plain versions only
    for n, v in ts["params"].items():
        assert not torch.equal(v, before[n]), n
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {2}

"""The port's fused bf16 block-half and its in-kernel dropout hash
(ops/cuda/fused_block.py ``fused_half``, ``fused_half_int8(...,
quant_bwd=False)``, ``seed_bits``) against the JAX package's
``fused_half`` / ``fused_half_int8`` with ``interpret=True`` and its
``_seed_bits``.

Tolerances: the dropout bits are bit for bit the reference's. bf16 outputs
(y, dx, dres) may differ by at most 2 bf16 ulps of the tensor's largest
value: the reference accumulates the conv in f32 in its own order, the
plain version in float64, so a sum that lies at a bf16 rounding boundary
may round the other way. f32 sums over positions (the BatchNorm statistics,
d(scale), d(shift), dW) agree to 1e-5 of their largest value: only their
order differs. The int8 forward of QAT is exact, as in
tests/test_torch_fused_block.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu.ops.pallas.conv import _pick_tile
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

SEEDS = [0, 1, -1, 12345, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2 ** 31 - 2]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _seed(s):
    return torch.tensor(s, dtype=torch.int32)


# --- the dropout hash ------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_seed_bits_match_jax(seed):
    """Bit for bit, at several lane offsets and tile widths."""
    cin, n = 48, 4096
    for lane0, tile in ((0, 4096), (0, 512), (1536, 1024), (3968, 128)):
        want = np.asarray(jfb._seed_bits(jnp.int32(seed), cin, tile, n,
                                         lane0))
        got = fb.seed_bits(_seed(seed), cin, n, lane0, tile)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_seed_bits_rebuild_one_mask_across_tilings():
    """The forward, dgrad and wgrad tiles of JAX's pickers (three different
    widths at 320 channels, 16x16, batch 32) each rebuild the same mask."""
    c, hw, n = 320, 256, 32 * 256
    tiles = {jfb._lane_tile(16, 16, n, c, c, False),
             _pick_tile(hw, n, c // 2, max_tile=4096),
             _pick_tile(hw, n, 2 * c)}
    assert len(tiles) == 3, tiles
    full = fb.seed_bits(_seed(-7), c, n, 0, n)
    assert full.float().mean().item() == pytest.approx(127.5, abs=1.0)
    for tile in tiles:
        parts = [fb.seed_bits(_seed(-7), c, n, i, tile)
                 for i in range(0, n, tile)]
        assert torch.equal(torch.cat(parts, dim=1), full), tile


def test_seed_contract_matches_jax():
    """A 0-d int32 tensor is a seed, a [C, N] tensor materialized bits;
    other scalars are refused, as JAX's ``_is_seed`` refuses them; and the
    hash's int32 index needs C * N < 2^31."""
    assert fb.is_seed(_seed(3)) and jfb._is_seed(jnp.int32(3))
    bits = torch.zeros((32, 64), dtype=torch.uint8)
    assert not fb.is_seed(bits) and not fb.is_seed(None)
    for bad, jbad in ((3, 3), (torch.tensor(3, dtype=torch.int64),
                               jnp.uint32(3))):
        with pytest.raises(ValueError):
            fb.is_seed(bad)
        with pytest.raises(ValueError):
            jfb._is_seed(jbad)
    huge = torch.zeros(1, dtype=torch.bfloat16).expand(2 ** 16, 2 ** 15)
    with pytest.raises(ValueError, match="< 2\\^31"):
        fb.fused_half(huge, torch.zeros(32, 2 ** 16, 3, 3), torch.ones(
            2 ** 16), torch.zeros(2 ** 16), _seed(1), dropout_rate=0.3,
            h=8, w_img=8)


# --- the bf16 half ---------------------------------------------------------------

C, H, W, B = 32, 8, 8, 8   # N = 512
RATE = 0.3


def _inputs(c, n, seed=0, res=True):
    """x, w (HWIO), scale, shift, bits, res as numpy (x, res bf16-valued)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa
    x = bf(rng.standard_normal((c, n)))
    wt = (rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    bits = rng.integers(0, 256, (c, n), dtype=np.uint8)
    r = bf(rng.standard_normal((c, n))) if res else None
    return x, wt, scale, shift, bits, r


def _bits(mode, bits):
    """(JAX bits, port bits) of a bits mode."""
    if mode == "none":
        return None, None
    if mode == "seed":
        return jnp.int32(-123456789), _seed(-123456789)
    return jnp.asarray(bits), torch.from_numpy(bits)


def _ulp_ok(got, want, name):
    """Within 2 bf16 ulps of the tensor's largest value."""
    scale = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got - want).max() <= 2 * ulp, name


def _sum_ok(got, want, name):
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


def _run(op, quant, mode, use_res, want_stats, seed=0):
    """Forward and backward of one half on both sides, for a loss linear in
    (y, ysum, yssq) so the cotangents are fixed inputs. Returns the JAX and
    the port's (outputs, grads)."""
    n = B * H * W
    x, wt, scale, shift, bits, res = _inputs(C, n, seed, use_res)
    rng = np.random.default_rng(seed + 1)
    cy = np.asarray(jnp.asarray(rng.standard_normal((C, n)), jnp.bfloat16),
                    np.float32)
    cs, cq = (rng.standard_normal((2, C)) * 0.01).astype(np.float32)
    rate = RATE if mode != "none" else 0.0
    jbits, tbits = _bits(mode, bits)
    kw = dict(dropout_rate=rate, h=H, w_img=W, want_stats=want_stats)
    jkw = dict(kw, interpret=True, **({"quant_bwd": False} if quant else {}))
    jop = jfb.fused_half_int8 if quant else jfb.fused_half

    def jloss(x, wt, s, t, r):
        y, ys, yq = jop(x, wt, s, t, jbits, r, **jkw)
        loss = jnp.sum(y.astype(jnp.float32) * cy)
        if want_stats:
            loss = loss + jnp.sum(ys * cs) + jnp.sum(yq * cq)
        return loss, (y, ys, yq)

    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
             jnp.asarray(scale), jnp.asarray(shift),
             None if res is None else jnp.asarray(res, jnp.bfloat16))
    argnums = (0, 1, 2, 3, 4) if use_res else (0, 1, 2, 3)
    jgrads, jout = jax.grad(jloss, argnums=argnums, has_aux=True)(*jargs)

    targs = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)), _t(scale),
             _t(shift)]
    r = None if res is None else _t(res, torch.bfloat16)
    for a in targs + ([r] if r is not None else []):
        a.requires_grad_(True)
    tkw = dict(kw, **({"quant_bwd": False} if quant else {}))
    y, ys, yq = op(*targs, tbits, r, **tkw)
    loss = (y.float() * _t(cy)).sum()
    if want_stats:
        loss = loss + (ys * _t(cs)).sum() + (yq * _t(cq)).sum()
    loss.backward()
    tgrads = [targs[0].grad, targs[1].grad.permute(2, 3, 1, 0),
              targs[2].grad, targs[3].grad] + ([r.grad] if use_res else [])
    return (jout, jgrads), ((y, ys, yq), tgrads)


def _check(j, t, want_stats, y_exact=False):
    (jout, jgrads), (tout, tgrads) = j, t
    jy = np.asarray(jout[0], np.float32)
    assert tout[0].dtype == torch.bfloat16
    if y_exact:
        np.testing.assert_array_equal(_np(tout[0]), jy)
    else:
        _ulp_ok(_np(tout[0]), jy, "y")
    if want_stats:
        _sum_ok(_np(tout[1]), np.asarray(jout[1]), "ysum")
        _sum_ok(_np(tout[2]), np.asarray(jout[2]), "yssq")
    else:
        assert tout[1] is None and tout[2] is None
    for name, g, jg in zip(["dx", "dW", "dscale", "dshift", "dres"], tgrads,
                           jgrads):
        g, jg = _np(g), np.asarray(jg, np.float32)
        assert g.shape == jg.shape and np.abs(jg).max() > 0, name
        (_ulp_ok if name in ("dx", "dres") else _sum_ok)(g, jg, name)


@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,want_stats", [(False, True), (True, False),
                                                (True, True)])
def test_fused_half_matches_jax(mode, use_res, want_stats):
    """y, ysum, yssq and every gradient (dx, dW, d(scale), d(shift),
    d(res)) against JAX's custom VJP, in each bits mode."""
    j, t = _run(fb.fused_half, False, mode, use_res, want_stats)
    _check(j, t, want_stats)


@pytest.mark.parametrize("mode", ["bits", "seed"])
@pytest.mark.parametrize("use_res,want_stats", [(False, True), (True, False)])
def test_qat_half_matches_jax(mode, use_res, want_stats):
    """``fused_half_int8(quant_bwd=False)``: the int8 forward exactly as in
    FQT, and the bf16 straight-through gradients against JAX's."""
    j, t = _run(fb.fused_half_int8, True, mode, use_res, want_stats, seed=3)
    _check(j, t, want_stats, y_exact=True)


def test_seed_mode_equals_its_expanded_bits():
    """A seed and the [C, N] bits it expands to give the same half,
    forward and backward, in the bf16 and in the QAT op."""
    n = B * H * W
    x, wt, scale, shift, _, res = _inputs(C, n, seed=5)
    seed = _seed(2 ** 31 - 5)
    outs = []
    for op, kw in ((fb.fused_half, {}), (fb.fused_half_int8,
                                         {"quant_bwd": False})):
        for bits in (seed, fb.seed_bits(seed, C, n, 0, n)):
            args = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)),
                    _t(scale), _t(shift)]
            for a in args:
                a.requires_grad_(True)
            y, ys, yq = op(*args, bits, _t(res, torch.bfloat16),
                           dropout_rate=RATE, h=H, w_img=W, **kw)
            (y.float().sum() + ys.sum() + yq.sum()).backward()
            outs.append([y, ys, yq] + [a.grad for a in args])
    for a, b in zip(outs[0::2], outs[1::2]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


# --- the reference's rounding points -----------------------------------------

def test_bf16_prologue_is_one_fma_then_rounded():
    """x * scale + shift with shift = -f32(x * scale): one fma leaves the
    product's rounding error (a normal bf16 number once rounded), two
    roundings leave 0; an identity centre tap shows each value of d in y."""
    c, n = 32, 2 * H * W
    rng = np.random.default_rng(1)
    xc = np.asarray(jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.bfloat16),
                    np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = -(xc * scale).astype(np.float32)
    x = np.repeat(xc[:, None], n, 1)
    wt = np.zeros((3, 3, c, c), np.float32)
    wt[1, 1] = np.eye(c)
    jy, _, _ = jfb.fused_half(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(scale),
        jnp.asarray(shift), None, None, h=H, w_img=W, want_stats=False,
        interpret=True)
    jy = np.asarray(jy, np.float32)
    assert (jy > 0).any()
    ty, _, _ = fb.fused_half(_t(x, torch.bfloat16),
                             _t(wt.transpose(3, 2, 0, 1)), _t(scale),
                             _t(shift), h=H, w_img=W, want_stats=False)
    np.testing.assert_array_equal(_np(ty), jy)


def test_bf16_dropout_keeps_by_reciprocal_multiply():
    """In bf16 the reference's r / (thresh/256) and the port's round(r *
    f32(256/thresh)) agree for every bf16 r and every threshold."""
    r = torch.arange(0, 1 << 15, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    r = r[torch.isfinite(r)]
    for thresh in range(1, 256):
        by_div = (r / np.float32(thresh / 256.0)).to(torch.bfloat16)
        by_mul = (r * fb.inv_keep(thresh)).to(torch.bfloat16)
        assert torch.equal(by_div, by_mul), thresh


def test_refuses_what_the_reference_refuses():
    n = 2 * H * W
    x, wt, scale, shift, bits, _ = _inputs(C, n, res=False)
    args = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)), _t(scale),
            _t(shift)]
    with pytest.raises(ValueError, match="needs a bits array"):
        fb.fused_half(*args, None, None, dropout_rate=0.3, h=H, w_img=W)
    with pytest.raises(ValueError, match="zeroes the activations"):
        fb.fused_half(*args, torch.from_numpy(bits), dropout_rate=1.0, h=H,
                      w_img=W)
    with pytest.raises(ValueError, match="multiple of H\\*W"):
        fb.fused_half(*args, torch.from_numpy(bits), dropout_rate=0.3, h=H,
                      w_img=W + 1)


@pytest.mark.parametrize("c", [16, 48, 80, 112])
def test_every_width_the_gate_admits_reaches_the_kernels_whole(c,
                                                               monkeypatch):
    """The gate admits C % 16 without dropout (ROADMAP Queue 2 item 7a).
    ``fused_half`` pads such a width with zero channels to a multiple of
    32, so every kernel-facing stage gets a shape the card's own check
    (``check_fwd_bf16_geometry``, the rule of the bf16 forward, dgrad and
    wgrad) accepts, and the padded half's output and gradients equal the
    unpadded half's."""
    from pytorch_ddp_resnet_tpu_torch.models.blocks import ResidualBlock

    b, h, w = 4, 16, 16
    n = b * h * w
    block = ResidualBlock(c, False, True, True, 0.0, fused_block=True)
    assert block.lane_eligible((b, h, w, c), True)
    x, wt, scale, shift, _, res = _inputs(c, n)

    def run(op):
        ins = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)),
               _t(scale), _t(shift), _t(res, torch.bfloat16)]
        ins = [t.requires_grad_() for t in ins]
        y, ys, yq = op(*ins[:4], None, ins[4], h=h, w_img=w)
        loss = ((y.float() * torch.linspace(-1, 1, c * n).reshape(c, n)
                 ).sum() + ys.sum() * 1e-3 + yq.sum() * 1e-4)
        return [y, ys, yq] + list(torch.autograd.grad(loss, ins))

    want = run(lambda *a, **k: fb._FusedHalf.apply(*a[:6], None, h, w,
                                                   True))
    seen = []
    for name in ("fwd_bf16", "dgrad_bf16", "wgrad_bf16"):
        orig = getattr(fb, name)

        def spy(*a, _orig=orig, _name=name, **k):
            rows = [t.shape[0] for t in a
                    if isinstance(t, torch.Tensor) and t.dim() == 2]
            for r in rows:
                assert r % 32 == 0, (_name, r)
                fb.check_fwd_bf16_geometry(_name, r, r, n, h, w)
            seen.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(fb, name, spy)
    got = run(fb.fused_half)
    assert sorted(seen) == ["dgrad_bf16", "fwd_bf16", "wgrad_bf16"]
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape
        assert torch.equal(a.detach(), b_.detach())

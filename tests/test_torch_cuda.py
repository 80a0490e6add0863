"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA card:
a CUDA kernel has no CPU mode. This file imports only ``torch``, ``numpy``
and the port, so on a machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance, as ``|kernel - plain| / max(1, |plain|)``: 1e-4 for float32
(another summation order), 2e-2 for bf16 (the f32 result rounded to bf16
once; one step is 2^-8 relative). The Adam kernels compute the plain
version's float32 operations one for one with no FMA: they are held to
one float32 step (rtol 2^-23) in the parameter and the moments, and the
many-tensor and arena kernels to identical bits.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import Bert, BertConfig, BertForPretraining
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import batch_norm as BN
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_adam as FAD
from paddle_tpu_torch.ops.kernels import layer_norm as LN
from paddle_tpu_torch.ops.kernels import softmax_xent as SX
from paddle_tpu_torch.tools import bench_bert, bench_resnet

from flash_grid import GRID

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scaled_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(37, 96), (4096, 768), (8, 5000),
                                 (3, 9000), (2, 16384)])
def test_layer_norm_kernel_matches_plain(cuda_device, n, d, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    x = (torch.randn(n, d, device=cuda_device, generator=g) * 3 + 1).to(dt)
    w = torch.rand(d, device=cuda_device, generator=g).to(dt) + 0.5
    b = torch.randn(d, device=cuda_device, generator=g).to(dt)
    before = kernels.launches["layer_norm_fwd"]
    y, mu, rstd = LN.layer_norm_fwd(x, w, b, 1e-12)
    torch.cuda.synchronize()
    assert kernels.launches["layer_norm_fwd"] == before + 1
    y0, mu0, rstd0 = LN.layer_norm_fwd_plain(x, w, b, 1e-12)
    assert _scaled_err(y, y0) <= TOL[dt]
    assert _scaled_err(mu, mu0) <= 1e-4
    assert _scaled_err(rstd, rstd0) <= 1e-4


FLASH_CASES = {
    # name: (B, H, S, D, mask, causal)
    "none": (2, 2, 32, 64, None, False),
    "key_1e9": (2, 3, 128, 64, "key", False),
    "bool_fully_masked_row": (2, 2, 64, 64, "bool", False),
    "full_per_head": (2, 3, 64, 64, "full", False),
    "causal": (1, 2, 130, 64, None, True),
    "unaligned_s40": (2, 2, 40, 64, "key", False),
    "head_dim_128": (2, 3, 70, 128, "key", False),
}


def _flash_inputs(case, dt, device):
    b, h, s, d, kind, causal = FLASH_CASES[case]
    g = torch.Generator(device=device).manual_seed(len(case))
    # head-split views of a fused (B, S, 3, H, D) projection, as in BERT
    qkv = torch.randn(b, s, 3, h, d, device=device, generator=g)
    qkv = qkv.to(dt).permute(2, 0, 3, 1, 4)
    mask = None
    if kind == "key":
        mask = torch.where(torch.rand(b, 1, 1, s, device=device,
                                      generator=g) < 0.3, -1e9, 0.0)
    elif kind == "bool":
        mask = torch.rand(b, 1, s, s, device=device, generator=g) > 0.3
        mask[1, 0, 5, :] = False
    elif kind == "full":
        mask = torch.randn(1, h, s, s, device=device, generator=g) * 2
    return qkv[0], qkv[1], qkv[2], mask, causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda_device, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, mask, causal = _flash_inputs(case, dt, cuda_device)
    before = kernels.launches["flash_attention_fwd"]
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention_fwd"] == before + 1
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask,
                                                causal=causal)
    assert _scaled_err(out, out0) <= TOL[dt]
    assert _scaled_err(m, m0) <= 1e-4
    assert _scaled_err(l, l0) <= 1e-4
    if case == "bool_fully_masked_row":
        assert bool((out[1, :, 5] == 0).all())


@pytest.mark.cuda
def test_flash_attention_dropout_in_training_raises(cuda_device):
    """Attention dropout in training runs in the kernel; only a rate
    outside [0, 1) raises."""
    q = torch.randn(1, 2, 8, 64, device=cuda_device)
    out = FA.flash_attention(q, q, q, dropout_p=0.1, training=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="dropout_p"):
        FA.flash_attention(q, q, q, dropout_p=1.0, training=True)


@pytest.mark.cuda
def test_flash_attention_rejects_other_head_dims(cuda_device):
    """Head dims above 128 are a stated restriction; integer inputs are
    not attention."""
    for d in (129, 192):
        q = torch.zeros(1, 1, 8, d, device=cuda_device)
        with pytest.raises(ValueError, match="head dims up to 128"):
            FA.flash_attention_fwd(q, q, q)
    i = torch.zeros(1, 1, 8, 64, device=cuda_device, dtype=torch.int32)
    with pytest.raises(TypeError, match="float dtype"):
        FA.flash_attention_fwd(i, i, i)


# other head dims run zero-padded to 64 or 128, other float dtypes in
# float32; float16's tolerance is one float16 step (2^-10 relative) above
# float32's, as bf16's is one bf16 step
PADDED_CASES = [(8, "float32"), (16, "float32"), (32, "float32"),
                (96, "float32"), (16, "bfloat16"), (96, "bfloat16"),
                (64, "float16"), (16, "float16")]
PADDED_TOL = {**TOL, torch.float16: 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dtype", PADDED_CASES)
def test_flash_kernels_take_other_head_dims_and_float16(cuda_device, d,
                                                        dtype, causal):
    dt = getattr(torch, dtype)
    b, h, s = 2, 3, 70
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = torch.randn(4, b, h, s, d, device=cuda_device,
                              generator=g).to(dt)
    mask = torch.where(torch.rand(b, 1, 1, s, device=cuda_device,
                                  generator=g) < 0.3, -1e9, 0.0)
    kw = dict(causal=causal, dropout_p=0.1, seed=(d, 3))
    before = dict(kernels.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, **kw)
    grads = FA.flash_attention_bwd(q, k, v, mask, out, m, l, do, **kw)
    torch.cuda.synchronize()
    for name in (FA.NAME, FA.BWD_DQ, FA.BWD_DKV):
        assert kernels.launches[name] == before[name] + 1
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, **kw)
    ref = FA.flash_attention_bwd_plain(q, k, v, mask, out, m, l, do, **kw)
    assert _scaled_err(m, m0) <= 1e-4 and _scaled_err(l, l0) <= 1e-4
    for got, want in zip((out, *grads), (out0, *ref)):
        assert got.dtype == dt and got.shape == want.shape
        assert _scaled_err(got, want) <= PADDED_TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_flash_kernels_fold_sdpa_causal_edge_for_row_masks(cuda_device,
                                                           kind, dtype):
    """A (B, 1, Sq, 1) mask, which the reference hands to sdpa, under
    causal: sdpa's -1e9 edge folded into a full bias, so a row masked
    everywhere is the average of all Sk keys; every output matches the
    plain versions."""
    dt = getattr(torch, dtype)
    b, h, s, d = 2, 3, 70, 64
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v, do = torch.randn(4, b, h, s, d, device=cuda_device,
                              generator=g).to(dt)
    if kind == "bool":
        mask = torch.ones(b, 1, s, 1, dtype=torch.bool, device=cuda_device)
        mask[1, 0, 3, 0] = False
    else:
        mask = torch.randn(b, 1, s, 1, device=cuda_device, generator=g)
        mask[1, 0, 3, 0] = -1e9
    before = dict(kernels.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, causal=True)
    grads = FA.flash_attention_bwd(q, k, v, mask, out, m, l, do,
                                   causal=True)
    torch.cuda.synchronize()
    for name in (FA.NAME, FA.BWD_DQ, FA.BWD_DKV):
        assert kernels.launches[name] == before[name] + 1
    want = [FA.flash_attention_fwd_plain(q, k, v, mask, causal=True)[0]]
    want += FA.flash_attention_bwd_plain(q, k, v, mask, out, m, l, do,
                                         causal=True)
    for got, ref in zip([out, *grads], want):
        assert _scaled_err(got, ref) <= TOL[dt]
    torch.testing.assert_close(out[1, :, 3].float(),
                               v[1].float().mean(dim=1), rtol=TOL[dt],
                               atol=TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_give_sdpa_uniform_row_for_a_row_mask(cuda_device,
                                                           dtype):
    """A (B, 1, Sq, 1) bool mask, which the reference hands to plain sdpa:
    the kernels run on q with the masked rows zeroed, so a masked row is
    sdpa's uniform average over the keys and gets dq = 0, and every output
    matches the plain versions."""
    dt = getattr(torch, dtype)
    b, h, s, d = 2, 3, 70, 64
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do = torch.randn(4, b, h, s, d, device=cuda_device,
                              generator=g).to(dt)
    mask = torch.ones(b, 1, s, 1, dtype=torch.bool, device=cuda_device)
    mask[1, 0, 3, 0] = False
    before = dict(kernels.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, mask)
    grads = FA.flash_attention_bwd(q, k, v, mask, out, m, l, do)
    torch.cuda.synchronize()
    for name in (FA.NAME, FA.BWD_DQ, FA.BWD_DKV):
        assert kernels.launches[name] == before[name] + 1
    want = [FA.flash_attention_fwd_plain(q, k, v, mask)[0]]
    want += FA.flash_attention_bwd_plain(q, k, v, mask, out, m, l, do)
    for got, ref in zip([out, *grads], want):
        assert _scaled_err(got, ref) <= TOL[dt]
    torch.testing.assert_close(out[1, :, 3].float(),
                               v[1].float().mean(dim=1), rtol=TOL[dt],
                               atol=TOL[dt])
    assert not grads[0][1, :, 3].any()


@pytest.mark.cuda
def test_bert_without_flash_attention_raises_on_card(cuda_device):
    model = Bert(BertConfig.tiny(use_flash_attention=False)).to(cuda_device)
    ids = torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="CPU only"):
        model.eval()(ids)


@pytest.mark.cuda
def test_tiny_bert_on_card_matches_cpu_and_counts_launches(cuda_device):
    torch.manual_seed(0)
    model = Bert(BertConfig.tiny(hidden_size=256, num_attention_heads=4))
    cpu = Predictor(copy.deepcopy(model), device="cpu")
    gpu = Predictor(model)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (3, 40)).astype("int32")
    tt = np.zeros_like(ids)
    mask = (np.arange(40)[None, :] < np.array([[40], [17], [3]])).astype(
        "int32")
    kernels.reset_launches()
    got = gpu.run(ids, tt, mask)
    assert kernels.launches == dict(dict.fromkeys(kernels.SOURCES, 0),
                                    layer_norm_fwd=5, flash_attention_fwd=2)
    for a, b in zip(got, cpu.run(ids, tt, mask)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


# -- the training slice's kernels ----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(37, 96), (4096, 768), (5, 1000),
                                 (8, 5000)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, n, d, dtype,
                                             wdtype):
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    x = (torch.randn(n, d, device=cuda_device, generator=g) * 3 + 1).to(dt)
    w = (torch.rand(d, device=cuda_device, generator=g) + 0.5).to(wdt)
    b = torch.randn(d, device=cuda_device, generator=g).to(wdt)
    gy = torch.randn(n, d, device=cuda_device, generator=g).to(dt)
    _, mu, rstd = LN.layer_norm_fwd(x, w, b, 1e-12)
    before = kernels.launches["layer_norm_bwd"]
    dx, dw, db = LN.layer_norm_bwd(x, w, mu, rstd, gy)
    torch.cuda.synchronize()
    assert kernels.launches["layer_norm_bwd"] == before + 1
    assert dx.dtype == dt and dw.dtype == wdt and db.dtype == wdt
    dx0, dw0, db0 = LN.layer_norm_bwd_plain(x, w, mu, rstd, gy)
    assert _scaled_err(dx, dx0) <= TOL[dt]
    # dw and db sum n rows: scale the tolerance by the sums' size
    for got, ref in ((dw, dw0), (db, db0)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[wdt] * max(1.0, ref.float().abs().max().item())
    # the cross-block reduction is deterministic: a second run is equal
    dx1, dw1, db1 = LN.layer_norm_bwd(x, w, mu, rstd, gy)
    assert torch.equal(dw, dw1) and torch.equal(db, db1)
    assert torch.equal(dx, dx1)


def _ln_rows(dev, n, d, dtype, offset, gen):
    """(n, d) rows ``offset`` elements into their buffer: packed, but off
    16 bytes unless offset is 0."""
    flat = torch.randn(n * d + offset, device=dev, generator=gen)
    return flat.to(getattr(torch, dtype))[offset:].view(n, d)


def _ln_bwd_matches_plain(x, w, mu, rstd, gy):
    """The backward kernel against its plain version (dw and db to the
    tolerance scaled by the sums' size), and a second run bit-equal."""
    got = LN.layer_norm_bwd(x, w, mu, rstd, gy)
    torch.cuda.synchronize()
    ref = LN.layer_norm_bwd_plain(x, w, mu, rstd, gy)
    assert _scaled_err(got[0], ref[0]) <= TOL[x.dtype]
    for a, r in zip(got[1:], ref[1:]):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= TOL[w.dtype] * max(1.0, r.float().abs().max().item())
    again = LN.layer_norm_bwd(x, w, mu, rstd, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [9000, 16384])
def test_layer_norm_bwd_takes_wide_rows(cuda_device, d, dtype):
    """Rows of any width: above 1024 a block a row, re-reading the row."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = _ln_rows(cuda_device, 3, d, dtype, 0, gen) * 3 + 1
    w = torch.rand(d, device=cuda_device, generator=gen) + 0.5
    b = torch.randn(d, device=cuda_device, generator=gen)
    gy = _ln_rows(cuda_device, 3, d, dtype, 0, gen)
    _, mu, rstd = LN.layer_norm_fwd(x, w, b, 1e-12)
    before = kernels.launches["layer_norm_bwd"]
    _ln_bwd_matches_plain(x, w, mu, rstd, gy)
    assert kernels.launches["layer_norm_bwd"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,offset", [(64, 770, 0), (300, 768, 1),
                                        (5, 9000, 1), (4, 16384, 1)])
def test_layer_norm_kernels_take_unaligned_rows(cuda_device, n, d, offset,
                                                dtype):
    """Odd D and views off 16 bytes take the one-element-a-lane instances;
    both kernels against their plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + d + offset)
    x = _ln_rows(cuda_device, n, d, dtype, offset, gen)
    gy = _ln_rows(cuda_device, n, d, dtype, offset, gen)
    assert LN.vector_width(x, gy) == 1
    w = torch.rand(d, device=cuda_device, generator=gen) + 0.5
    b = torch.randn(d, device=cuda_device, generator=gen)
    y, mu, rstd = LN.layer_norm_fwd(x, w, b, 1e-12)
    torch.cuda.synchronize()
    y0, mu0, rstd0 = LN.layer_norm_fwd_plain(x, w, b, 1e-12)
    assert _scaled_err(y, y0) <= TOL[x.dtype]
    assert max(_scaled_err(mu, mu0), _scaled_err(rstd, rstd0)) <= 1e-4
    _ln_bwd_matches_plain(x, w, mu, rstd, gy)


@pytest.mark.cuda
def test_flash_dropout_mask_identity(cuda_device):
    """The forward kernel drops exactly where the plain hash says: with
    q = 0 every probability is 1/Sk, and v = I puts each key's kept
    (scaled) probability in its own output column."""
    b, h, sq, sk = 2, 3, 100, 64
    q = torch.zeros(b, h, sq, 64, device=cuda_device)
    v = torch.eye(sk, device=cuda_device).expand(b, h, sk, sk)
    seed = (12345, -678)
    out, _, _ = FA.flash_attention_fwd(q, q[:, :, :sk], v, dropout_p=0.1,
                                       seed=seed)
    keep = FA.dropout_keep_mask(seed, b * h, sq, sk, 0.1, cuda_device)
    assert torch.equal(out.reshape(b * h, sq, sk) > 0, keep)
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(
        out.reshape(b * h, sq, sk)[keep],
        torch.full_like(out.reshape(b * h, sq, sk)[keep], 1 / (0.9 * sk)))


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_fwd_bwd_kernels_match_plain(cuda_device, case,
                                                     dtype, p_drop):
    dt = getattr(torch, dtype)
    q, k, v, mask, causal = _flash_inputs(case, dt, cuda_device)
    seed = (len(case), 99)
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, causal=causal,
                                       dropout_p=p_drop, seed=seed)
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, causal=causal,
                                                dropout_p=p_drop, seed=seed)
    assert _scaled_err(out, out0) <= TOL[dt]
    assert _scaled_err(l, l0) <= 1e-4
    g = torch.Generator(device=cuda_device).manual_seed(7)
    # dO in the (B, S, H, D) memory order the model hands it over in
    do = torch.randn(q.shape[0], q.shape[2], q.shape[1], q.shape[3],
                     device=cuda_device, generator=g).to(dt).transpose(1, 2)
    before = dict(kernels.launches)
    grads = FA.flash_attention_bwd(q, k, v, mask, out, m, l, do,
                                   causal=causal, dropout_p=p_drop,
                                   seed=seed)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert kernels.launches[name] == before[name] + 1
    ref = FA.flash_attention_bwd_plain(q, k, v, mask, out, m, l, do,
                                       causal=causal, dropout_p=p_drop,
                                       seed=seed)
    for got, want in zip(grads, ref):
        assert got.dtype == dt and bool(torch.isfinite(got).all())
        assert _scaled_err(got, want) <= TOL[dt]
    if case == "bool_fully_masked_row":
        assert bool((grads[0][1, :, 5] == 0).all())




def _tile_inputs(case, device):
    """q (B, H, Sq, D), k and v (B, H, Sk, D), dO in the (B, S, H, D)
    memory order, the mask, and the case's options."""
    d, dtype, sq, sk, kind, causal, p_drop = GRID[case]
    dt = getattr(torch, dtype)
    b, h = 2, 3
    g = torch.Generator(device=device).manual_seed(sorted(GRID)
                                                   .index(case))
    q = torch.randn(b, h, sq, d, device=device, generator=g).to(dt)
    k, v = torch.randn(2, b, h, sk, d, device=device, generator=g).to(dt)
    do = torch.randn(b, sq, h, d, device=device, generator=g).to(dt)
    mask = None
    if kind == "key":
        mask = torch.where(torch.rand(b, 1, 1, sk, device=device,
                                      generator=g) < 0.3, -1e9, 0.0)
    elif kind == "full":
        mask = torch.randn(1, h, sq, sk, device=device, generator=g) * 2
    elif kind == "bool":
        mask = torch.rand(b, 1, sq, sk, device=device, generator=g) > 0.3
        mask[0, 0, 5, :] = False
    return q, k, v, do.transpose(1, 2), mask, dict(
        causal=causal, dropout_p=p_drop, seed=(sq, sk))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRID))
def test_flash_kernels_match_plain_at_tile_edges(cuda_device, case):
    q, k, v, do, mask, kw = _tile_inputs(case, cuda_device)
    dt = q.dtype
    before = dict(kernels.launches)
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert kernels.launches[FA.NAME] == before[FA.NAME] + 1
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, **kw)
    assert _scaled_err(out, out0) <= TOL[dt]
    assert _scaled_err(m, m0) <= 1e-4 and _scaled_err(l, l0) <= 1e-4
    grads = FA.flash_attention_bwd(q, k, v, mask, out, m, l, do, **kw)
    torch.cuda.synchronize()
    for name in (FA.BWD_DQ, FA.BWD_DKV):
        assert kernels.launches[name] == before[name] + 1
    ref = FA.flash_attention_bwd_plain(q, k, v, mask, out, m, l, do, **kw)
    for got, want in zip(grads, ref):
        assert got.dtype == dt and bool(torch.isfinite(got).all())
        assert _scaled_err(got, want) <= TOL[dt]
    if GRID[case][4] == "bool":
        assert bool((out[0, :, 5] == 0).all())
        assert bool((grads[0][0, :, 5] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_and_dkv_kernels_draw_the_same_dropout_mask(cuda_device,
                                                              dtype):
    """q = 0 makes every probability 1/Sk, and dO = I puts query i's
    dropped, scaled probabilities in column i of dv: dv[k, i] =
    keep[i, k] / (0.9 Sk). So the dv the dK/dV kernel computes from the
    forward kernel's output is positive exactly where the hash keeps, and
    equals the plain backward under ``dropout_keep_mask``."""
    dt = getattr(torch, dtype)
    b, h, sq, sk, d = 2, 3, 64, 130, 64
    seed = (4242, -99)
    q = torch.zeros(b, h, sq, d, device=cuda_device, dtype=dt)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    k = torch.randn(b, h, sk, d, device=cuda_device, generator=g).to(dt)
    v = torch.randn(b, h, sk, d, device=cuda_device, generator=g).to(dt)
    do = torch.eye(sq, d, device=cuda_device, dtype=dt).expand(b, h, sq, d)
    out, m, l = FA.flash_attention_fwd(q, k, v, dropout_p=0.1, seed=seed)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, None, out, m, l, do,
                                        dropout_p=0.1, seed=seed)
    keep = FA.dropout_keep_mask(seed, b * h, sq, sk, 0.1, cuda_device)
    assert torch.equal(dv.reshape(b * h, sk, d)[:, :, :sq] > 0,
                       keep.transpose(1, 2))
    kf = keep.float()
    _, _, dv0 = FA.flash_attention_bwd_plain(q, k, v, None, out, m, l, do,
                                             dropout_p=0.1, keep=kf)
    assert _scaled_err(dv, dv0) <= TOL[dt]
    torch.testing.assert_close(
        dv.reshape(b * h, sk, d)[:, :, :sq].float(),
        kf.transpose(1, 2) / (0.9 * sk), rtol=TOL[dt], atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_copy_inputs_off_16_byte_rows(cuda_device, dtype):
    """q, k, v, dO and O whose storage starts one element off a 16-byte
    boundary, or whose rows are 66 elements apart: the wrappers copy them
    for the kernels' 16-byte copies, and the results equal those from
    contiguous copies."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, s, d = 2, 3, 70, 64
    n = b * h * s * d
    flat = torch.randn(n + 1, device=cuda_device, generator=g).to(dt)
    q = flat[1:].view(b, h, s, d)                 # one element off
    assert q.data_ptr() % 16 == es
    wide = torch.randn(b, h, s, d + 2, device=cuda_device,
                       generator=g).to(dt)
    k = wide[..., :d]                             # rows 66 elements apart
    v = wide[..., 2:]                             # and 2 elements off
    do = torch.randn(n + 3, device=cuda_device, generator=g).to(dt)[3:]
    do = do.view(b, h, s, d)
    for t in (q, k, v, do):
        assert not FA._aligned16(t)
        assert FA._aligned16(FA._kernel_operand(t))
    out, m, l = FA.flash_attention_fwd(q, k, v)
    want = FA.flash_attention_fwd(*(t.contiguous().clone()
                                    for t in (q, k, v)))
    assert torch.equal(out, want[0])
    flat_o = torch.empty(out.numel() + 1, device=cuda_device, dtype=dt)
    out_off = flat_o[1:].view(out.shape).copy_(out)   # O one element off
    assert not FA._aligned16(out_off)
    grads = FA.flash_attention_bwd(q, k, v, None, out_off, m, l, do)
    ref = FA.flash_attention_bwd(*(t.clone() for t in (q, k, v)), None,
                                 out, m, l, do.clone())
    for a, r in zip(grads, ref):
        assert torch.equal(a, r)
    assert _scaled_err(grads[2], FA.flash_attention_bwd_plain(
        q, k, v, None, out, m, l, do)[2]) <= TOL[dt]


def _grad_fns(model, x):
    """The grad_fn of each LayerNorm's and each attention call's output
    in one forward."""
    seen = []
    hook = lambda mod, args, out: seen.append((type(mod).__name__,
                                               out.grad_fn))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.LayerNorm)]
    orig = FA.flash_attention

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(("flash_attention", out.grad_fn))
        return out

    import paddle_tpu_torch.models.bert as bert_mod
    bert_mod.flash_attention = spy
    try:
        model(x)
    finally:
        bert_mod.flash_attention = orig
        for hd in handles:
            hd.remove()
    return seen


@pytest.mark.cuda
def test_bert_every_parameter_gets_a_gradient_on_card(cuda_device):
    """On a CUDA tensor the LayerNorm and attention outputs carry the
    port's autograd Functions, and a pretraining loss reaches every
    parameter with a finite gradient (default dropouts on)."""
    torch.manual_seed(0)
    model = BertForPretraining(BertConfig.tiny(hidden_size=256,
                                               num_attention_heads=4))
    model = model.to(cuda_device).train()
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (3, 40)).astype("int32"))
    ids = ids.to(cuda_device)
    fns = _grad_fns(model, ids)
    assert [n for n, _ in fns].count("flash_attention") == 2
    assert len(fns) == 8
    for name, fn in fns:
        want = ("FlashAttentionFunctionBackward" if name == "flash_attention"
                else "LayerNormFunctionBackward")
        assert type(fn).__name__ == want, (name, fn)
    mlm = torch.from_numpy(np.where(rng.rand(3, 40) < 0.3,
                                    rng.randint(0, 1024, (3, 40)), -1)
                           .astype("int32")).to(cuda_device)
    nsp = torch.tensor([0, 1, 1], device=cuda_device)
    # token types too, so that every embedding table is on the path
    tt = torch.from_numpy((rng.rand(3, 40) < 0.5).astype("int32"))
    kernels.reset_launches()
    logits, nsp_logits = model(ids, tt.to(cuda_device))
    model.loss(logits, nsp_logits, mlm, nsp).backward()
    torch.cuda.synchronize()
    assert kernels.launches == dict(
        dict.fromkeys(kernels.SOURCES, 0), layer_norm_fwd=6,
        layer_norm_bwd=6, flash_attention_fwd=2, flash_attention_bwd_dq=2,
        flash_attention_bwd_dkv=2)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        if name != "bert.embeddings.position_embeddings.weight":
            assert p.grad.abs().sum().item() > 0, name


@pytest.mark.cuda
def test_bench_bert_runs_two_steps(cuda_device):
    tok_s, loss = bench_bert.bench_bert(batch=8, seq=128, steps=2, inner=1)
    assert tok_s > 0 and np.isfinite(loss)


# -- the loss and optimizer slice's kernels ------------------------------------

@pytest.fixture
def kernel_switch():
    """``kernels.configure``, with every name restored afterwards."""
    yield kernels.configure
    kernels.configure(softmax_xent=None, fused_adam=None,
                      fused_adam_multi=None)


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,v", [(37, 2500), (64, 2), (300, 30522),
                                 (9, 7), (3, 4099)])
def test_softmax_xent_kernels_match_plain(cuda_device, n, v, dtype, eps):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(n + v)
    x = (torch.randn(n, v, device=cuda_device, generator=g) * 3).to(dt)
    lab = torch.randint(0, v, (n, 1), device=cuda_device, generator=g,
                        dtype=torch.int32)
    lab[::3] = -1                   # no column: the caller's ignored rows
    lab[1::4] = v + 2               # out of range
    gy = torch.randn(n, 1, device=cuda_device, generator=g)
    gy[::3] = 0.0
    before = dict(kernels.launches)
    loss, lse = SX.softmax_xent_fwd(x, lab, eps)
    dx = SX.softmax_xent_bwd(x, lab, lse, gy, eps)
    torch.cuda.synchronize()
    for name in ("softmax_xent_fwd", "softmax_xent_bwd"):
        assert kernels.launches[name] == before[name] + 1
    loss0, lse0 = SX.softmax_xent_fwd_plain(x, lab, eps)
    assert _scaled_err(loss, loss0) <= 1e-4
    assert _scaled_err(lse, lse0) <= 1e-4
    assert dx.dtype == dt
    assert _scaled_err(dx, SX.softmax_xent_bwd_plain(x, lab, lse, gy,
                                                     eps)) <= TOL[dt]


@pytest.mark.cuda
def test_softmax_xent_kernels_take_unaligned_rows(cuda_device):
    """Logits whose rows start off a 16-byte boundary (a view at an odd
    offset): the forward's scalar head and the backward's element path."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(10 * 33 + 1, device=cuda_device, generator=g)[1:]
    x = x.view(10, 33)
    lab = torch.randint(0, 33, (10, 1), device=cuda_device, generator=g,
                        dtype=torch.int32)
    gy = torch.randn(10, 1, device=cuda_device, generator=g)
    loss, lse = SX.softmax_xent_fwd(x, lab)
    assert _scaled_err(loss, SX.softmax_xent_fwd_plain(x, lab)[0]) <= 1e-4
    dx = SX.softmax_xent_bwd(x, lab, lse, gy)
    assert _scaled_err(dx, SX.softmax_xent_bwd_plain(x, lab, lse, gy)) <= 1e-4


def _adam_state(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(shape, device=device, generator=g).to(dtype)
    gr = torch.randn(shape, device=device, generator=g)
    m = torch.randn(shape, device=device, generator=g) * 0.1
    v = torch.rand(shape, device=device, generator=g) * 0.01
    return p, gr, m, v


def _close_adam(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=2 ** -23, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(30522, 768), (1000, 77), (5,), (3,)])
def test_fused_adam_kernel_matches_plain(cuda_device, shape, dtype):
    p, g, m, v = _adam_state(shape, getattr(torch, dtype), cuda_device, 1)
    lr, b1p, b2p = (torch.tensor(x, device=cuda_device)
                    for x in (1e-3, 0.9 ** 3, 0.999 ** 3))
    want = FAD.adam_plain(p, g, m, v, FAD.scalars(cuda_device, lr, b1p, b2p))
    before = kernels.launches["fused_adam"]
    got = FAD.fused_adam_update(p, g, m, v, lr, b1p, b2p)
    torch.cuda.synchronize()
    assert kernels.launches["fused_adam"] == before + 1
    assert got[0] is p and got[1] is m and got[2] is v
    _close_adam(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [9, 300])
def test_fused_adam_multi_and_flat_kernels(cuda_device, count):
    """Many tensors (300: two launches of the 256-tensor table, and a view
    off a 16-byte boundary) against the plain version, and the arena
    kernel over the same elements laid flat: identical bits."""
    shapes = [(30522, 768), (768,), (2, 768), (768, 3072), (7,)]
    shapes = [shapes[i % len(shapes)] if count < 50 else (i % 37 + 1,)
              for i in range(count)]
    states = [_adam_state(s, torch.float32, cuda_device, i)
              for i, s in enumerate(shapes)]
    odd = torch.zeros(1025, device=cuda_device)[1:]    # unaligned view
    states.append((odd, odd + 1, odd.clone(), odd.clone() + 0.5))
    ps, gs, ms, vs = (list(t) for t in zip(*states))
    lr, b1p, b2p = (torch.tensor(x, device=cuda_device)
                    for x in (1e-3, 0.9 ** 2, 0.999 ** 2))
    scal = FAD.scalars(cuda_device, lr, b1p, b2p, 0.01)
    want = [FAD.adam_plain(*st, scal, decay=True) for st in states]
    total = sum(p.numel() for p in ps)
    flat = [torch.zeros(total + (-total) % 1024, device=cuda_device)
            for _ in range(4)]
    for f, ts in zip(flat, (ps, gs, ms, vs)):
        f[:total] = torch.cat([t.reshape(-1) for t in ts])
    before = dict(kernels.launches)
    FAD.fused_adam_update_multi(ps, gs, ms, vs, lr, b1p, b2p,
                                weight_decay=0.01)
    FAD.fused_adam_update_flat(*flat, lr, b1p, b2p, weight_decay=0.01)
    torch.cuda.synchronize()
    assert kernels.launches["fused_adam_multi"] == \
        before["fused_adam_multi"] + -(-len(ps) // 256)
    assert kernels.launches["fused_adam_flat"] == \
        before["fused_adam_flat"] + 1
    for got, w in zip(zip(ps, ms, vs), want):
        _close_adam(got, w)
    for f, ts in zip((flat[0], flat[2], flat[3]), (ps, ms, vs)):
        assert torch.equal(f[:total], torch.cat([t.reshape(-1)
                                                 for t in ts]))


@pytest.mark.cuda
def test_loss_and_adam_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros(4, 6, device=cuda_device)
    lab = torch.zeros(4, 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        SX.softmax_xent_fwd(x, lab.long())
    with pytest.raises(ValueError, match="CUDA device"):
        SX.softmax_xent_fwd(x, lab.cpu())
    with pytest.raises(ValueError):
        SX.softmax_xent_fwd(x, lab[:3])
    _, lse = SX.softmax_xent_fwd(x, lab)
    with pytest.raises(TypeError, match="float32"):
        SX.softmax_xent_bwd(x, lab, lse, lse.double())
    p, g, m, v = (torch.zeros(1024, device=cuda_device) for _ in range(4))
    with pytest.raises(ValueError, match="CUDA device"):
        FAD.fused_adam_update(p, g, m.cpu(), v, 1e-3, 0.9, 0.999)
    with pytest.raises(TypeError):
        FAD.fused_adam_update(p, g, m.bfloat16(), v, 1e-3, 0.9, 0.999)
    with pytest.raises(ValueError, match="multiple of 1024"):
        FAD.fused_adam_update_flat(p[:1000], g[:1000], m[:1000], v[:1000],
                                   1e-3, 0.9, 0.999)
    with pytest.raises(ValueError, match="contiguous"):
        FAD.fused_adam_update(p.view(32, 32).t(), g.view(32, 32),
                              m.view(32, 32), v.view(32, 32), 1e-3, 0.9,
                              0.999)


@pytest.mark.cuda
def test_adamw_routes_on_card_match_the_plain_route(cuda_device,
                                                    kernel_switch):
    """Four copies of one model stepped by the per-parameter plain AdamW,
    use_fused, use_multi_tensor and the flat arena under
    fused_adam_multi: the kernel routes within a float32 step or so of
    the plain route, multi and arena identical."""
    torch.manual_seed(0)
    base = nn.Sequential(nn.Linear(64, 96), nn.Linear(96, 33))
    models = [copy.deepcopy(base).to(cuda_device) for _ in range(4)]
    kernel_switch(fused_adam_multi=True)
    opts = [optimizer.AdamW(learning_rate=1e-3, parameters=list(
        mod.parameters()), **kw) for mod, kw in zip(models, (
            dict(use_multi_tensor=False), dict(use_fused=True,
                                               use_multi_tensor=False),
            dict(use_multi_tensor=True), dict(flat_arena=True)))]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    kernels.reset_launches()
    for _ in range(3):
        grads = [torch.randn(p.shape, device=cuda_device, generator=g)
                 for p in base.parameters()]
        for mod, opt in zip(models, opts):
            for p, gr in zip(mod.parameters(), grads):
                p.grad = gr.clone()
            opt.step()
            opt.clear_grad()
    torch.cuda.synchronize()
    assert kernels.launches["fused_adam"] == 3 * 4
    assert kernels.launches["fused_adam_multi"] == 3
    assert kernels.launches["fused_adam_flat"] == 3
    plain = [p for p in models[0].parameters()]
    for mod in models[1:]:
        for p, q in zip(mod.parameters(), plain):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6)
    for p, q in zip(models[2].parameters(), models[3].parameters()):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_bench_bert_fused_route_runs_two_steps(cuda_device, kernel_switch):
    kernel_switch(softmax_xent=True, fused_adam_multi=True)
    kernels.reset_launches()
    tok_s, loss = bench_bert.bench_bert(batch=8, seq=128, steps=2, inner=1)
    assert tok_s > 0 and np.isfinite(loss)
    steps = 4                       # warm-up, one more, two timed
    assert kernels.launches["softmax_xent_fwd"] == 2 * steps
    assert kernels.launches["softmax_xent_bwd"] == 2 * steps
    assert kernels.launches["fused_adam_multi"] == steps
    assert kernels.launches["fused_adam"] == 0


# -- the batch-norm kernels ------------------------------------------------------

BN_SHAPES = [(200, 24), (32, 2048), (4097, 64), (6272, 2048), (1000, 100),
             (70001, 256), (3, 8)]


def _bn_operands(device, m, c, dt, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(m, c, device=device, generator=g) * 2 + 1).to(dt)
    gr = torch.randn(m, c, device=device, generator=g).to(dt)
    w = torch.rand(c, device=device, generator=g) + 0.5
    b = torch.randn(c, device=device, generator=g)
    return x, gr, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c", BN_SHAPES)
def test_batch_norm_kernels_match_plain(cuda_device, m, c, dtype):
    """Vector and scalar routes (C a multiple of the 16-byte vector or
    not), ragged last row chunks, few rows with many channels."""
    dt = getattr(torch, dtype)
    x, g, w, b = _bn_operands(cuda_device, m, c, dt, m + c)
    before = dict(kernels.launches)
    got = BN.bn_stats(x, w, b, 1e-5)
    mean0, var0, rstd, scale, shift = BN.bn_stats_plain(x, w, b, 1e-5)
    for a, r in zip(got, (mean0, var0, rstd, scale, shift)):
        assert a.shape == r.shape and _scaled_err(a, r) <= 1e-4
    again = BN.bn_stats(x)             # mean and var alone: the same bits
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert _scaled_err(BN.bn_normalize(x, scale, shift),
                       BN.bn_normalize_plain(x, scale, shift)) <= TOL[dt]
    dg, db = BN.bn_bwd_reduce(x, g, mean0, rstd)
    dg0, db0 = BN.bn_bwd_reduce_plain(x, g, mean0, rstd)
    for a, r in ((dg, dg0), (db, db0)):
        assert (a - r).abs().max().item() <= \
            1e-4 * max(1.0, r.abs().max().item())
    gm, gv = torch.randn(2, c, device=cuda_device).unbind(0)
    for args in ((x, g, mean0, rstd, w, dg0, db0, gm, gv),
                 (x, g, mean0, rstd, w, dg0, db0)):
        assert _scaled_err(BN.bn_bwd_dx(*args),
                           BN.bn_bwd_dx_plain(*args)) <= TOL[dt]
    torch.cuda.synchronize()
    for name in (BN.STATS, BN.NORMALIZE, BN.BWD_REDUCE, BN.BWD_DX):
        assert kernels.launches[name] == before[name] + (
            2 if name in (BN.STATS, BN.BWD_DX) else 1)


@pytest.mark.cuda
def test_batch_norm_kernels_take_an_unaligned_view_and_a_large_mean(
        cuda_device):
    """A view that starts 4 bytes into its storage takes the scalar
    route; at mean 1000 the shifted sums keep the variance."""
    base = torch.randn(64 * 32 + 1, device=cuda_device)
    x = base[1:].view(64, 32)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    mean, var = BN.bn_stats(x)
    mean0, var0 = BN.bn_stats_plain(x)
    assert _scaled_err(mean, mean0) <= 1e-4 and _scaled_err(var, var0) <= 1e-4
    xl = torch.randn(5000, 64, device=cuda_device) + 1000.0
    _, var = BN.bn_stats(xl)
    assert torch.allclose(var.ravel(), xl.double().var(0, unbiased=False)
                          .float(), rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_function_matches_plain_autograd(cuda_device, dtype):
    """All three outputs' gradients through the kernels against autograd
    of the plain forward, and the refusals on the card."""
    dt = getattr(torch, dtype)
    x, g, w, b = _bn_operands(cuda_device, 777, 48, dt, 5)
    gm = torch.randn(48, device=cuda_device)
    gv = torch.randn(48, device=cuda_device)

    def run(fn):
        xs = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        out, mean, var = fn(*xs)
        ((out.reshape(g.shape).float() * g.float()).sum() +
         (mean.reshape(-1) * gm).sum() +
         (var.reshape(-1) * gv).sum()).backward()
        return [out, mean, var] + [t.grad for t in xs]

    def plain(x, w, b):
        mean, var, _, scale, shift = BN.bn_stats_plain(x, w, b, 1e-5)
        return BN.bn_normalize_plain(x, scale, shift), mean, var

    got = run(lambda x, w, b: BN.bn_channels_last(
        x.view(7, 111, 48), w, b, 1e-5))
    ref = run(plain)
    for a, r, name in zip(got, ref, ("out", "mean", "var", "dx", "dw", "db")):
        tol = TOL[dt] if name in ("out", "dx") else 1e-3
        assert (a.reshape(r.shape).float() - r.float()).abs().max().item() \
            <= tol * max(1.0, r.float().abs().max().item()), name
    with pytest.raises(ValueError, match="copy"):
        BN.bn_channels_last(x.t(), w[:1].expand(777), b[:1].expand(777), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        BN.bn_stats(x[:, ::2])
    with pytest.raises(TypeError):
        BN.bn_stats(x.half())


@pytest.mark.cuda
def test_resnet_kernel_route_launches_and_matches_the_cpu(cuda_device):
    """A 4-block bottleneck ResNet, NHWC, batch-norm kernels on: one f32
    step on the card against the CPU (the plain versions), 17 launches of
    each kernel; the NCHW model launches none."""
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models import BottleneckBlock, ResNet
    from paddle_tpu_torch.ops import loss as loss_ops
    import paddle_tpu_torch as ptt
    ptt.seed(0)
    cpu = ResNet(BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                 data_format="NHWC").train()
    card = copy.deepcopy(cpu).to(cuda_device)
    x = torch.randn(8, 64, 64, 3)
    y = torch.randint(0, 10, (8,))
    kernels.configure(batch_norm=True)
    try:
        kernels.reset_launches()
        res = []
        for model, dev in ((card, cuda_device), (cpu, "cpu")):
            o = opt.Momentum(0.01, 0.9, parameters=model.parameters())
            lo = loss_ops.cross_entropy(model(x.to(dev)), y.to(dev))
            lo.backward()
            o.step()
            res.append((lo.item(), {k: v.detach().cpu() for k, v in
                                    model.state_dict().items()}))
        launches = dict(kernels.launches)
    finally:
        kernels.configure(batch_norm=None)
    assert all(launches[n] == 17 for n in launches
               if n.startswith("batch_norm")), launches
    assert abs(res[0][0] - res[1][0]) <= 1e-4
    for k in res[1][1]:
        assert torch.allclose(res[0][1][k], res[1][1][k], atol=2e-4,
                              rtol=2e-3), k
    kernels.reset_launches()
    small = dict(model_fn=lambda **kw: ResNet(BottleneckBlock, [1, 1, 1, 1],
                                              num_classes=10, **kw))
    img_s, last = bench_resnet.bench_resnet(batch=8, steps=2, inner=1,
                                            size=64, **small)
    assert img_s > 0 and np.isfinite(last)
    assert sum(kernels.launches.values()) == 0

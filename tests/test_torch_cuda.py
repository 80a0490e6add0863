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
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import io, nn, optimizer
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


def _state_as(shape, dtypes, device, seed):
    """Adam state with p, g, m and v in ``dtypes`` (names)."""
    p, g, m, v = _adam_state(shape, torch.float32, device, seed)
    return tuple(t.to(getattr(torch, d)) for t, d in zip((p, g, m, v),
                                                        dtypes))


def _skip_flag(device, skip):
    return torch.tensor(bool(skip), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtypes", [
    ("bfloat16", "bfloat16", "float32", "float32"),
    ("bfloat16", "float32", "float32", "float32"),
    ("float32", "bfloat16", "float32", "float32"),
    ("float32", "float32", "float32", "float32")])
@pytest.mark.parametrize("shape", [(30522, 768), (1000, 77), (5,)])
def test_fused_adam_takes_bf16_and_the_skip_flag(cuda_device, shape,
                                                 dtypes, skip):
    """#8 with bf16 p and g read in place (no float32 copy) and the skip
    flag on the card: the plain version's bits (p rounded once), and with
    the flag set every tensor bit-equal to before."""
    p, g, m, v = _state_as(shape, dtypes, cuda_device, 3)
    before = [t.clone() for t in (p, m, v)]
    lr, b1p, b2p = (torch.tensor(x, device=cuda_device)
                    for x in (1e-3, 0.9 ** 3, 0.999 ** 3))
    flag = _skip_flag(cuda_device, skip)
    want = FAD.adam_plain(p, g, m, v, FAD.scalars(cuda_device, lr, b1p, b2p,
                                                  0.0, flag))
    n = kernels.launches["fused_adam"]
    got = FAD.fused_adam_update(p, g, m, v, lr, b1p, b2p, skip=flag)
    torch.cuda.synchronize()
    assert kernels.launches["fused_adam"] == n + 1
    assert got[0] is p and got[1] is m and got[2] is v
    _close_adam(got, want)
    if skip:
        assert all(torch.equal(a, b) for a, b in zip(got, before))


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
def test_fused_adam_multi_takes_mixed_dtypes_and_the_skip_flag(cuda_device,
                                                               skip):
    """#9 over tensors whose p and g are each bf16 or float32 (one launch
    reads every one in its own dtype), against the plain version."""
    shapes = [(30522, 768), (768,), (2, 768), (768, 3072), (7,), (1,)]
    combos = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
              ("float32", "bfloat16"), ("float32", "float32")]
    states = [_state_as(s, combos[i % 4] + ("float32", "float32"),
                        cuda_device, 10 + i) for i, s in enumerate(shapes)]
    ps, gs, ms, vs = (list(t) for t in zip(*states))
    before = [t.clone() for t in ps + ms + vs]
    lr, b1p, b2p = (torch.tensor(x, device=cuda_device)
                    for x in (1e-3, 0.9 ** 2, 0.999 ** 2))
    flag = _skip_flag(cuda_device, skip)
    scal = FAD.scalars(cuda_device, lr, b1p, b2p, 0.01, flag)
    want = [FAD.adam_plain(*st, scal, decay=True) for st in states]
    n = kernels.launches["fused_adam_multi"]
    _, ms2, vs2 = FAD.fused_adam_update_multi(ps, gs, ms, vs, lr, b1p, b2p,
                                              weight_decay=0.01, skip=flag)
    torch.cuda.synchronize()
    assert kernels.launches["fused_adam_multi"] == n + 1
    assert all(a is b for a, b in zip(ms2 + vs2, ms + vs))
    for got, w in zip(zip(ps, ms, vs), want):
        _close_adam(got, w)
    if skip:
        assert all(torch.equal(a, b) for a, b in zip(ps + ms + vs, before))


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1024 * 107, 1024 * 37 + 0])
def test_fused_adam_flat_takes_a_bf16_group_and_the_skip_flag(
        cuda_device, n, dtype, skip):
    """#10 over a group whose p, g, m and v are all bf16 (the reference
    arena's layout) or all float32: float32 arithmetic, one rounding on
    store, the plain version's bits; a view one element off 16 bytes
    takes the element path."""
    dt = getattr(torch, dtype)
    p, g, m, v = _state_as((n,), (dtype,) * 4, cuda_device, 5)
    lr, b1p, b2p = (torch.tensor(x, device=cuda_device)
                    for x in (1e-3, 0.9 ** 4, 0.999 ** 4))
    flag = _skip_flag(cuda_device, skip)
    scal = FAD.scalars(cuda_device, lr, b1p, b2p, 0.01, flag)
    for off in (0, 1):
        bufs = []
        for t in (p, g, m, v):
            b = torch.zeros(n + 1, dtype=dt, device=cuda_device)[off:off + n]
            b.copy_(t)
            bufs.append(b)
        before = [t.clone() for t in bufs]
        want = FAD.adam_plain(*bufs, scal, decay=True)
        k = kernels.launches["fused_adam_flat"]
        FAD.fused_adam_update_flat(*bufs, lr, b1p, b2p, weight_decay=0.01,
                                   skip=flag)
        torch.cuda.synchronize()
        assert kernels.launches["fused_adam_flat"] == k + 1
        got = (bufs[0], bufs[2], bufs[3])
        for a, w in zip(got, want):
            assert a.dtype == dt
            torch.testing.assert_close(a, w.to(dt), rtol=2 ** -23, atol=0.0)
        if skip:
            assert all(torch.equal(a, b) for a, b in
                       zip(bufs, before))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plain", "use_fused", "multi", "arena"])
def test_o2_adamw_routes_skip_an_overflow_bit_equal(cuda_device,
                                                    kernel_switch, route):
    """A bf16 (O2) model stepped by AdamW under a GradScaler on each
    route: the kernel routes launch their kernel each step, and a step
    forced to overflow leaves every parameter, slot, arena buffer and pow
    bit-equal, halves the scale and zeroes the good count."""
    from paddle_tpu_torch import amp, clip
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(64, 96), nn.Linear(96, 33)).to(
        cuda_device)
    kw = {"plain": dict(use_multi_tensor=False, use_fused=False),
          "use_fused": dict(use_fused=True, use_multi_tensor=False),
          "multi": dict(use_multi_tensor=True),
          "arena": dict(flat_arena=True)}[route]
    kernel_switch(fused_adam_multi=route == "arena")
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=list(
        model.parameters()), grad_clip=clip.ClipGradByGlobalNorm(1.0), **kw)
    amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    x = torch.randn(8, 64, device=cuda_device)

    def step():
        with amp.auto_cast(level="O2"):
            y = model(x)
        scaler.scale((y.float() ** 2).mean() * 100).backward()
        scaler.step(opt)
        opt.clear_grad()

    kernels.reset_launches()
    for _ in range(2):
        step()
    want = {"plain": {}, "use_fused": {"fused_adam": 8},
            "multi": {"fused_adam_multi": 2},
            "arena": {"fused_adam_flat": 2}}[route]
    assert {k: n for k, n in kernels.launches.items() if n} == want
    state = [t.clone() for t in _optimizer_state(opt, model)]
    scaler.set_state_dict({"scale": 3.4e38, "good": 1, "bad": 0})
    step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in
               zip(_optimizer_state(opt, model), state))
    assert scaler.state_dict() == {"scale": float(torch.tensor(3.4e38) * 0.5),
                                   "good": 0, "bad": 0}


def _optimizer_state(opt, model):
    """Every tensor a step may write: parameters, slots, arena buffers and
    pows."""
    out = list(model.parameters())
    for slots in opt._accumulators.values():
        out += list(slots.values())
    if opt._arena is not None:
        for grp in opt._arena.groups:
            out += [grp.flat] + list(grp.slots.values()) + \
                list(grp.pows.values())
    return out


def _recipe_mlp_arms(device, route):
    """Two identical bf16 (O2) MLPs, each with the recipe's AdamW (a
    warm-up and decay schedule, ``ClipGradByGlobalNorm(1.0)``) on
    ``route`` and a ``GradScaler``: ``(model, opt, sched, scaler, step)``
    each."""
    from paddle_tpu_torch import amp, clip
    from paddle_tpu_torch.optimizer import lr
    torch.manual_seed(0)
    first = nn.Sequential(nn.Linear(256, 512), nn.ReLU(),
                          nn.Linear(512, 64)).to(device)
    kw = {"plain": dict(use_multi_tensor=False, use_fused=False),
          "use_fused": dict(use_fused=True, use_multi_tensor=False),
          "multi": dict(use_multi_tensor=True),
          "arena": dict(flat_arena=True)}[route]
    arms = []
    for model in (first, copy.deepcopy(first)):
        sched = lr.LinearWarmup(lr.PolynomialDecay(1e-3, decay_steps=20),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
        opt = optimizer.AdamW(learning_rate=sched, parameters=list(
            model.parameters()), grad_clip=clip.ClipGradByGlobalNorm(1.0),
            **kw)
        amp.decorate(model, opt, level="O2")
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                incr_every_n_steps=2)

        def step(x, y, model=model, opt=opt, scaler=scaler):
            with amp.auto_cast(level="O2"):
                d = model(x).float() - y
            loss = (d * d).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            return loss.detach()

        arms.append((model, opt, sched, scaler, step))
    return arms


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plain", "use_fused", "multi", "arena"])
def test_recipe_graph_replays_a_rate_and_scale_set_from_the_host(
        cuda_device, kernel_switch, route):
    """The recipe on a bf16 MLP (no atomic sums, so the graphed and the
    eager step agree to the bit) on each optimizer route, graphed by
    ``jit.to_static`` against the same step made eagerly, over 7 calls
    with the scheduler stepped between them: before the fourth the rate
    (3e-3) and a scale that is no power of two (1000) are set from the
    host, and the fifth is forced to overflow (the scale set back after
    it). After each call the
    losses, every parameter, slot, arena buffer and pow, and the scaler's
    state are equal bit for bit; the parameters move on every call but
    the first (rate 0) and the overflowed one, which leaves all the state
    as it was; one capture, the kernel route's launches each call."""
    from paddle_tpu_torch import jit
    kernel_switch(fused_adam_multi=route == "arena")
    arms = _recipe_mlp_arms(cuda_device, route)
    f = jit.to_static(arms[0][4])
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batches = [(torch.randn(64, 256, device=cuda_device, generator=g),
                torch.randn(64, 64, device=cuda_device, generator=g))
               for _ in range(7)]
    kernels.reset_launches()
    for i, (x, y) in enumerate(batches):
        for _, o, _, scaler, _ in arms:
            if i == 3:
                o.set_lr(3e-3)
                scaler.set_state_dict({"scale": 1000.0, "good": 0,
                                       "bad": 0})
            if i == 4:
                scaler.set_state_dict({"scale": 3.4e38, "good": 1,
                                       "bad": 0})
            if i == 5:
                scaler.set_state_dict({"scale": 2.0 ** 10, "good": 0,
                                       "bad": 0})
        model, o = arms[1][0], arms[1][1]
        params = [p.detach().clone() for p in model.parameters()]
        state = [t.clone() for t in _optimizer_state(o, model)]
        got, want = f(x, y), arms[1][4](x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert all(torch.equal(a, b) for a, b in zip(
            *(_optimizer_state(o_, m_) for m_, o_, *_ in arms))), i
        assert arms[0][3].state_dict() == arms[1][3].state_dict(), i
        moved = [not torch.equal(a, b) for a, b in
                 zip(model.parameters(), params)]
        assert all(moved) == (i not in (0, 4)) and any(moved) == all(
            moved), i
        if i == 4:
            assert all(torch.equal(a, b) for a, b in
                       zip(_optimizer_state(o, model), state))
        for _, _, sched, _, _ in arms:
            sched.step()
    (entry,) = f._cache.values()
    assert entry.graph is not None and entry.replays == len(batches) - 1
    name, per_call = {"plain": (None, 0), "use_fused": ("fused_adam", 4),
                      "multi": ("fused_adam_multi", 1),
                      "arena": ("fused_adam_flat", 1)}[route]
    launched = {k: n for k, n in kernels.launches.items()
                if n and k.startswith("fused_adam")}
    assert launched == ({name: per_call * 2 * len(batches)} if name
                        else {})


def _arena_apart(got, want, before):
    """Elements of p, m and v (one arena group's buffers) not bit-equal
    between ``got`` and ``want``, apart by more than one bf16 step, and
    moved from ``before`` in ``want``: counts for each."""
    out = {}
    for name, a, b, b0 in zip("pmv", got, want, before):
        a32, b32 = a.float(), b.float()
        _, e = torch.frexp(torch.maximum(a32.abs(), b32.abs()))
        step = torch.ldexp(torch.ones_like(a32), e - 8)
        out[name] = dict(differ=int((a != b).sum()),
                         beyond_step=int(((a32 - b32).abs() > step).sum()),
                         moved=int((b != b0).sum()), n=b.numel())
    return out


@pytest.mark.cuda
def test_recipe_graph_equals_eager_and_replays_new_rate_and_scale(
        cuda_device, kernel_switch):
    """The bench's recipe (O2, schedule, clip, scaler) on a 2-layer BERT,
    flat arena and fused loss: the graphed step against the eager one
    over 6 calls with the scheduler stepped between them and, before the
    third, the rate (9e-5) and the scale (1000) set from the host on
    both; the graphed trainer is given the eager one's arena before each
    call, so each call is one update from one state. The same losses, the
    device rate each call's, the scale 1000 doubled after 4 good steps,
    no capture after the first; after each call the pows bit-equal
    and, of p, m and v, at most a fifth as many elements not bit-equal as
    the eager call moved (PyTorch's embedding backward sums with atomics,
    so two eager arms part too) and at most 0.5% apart by more than one
    bf16 step: a graph that updated nothing, or kept an earlier rate or
    scale, parts wherever the eager call moved."""
    kernel_switch(softmax_xent=True, fused_adam_multi=True)
    arms = [bench_bert.Trainer(8, 64, 1, opt_kw=dict(flat_arena=True),
                               token_types=True, recipe=True, **GRAPH_BERT)
            for _ in range(2)]
    for tr in arms:
        tr.opt._ensure_all_slots()
    bufs = [[t for grp in tr.opt._arena.groups for t in
             [grp.flat] + list(grp.slots.values()) + list(grp.pows.values())]
            for tr in arms]
    losses = [[], []]
    for i in range(6):
        with torch.no_grad():
            for a, b in zip(*bufs):
                a.copy_(b)
        rate = None
        if i == 2:
            rate = 9e-5
            for tr in arms:
                tr.opt.set_lr(rate)
                tr.scaler.set_state_dict({"scale": 1000.0, "good": 0,
                                          "bad": 0})
        before = [t.clone() for t in bufs[1][:3]]
        for arm, (tr, out) in enumerate(zip(arms, losses)):
            want_rate = tr.sched.last_lr if rate is None else rate
            assert float(next(iter(tr.opt._lr.values()))) == float(
                torch.tensor(want_rate, dtype=torch.float32))
            out.append(tr.call(graph=arm == 0))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(bufs[0][3:],
                                                     bufs[1][3:])), i
        apart = _arena_apart(bufs[0][:3], bufs[1][:3], before)
        for name, c in apart.items():
            assert c["beyond_step"] <= 5e-3 * c["n"], (i, apart)
            if name == "m" or (name == "p" and i):
                assert c["moved"] and 5 * c["differ"] <= c["moved"], \
                    (i, apart)
    (entry,) = arms[0].step._cache.values()
    assert entry.replays == 5
    for tr in arms:
        assert tr.scaler.state_dict() == {"scale": 2000.0, "good": 0,
                                          "bad": 0}
    torch.testing.assert_close(torch.cat(losses[0]), torch.cat(losses[1]),
                               rtol=1e-5, atol=1e-5)


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


# -- generative serving: the prefill's causal attention, and the engine ------

@pytest.mark.cuda
@pytest.mark.parametrize("h,s,d", [(4, 1, 64), (4, 4, 64), (4, 16, 64),
                                   (2, 16, 8), (2, 4, 96), (2, 16, 96)])
def test_flash_causal_f32_at_prefill_lengths(cuda_device, h, s, d):
    """The prefill's shapes: one prompt, (1, H, L, Dh) float32 causal
    views of a (1, L, H, Dh) projection, L far below the kernel's query
    tile (padded query rows, the causal edge inside one tile); head dim
    8 runs zero-padded to 64, and 96 (the speculative pair's) to 128."""
    g = torch.Generator(device=cuda_device).manual_seed(s * 100 + d)
    qkv = torch.randn(3, 1, s, h, d, device=cuda_device, generator=g)
    q, k, v = (t.transpose(1, 2) for t in qkv)
    before = kernels.launches["flash_attention_fwd"]
    out, m, l = FA.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention_fwd"] == before + 1
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, causal=True)
    assert _scaled_err(out, out0) <= TOL[torch.float32]
    assert _scaled_err(m, m0) <= 1e-4 and _scaled_err(l, l0) <= 1e-4
    # row 0 sees key 0 alone
    assert _scaled_err(out[:, :, 0], v[:, :, 0]) <= TOL[torch.float32]


@pytest.mark.cuda
def test_generate_engine_on_card_matches_cpu(cuda_device):
    """A small engine on the card against the same weights on the CPU:
    each prefill launches the flash kernel once a layer, a decode tick
    never; the card's logits along the CPU's greedy streams are within
    1e-4 scaled of the CPU's at every position (teacher-forced), and the
    streams agree wherever the CPU's top-2 margin exceeds that."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    cpu = serving.demo_model(vocab=64, dim=256, heads=4, layers=2,
                             max_len=128, seed=1, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    prompts = [[1, 2, 3], list(range(1, 17)), [5] * 9, [30, 2]]
    streams = {}
    for name, model in (("cpu", cpu), ("card", card)):
        eng = serving.GenerateEngine(model, slots=4, page=32, max_len=128,
                                     prompt_buckets=(4, 16), start=False,
                                     shed=False)
        eng.warmup()
        before = eng.executables()
        kernels.reset_launches()
        futs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        for _ in range(100):
            if all(f.done() for f in futs):
                break
            eng.tick()
        streams[name] = [list(map(int, f.result(timeout=60))) for f in futs]
        launches = kernels.launches["flash_attention_fwd"]
        st = eng.stats()
        assert eng.executables() == before
        eng.close()
        want = model.layers * st["prefills"] if name == "card" else 0
        assert launches == want
    for p, want, got in zip(prompts, streams["cpu"], streams["card"]):
        ref = teacher_forced_logits(cpu, p, want)
        on_card = teacher_forced_logits(card, p, want)
        scale = np.maximum(1.0, np.abs(ref))
        assert (np.abs(on_card - ref) / scale).max() <= 1e-4
        top2 = np.sort(ref, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 1e-4 * scale.max(axis=-1)
        # the card's free-running stream agrees up to its first near-tie
        first_tie = int(np.argmin(sure)) if not sure.all() else len(want)
        assert got[:first_tie] == want[:first_tie]
        assert (np.argmax(on_card, axis=-1)[sure] == np.asarray(want)[sure]
                ).all()


@pytest.mark.cuda
def test_spec_engine_on_card_completes_a_brim_request(cuda_device):
    """The speculative engine on the card: a request at prompt + new equal
    to the model's max_len (its chunks reach past the position table and
    the arena: no device assert), each prefill launching the flash
    kernel once a layer of both models and a tick never, and greedy
    speculation giving the greedy plain stream up to its first near-tie
    of the target's teacher-forced logits."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    target, draft = serving.demo_spec_pair(vocab=64, dim=192, heads=2,
                                           draft_layers=1, extra_layers=3,
                                           max_len=32, seed=1, distill=0.1)
    prompt = list(range(1, 9))
    streams = {}
    for name, d in (("plain", None), ("spec", draft)):
        eng = serving.GenerateEngine(target, slots=4, page=16, max_len=32,
                                     prompt_buckets=(16,), start=False,
                                     shed=False, draft_model=d, spec_k=8)
        eng.warmup()
        before = eng.executables()
        kernels.reset_launches()
        futs = [eng.submit(prompt, max_new_tokens=24),
                eng.submit(prompt[:3], max_new_tokens=29,
                           sampling={"temperature": 1.0}, seed=5)]
        for _ in range(100):
            if all(f.done() for f in futs):
                break
            eng.tick()
        streams[name] = [list(map(int, f.result(timeout=60))) for f in futs]
        st = eng.stats()
        assert eng.executables() == before and st["failed"] == 0
        layers = target.layers + (draft.layers if d is not None else 0)
        assert kernels.launches["flash_attention_fwd"] == \
            layers * st["prefills"]
        eng.close()
    assert [len(s) for s in streams["spec"]] == [24, 29]
    want, got = streams["plain"][0], streams["spec"][0]
    logits = teacher_forced_logits(target, prompt, want)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4 * np.maximum(
        1.0, np.abs(top2[:, 1]))
    first_tie = int(np.argmin(sure)) if not sure.all() else len(want)
    assert got[:first_tie] == want[:first_tie]


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [16, 32])
def test_kv_segment_round_trip_on_card(cuda_device, pad):
    """A KV segment off the card and back: leaves bit for bit, bytes =
    ``bytes_per_token x pad``, the arena's footprint unchanged, the ledger
    length carried; a segment built on the host lands the same way."""
    from paddle_tpu_torch.serving.kv_cache import KVCachePool, bytes_per_token
    spec = {"k0": ((4, 64), "float32"), "v0": ((4, 64), "float32"),
            "k1": ((4, 64), "float32"), "v1": ((4, 64), "float32")}
    src = KVCachePool(spec, slots=3, page=16, max_len=64)
    src.grow_to(32, lambda b, o, n: {k: torch.cat([v, torch.zeros(
        (v.shape[0], n - o) + tuple(v.shape[2:]), device=v.device)], 1)
        for k, v in b.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for buf in src.buffers.values():
        buf.copy_(torch.randn(buf.shape, device="cuda", generator=gen))
    s = src.alloc()
    src.note_length(s, pad - 3)
    before = src.allocated_bytes()
    seg = src.export_slot(s, pad_to=pad)
    assert src.allocated_bytes() == before
    assert seg["bytes"] == bytes_per_token(spec) * pad
    for name, buf in src.buffers.items():
        assert isinstance(seg["leaves"][name], np.ndarray)
        np.testing.assert_array_equal(seg["leaves"][name],
                                      buf[s, :pad].cpu().numpy())
    dst = KVCachePool(spec, slots=2, page=16, max_len=64)
    dst.grow_to(32, lambda b, o, n: {k: torch.cat([v, torch.zeros(
        (v.shape[0], n - o) + tuple(v.shape[2:]), device=v.device)], 1)
        for k, v in b.items()})
    dst.alloc()
    d = dst.alloc()
    before = dst.allocated_bytes()
    assert dst.import_slot(d, seg) == seg["bytes"]
    assert dst.allocated_bytes() == before and dst.length(d) == pad - 3
    for name in spec:
        assert torch.equal(dst.buffers[name][d, :pad],
                           src.buffers[name][s, :pad])
        assert not dst.buffers[name][0].any()


@pytest.mark.cuda
def test_kv_hand_off_stream_on_card(cuda_device):
    """Two engines on the card: lanes exported mid-stream (and a queued
    request moved bare) from the first, imported by a warmed
    ``kv_import=True`` second engine that meets no new signature, imports
    without a prefill (no flash launch for an imported lane) and continues
    each sampled stream as the unmoved run on the card gives it, up to a
    counted near-tie."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving import sampling as S
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    model = serving.demo_model(vocab=64, dim=256, heads=4, layers=2,
                               max_len=96, seed=1)
    eng_kw = dict(slots=4, page=32, max_len=96, prompt_buckets=(4, 16),
                  shed=False)
    jobs = [([1, 2, 3], 40), (list(range(1, 17)), 24), ([5] * 9, 30),
            ([30, 2], 12), ([7, 7, 7, 7, 7], 20)]
    knobs = {"temperature": 1.0, "top_k": 20, "top_p": 0.9}

    def submit(eng):
        return [eng.submit(p, max_new_tokens=n, sampling=knobs,
                           seed=100 + i) for i, (p, n) in enumerate(jobs)]

    def drive(eng, futs):
        for _ in range(400):
            if all(f.done() for f in futs):
                break
            eng.tick()
        return [list(map(int, f.result(timeout=60))) for f in futs]

    clean = serving.GenerateEngine(model, start=False, **eng_kw)
    want = drive(clean, submit(clean))
    clean.close()
    a = serving.GenerateEngine(model, start=False, **eng_kw)
    futs = submit(a)
    for _ in range(5):
        a.tick()
    moved = a.disown_inflight(export_kv=True) + a.steal_pending()
    a.close(drain=False)
    exported = [r for r in moved if r.preset is not None]
    assert len(exported) == 4 and len(moved) == 5
    b = serving.GenerateEngine(model, start=False, kv_import=True, **eng_kw)
    b.warmup()
    before = b.executables()
    kernels.reset_launches()
    b.requeue(moved)
    got = drive(b, futs)
    st = b.stats()
    assert b.executables() == before and st["kv_imports"] == 4
    assert st["prefills"] == 1
    assert kernels.launches["flash_attention_fwd"] == model.layers
    b.close()
    parted = 0
    for i, ((prompt, n), w, g) in enumerate(zip(jobs, want, got)):
        assert len(g) == n
        t = next((j for j in range(n) if w[j] != g[j]), None)
        if t is None:
            continue
        z = torch.from_numpy(teacher_forced_logits(model, prompt,
                                                   w[:t + 1])[t:])
        filt = S.filter_logits(z, [1.0], [20], [0.9])
        scored = (filt + S.gumbel(S.keys_for([100 + i], [t], S.SALT_TOKEN),
                                  64))[0]
        top2 = torch.topk(scored, 2).values
        assert float(top2[0] - top2[1]) <= 1e-4 * max(1.0, abs(float(
            top2[0])))
        parted += 1
    assert parted < len(jobs)


@pytest.mark.cuda
def test_bert_fleet_two_replicas_share_the_card(cuda_device):
    """Two replicas of a small BERT on the one card, each with its own
    weights there: replica 0 fails three batch attempts inside a
    four-attempt retry policy, its breaker opens and traffic routes to
    replica 1; every output matches the CPU's, and the kernels launch per
    executed batch over both replicas (2 layers: 5 layer norms, 2
    attentions)."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    from paddle_tpu_torch.serving import MultiDeviceEngine
    torch.manual_seed(0)
    cpu = Bert(BertConfig.tiny()).eval()
    card = copy.deepcopy(cpu)
    fleet = MultiDeviceEngine(
        Predictor(card), devices=["cuda:0", "cuda:0"], buckets=[4, 8],
        max_batch=8, timeout_ms=1.0, hedge_ms=0, supervise=False,
        breaker_cooldown_s=600.0,
        retry_policy=RetryPolicy(max_attempts=4, base_delay=0.001,
                                 max_delay=0.001, jitter=0.0))
    rng = np.random.RandomState(0)
    reqs = []
    for rows in (1, 3, 2, 4, 1, 2):
        ids = rng.randint(0, 1024, (rows, 16)).astype("int32")
        tt = (rng.rand(rows, 16) < 0.5).astype("int32")
        mask = np.ones((rows, 16), "int32")
        reqs.append((ids, tt, mask))
    try:
        ptrs = [next(iter(r.predictor.state.values())).data_ptr()
                for r in fleet._replicas]
        assert len(set(ptrs)) == 2
        assert all(r.device == torch.device("cuda", 0)
                   for r in fleet._replicas)
        fleet.warmup([((16,), "int32")] * 3)
        spec = faults.inject("replica_error", replica=0, times=3)
        kernels.reset_launches()
        outs = [fleet.run(*r, timeout=120) for r in reqs]
        st = fleet.stats()
        assert spec.fired == 3 and st["breakers"][0] == "open"
        assert [r["submitted"] for r in st["replicas"]] == [1, 5]
        for r, out in zip(reqs, outs):
            with torch.inference_mode():
                want = cpu(*(torch.from_numpy(a) for a in r))
            for a, b in zip(out, want):
                assert np.abs(a - b.numpy()).max() <= 1e-4
        assert kernels.launches["layer_norm_fwd"] == 5 * st["batches"]
        assert kernels.launches["flash_attention_fwd"] == 2 * st["batches"]
    finally:
        faults.clear()
        fleet.close()


@pytest.mark.cuda
def test_decode_fleet_fails_over_on_the_card(cuda_device):
    """Two decode replicas on the one card: replica 1 hangs in a tick with
    its lanes seated, the supervisor moves them to replica 0, and every
    sampled stream equals a single engine's on the card, up to a counted
    near-tie."""
    import threading
    import time
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import sampling as S
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    model = serving.demo_model(vocab=64, dim=256, heads=4, layers=2,
                               max_len=96, seed=1)
    eng_kw = dict(slots=4, page=32, max_len=96, prompt_buckets=(4, 16),
                  shed=False)
    jobs = [([1 + i, 2, 3][: 1 + i % 3], 20 + i) for i in range(8)]
    knobs = {"temperature": 1.0, "top_k": 20, "top_p": 0.9}
    single = serving.GenerateEngine(model, **eng_kw)
    want = [list(map(int, single.submit(p, max_new_tokens=n,
                                        sampling=knobs, seed=200 + i)
                     .result(timeout=60))) for i, (p, n) in enumerate(jobs)]
    single.close()
    fleet = serving.MultiDecodeEngine(
        model, devices=["cuda:0", "cuda:0"], start=False,
        supervisor_interval_s=0.02, inflight_timeout_ms=300,
        restart_after_s=600.0, breaker_cooldown_s=600.0, **eng_kw)
    hung = fleet.engines[1]
    ticker = threading.Thread(target=hung.tick, daemon=True)
    try:
        fleet.warmup()
        fleet.engines[0].start()
        futs = [fleet.submit(p, max_new_tokens=n, sampling=knobs,
                             seed=200 + i) for i, (p, n) in enumerate(jobs)]
        hung.tick()                         # seats its four lanes
        assert hung.heartbeat()["active"] == 4
        faults.inject("replica_hang", replica=1, delay=3.0)
        t0 = time.monotonic()
        ticker.start()
        got = [list(map(int, f.result(timeout=60))) for f in futs]
        assert time.monotonic() - t0 < 2.5
        assert fleet.stats()["failovers"] == 1
    finally:
        faults.clear()
        fleet.close(drain=False, timeout=5.0)
        ticker.join(10.0)
    assert not ticker.is_alive()
    parted = 0
    for i, ((prompt, n), w, g) in enumerate(zip(jobs, want, got)):
        assert len(g) == n
        t = next((j for j in range(n) if w[j] != g[j]), None)
        if t is None:
            continue
        z = torch.from_numpy(teacher_forced_logits(model, prompt,
                                                   w[:t + 1])[t:])
        filt = S.filter_logits(z, [1.0], [20], [0.9])
        scored = (filt + S.gumbel(S.keys_for([200 + i], [t], S.SALT_TOKEN),
                                  64))[0]
        top2 = torch.topk(scored, 2).values
        assert float(top2[0] - top2[1]) <= 1e-4 * max(1.0, abs(float(
            top2[0])))
        parted += 1
    assert parted < len(jobs)


# -- CUDA graphs: jit.to_static's step and the Predictor's executables ----------

GRAPH_BERT = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
                  intermediate_size=256, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_kw", [None, dict(flat_arena=True)])
def test_to_static_graph_equals_eager_for_a_bert_step(cuda_device, opt_kw,
                                                      kernel_switch):
    """Three calls of two 2-layer BERT steps at dropout 0, the first eager
    and captured, two replayed, against the same calls made eagerly from
    the same weights: the same losses and parameters within 1e-5, not
    to the bit (PyTorch's embedding backward sums with atomics, so two
    eager trainers part as well; ``chip_smoke.py`` phase 17 measures
    both pairs at BERT-base), and the replays count the launches the
    eager calls made."""
    if opt_kw:
        kernel_switch(softmax_xent=True, fused_adam_multi=True)
    eager = bench_bert.Trainer(8, 64, 2, opt_kw=opt_kw, **GRAPH_BERT)
    graph = bench_bert.Trainer(8, 64, 2, opt_kw=opt_kw, **GRAPH_BERT)
    # to_static creates the slots (and builds the arena) before the first
    # step; the eager trainer does so too, so both start from one layout
    eager.opt._ensure_all_slots()
    kernels.reset_launches()
    want = torch.cat([eager.eager_step(*eager.data) for _ in range(3)])
    torch.cuda.synchronize()
    eager_launches = dict(kernels.launches)
    kernels.reset_launches()
    got = torch.cat([graph.step(*graph.data) for _ in range(3)])
    torch.cuda.synchronize()
    assert dict(kernels.launches) == eager_launches
    (entry,) = graph.step._cache.values()
    assert entry.graph is not None and entry.replays == 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for p, q in zip(graph.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_graph_replays_draw_fresh_flash_seed_words(cuda_device):
    """Each replay of a captured dropout draw gives new seed words, and the
    forward kernel under the replay reads them: its output is the plain
    version's at that replay's words. A BERT forward in train mode with
    attention dropout alone differs between two replays."""
    from paddle_tpu_torch import jit, random, seed
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 2, 64, 64, device=cuda_device, generator=g)

    def draw(q):
        words = random.next_seed_words(q.device)
        out, _, _ = FA.flash_attention_fwd(q, q, q, dropout_p=0.1,
                                           seed=words)
        return words, out

    f = jit.to_static(draw)
    f(q)
    replays = [f(q) for _ in range(2)]
    (w1, o1), (w2, o2) = replays
    assert not torch.equal(w1, w2) and not torch.equal(o1, o2)
    for w, o in replays:
        ref, _, _ = FA.flash_attention_fwd_plain(q, q, q, dropout_p=0.1,
                                                 seed=w)
        assert _scaled_err(o, ref) <= TOL[torch.float32]
    seed(0)
    model = Bert(BertConfig.tiny(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.1)).to(
        cuda_device).train()
    ids = torch.randint(0, 100, (2, 64), device=cuda_device, generator=g)
    fwd = jit.to_static(lambda ids: model(ids)[0], models=[model])
    fwd(ids)
    a, b = fwd(ids), fwd(ids)
    assert not torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_predictor_graphs_match_eager_and_follow_a_rebinding(cuda_device,
                                                             precision):
    """A 2-layer BERT Predictor's replays equal its module's eager forward
    within the kernels' tolerance; a module captured ahead
    (``prepare``) and then bound serves its own weights with no capture
    on the call path."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import Config
    seed(0)
    cfg = Config().enable_bf16() if precision == "bfloat16" else None
    pred = Predictor(Bert(BertConfig.tiny(**GRAPH_BERT)).eval(), cfg)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    ids = torch.randint(0, 100, (4, 64), device=cuda_device, generator=g,
                        dtype=torch.int32)
    pred.warmup([((4, 64), "int32")])
    assert pred.captures == 1
    got = pred.run_device(ids)
    with torch.inference_mode():
        want = pred.model(ids)
    for a, b in zip(got, want):
        assert _scaled_err(a, b) <= TOL[a.dtype]
    fresh = copy.deepcopy(pred.model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.mul_(0.5)
    assert pred.prepare(fresh) == 1
    pred.model = fresh
    got = pred.run_device(ids)
    assert pred.captures == 2 and len(pred._compiled) == 1
    with torch.inference_mode():
        want = fresh(ids)
    for a, b in zip(got, want):
        assert _scaled_err(a, b) <= TOL[a.dtype]


@pytest.mark.cuda
def test_a_step_with_item_raises_at_capture_and_does_not_fall_back(
        cuda_device):
    """``.item()`` inside a step cannot be captured: the first call's
    eager run succeeds, its capture raises ``CaptureError`` naming the
    line, and the step is not run a third time eagerly."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.graphs import CaptureError
    runs = []

    def step(x):
        runs.append(1)
        return x * float(x.sum().item())

    f = jit.to_static(step)
    with pytest.raises(CaptureError, match=r"x\.sum\(\)\.item\(\)"):
        f(torch.ones(4, device=cuda_device))
    assert len(runs) == 2
    torch.cuda.synchronize()
    assert float((torch.ones(4, device=cuda_device) * 2).sum()) == 8.0


@pytest.mark.cuda
def test_a_decode_step_that_syncs_raises_capture_error(cuda_device):
    """A ``GenerateEngine`` step whose body reads a value back to the host
    cannot be captured: ``warmup`` raises ``CaptureError`` naming the
    line, and no eager step takes over."""
    from paddle_tpu_torch.graphs import CaptureError
    from paddle_tpu_torch.serving import GenerateEngine
    from paddle_tpu_torch.serving.generate import DemoLM

    class SyncingLM(DemoLM):
        def decode_fn(self, state, tokens, kv, lengths):
            if float(lengths.max()) < 0:
                raise AssertionError("a length below zero")
            return super().decode_fn(state, tokens, kv, lengths)

    lm = SyncingLM(vocab=32, dim=16, heads=2, layers=2, max_len=64,
                   device=cuda_device)
    eng = GenerateEngine(lm, slots=3, page=8, max_len=32,
                         prompt_buckets=(4, 8), start=False)
    with pytest.raises(CaptureError, match=r"float\(lengths\.max\(\)\)"):
        eng.warmup()
    assert eng.captures == 0
    eng.close(drain=False)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_graphed_decode_engine_equals_its_eager_arm(cuda_device, spec):
    """On the card every tick and admission of a warmed engine replays a
    graph (no capture after warmup) and the streams equal the eager arm's
    (the same bodies run launch by launch), greedy and sampled; the
    graphs' pool holds memory after warmup, the eager arm's none."""
    from paddle_tpu_torch import graphs
    from paddle_tpu_torch.serving import GenerateEngine, demo_model
    from paddle_tpu_torch.tools.decode_loadgen import EagerEngine
    lm = demo_model(vocab=32, dim=64, heads=2, layers=2, max_len=64,
                    device=cuda_device)
    jobs = [([1, 2, 3], 28, {}), ([5, 4, 3], 9, {}),
            ([3, 1, 4], 12, {"sampling": {"temperature": 1.0}, "seed": 2}),
            ([9, 8], 20, {"sampling": {"temperature": 0.8, "top_k": 5,
                                       "top_p": 0.9}, "seed": 3})]
    out = {}
    for cls in (GenerateEngine, EagerEngine):
        eng = cls(lm, slots=3, page=8, max_len=32, prompt_buckets=(4, 8),
                  start=False, draft_model=lm if spec else None, spec_k=4)
        eng.warmup()
        caps = eng.captures
        pool = graphs.pool_bytes(eng._graphs.pool)
        assert (pool > 0) == (cls is GenerateEngine)
        futs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in jobs]
        for _ in range(500):
            if all(f.done() for f in futs):
                break
            eng.tick()
        st = eng.stats()
        out[cls] = [[int(t) for t in f.result(timeout=10)] for f in futs]
        assert eng.captures == caps and st["grows"] == 2
        if cls is GenerateEngine:
            assert caps > 0 and st["tick_replays"] == st["ticks"]
            assert st["prefill_replays"] == st["prefills"] == len(jobs)
        eng.close(drain=False)
    assert out[GenerateEngine] == out[EagerEngine]


def _disagg_jobs():
    return [([1, 2, 3], 12, None, None), ([5] * 7, 9, None, None),
            ([1, 2, 3], 12, {"temperature": 1.0}, 5),      # a prefix hit
            ([9, 8, 7], 10, {"temperature": 0.8, "top_k": 5,
                             "top_p": 0.9}, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_graphed_disagg_server_equals_the_single_engine(cuda_device,
                                                        sampled):
    """The split topology on the card (a prefill pool and a decode pool,
    graphed) gives the graphed single engine's streams token for token:
    one arena capacity, so both run the same graphs at the same shapes;
    nothing captured or met after warmup."""
    from paddle_tpu_torch.serving import DisaggServer, GenerateEngine
    from paddle_tpu_torch.serving import demo_model
    lm = demo_model(vocab=32, dim=64, heads=2, layers=2, max_len=64,
                    device=cuda_device)
    kw = dict(slots=4, page=32, max_len=32, prompt_buckets=(8,))
    jobs = [(p, n, sp if sampled else None, s if sampled else None)
            for p, n, sp, s in _disagg_jobs()]
    eng = GenerateEngine(lm, start=False, **kw)
    eng.warmup()
    futs = [eng.submit(p, max_new_tokens=n, sampling=sp, seed=s)
            for p, n, sp, s in jobs]
    for _ in range(500):
        if all(f.done() for f in futs):
            break
        eng.tick()
    want = [[int(t) for t in f.result(timeout=10)] for f in futs]
    eng.close(drain=False)
    srv = DisaggServer(lm, prefill_devices=[cuda_device],
                       decode_devices=[cuda_device] * 2, supervise=False,
                       **kw)
    srv.warmup()
    counts = [(r.engine.executables(), r.engine.captures)
              for pool in (srv.prefill_pool, srv.decode_pool)
              for r in pool._replicas]
    futs = [srv.submit(p, max_new_tokens=n, sampling=sp, seed=s)
            for p, n, sp, s in jobs]
    got = [[int(t) for t in f.result(timeout=60)] for f in futs]
    st = srv.stats()
    after = [(r.engine.executables(), r.engine.captures)
             for pool in (srv.prefill_pool, srv.decode_pool)
             for r in pool._replicas]
    srv.close()
    assert got == want
    assert after == counts
    assert st["prefix"]["hits"] == 1 and st["decode"]["prefills"] == 0
    assert st["handoff_bytes"] == sum(srv.planned_handoff_ms(len(p))[0]
                                      for p, *_ in jobs)


@pytest.mark.cuda
def test_a_prefix_hit_launches_no_flash_kernel(cuda_device):
    """A miss replays the prefill graph (kernel #3 once a layer); a hit of
    the same prompt samples from the cached logits and launches none."""
    from paddle_tpu_torch.serving import PrefixCache, demo_model
    from paddle_tpu_torch.serving.disagg import PrefillEngine
    lm = demo_model(vocab=32, dim=64, heads=2, layers=2, max_len=64,
                    device=cuda_device)
    got = []
    eng = PrefillEngine(lm, prompt_buckets=(8,), max_len=32, page=32,
                        start=False, cache=PrefixCache(lm.kv_spec()),
                        on_segment=lambda *a: got.append(a[1:]))
    eng.warmup()
    kernels.reset_launches()
    eng._process(eng.make_request([4, 2, 7], max_new_tokens=4))
    assert kernels.launches["flash_attention_fwd"] == lm.layers
    eng._process(eng.make_request([4, 2, 7], max_new_tokens=4))
    assert kernels.launches["flash_attention_fwd"] == lm.layers
    st = eng.stats()
    eng.close()
    assert [hit for _seg, _first, hit in got] == [False, True]
    assert got[0][1] == got[1][1] and got[1][0] is got[0][0]
    # a greedy hit's first token is the cached logits' argmax, on the host
    assert st["prefill_replays"] == 1 and st["psample_replays"] == 0


@pytest.mark.cuda
def test_a_prefill_step_that_syncs_raises_capture_error(cuda_device):
    """A ``PrefillEngine`` prefill whose body reads a value back to the
    host cannot be captured: ``warmup`` raises ``CaptureError`` naming
    the line, and no eager step takes over."""
    from paddle_tpu_torch.graphs import CaptureError
    from paddle_tpu_torch.serving.disagg import PrefillEngine
    from paddle_tpu_torch.serving.generate import DemoLM

    class SyncingLM(DemoLM):
        def prefill_fn(self, state, tokens, lengths):
            if int(lengths.min()) < 0:
                raise AssertionError("a length below zero")
            return super().prefill_fn(state, tokens, lengths)

    lm = SyncingLM(vocab=32, dim=16, heads=2, layers=2, max_len=64,
                   device=cuda_device)
    eng = PrefillEngine(lm, prompt_buckets=(4, 8), max_len=32, page=8,
                        start=False)
    with pytest.raises(CaptureError, match=r"int\(lengths\.min\(\)\)"):
        eng.warmup()
    assert eng.captures == 0
    eng.close()


# -- the deployment path: the int8 kernels, the int8 Predictor, export ---------

def _int8_operands(dev, m, k, n, seed, x_dtype=torch.float32, pitch=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k + pitch, device=dev, generator=g).to(x_dtype)
    x = x[:, :k]
    asc = x.float().abs().amax() * 0.9
    b = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                      dtype=torch.int8)
    ws = torch.rand(n, device=dev, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(n, device=dev, generator=g)
    return x, asc, b, ws, bias


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 768, 2304), (4096, 768, 768),
                                   (4096, 768, 3072), (4096, 3072, 768),
                                   (16, 64, 10), (4, 8, 4), (2, 8, 4),
                                   (1000, 147, 64)])
def test_int8_kernels_match_plain(cuda_device, m, k, n):
    """The quantizer's values and the GEMM's int32 sums equal the plain
    versions' (the sums read through unit scales, exact below 2^24), the
    f32 outputs within one float32 ulp (the epilogue is __fmul_rn /
    __fadd_rn in the plain version's order: 0 expected)."""
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    x, asc, b, ws, bias = _int8_operands(cuda_device, m, k, n, m + k + n)
    q = G.int8_quantize(x, asc)
    assert torch.equal(q, G.int8_quantize_plain(x, asc, 127))
    one = torch.ones(n, device=cuda_device)
    acc = G.int8_gemm(q, b, one, torch.tensor(127.0, device=cuda_device))
    want = torch.matmul(q.double(), b.double().t())
    assert want.abs().max() < 2 ** 24 and torch.equal(acc.double(), want)
    out = G.int8_gemm(q, b, ws, asc, bias)
    ref = G.int8_gemm_plain(q, b, ws, asc, bias, 127, torch.float32)
    ulp = torch.nextafter(ref.abs(), torch.tensor(float("inf"),
                                                  device=cuda_device))
    assert ((out - ref).abs() <= ulp - ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_int8_kernels_take_pitched_rows_and_bf16(cuda_device, x_dtype):
    """Rows with a pitch (a column slice), bf16 input, bias and output:
    the kernels' scalar and bf16 paths against the plain versions."""
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    dt = getattr(torch, x_dtype)
    x, asc, b, ws, bias = _int8_operands(cuda_device, 333, 200, 77, 3, dt,
                                         pitch=8)
    assert x.stride(0) == 208
    q = G.int8_quantize(x, asc)
    assert torch.equal(q, G.int8_quantize_plain(x, asc, 127))
    out = G.int8_gemm(q, b, ws, asc, bias.to(dt), out_dtype=dt)
    ref = G.int8_gemm_plain(q, b, ws, asc, bias.to(dt), 127, dt)
    assert out.dtype == dt and torch.equal(out, ref)


def _int8_gemm_check(dev, q, b, ws, asc, bias, out_dtype, kind):
    """One product through the kernel ``gemm_route`` picks: the route
    counted is that one (of ``kind``), the int32 sums read through unit
    scales equal the exact ones where float32 holds them (below 2^24),
    and the outputs equal the plain version's."""
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    route = G.route_of(q, b, G._sm_count(q))
    assert route[0] == kind
    n = b.shape[0]
    before = dict(kernels.route_launches)
    acc = G.int8_gemm(q, b, torch.ones(n, device=dev),
                      torch.tensor(127.0, device=dev))
    counted = {r: v - before.get(r, 0)
               for r, v in kernels.route_launches.items()
               if v != before.get(r, 0)}
    assert counted == {G.route_name(route): 1}
    want = torch.matmul(q.double(), b.double().t())
    assert torch.equal(acc, want.float())
    if want.abs().max() < 2 ** 24:
        assert torch.equal(acc.double(), want)
    out = G.int8_gemm(q, b, ws, asc, bias, out_dtype=out_dtype)
    ref = G.int8_gemm_plain(q, b, ws, asc, bias, 127, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,kind", [(129, 3072, 200, "wgmma"),
                                        (100, 576, 1000, "wgmma"),
                                        (1, 64, 16, "wgmma"),
                                        (100, 1008, 576, "wgmma"),
                                        (4096, 768, 768, "wgmma"),
                                        (129, 200, 3072, "bytes")])
@pytest.mark.parametrize("out_dtype,bias_dtype", [
    ("float32", "float32"), ("float32", None), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"), ("bfloat16", None)])
def test_int8_gemm_routes_off_the_tile(cuda_device, m, k, n, kind,
                                       out_dtype, bias_dtype):
    """M, N and K off the tiles, f32 and bf16 outputs (TMA stores and
    the consumers' own stores), each bias: the wgmma kernel where TMA can
    load the operands (K a multiple of 16), the byte-load kernel at K =
    200."""
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    x, asc, b, ws, bias = _int8_operands(cuda_device, m, k, n, m + k + n)
    q = G.int8_quantize(x, asc)
    bias = None if bias_dtype is None else bias.to(getattr(torch,
                                                           bias_dtype))
    _int8_gemm_check(cuda_device, q, b, ws, asc, bias,
                     getattr(torch, out_dtype), kind)


@pytest.mark.cuda
def test_int8_gemm_takes_a_pitched_a_through_tma(cuda_device):
    """A column view of wider rows (pitch 224 = K + 16 bytes) is loaded
    by TMA as it stands."""
    from paddle_tpu_torch.ops.kernels import int8_gemm as G
    x, asc, b, ws, bias = _int8_operands(cuda_device, 333, 208, 77, 5)
    buf = torch.zeros(333, 224, dtype=torch.int8, device=cuda_device)
    buf[:, :208] = G.int8_quantize(x, asc)
    q = buf[:, :208]
    assert q.stride(0) == 224
    _int8_gemm_check(cuda_device, q, b, ws, asc, bias, torch.float32,
                     "wgmma")


@pytest.mark.cuda
def test_int8_gemm_largest_sums_are_exact(cuda_device):
    """Operands at +-127 over K = 3,072: sums up to +-49,548,288 (exact
    in float32 too, 48,387 x 2^10) on the wgmma kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    k = 3072

    def signs(rows):
        return (torch.randint(0, 2, (rows, k), device=cuda_device,
                              generator=g) * 254 - 127).to(torch.int8)
    q, b = signs(256), signs(512)
    q[0], b[0], b[1] = 127, 127, -127
    ws = torch.rand(512, device=cuda_device, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(512, device=cuda_device, generator=g)
    acc = _int8_gemm_check(cuda_device, q, b, ws,
                           torch.tensor(127.0, device=cuda_device), bias,
                           torch.float32, "wgmma")
    assert acc[0, 0].item() == 49548288.0
    assert acc[0, 1].item() == -49548288.0


def _int8_bert(dev):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import Config
    seed(0)
    m = Bert(BertConfig.tiny(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)).eval()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (4, 32)).astype("int32")
    mask = (np.arange(32)[None, :] < rng.randint(8, 33, 4)[:, None]).astype(
        "int32")
    x = (ids, np.zeros_like(ids), mask)
    return Predictor(m, Config().enable_int8([x]), device=dev), x


@pytest.mark.cuda
def test_int8_predictor_replay_equals_its_eager_forward(cuda_device):
    pred, x = _int8_bert(cuda_device)
    dev = [torch.from_numpy(a).to(cuda_device) for a in x]
    first = pred.run_device(*dev)                 # eager run, then capture
    kernels.reset_launches()
    got = pred.run_device(*dev)                   # a replay
    assert pred.captures == 1
    assert kernels.launches["int8_gemm"] == 9      # 4 a layer and the pooler
    assert kernels.launches["int8_quantize"] == 9
    with torch.inference_mode():
        want = pred.model(*dev)
    for a, b, c in zip(got, want, first):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_custom_ops_under_torch_export_on_the_card(cuda_device):
    """``torch.export`` on the card holds the kernels as custom ops; the
    program, run, launches them and gives the live outputs."""
    pred, x = _int8_bert(cuda_device)
    dev = [torch.from_numpy(a).to(cuda_device) for a in x]
    live = pred.run_device(*dev)
    with torch.no_grad():
        program = torch.export.export(pred.model, tuple(dev), strict=False)
    names = {str(n.target) for n in program.graph.nodes
             if str(n.target).startswith("paddle_tpu_torch.")}
    assert {t.split(".")[1] for t in names} == {
        "layer_norm_fwd", "flash_attention_fwd", "int8_quantize",
        "int8_gemm"}
    kernels.reset_launches()
    with torch.no_grad():
        got = program.module()(*dev)
    assert kernels.launches["int8_gemm"] == 9
    assert kernels.launches["flash_attention_fwd"] == 2
    for a, b in zip(got, live):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_load_exported_runs_a_program_exported_on_the_card(cuda_device,
                                                           tmp_path):
    from paddle_tpu_torch.inference import load_exported
    pred, x = _int8_bert(cuda_device)
    live = pred.run(*x)
    path = str(tmp_path / "bert-int8.pt2")
    pred.export(path, *x)
    run = load_exported(path)
    kernels.reset_launches()
    got = run(*x)
    assert kernels.launches["int8_gemm"] == 9
    assert kernels.launches["layer_norm_fwd"] == 5
    for a, b in zip(got, live):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_int8_conv_predictor_on_the_card(cuda_device, data_format):
    """Frozen int8 convolutions (padding, stride 2 with 2 groups, a
    pointwise one) behind a graphed Predictor: every layer on the int8
    path, a replay equal to the eager forward, and each layer equal to
    the CPU's on the input the card's layer saw."""
    import copy as _copy

    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import Config
    seed(1)
    df = dict(data_format=data_format)
    m = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, **df), nn.ReLU(),
                      nn.Conv2D(8, 8, 3, stride=2, padding=1, groups=2,
                                **df), nn.ReLU(),
                      nn.Conv2D(8, 4, 1, bias_attr=False, **df))
    cpu = _copy.deepcopy(m)
    shape = (4, 16, 16, 3) if data_format == "NHWC" else (4, 3, 16, 16)
    x = np.random.RandomState(1).randn(*shape).astype("f4")
    pred = Predictor(m, Config().enable_int8([x]), device=cuda_device)
    frozen = [l for l in pred.model.modules()
              if isinstance(l, Q.QuantizedConv2D)]
    assert len(frozen) == 3 and all(l._int8_compute for l in frozen)
    dev = torch.from_numpy(x).to(cuda_device)
    pred.run_device(dev)
    kernels.reset_launches()
    got = pred.run_device(dev)
    assert kernels.launches["int8_gemm"] == 4     # a GEMM a group
    with torch.inference_mode():
        assert torch.equal(got, pred.model(dev))
    cpu = Q.convert(cpu)
    cpu.set_state_dict(pred.model.state_dict())
    for card_l, cpu_l in zip(frozen, [l for l in cpu.modules()
                                      if isinstance(l, Q.QuantizedConv2D)]):
        seen = []
        h = card_l.register_forward_hook(
            lambda mod, i, o: seen.append((i[0].cpu(), o.cpu())))
        with torch.inference_mode():
            pred.model(dev)
        h.remove()
        inp, out = seen[0]
        with torch.no_grad():
            assert torch.equal(cpu_l(inp), out)


@pytest.mark.cuda
def test_quant_aware_step_as_a_cuda_graph_advances_the_observer(
        cuda_device):
    """A quant_aware step under ``jit.to_static`` on the card: each
    replay advances ``act_scale`` in place, and the losses and scales
    follow an eager copy of the same training (float32 sums in another
    order: 1e-5)."""
    import copy as _copy

    from paddle_tpu_torch import jit
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch import seed
    seed(4)
    base = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 1))
    rng = np.random.RandomState(4)
    batches = [(torch.from_numpy(rng.rand(32, 8).astype("f4") * (1 + i))
                .to(cuda_device),
                torch.from_numpy((rng.rand(32, 1) * 2).astype("f4"))
                .to(cuda_device)) for i in range(5)]
    runs = {}
    for arm in ("graph", "eager"):
        model = Q.quant_aware(_copy.deepcopy(base)).to(cuda_device)
        model.train()
        o = optimizer.SGD(learning_rate=0.05, parameters=model.parameters())

        def step(xb, yb):
            loss = ((model(xb) - yb) ** 2).mean()
            loss.backward()
            o.step()
            o.clear_grad()
            return loss

        fn = jit.to_static(step, models=[model], optimizers=[o]) \
            if arm == "graph" else step
        buf = model[0].act_scale
        losses, scales = [], []
        for x, y in batches:
            losses.append(float(fn(x, y).detach()))
            scales.append(float(buf))
        assert model[0].act_scale is buf
        runs[arm] = (losses, scales)
    assert len(set(runs["graph"][1])) == 5         # moved at every step
    np.testing.assert_allclose(runs["graph"][0], runs["eager"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(runs["graph"][1], runs["eager"][1],
                               rtol=1e-5)


# -- the input pipeline: pinned slots, the copy stream, the hand-over ----------

def _pipeline_data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 3, 16, 16)).astype("u1"),
            rng.randint(0, 10, (n,)).astype("i8"))


@pytest.mark.cuda
def test_pinned_slots_go_back_only_after_their_copy(cuda_device,
                                                    monkeypatch):
    """Each batch leaves for the card from its page-locked slot, on a
    stream that is not the consumer's, and the slot goes back to the
    batcher only once every copy on that stream is done; the batches are
    the host batcher's, bit for bit, with int64 labels as int32."""
    from paddle_tpu_torch.io import native, prefetch_to_device
    x, y = _pipeline_data()
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=3,
              prefetch_slots=2)
    b = native.NativeBatcher([x, y], pin_memory=True, **kw)
    seen = []
    release = native.SlotBatch.release

    def checked(self):
        if self._release is not None:
            s = torch.cuda.current_stream()
            seen.append((s != torch.cuda.default_stream(), s.query(),
                         all(t.is_pinned() for t in self.pinned)))
        release(self)

    monkeypatch.setattr(native.SlotBatch, "release", checked)
    got = []
    for xb, yb in prefetch_to_device(b.slots(), size=2):
        time.sleep(0.01)    # a slow consumer: the producer runs ahead
        got.append((xb.cpu().numpy(), yb.cpu().numpy()))
    want = list(native.NativeBatcher([x, y], **kw))
    assert len(got) == len(want) == len(seen) == 12
    assert all(all(s) for s in seen)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy.astype("i4"))
        assert gy.dtype == np.int32
    assert not b.running


@pytest.mark.cuda
def test_handed_over_batches_wait_for_their_copy_and_are_recorded(
        cuda_device, monkeypatch):
    """The consumer's stream waits on each batch's copy event, and every
    tensor is recorded on it, so that its memory is not reused while the
    step reads it; a busy consumer stream reads the right values."""
    from paddle_tpu_torch.io import prefetch_to_device
    recorded = []
    orig = torch.Tensor.record_stream

    def spy(self, stream):
        recorded.append(stream)
        return orig(self, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    rng = np.random.RandomState(1)
    batches = [(rng.rand(64, 64).astype("f4"), np.arange(4) + i)
               for i in range(6)]
    big = torch.randn(4096, 4096, device=cuda_device)
    sums = []
    for xb, ib in prefetch_to_device(iter(batches), size=3):
        big = big @ big / 64.0          # keep the consumer's stream busy
        sums.append((xb.sum(), ib.clone()))
    assert len(recorded) == 12 and all(
        s == torch.cuda.current_stream() for s in recorded)
    for (s, ib), (xb, want_i) in zip(sums, batches):
        assert abs(float(s) - float(xb.sum())) <= 1e-3 * abs(float(xb.sum()))
        assert ib.dtype == torch.int32 and ib.tolist() == want_i.tolist()


@pytest.mark.cuda
def test_dataloader_for_the_card_feeds_a_graphed_step_bit_equal(
        cuda_device):
    """``DataLoader(prefetch_to_device=2)`` on the card: the native epoch
    fills pinned slots, its batches equal the host loader's, and a small
    ResNet's graphed losses fed from it equal those of the same step fed
    the host batches one call at a time."""
    from paddle_tpu_torch.models import resnet
    x, y = _pipeline_data(64)
    y = y.astype("i4")
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=7)
    dl = io.DataLoader(io.TensorDataset(x, y), prefetch_to_device=2, **kw)
    assert dl._native_epoch.pin_memory
    host = list(io.DataLoader(io.TensorDataset(x, y), **kw))
    losses = {}
    for arm in ("pipeline", "host"):
        tr = bench_resnet.Trainer(8, 1, "NCHW", cuda_device, 16,
                                  model_fn=resnet.ResNet,
                                  block=resnet.BottleneckBlock,
                                  depths=[1, 1, 1, 1], num_classes=10)
        feed = dl if arm == "pipeline" else (
            (torch.from_numpy(a).to(cuda_device),
             torch.from_numpy(b).to(cuda_device)) for a, b in host)
        out = []
        for xb, yb in feed:
            if arm == "pipeline":
                k = len(out)
                assert torch.equal(xb.cpu(), torch.from_numpy(host[k][0]))
                assert torch.equal(yb.cpu(), torch.from_numpy(host[k][1]))
            out.append(tr.step(xb[None], yb[None])[-1])
        losses[arm] = torch.stack(out).tolist()
        del tr
    assert len(losses["pipeline"]) == 8
    assert losses["pipeline"] == losses["host"]
    assert not dl._native_epoch.running

"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA card:
a CUDA kernel has no CPU mode. This file imports only ``torch``, ``numpy``
and the port, so on a machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance, as ``|kernel - plain| / max(1, |plain|)``: 1e-4 for float32
(another summation order), 2e-2 for bf16 (the f32 result rounded to bf16
once; one step is 2^-8 relative).
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import Bert, BertConfig, BertForPretraining
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import layer_norm as LN
from paddle_tpu_torch.tools import bench_bert

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
                                 (3, 9000)])
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
    q = torch.zeros(1, 1, 8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_fwd(q, q, q)


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
    assert kernels.launches == {"layer_norm_fwd": 5, "layer_norm_bwd": 0,
                                "flash_attention_fwd": 2,
                                "flash_attention_bwd_dq": 0,
                                "flash_attention_bwd_dkv": 0}
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


@pytest.mark.cuda
def test_layer_norm_bwd_rejects_wide_rows(cuda_device):
    x = torch.zeros(2, 9000, device=cuda_device)
    w = torch.ones(9000, device=cuda_device)
    mu = torch.zeros(2, 1, device=cuda_device)
    with pytest.raises(ValueError, match="8192"):
        LN.layer_norm_bwd(x, w, mu, mu, x)


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
    assert kernels.launches == {"layer_norm_fwd": 6, "layer_norm_bwd": 6,
                                "flash_attention_fwd": 2,
                                "flash_attention_bwd_dq": 2,
                                "flash_attention_bwd_dkv": 2}
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        if name != "bert.embeddings.position_embeddings.weight":
            assert p.grad.abs().sum().item() > 0, name


@pytest.mark.cuda
def test_bench_bert_runs_two_steps(cuda_device):
    tok_s, loss = bench_bert.bench_bert(batch=8, seq=128, steps=2, inner=1)
    assert tok_s > 0 and np.isfinite(loss)

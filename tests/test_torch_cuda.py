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

from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import Bert, BertConfig
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import layer_norm as LN

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
    q = torch.zeros(1, 1, 8, 64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="training slice"):
        FA.flash_attention(q, q, q, dropout_p=0.1, training=True)


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
    assert kernels.launches == {"layer_norm_fwd": 5,
                                "flash_attention_fwd": 2}
    for a, b in zip(got, cpu.run(ids, tt, mask)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)

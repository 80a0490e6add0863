"""The int8 GEMM's route and tile rule (``ops/kernels/int8_gemm.py``,
``gemm_route``) as a pure function, on the CPU, and the GEMM at the
shapes that rule has to handle against the JAX package's int8 product.

On the card ``int8_gemm`` launches ``int8_gemm_wgmma`` (wgmma fed by TMA,
128 x BN tiles) wherever TMA can load both operands, else the byte-load
``mma.sync`` kernel; which one each product of BERT-base, ``bench_int8``
and ResNet-50 takes is pinned here. The kernels themselves are held to
the plain version on the card (``tests/test_torch_cuda.py``).

The reference side is ``paddle_tpu/quantization.py``'s ``impl_int8``
written out: ``lax.dot_general`` with int32 sums, then ``(acc * step) *
wscale + bias`` in float32. Tolerance: equal sums, and outputs equal (the
same float32 operations in the same order on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models import resnet50
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import int8_gemm as G


def _route(m, k, n, lda=None, ldb=None, a_addr=0, b_addr=0, sms=132):
    return G.gemm_route(m, n, k, k if lda is None else lda,
                        k if ldb is None else ldb, a_addr, b_addr, sms)


# (label, M, K, N, route): BERT-base's served batch (32 x 128 rows) and
# its pooler, bench_int8's tower, ResNet-50's products at batch 8, the
# reference's ragged shapes
ROUTES = [
    ("bert_qkv", 4096, 768, 2304, ("wgmma", 128)),
    ("bert_out", 4096, 768, 768, ("wgmma", 192)),
    ("bert_ffn_up", 4096, 768, 3072, ("wgmma", 128)),
    ("bert_ffn_down", 4096, 3072, 768, ("wgmma", 192)),
    ("bert_pooler", 32, 768, 768, ("wgmma", 128)),
    ("bench_int8", 512, 4096, 4096, ("wgmma", 128)),
    ("resnet_layer1_3x3", 25088, 576, 64, ("wgmma", 128)),
    ("resnet_layer3_3x3", 1568, 2304, 256, ("wgmma", 128)),
    ("resnet_fc", 8, 2048, 1000, ("wgmma", 128)),
    ("resnet_stem", 100352, 147, 64, ("bytes", 0)),
    ("ragged_16x64x10", 16, 64, 10, ("wgmma", 128)),
    ("ragged_4x8x4", 4, 8, 4, ("bytes", 0)),
    ("ragged_2x8x4", 2, 8, 4, ("bytes", 0)),
]


@pytest.mark.parametrize("label,m,k,n,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_of_each_product(label, m, k, n, want):
    assert _route(m, k, n) == want


@pytest.mark.parametrize("kw", [dict(lda=208), dict(ldb=200),
                                dict(a_addr=8), dict(b_addr=4)],
                         ids=["lda_208_ok", "ldb_200", "a_off_8", "b_off_4"])
def test_pitches_and_addresses_tma_cannot_load_take_the_byte_path(kw):
    route = _route(129, 192, 3072, **kw)
    assert route == (("wgmma", 128) if kw == dict(lda=208) else ("bytes", 0))


def test_k_zero_takes_the_byte_path():
    assert _route(16, 0, 16) == ("bytes", 0)


@pytest.mark.parametrize("m,n,sms,want", [
    (4096, 768, 132, 192),     # 128 tiles of 128 x 192, 192 of 128 x 128
    (4096, 768, 114, 128),     # neither fits one wave on 114 SMs
    (4224, 768, 132, 192),     # 33 x 4 = 132 fits, 33 x 6 = 198 does not
    (4352, 768, 132, 128),     # 34 x 4 = 136: neither fits
    (128, 192, 132, 128),      # one tile either way
])
def test_the_wider_tile_only_where_it_alone_fits_one_wave(m, n, sms, want):
    assert _route(m, 768, n, sms=sms) == ("wgmma", want)


def test_route_names():
    assert G.route_name(("wgmma", 192)) == "int8_gemm:wgmma_128x192"
    assert G.route_name(("bytes", 0)) == "int8_gemm:mma_sync_bytes"


def test_route_of_reads_pitches_and_offsets_from_the_tensors():
    buf = torch.zeros(64, 224, dtype=torch.int8)
    b = torch.zeros(96, 208, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    assert G.route_of(buf[:, :208], b) == ("wgmma", 128)      # pitch 224
    assert G.route_of(buf[:, 8:216], b) == ("bytes", 0)       # 8 bytes in
    assert G.route_of(buf[:1, :208], b) == ("wgmma", 128)     # one row
    assert G.route_of(torch.zeros(64, 200, dtype=torch.int8),
                      torch.zeros(96, 200, dtype=torch.int8)) == ("bytes", 0)


def test_route_launches_follow_add_and_reset():
    kernels.reset_launches()
    try:
        kernels.add_launches({"int8_gemm": 3},
                             routes={"int8_gemm:wgmma_128x128": 3})
        kernels.add_launches({"int8_gemm": 1}, -1,
                             {"int8_gemm:wgmma_128x128": 1})
        assert kernels.launches["int8_gemm"] == 2
        assert kernels.route_launches == {"int8_gemm:wgmma_128x128": 2}
    finally:
        kernels.reset_launches()
    assert kernels.route_launches == {}


def test_resnet50_int8_takes_the_wgmma_route_but_at_its_stem(monkeypatch):
    """Every int8 GEMM of a calibrated ResNet-50 (53 convolutions, as
    im2col GEMMs, and the classifier) through the layers' own operands:
    TMA loads all but the 7 x 7 stem's (K = 147); with 392 times this 32
    x 32, batch-1 run's rows (a convolution's at batch 8, 224 x 224) each
    takes 128 x 128 tiles."""
    torch.manual_seed(0)
    model = resnet50().eval()
    x = np.random.RandomState(0).randn(1, 3, 32, 32).astype("f4")
    pred = Predictor(model, Config().enable_int8([x]), device="cpu")
    seen = []
    real = Q.int8_gemm

    def spy(a, b, *args, **kw):
        route = G.route_of(a, b)
        big = G.gemm_route(a.shape[0] * 49 * 8, b.shape[0], a.shape[1],
                           G._pitch(a), G._pitch(b), a.data_ptr(),
                           b.data_ptr())
        seen.append((a.shape[1], route, big))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(Q, "int8_gemm", spy)
    with torch.no_grad():
        out = pred.model(torch.from_numpy(x))
    assert out.shape == (1, 1000) and torch.isfinite(out).all()
    assert len(seen) == 54
    assert [k for k, r, _ in seen if r[0] == "bytes"] == [147]
    assert sum(r == ("wgmma", 128) for _, r, _ in seen) == 53
    assert {b for k, _, b in seen if k != 147} == {("wgmma", 128)}


def _reference_int8(xq, wt, step, wscale, bias):
    """impl_int8's product on already quantized operands (``wt`` (K, N),
    as the reference holds ``qweight``), and its epilogue in its order,
    in float32 numpy (one rounding an operation, as the kernels round)."""
    acc = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), jnp.asarray(wt), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    out = acc.astype(np.float32) * np.float32(step) * wscale
    if bias is not None:
        out = out + bias
    return acc, out


@pytest.mark.parametrize("m,k,n", [(129, 3072, 200), (100, 576, 1000),
                                   (1, 64, 16), (129, 200, 3072),
                                   (100, 1008, 576)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_gemm_matches_the_reference_off_the_tile(m, k, n, with_bias):
    rng = np.random.RandomState(m + k + n)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wt = rng.randint(-127, 128, (k, n)).astype(np.int8)
    wscale = (rng.rand(n) * 1e-3 + 1e-4).astype(np.float32)
    bias = rng.randn(n).astype(np.float32) if with_bias else None
    act = np.float32(3.5)
    step = np.float32(max(act, np.float32(1e-8)) / np.float32(127.0))
    acc_ref, out_ref = _reference_int8(xq, wt, step, wscale, bias)
    a = torch.from_numpy(xq.copy())
    b = torch.from_numpy(np.ascontiguousarray(wt.T))
    ascale = torch.tensor(act)
    one = torch.ones(n)
    acc = G.int8_gemm(a, b, one, torch.tensor(127.0))
    np.testing.assert_array_equal(acc.numpy(), acc_ref.astype(np.float32))
    out = G.int8_gemm(a, b, torch.from_numpy(wscale), ascale,
                      None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(out.numpy(), out_ref)


def test_extreme_sums_stay_exact():
    """Operands at +-127 over K = 3,072: the largest sums, +-49,548,288,
    exact in int32 and in float32 (48,387 x 2^10)."""
    k = 3072
    rng = np.random.RandomState(7)
    xq = (rng.randint(0, 2, (8, k)) * 254 - 127).astype(np.int8)
    w = (rng.randint(0, 2, (16, k)) * 254 - 127).astype(np.int8)
    xq[0] = 127
    w[0], w[1] = 127, -127
    acc_ref, _ = _reference_int8(xq, w.T, np.float32(1.0),
                                 np.ones(16, np.float32), None)
    acc = G.int8_gemm(torch.from_numpy(xq), torch.from_numpy(w),
                      torch.ones(16), torch.tensor(127.0))
    assert acc[0, 0].item() == 49548288.0 and acc[0, 1].item() == -49548288.0
    np.testing.assert_array_equal(acc.numpy(), acc_ref.astype(np.float32))

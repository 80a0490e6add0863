"""The int8 products: the activation quantizer ``int8_quantize`` and the
int8 x int8 -> int32 GEMM ``int8_gemm`` (``csrc/int8_gemm.cu``), their
plain PyTorch versions, and the custom ops that let ``torch.export`` and
the flop counter see them.

Counterpart of no Pallas kernel: the reference's frozen int8 layers
multiply through XLA (``lax.dot_general`` and ``lax.conv_general_dilated``
with ``preferred_element_type=int32``, ``paddle_tpu/quantization.py:242``
and ``:318``), which PyTorch on CUDA cannot follow at every shape. The
quantizer reads the activation scale on the card, ``step = max(act_scale,
1e-8) / qmax``, so nothing is read on the host and a CUDA graph captures
both kernels. The GEMM takes its weight as ``(N, K)`` rows (the frozen
``qweight`` is ``[in, out]`` as the reference holds it; a layer keeps the
transposed copy beside it) and computes ``(float(acc) * step) * wscale[n]
(+ bias[n])`` cast to the output dtype.

On the card the GEMM runs one of two kernels, which :func:`gemm_route`
picks from the operands' shapes, pitches and addresses:
``int8_gemm_wgmma`` (wgmma fed by TMA, persistent, 128 x BN tiles with BN
in :data:`TILE_NS`) wherever TMA can load A and B, and the byte-load
``mma.sync`` kernel ``int8_gemm_tc`` for the rest (K = 147 at ResNet-50's
first convolution, pitches that are not multiples of 16 bytes, column
slices off a 16-byte boundary). ``kernels.launches["int8_gemm"]`` counts
both; ``kernels.route_launches`` counts each instance under
:func:`route_name`.

The plain GEMM computes the accumulator exactly: int32 ``torch.matmul`` on
the CPU, float64 on the card (exact below 2^53; float32 is not, K =
3,072 of 127 x 127 products reaching 4.96e7, past 2^24).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import check, count_launch, device_index, function, stream_of, traced

QUANTIZE = "int8_quantize"
GEMM = "int8_gemm"

_Q_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_void_p]
_G_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FLOATS = (torch.float32, torch.bfloat16)


def true_div(t, c):
    """``t / c`` for a Python number ``c``, IEEE-rounded on every device:
    PyTorch on CUDA multiplies by ``1 / c`` when the divisor is a host
    scalar, which can land an ulp away; a 0-d tensor divisor divides."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def act_step(ascale, qmax):
    """The activation step ``max(act_scale, 1e-8) / qmax`` in float32 (the
    kernels' ``__fdiv_rn``), as a 0-d tensor on ``ascale``'s device."""
    return true_div(ascale.reshape(()).float().clamp_min(1e-8), float(qmax))


def int8_quantize_plain(x, ascale, qmax):
    """Plain version of the quantizer: ``clamp(round(x / step), -qmax,
    qmax)`` as int8, ``x`` (M, K) float32 or bf16, on any device."""
    q = torch.round(x.float() / act_step(ascale, qmax))
    return q.clamp(-qmax, qmax).to(torch.int8)


def int8_gemm_plain(a, b, wscale, ascale, bias, qmax, out_dtype):
    """Plain version of the GEMM on any device: ``a`` (M, K) and ``b`` (N,
    K) int8, ``wscale`` (N,) float32, ``bias`` (N,) or None; returns (M,
    N) in ``out_dtype``. The accumulator is exact (int32 on the CPU,
    float64 on the card)."""
    if a.device.type == "cpu":
        acc = torch.matmul(a.to(torch.int32), b.to(torch.int32).t())
    else:
        acc = torch.matmul(a.double(), b.double().t())
    out = acc.float() * act_step(ascale, qmax) * wscale.reshape(-1)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _check_2d(name, t, dtypes):
    if t.dim() != 2 or (t.numel() and (t.stride(1) != 1 or (
            t.shape[0] > 1 and t.stride(0) < t.shape[1]))):
        raise ValueError(f"{name}: wants (rows, K) with K contiguous, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")


def _check_scale(name, ascale, x):
    if ascale.numel() != 1 or ascale.dtype != torch.float32:
        raise ValueError(f"{name}: the activation scale must be one "
                         f"float32, got {tuple(ascale.shape)} "
                         f"{ascale.dtype}")
    if ascale.device != x.device:
        raise ValueError(f"{name}: the activation scale is on "
                         f"{ascale.device}, the input on {x.device}")


def _pitch(t):
    """Elements from one row to the next (K where there is one row)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


# -- which kernel a product takes ---------------------------------------------

#: the wgmma kernel's tile: 128 rows (two consumer warpgroups of 64) by
#: one of these widths
TILE_M = 128
TILE_NS = (128, 192)
#: the H100's streaming multiprocessors: the grid the tile rule assumes
#: where no card is asked
H100_SMS = 132


def gemm_route(m, n, k, lda, ldb, a_addr, b_addr, sms=H100_SMS):
    """The kernel an ``(m, k) x (n, k)`` product takes: ``("wgmma", BN)``
    where TMA can load both operands (K > 0, pitches ``lda`` and ``ldb``
    multiples of 16 bytes, addresses 16-byte aligned), else ``("bytes",
    0)``, the byte-load ``mma.sync`` kernel.

    BN is 192 where 128 x 192 tiles fit the product in one wave on
    ``sms`` SMs and 128 x 128 tiles do not (at N = 768 and M = 4,096: 128
    tiles against 192), else 128. Beyond one wave the narrower tile is
    the faster on an H100: its ring holds 5 K steps to the wider tile's 3
    (``chip_smoke.py`` phase 20 times BERT-base's products at both)."""
    if k <= 0 or lda % 16 or ldb % 16 or a_addr % 16 or b_addr % 16:
        return "bytes", 0
    narrow, wide = TILE_NS
    m_tiles = math.ceil(m / TILE_M)
    if m_tiles * math.ceil(n / wide) <= sms < m_tiles * math.ceil(n / narrow):
        return "wgmma", wide
    return "wgmma", narrow


def route_name(route):
    """The key of ``kernels.route_launches`` for a :func:`gemm_route`."""
    kind, bn = route
    return (f"{GEMM}:wgmma_{TILE_M}x{bn}" if kind == "wgmma"
            else f"{GEMM}:mma_sync_bytes")


def route_of(a, b, sms=H100_SMS):
    """:func:`gemm_route` of the operands ``a`` (M, K) and ``b`` (N, K)."""
    return gemm_route(a.shape[0], b.shape[0], a.shape[1], _pitch(a),
                      _pitch(b), a.data_ptr(), b.data_ptr(), sms)


_sms = {}


def _sm_count(t):
    i = device_index(t)
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


# -- the kernels' launches, or the plain versions on the CPU (the custom
# ops' bodies) -------------------------------------------------------------

def _quantize_body(x, ascale, qmax):
    if x.device.type == "cpu":
        return int8_quantize_plain(x, ascale, qmax)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    m, k = x.shape
    if m == 0 or k == 0:
        return q
    ascale = ascale.reshape(()).contiguous()
    fn = function(QUANTIZE, _Q_ARGTYPES)
    code = fn(device_index(x), x.data_ptr(), _pitch(x), ascale.data_ptr(),
              int(qmax), q.data_ptr(), m, k,
              int(x.dtype == torch.bfloat16), stream_of(x))
    check(QUANTIZE, fn, code)
    count_launch(QUANTIZE)
    return q


def _gemm_body(a, b, wscale, ascale, bias, qmax, out_bf16):
    out_dtype = torch.bfloat16 if out_bf16 else torch.float32
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b, wscale, ascale, bias, qmax, out_dtype)
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    if m == 0 or n == 0:
        return out
    wscale = wscale.reshape(-1).contiguous()
    ascale = ascale.reshape(()).contiguous()
    bias = None if bias is None else bias.contiguous()
    sms = _sm_count(a)
    route = route_of(a, b, sms)
    fn = function(GEMM, _G_ARGTYPES)
    code = fn(device_index(a), a.data_ptr(), _pitch(a), b.data_ptr(),
              _pitch(b), wscale.data_ptr(), ascale.data_ptr(),
              None if bias is None else bias.data_ptr(),
              int(bias is not None and bias.dtype == torch.bfloat16),
              out.data_ptr(), n, m, n, k, int(qmax), int(out_bf16),
              route[1], sms, stream_of(a))
    check(GEMM, fn, code)
    count_launch(GEMM, route_name(route))
    return out


@torch.library.custom_op("paddle_tpu_torch::int8_quantize", mutates_args=())
def _quantize_op(x: torch.Tensor, ascale: torch.Tensor,
                 qmax: int) -> torch.Tensor:
    return _quantize_body(x, ascale, qmax)


@_quantize_op.register_fake
def _(x, ascale, qmax):
    return x.new_empty(x.shape, dtype=torch.int8)


@torch.library.custom_op("paddle_tpu_torch::int8_gemm", mutates_args=())
def _gemm_op(a: torch.Tensor, b: torch.Tensor, wscale: torch.Tensor,
             ascale: torch.Tensor, bias: torch.Tensor | None, qmax: int,
             out_bf16: bool) -> torch.Tensor:
    return _gemm_body(a, b, wscale, ascale, bias, qmax, out_bf16)


@_gemm_op.register_fake
def _(a, b, wscale, ascale, bias, qmax, out_bf16):
    return a.new_empty((a.shape[0], b.shape[0]),
                       dtype=torch.bfloat16 if out_bf16 else torch.float32)


@register_flop_formula(torch.ops.paddle_tpu_torch.int8_gemm)
def _gemm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return 2 * a_shape[0] * a_shape[1] * b_shape[0]


# -- the wrappers ------------------------------------------------------------

def int8_quantize(x, ascale, qmax=127):
    """``x`` (M, K) float32 or bf16 (K contiguous, any row pitch)
    quantized to int8 by the act_scale tensor ``ascale`` (one float32, on
    x's device). On a CUDA tensor it launches the kernel; on a CPU tensor
    it computes :func:`int8_quantize_plain`."""
    _check_2d("int8_quantize", x, _FLOATS)
    _check_scale("int8_quantize", ascale, x)
    if traced(x):
        return _quantize_op(x, ascale, int(qmax))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_quantize: no kernel for {x.device}")
    return _quantize_body(x, ascale, int(qmax))


def int8_gemm(a, b, wscale, ascale, bias=None, qmax=127,
              out_dtype=torch.float32):
    """``(float(a @ b.T) * step) * wscale (+ bias)`` in ``out_dtype``
    (float32 or bf16): ``a`` (M, K) and ``b`` (N, K) int8, K contiguous,
    ``wscale`` N float32 values, ``ascale`` the act_scale tensor (step =
    max(ascale, 1e-8) / qmax), ``bias`` (N,) float32 or bf16 or None. On a
    CUDA tensor it launches the kernel :func:`gemm_route` picks; on a CPU
    tensor it computes :func:`int8_gemm_plain`."""
    _check_2d("int8_gemm", a, (torch.int8,))
    _check_2d("int8_gemm", b, (torch.int8,))
    _check_scale("int8_gemm", ascale, a)
    n = b.shape[0]
    if b.shape[1] != a.shape[1]:
        raise ValueError(f"int8_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must share K")
    if wscale.numel() != n or wscale.dtype != torch.float32:
        raise ValueError(f"int8_gemm: wscale must be {n} float32 values, "
                         f"got {tuple(wscale.shape)} {wscale.dtype}")
    if bias is not None and (bias.shape != (n,) or bias.dtype not in
                             _FLOATS):
        raise ValueError(f"int8_gemm: bias must be ({n},) float32 or bf16, "
                         f"got {tuple(bias.shape)} {bias.dtype}")
    if out_dtype not in _FLOATS:
        raise TypeError(f"int8_gemm: out_dtype must be float32 or bf16, "
                        f"got {out_dtype}")
    if any(t.device != a.device for t in (b, wscale) +
           (() if bias is None else (bias,))):
        raise ValueError("int8_gemm: every operand must be on one device")
    out_bf16 = out_dtype == torch.bfloat16
    if traced(a):
        return _gemm_op(a, b, wscale, ascale, bias, int(qmax), out_bf16)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_gemm: no kernel for {a.device}")
    return _gemm_body(a, b, wscale, ascale, bias, int(qmax), out_bf16)

"""The port's deployment path on the CPU: ``io`` save and load,
``jit.save`` / ``jit.load``, ``Predictor(Config(path))``,
``create_predictor``, ``Predictor.export`` / ``load_exported`` and
``Predictor.compile_report`` with ``monitor.xla`` (the counterparts of
``tests/test_io.py:10-42`` and the export and cost cases of the
reference's inference tests).

A saved state dict is the reference's file format (a pickle of numpy
arrays, bf16 as ``ml_dtypes.bfloat16``): files cross between the two
packages both ways and load bit for bit.

Tolerances: round trips through a file and a reloaded Predictor are bit
for bit (the same weights, the same operations); an exported program
against the live Predictor 1e-6 relative (the same operations in a
traced graph); a model loaded from the other package's file against that
package's outputs 1e-5 (float32 products summed in another order).

Isolation: every test clears the reference's flat-arena hook and turns
both monitors off, before and after (ROADMAP.md ground rules).
"""
import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import io as jio
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import nn as jnn

from paddle_tpu_torch import device, io, jit, monitor, nn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import (Config, Predictor, create_predictor,
                                        load_exported)
from paddle_tpu_torch.models import Bert, BertConfig
from paddle_tpu_torch.monitor import xla


@pytest.fixture(autouse=True)
def _no_arena_hook():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    xla.reset()
    yield
    for mon in (ref_monitor, monitor):
        mon.disable(flush_counters=False)
        mon.reset()
    xla.reset()
    ref_tensor._arena_hook = hook


def _t(a):
    return torch.from_numpy(np.array(a))


def _lenet(mod):
    """The reference's LeNet (``paddle_tpu/models/lenet.py``) built of
    either package's layers."""
    return mod.Sequential(
        mod.Conv2D(1, 6, 5, padding=2), mod.ReLU(), mod.MaxPool2D(2, 2),
        mod.Conv2D(6, 16, 5), mod.ReLU(), mod.MaxPool2D(2, 2),
        mod.Flatten(), mod.Linear(400, 120), mod.ReLU(),
        mod.Linear(120, 84), mod.ReLU(), mod.Linear(84, 10))


def _assert_states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype
        assert torch.equal(sa[k], sb[k]), k


def test_save_load_state_dict(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8))
    with torch.no_grad():
        m[1]._mean.uniform_()
    path = str(tmp_path / "sub" / "model.pdparams")
    io.save(m.state_dict(), path)
    loaded = io.load(path)
    assert type(loaded) is dict
    assert all(isinstance(v, np.ndarray) for v in loaded.values())
    m2 = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8))
    missing, unexpected = m2.set_state_dict(loaded)
    assert not missing and not unexpected
    _assert_states_equal(m, m2)


def test_set_state_dict_reports_and_checks():
    m = nn.Linear(3, 2)
    missing, unexpected = m.set_state_dict(
        {"weight": np.ones((3, 2), "f4"), "extra": np.zeros(1, "f4")})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert torch.equal(m.weight.detach(), torch.ones(3, 2))
    with pytest.raises(ValueError, match="shape"):
        m.set_state_dict({"weight": np.ones((2, 3), "f4")})


def test_save_load_dygraph_roundtrip(tmp_path):
    torch.manual_seed(1)
    m = nn.Linear(3, 3)
    prefix = str(tmp_path / "ck")
    io.save_dygraph(m.state_dict(), prefix)
    opt_state = {"lr": 0.1, "weight@moment1": torch.ones(3, 3),
                 "__aux__": {}}
    io.save_dygraph(opt_state, prefix)
    assert os.path.exists(prefix + ".pdparams")
    assert os.path.exists(prefix + ".pdopt")
    params, opt = io.load_dygraph(prefix)
    assert params is not None and "weight" in params
    np.testing.assert_array_equal(params["weight"], m.weight.detach().numpy())
    assert opt["lr"] == 0.1
    np.testing.assert_array_equal(opt["weight@moment1"], np.ones((3, 3)))
    # the reference reads the same pair, and splits by the same rule
    jparams, jopt = jio.load_dygraph(prefix)
    np.testing.assert_array_equal(jparams["bias"], params["bias"])
    assert set(jopt) == set(opt)
    assert io.load_dygraph(str(tmp_path / "none")) == (None, None)


def test_inference_model_roundtrip(tmp_path):
    torch.manual_seed(2)
    m = _lenet(nn)
    x = np.random.RandomState(2).randn(2, 1, 28, 28).astype("f4")
    ref = m.eval()(_t(x)).detach().numpy()
    prefix = str(tmp_path / "infer")
    io.save_inference_model(prefix, m)
    assert os.path.exists(prefix + ".pdmodel")
    assert os.path.exists(prefix + ".pdiparams")
    m2 = io.load_inference_model(prefix)
    assert not m2.training and m2 is not m
    _assert_states_equal(m, m2)
    np.testing.assert_array_equal(m2(_t(x)).detach().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_files_cross_between_the_packages(tmp_path, dtype):
    """A file written by the reference loads in the port with the same
    arrays and dtypes, and one written by the port in the reference."""
    pt.seed(3)
    jm = _lenet(jnn)
    m = _lenet(nn)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
        m.to(torch.bfloat16)
    jpath = str(tmp_path / "ref.pdparams")
    path = str(tmp_path / "port.pdparams")
    jio.save(jm.state_dict(), jpath)
    from_ref = io.load(jpath)
    assert not any(m.set_state_dict(from_ref))
    for k, t in m.state_dict().items():
        want = np.asarray(from_ref[k])
        assert want.dtype == (ml_dtypes.bfloat16 if dtype == "bfloat16"
                              else np.float32)
        got = t.detach()
        if dtype == "bfloat16":
            got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # the port's file, read by the reference
    with torch.no_grad():
        for t in m.parameters():
            t.mul_(0.5)
    io.save(m.state_dict(), path)
    from_port = jio.load(path)
    ported = io.load(path)
    for k in from_port:
        assert from_port[k].dtype == ported[k].dtype
        assert from_port[k].dtype == np.asarray(from_ref[k]).dtype
    jm.set_state_dict(from_port)
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v.numpy()).view(np.uint8),
                                      ported[k].view(np.uint8))
    if dtype == "float32":
        x = np.random.RandomState(3).randn(2, 1, 28, 28).astype("f4")
        jm.eval(), m.eval()
        np.testing.assert_allclose(m(_t(x)).detach().numpy(),
                                   jm(pt.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def _bert_inputs(rows=2, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (rows, seq)).astype("int32")
    lens = rng.randint(4, seq + 1, rows)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype("int32")
    return ids, np.zeros_like(ids), mask


def _tiny_bert(seed=4):
    torch.manual_seed(seed)
    return Bert(BertConfig.tiny(hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)).eval()


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_predictor_from_config_path(tmp_path, precision):
    m = _tiny_bert()
    x = _bert_inputs()
    prefix = str(tmp_path / "bert")
    io.save_inference_model(prefix, m)
    cfg, loaded_cfg = Config(), Config(prefix)
    if precision == "int8":
        cfg.enable_int8([x])
        loaded_cfg.enable_int8([x])
    live = Predictor(m, cfg, device="cpu").run(*x)
    loaded = Predictor(loaded_cfg, device="cpu")
    assert loaded.config is loaded_cfg
    for a, b in zip(loaded.run(*x), live):
        np.testing.assert_array_equal(a, b)
    prev = device.get_device()
    device.set_device("cpu")
    try:
        made = create_predictor(Config(prefix))
    finally:
        device.set_device(prev)
    assert made.device.type == "cpu"
    if precision == "float32":
        for a, b in zip(made.run(*x), live):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="model_path"):
        Predictor(Config(), device="cpu")


def test_jit_save_load(tmp_path):
    torch.manual_seed(5)
    m = nn.Sequential(nn.Linear(6, 12), nn.ReLU(), nn.Linear(12, 3))
    x = _t(np.random.RandomState(5).randn(5, 6).astype("f4"))
    path = str(tmp_path / "jit" / "model")
    jit.save(m, path)
    m2 = jit.load(path)
    np.testing.assert_array_equal(m2(x).detach().numpy(),
                                  m.eval()(x).detach().numpy())


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_predictor_export_roundtrip(tmp_path, precision):
    """``export`` -> ``load_exported`` runs without the model, weights in
    the file, against the live Predictor (the reference's
    ``test_predictor_stablehlo_export_roundtrip``)."""
    torch.manual_seed(4)
    m = nn.Sequential(nn.Linear(6, 12), nn.ReLU(), nn.Linear(12, 3))
    x = np.random.RandomState(4).randn(5, 6).astype("f4")
    cfg = Config()
    if precision == "int8":
        cfg.enable_int8([x])
    p = Predictor(m, cfg, device="cpu")
    ref = p.run(x)
    path = str(tmp_path / "model.pt2")
    assert p.export(path, x) == path
    assert os.path.getsize(path) > 100
    runner = load_exported(path)
    np.testing.assert_allclose(runner(x), ref, rtol=1e-6)
    np.testing.assert_allclose(runner(_t(x)), ref, rtol=1e-6)


def test_export_of_a_value_dependent_branch_names_the_model(tmp_path):
    class Gated(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            if float(x.sum()) > 0:
                return self.fc(x)
            return x

    p = Predictor(Gated(), device="cpu")
    with pytest.raises(RuntimeError, match=r"Gated.*float\(x\.sum\(\)\)"):
        p.export(str(tmp_path / "gated.pt2"), np.ones((2, 4), "f4"))


def test_exported_bert_holds_the_kernels_ops(tmp_path):
    """A BERT program calls the port's kernels as custom ops (layer norm,
    attention, and in int8 the quantizer and the GEMM), and runs them."""
    m = _tiny_bert()
    x = _bert_inputs()
    for cfg, ops in ((Config(), {"layer_norm_fwd", "flash_attention_fwd"}),
                     (Config().enable_int8([x]),
                      {"layer_norm_fwd", "flash_attention_fwd",
                       "int8_quantize", "int8_gemm"})):
        p = Predictor(m, cfg, device="cpu")
        live = p.run(*x)
        path = str(tmp_path / f"{cfg.precision}.pt2")
        p.export(path, *x)
        program = torch.export.load(path)
        names = {str(n.target).split(".")[1] for n in program.graph.nodes
                 if str(n.target).startswith("paddle_tpu_torch.")}
        assert names == ops
        for a, b in zip(load_exported(path)(*x), live):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_compile_report_keys_and_flops():
    """The reference's keys; flops 2 M K N a layer of a Linear tower, f32
    and int8; the monitor's gauges and ``xla_cost`` record."""
    torch.manual_seed(6)
    sizes = (16, 32, 32, 8)
    layers = []
    for a, b in zip(sizes, sizes[1:]):
        layers += [nn.Linear(a, b), nn.ReLU()]
    m = nn.Sequential(*layers)
    x = np.random.RandomState(6).randn(4, 16).astype("f4")
    want = sum(2 * 4 * a * b for a, b in zip(sizes, sizes[1:]))
    monitor.enable()
    for cfg in (Config(), Config().enable_int8([x])):
        p = Predictor(m, cfg, device="cpu")
        info = p.compile_report(x)
        assert {"flops", "bytes_accessed", "peak_memory"} <= set(info)
        assert info["flops"] == want
        assert info["bytes_accessed"] > 0 and info["peak_memory"] > 0
        label = "predictor.Sequential"
        assert xla.last() == (label, info)
        assert xla.flops(label) == want
        assert xla.bytes_accessed() == info["bytes_accessed"]
        assert xla.peak_memory() == info["peak_memory"]
        snap = monitor.snapshot("xla.")
        assert snap[f"xla.flops.{label}"] == want
    assert xla.labels() == ["predictor.Sequential"]
    assert p.captures == 1                     # the report's run captured it


def test_compile_report_counts_attention():
    m = _tiny_bert()
    x = _bert_inputs(rows=2, seq=16)
    cfg = m.config
    d, f, b, s = cfg.hidden_size, cfg.intermediate_size, 2, 16
    gemms = 2 * b * s * (d * 3 * d + d * d + 2 * d * f) * 2 + 2 * b * d * d
    attention = 4 * b * s * s * d * 2
    info = Predictor(m, device="cpu").compile_report(*x)
    assert info["flops"] == gemms + attention


def test_xla_store_and_unported_parts():
    class Fake:
        def cost_analysis(self):
            return [{"flops": 10.0, "bytes accessed": -1.0}]

        def memory_analysis(self):
            raise RuntimeError("none")

    assert xla.capture("x", Fake()) == {"flops": 10.0}
    assert xla.get("x") == {"flops": 10.0} and xla.get("y") is None
    assert xla.bytes_accessed("x") is None
    xla.reset()
    assert xla.last() is None and xla.labels() == []
    for fn, args in ((xla.aot_capture, (None, "x", ())),
                     (xla.executable, ()), (xla.hlo_text, ()),
                     (xla.measured_mfu, (1.0,))):
        with pytest.raises(NotImplementedError, match="item 20"):
            fn(*args)


def test_saved_model_pickles_a_cpu_copy_without_executables(tmp_path):
    """A served model saved after the Predictor captured: the file holds
    the layer alone (no entries, locks or streams) and loads on the
    CPU."""
    m = _tiny_bert()
    x = _bert_inputs()
    p = Predictor(m, device="cpu")
    p.run(*x)
    prefix = str(tmp_path / "served")
    io.save_inference_model(prefix, p.model)
    with open(prefix + ".pdmodel", "rb") as fh:
        layer = pickle.load(fh)
    assert isinstance(layer, Bert)
    assert all(t.device.type == "cpu" for t in layer.state_dict().values())
    out = Predictor(Config(prefix), device="cpu").run(*x)
    for a, b in zip(out, p.run(*x)):
        np.testing.assert_array_equal(a, b)


def test_load_jax_state_still_rejects_mismatches():
    pt.seed(7)
    jm = jnn.Linear(3, 2)
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError):
        load_jax_state(nn.Linear(3, 2), {"weight": arrays["weight"]})
    with pytest.raises(ValueError):
        load_jax_state(nn.Linear(2, 3), arrays)


def test_bf16_predictor_takes_float32_inputs_as_the_reference_does():
    """A bf16 Predictor fed float32 (the reference's ``bench_int8`` feeds
    its bf16 tower so): ``jnp.matmul`` promotes the pair to float32, and
    so does the port's ``linear``, where it used to raise."""
    from paddle_tpu.inference import Config as JConfig
    from paddle_tpu.inference import Predictor as JPredictor
    pt.seed(9)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    m = load_jax_state(
        nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4)),
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    x = np.random.RandomState(9).randn(3, 8).astype("f4")
    want = JPredictor(jm, JConfig().enable_bf16()).run(x)
    got = Predictor(m, Config().enable_bf16(), device="cpu").run(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5)

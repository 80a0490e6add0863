"""What the port may and may not depend on.

``paddle_tpu_torch``, ``chip_smoke.py`` and ``bench_flash.py`` import
``torch`` and never ``jax`` or the JAX package ``paddle_tpu`` (not even
its JAX-free modules); the port's path calls no library attention or normalisation kernel
(convolution and pooling, which are outside any kernel of the reference,
are PyTorch's); and its entry points target the CUDA card unless the
caller asks for the CPU.
"""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "bench_flash.py"]


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_paddle_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_calls_no_library_kernels():
    """The port's path goes through its own kernels: no torch functional
    attention, layer norm or batch norm, no torch.compile, no cuDNN
    switch. ``torch.nn.functional`` is named in full and only for what
    the reference leaves to XLA outside its kernels: convolution and
    pooling, in ``ops/nn_ops.py``."""
    allowed = {"conv2d", "max_pool2d", "adaptive_avg_pool2d"}
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for word in ("from torch.nn import functional",
                     "import torch.nn.functional", "torch.compile",
                     "backends.cudnn", "import triton", "native_batch_norm",
                     "native_layer_norm", "torch.batch_norm",
                     "torch.layer_norm", "torch.instance_norm"):
            assert word not in text, f"{path.relative_to(ROOT)}: {word}"
        called = set(re.findall(r"torch\.nn\.functional\.(\w+)", text))
        if path.relative_to(PORT) == Path("ops/nn_ops.py"):
            assert called == allowed, called
        else:
            assert not called, f"{path.relative_to(ROOT)}: {called}"


def test_batch_norm_switch_is_ported_and_off_by_default():
    from paddle_tpu_torch.ops import kernels
    assert not kernels.enabled("batch_norm")
    kernels.configure(batch_norm=True)
    try:
        assert kernels.enabled("batch_norm")
        kernels.configure(batch_norm=False)
        assert not kernels.enabled("batch_norm")
    finally:
        kernels.configure(batch_norm=None)
    names = {"batch_norm_stats", "batch_norm_normalize",
             "batch_norm_bwd_reduce", "batch_norm_bwd_dx"}
    assert names <= set(kernels.SOURCES) and names <= set(kernels.launches)
    assert all(kernels.SOURCES[n] == "batch_norm.cu" for n in names)
    assert (kernels.CSRC / "batch_norm.cu").is_file()
    # the 14 Pallas kernels' counterparts and the two int8 kernels
    assert len(kernels.SOURCES) == 16


def test_importing_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import paddle_tpu_torch; "
            "import paddle_tpu_torch.serving, paddle_tpu_torch.models; "
            "import paddle_tpu_torch.tools.bench_resnet; "
            "import chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)") % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    from paddle_tpu_torch import device, inference, nn
    assert device.get_device() == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = nn.Sequential(nn.Linear(4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.Predictor(model)
    # asking for the CPU is the one way onto it
    pred = inference.Predictor(model, device="cpu")
    assert pred.device.type == "cpu"
    assert pred.run(torch.zeros(3, 4).numpy()).shape == (3, 2)


def test_bench_resnet_defaults_to_the_card(monkeypatch):
    from paddle_tpu_torch.tools import bench_resnet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_resnet.Trainer(batch=2, inner=1, size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_resnet.bench_resnet(batch=2, steps=1, inner=1, size=32)


def test_set_device_chooses_the_default(monkeypatch):
    from paddle_tpu_torch import device
    monkeypatch.setattr(device, "_current", None)
    assert device.set_device("gpu:1") == "cuda:1"
    assert device.get_device() == "cuda:1"
    assert device.set_device("cpu") == "cpu"
    assert device.resolve().type == "cpu"
    with pytest.raises(ValueError):
        device.set_device("tpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the chip script exits non-zero and prints no result;
    copied alone into an empty directory, it cannot find the port and
    fails the same way."""
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=str(where),
                           capture_output=True, text=True, timeout=120,
                           env={"PATH": "/usr/bin:/bin",
                                "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("module", ["paddle_tpu_torch.monitor",
                                    "paddle_tpu_torch.monitor.registry",
                                    "paddle_tpu_torch.monitor.trace",
                                    "paddle_tpu_torch.serving.metrics",
                                    "paddle_tpu_torch.serving.reqtrace"])
def test_monitor_and_serving_metrics_load_no_jax(module):
    """The monitor package and the serving metrics it feeds are covered
    by the import check above (every file under the port), and importing
    each alone loads no JAX."""
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert path in SOURCES
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)") % (str(ROOT), module)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr

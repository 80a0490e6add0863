"""What the port may and may not depend on.

``paddle_tpu_torch`` and ``chip_smoke.py`` import ``torch`` and never
``jax`` or the JAX package ``paddle_tpu`` (not even its JAX-free modules);
the port's path calls no library attention or normalisation kernel; and
its entry points target the CUDA card unless the caller asks for the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    attention or layer norm, no torch.compile, no cuDNN switch."""
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for word in ("torch.nn.functional", "from torch.nn import functional",
                     "torch.compile", "cudnn", "import triton"):
            assert word not in text, f"{path.relative_to(ROOT)}: {word}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import paddle_tpu_torch; "
            "import paddle_tpu_torch.serving, paddle_tpu_torch.models; "
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

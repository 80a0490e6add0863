"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's, on the CPU.

Each scheduler is pure host arithmetic in both packages, so the port's
``last_lr`` sequence over 30 steps must equal the reference's float for
float, also across a ``state_dict`` round trip. An optimizer that owns a
scheduler holds the rate as a float32 device tensor: after each
``scheduler.step()`` that tensor must equal ``last_lr`` rounded to
float32, on every optimizer class, and ``get_lr()`` returns ``last_lr``.

Momentum under a ``PiecewiseDecay`` with ``ClipGradByNorm`` trains a
narrow ResNet (``BasicBlock``, one block a stage, 32x32 images) in both
packages within the ResNet slice's tolerances (``test_torch_resnet.py``:
losses 1e-4, parameters 2e-4 absolute and 2e-3 relative after three
steps).

Isolation: the reference's flat-arena hook is cleared around each test
and no test builds a JAX ``ParamArena`` (ROADMAP.md Queue C); the ResNet
test runs PyTorch's native CPU convolutions, as ``test_torch_resnet.py``
does.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.tensor as ref_tensor
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.fluid import dygraph_lr as jdlr
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import loss as jloss
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as ptt
from paddle_tpu_torch import clip, nn, optimizer
from paddle_tpu_torch.convert import export_state, load_jax_state
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.ops import loss
from paddle_tpu_torch.optimizer import lr

# the reference's root rebinds `clip` to the clip op; the module is here
jclip = importlib.import_module("paddle_tpu.clip")

STEPS = 30


@pytest.fixture(autouse=True)
def _no_arena_hook():
    hook = ref_tensor._arena_hook
    ref_tensor._arena_hook = None
    yield
    ref_tensor._arena_hook = hook


def _lam(epoch):
    return 0.95 ** epoch


# name: a constructor over a module (the reference's lr or the port's)
CASES = {
    "noam": lambda m: m.NoamDecay(512, 4000),
    "noam_lr2": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "exponential": lambda m: m.ExponentialDecay(0.1, 0.9),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, 0.3),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 20),
    "polynomial_power2": lambda m: m.PolynomialDecay(0.1, 10, end_lr=0.01,
                                                     power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, 7, cycle=True),
    "piecewise": lambda m: m.PiecewiseDecay([3, 10, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, 12),
    "cosine_eta": lambda m: m.CosineAnnealingDecay(0.1, 25, eta_min=0.01),
    "warmup_float": lambda m: m.LinearWarmup(0.1, 5, 0.0, 0.1),
    "warmup_polynomial": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, decay_steps=20), warmup_steps=4,
        start_lr=0.0, end_lr=1e-4),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.2, 10), 3, 0.01, 0.2),
    "step": lambda m: m.StepDecay(0.1, 4),
    "step_gamma": lambda m: m.StepDecay(0.5, 3, gamma=0.7),
    "multistep": lambda m: m.MultiStepDecay(0.1, [2, 9, 15]),
    "lambda": lambda m: m.LambdaDecay(0.1, _lam),
    "last_epoch_5": lambda m: m.ExponentialDecay(0.1, 0.8, last_epoch=5),
    "fluid_noam": lambda m: m.noam_decay(128, 8),
    "fluid_exponential": lambda m: m.exponential_decay(0.1, 5, 0.5),
    "fluid_exponential_staircase": lambda m: m.exponential_decay(
        0.1, 5, 0.5, staircase=True),
    "fluid_piecewise": lambda m: m.piecewise_decay([5, 12], [1.0, 0.5, 0.1]),
    "fluid_cosine": lambda m: m.cosine_decay(0.1, 4, 6),
    "fluid_polynomial": lambda m: m.polynomial_decay(0.1, 15, 0.001, 1.5,
                                                     True),
    "fluid_warmup": lambda m: m.linear_lr_warmup(0.05, 6, 0.0, 0.05),
}


def _run(s, steps=STEPS):
    out = [s.last_lr]
    for _ in range(steps):
        out.append(s.step())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_equals_the_references(case):
    want = _run(CASES[case](jlr))
    got = _run(CASES[case](lr))
    assert got == want
    assert all(isinstance(v, float) or isinstance(v, int) for v in got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip_continues_the_sequence(case):
    ref, port = CASES[case](jlr), CASES[case](lr)
    _run(ref, 11)
    _run(port, 11)
    state = port.state_dict()
    assert state == ref.state_dict()
    fresh = CASES[case](lr)
    fresh.set_state_dict(state)
    assert fresh.last_epoch == ref.last_epoch and fresh() == ref()
    assert _run(fresh, 19) == _run(ref, 19)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("cooldown", [0, 2])
def test_reduce_on_plateau_equals_the_references(mode, cooldown):
    metrics = np.random.RandomState(3).rand(STEPS) + np.linspace(
        1.0, 0.0, STEPS) * (1 if mode == "min" else -1)
    metrics[10:20] = metrics[9]           # a plateau
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=1e-3,
              cooldown=cooldown, min_lr=1e-3)
    ref, port = jlr.ReduceOnPlateau(0.1, **kw), lr.ReduceOnPlateau(0.1, **kw)
    for m in metrics:
        assert port.step(float(m)) == ref.step(float(m))
        assert port.step() == ref.step()
    assert port.state_dict() == ref.state_dict()
    assert port.last_lr < 0.1


def _optimizer(cls, sched, params):
    if cls is optimizer.Momentum:
        return cls(sched, 0.9, parameters=params)
    return cls(learning_rate=sched, parameters=params)


@pytest.mark.parametrize("cls", [optimizer.SGD, optimizer.Momentum,
                                 optimizer.Adam, optimizer.AdamW])
def test_optimizer_device_rate_follows_the_scheduler(cls):
    """The rate each step uses is the scheduler's ``last_lr`` as float32,
    filled into the optimizer's tensor in place (its storage does not
    move, so a captured step reads it at replay)."""
    torch.manual_seed(0)
    m = nn.Linear(3, 2)
    sched = CASES["warmup_polynomial"](lr)
    o = _optimizer(cls, sched, m.parameters())
    o._ensure_all_slots()
    (rate,) = o._lr.values()
    ptr = rate.data_ptr()
    for _ in range(8):
        assert o.get_lr() == sched.last_lr
        assert rate.item() == float(np.float32(sched.last_lr))
        m(torch.ones(1, 3)).sum().backward()
        o.step()
        o.clear_grad()
        sched.step()
    assert rate.data_ptr() == ptr


def test_a_step_takes_the_scheduled_rate():
    """SGD under a piecewise schedule moves the parameter by exactly the
    scheduled rate times the gradient, step by step."""
    w = torch.nn.Parameter(torch.zeros(4))
    sched = lr.PiecewiseDecay([2, 4], [0.5, 0.25, 0.125])
    o = optimizer.SGD(learning_rate=sched, parameters=[w])
    want = 0.0
    for _ in range(6):
        w.grad = torch.ones(4)
        want -= sched.last_lr
        o.step()
        sched.step()
        assert torch.equal(w, torch.full((4,), want))


def test_set_state_dict_hands_the_rate_to_the_optimizer():
    w = torch.nn.Parameter(torch.zeros(2))
    sched = lr.ExponentialDecay(0.1, 0.5)
    o = optimizer.SGD(learning_rate=sched, parameters=[w])
    o._ensure_all_slots()
    sched.set_state_dict({"last_epoch": 3, "last_lr": 0.0125})
    assert o.get_lr() == 0.0125
    assert next(iter(o._lr.values())).item() == float(np.float32(0.0125))


@pytest.mark.parametrize("decay", ["PiecewiseDecay", "ExponentialDecay"])
def test_fluid_learning_rate_decay_raises_naming_item_21(decay):
    """The 1.x dygraph decay objects are not ported: the optimizer says so
    (NotImplementedError naming its item), never a TypeError."""
    sched = (jdlr.PiecewiseDecay([2], [0.1, 0.01], 0)
             if decay == "PiecewiseDecay"
             else jdlr.ExponentialDecay(0.1, 5, 0.5))
    with pytest.raises(NotImplementedError, match="item 21"):
        optimizer.SGD(learning_rate=sched,
                      parameters=[torch.nn.Parameter(torch.zeros(1))])


def test_exports_match_the_references():
    public = {n for n in dir(jlr) if not n.startswith("_")
              and n not in ("annotations", "math")}
    assert public <= set(dir(lr)), public - set(dir(lr))
    assert set(lr.__all__) == public
    assert ptt.lr is lr and ptt.optimizer.lr is lr
    assert pt.lr is jlr
    assert optimizer.LRScheduler is lr.LRScheduler
    assert issubclass(lr.ReduceOnPlateau, lr.LRScheduler)


def test_noam_and_cosine_closed_forms():
    """Two schedules against their closed forms as well (the reference is
    not the only witness)."""
    s = lr.NoamDecay(64, 10)
    for _ in range(15):
        n = max(s.last_epoch, 1)
        assert s.last_lr == 64 ** -0.5 * min(n ** -0.5, n * 10 ** -1.5)
        s.step()
    c = lr.CosineAnnealingDecay(1.0, 8)
    for k in range(9):
        assert math.isclose(c.last_lr, (1 + math.cos(math.pi * k / 8)) / 2)
        c.step()


# -- a narrow ResNet: Momentum, PiecewiseDecay and ClipGradByNorm ------------

R_BATCH, R_SIZE, R_CLASSES, R_STEPS = 8, 32, 10, 3


@pytest.fixture
def no_onednn_convolutions():
    """As in ``test_torch_resnet.py``: oneDNN's convolutions and XLA's CPU
    runtime do not share a process safely."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_resnet_momentum_piecewise_clip_by_norm(no_onednn_convolutions):
    pt.seed(0)
    jm = jresnet.ResNet(jresnet.BasicBlock, [1, 1, 1, 1],
                        num_classes=R_CLASSES)
    jm.train()
    m = resnet.ResNet(resnet.BasicBlock, [1, 1, 1, 1],
                      num_classes=R_CLASSES).train()
    load_jax_state(m, {k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    s0 = export_state(m)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(R_BATCH, 3, R_SIZE, R_SIZE).astype("f4"),
                rng.randint(0, R_CLASSES, R_BATCH).astype("i4"))
               for _ in range(R_STEPS)]
    js = jlr.PiecewiseDecay([1, 2], [0.004, 0.002, 0.001])
    jo = jopt.Momentum(learning_rate=js, momentum=0.9,
                       parameters=jm.parameters(),
                       grad_clip=jclip.ClipGradByNorm(0.05))

    def jstep(x, y):
        lo = jloss.cross_entropy(jm(x), y)
        lo.backward()
        jo.step()
        jo.clear_grad()
        return lo

    fn = jjit.to_static(jstep, models=[jm], optimizers=[jo])
    want_loss = []
    for x, y in batches:
        want_loss.append(float(fn(pt.to_tensor(x), pt.to_tensor(y)).numpy()))
        js.step()
    s = lr.PiecewiseDecay([1, 2], [0.004, 0.002, 0.001])
    o = optimizer.Momentum(learning_rate=s, momentum=0.9,
                           parameters=m.parameters(),
                           grad_clip=clip.ClipGradByNorm(0.05))
    got_loss = []
    for x, y in batches:
        lo = loss.cross_entropy(m(torch.from_numpy(np.array(x))),
                                torch.from_numpy(np.array(y)))
        lo.backward()
        o.step()
        o.clear_grad()
        s.step()
        got_loss.append(lo.item())
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-4)
    want = {k: np.asarray(v.numpy(), np.float32)
            for k, v in jm.state_dict().items()}
    got = export_state(m)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=2e-3,
                                   err_msg=k)
    moved = [k for k in want if not np.array_equal(got[k], s0[k])]
    assert len(moved) > len(want) // 2

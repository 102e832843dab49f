"""The port's Profiler capsule and trace-window policy against the JAX
package's (``tests/test_profiler.py``, ``tests/test_prof.py``), on the CPU.

* ``ROCKET_TPU_PROF``: the port's ``ProfPolicy`` parses every value as the
  reference does and refuses the same malformed ones; ``parse_step_window``
  likewise; the capsule installs the env policy unless a window is given.
* The step clock: ``steps_per_sec`` after warmup into the Looper state and
  the Tracker scalars; ``mfu`` from ``flops_per_sample`` x the batch size
  against a known peak, and none on the CPU (no peak there).
* The trace window: ``torch.profiler`` opens at ``trace_start`` and closes
  after ``trace_steps`` steps (or at ``destroy``), writing a Chrome trace;
  a Launcher tree with a Profiler publishes its clock.
"""

import json
import os

import numpy as np
import pytest
import torch

import rocket_tpu_torch as rt
from rocket_tpu.obs import prof as jprof
from rocket_tpu_torch import optim
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.obs import prof as tprof
from rocket_tpu_torch.utils import perf

VALUES = [None, "", "0", "off", "false", "1", "on", "true", "5:9", "0:1", "3@200", "1@2",
          " 2@50 "]
BAD = ["junk", "5:5", "3:1", "0@3", "5@3", "-1:4", "a@b", "1:"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_policy_grammar_matches_the_reference(value):
    got, want = tprof.ProfPolicy.from_env(value), jprof.ProfPolicy.from_env(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.steps, got.every, got.start) == (want.steps, want.every, want.start)
        assert ([s for s in range(500) if got.window_start(s)]
                == [s for s in range(500) if want.window_start(s)])


@pytest.mark.parametrize("value", BAD)
def test_policy_refuses_what_the_reference_refuses(value):
    with pytest.raises(ValueError):
        jprof.ProfPolicy.from_env(value)
    with pytest.raises(ValueError):
        tprof.ProfPolicy.from_env(value)


def test_parse_step_window_matches_the_reference():
    assert tprof.parse_step_window("3:9") == jprof.parse_step_window("3:9") == (3, 9)
    for bad in ("9", "4:4", "5:2", "-1:3"):
        with pytest.raises(ValueError):
            tprof.parse_step_window(bad)


def test_capsule_installs_the_env_policy(monkeypatch, tmp_path):
    monkeypatch.setenv("ROCKET_TPU_PROF", "2@50")
    profiler = rt.Profiler(trace_dir=str(tmp_path))
    assert (profiler._trace_start, profiler._trace_steps, profiler._trace_every) == (50, 2, 50)
    monkeypatch.setenv("ROCKET_TPU_PROF", "junk")
    with pytest.raises(ValueError):
        rt.Profiler(trace_dir=str(tmp_path))
    monkeypatch.setenv("ROCKET_TPU_PROF", "2@50")  # an explicit window wins
    explicit = rt.Profiler(trace_dir=str(tmp_path), trace_start=5, trace_steps=4)
    assert (explicit._trace_start, explicit._trace_steps, explicit._trace_every) == (5, 4, 0)
    monkeypatch.delenv("ROCKET_TPU_PROF")
    periodic = rt.Profiler(trace_dir=str(tmp_path), trace_steps=2, trace_every=40)
    assert (periodic._trace_start, periodic._trace_steps, periodic._trace_every) == (40, 2, 40)
    with pytest.raises(ValueError):
        rt.Profiler(trace_dir=str(tmp_path), trace_steps=5, trace_every=5)


def _attrs(size=None):
    attrs = Attributes()
    attrs.looper = Attributes(state=Attributes())
    attrs.tracker = Attributes(scalars=Attributes())
    if size is not None:
        attrs.batch_info = Attributes(size=size, index=None)
    return attrs


def _profiler(**kw):
    profiler = rt.Profiler(runtime=rt.Runtime(device="cpu"), **kw)
    profiler.setup()
    profiler.set()
    return profiler


def test_step_clock_and_mfu_from_flops_per_sample(monkeypatch):
    monkeypatch.setitem(perf.PEAK_FLOPS, "cpu", 1e12)
    profiler = _profiler(flops_per_sample=2e6, warmup=1)
    attrs = _attrs(size=32)
    for _ in range(4):
        profiler.launch(attrs)
    scalars = attrs.tracker.scalars
    assert scalars["perf/steps_per_sec"] > 0
    assert scalars["perf/mfu"] == pytest.approx(scalars["perf/steps_per_sec"] * 2e6 * 32 / 1e12)
    assert attrs.looper.state.steps_per_sec == round(scalars["perf/steps_per_sec"], 2)
    assert attrs.looper.state.mfu == round(scalars["perf/mfu"], 4)


def test_no_mfu_without_a_peak_and_none_during_warmup():
    assert perf.peak_flops("cpu") is None
    profiler = _profiler(flops_per_step=1e9, warmup=2)
    attrs = _attrs()
    profiler.launch(attrs)
    profiler.launch(attrs)
    assert attrs.tracker.scalars["perf/steps_per_sec"] is None  # still warming up
    profiler.launch(attrs)
    assert attrs.tracker.scalars["perf/steps_per_sec"] > 0
    assert attrs.tracker.scalars["perf/mfu"] is None


def test_peak_table_is_keyed_by_card_name_prefix(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert perf.peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert perf.peak_flops("cuda") is None


def test_trace_window_opens_closes_and_writes_a_chrome_trace(tmp_path):
    profiler = _profiler(trace_dir=str(tmp_path / "tr"), trace_start=3, trace_steps=2)
    for _ in range(3):
        profiler.launch(None)
    assert profiler._prof is None and profiler.trace_files == []
    profiler.launch(None)  # iteration 3 opens the window
    assert profiler._prof is not None
    torch.ones(8).sum()
    profiler.launch(None)
    assert profiler._prof is not None  # still inside the window
    profiler.launch(None)
    assert profiler._prof is None and len(profiler.trace_files) == 1
    with open(profiler.trace_files[0]) as f:
        assert "traceEvents" in json.load(f)
    for _ in range(3):  # a single window never reopens
        profiler.launch(None)
    profiler.destroy()
    assert len(profiler.trace_files) == 1


def test_destroy_closes_a_still_open_window(tmp_path):
    profiler = _profiler(trace_dir=str(tmp_path / "tr"), trace_start=1, trace_steps=100)
    profiler.launch(None)
    profiler.launch(None)
    assert profiler._prof is not None
    profiler.destroy()
    assert profiler._prof is None and os.path.exists(profiler.trace_files[0])


def test_periodic_windows_reopen(tmp_path):
    profiler = _profiler(trace_dir=str(tmp_path / "tr"), trace_steps=1, trace_every=3)
    for _ in range(10):
        profiler.launch(None)
    profiler.destroy()
    assert len(profiler.trace_files) == 3  # windows at iterations 3, 6 and 9


def test_profiler_in_a_launcher_tree_publishes_its_clock(tmp_path):
    rng = np.random.default_rng(0)
    data = [{"x": rng.normal(size=8).astype(np.float32), "y": np.int64(i % 4)}
            for i in range(96)]

    class Model:
        def init(self, gen, device=None):
            return {"w": torch.randn(8, 4, generator=gen)}

        def apply(self, params, batch, *, mode, rng):
            return {**batch, "logits": batch["x"] @ params["w"]}

    seen = {}

    class Spy(rt.Capsule):
        def __init__(self):
            super().__init__(priority=120)  # after the Profiler (150)

        def launch(self, attrs=None):
            if attrs.looper.state.steps_per_sec is not None:
                seen["steps_per_sec"] = attrs.looper.state.steps_per_sec

    def loss(batch):
        return torch.nn.functional.cross_entropy(batch["logits"], batch["y"])

    rt.Launcher([rt.Looper([
        rt.Dataset(data, batch_size=8),
        rt.Module(Model(), [rt.Loss(loss), rt.Optimizer(optim.adam(), learning_rate=1e-2)]),
        rt.Profiler(trace_dir=str(tmp_path / "traces"), trace_start=2, trace_steps=2,
                    flops_per_sample=1e3),
        Spy(),
    ], progress=False)], runtime=rt.Runtime(device="cpu")).launch()
    assert seen.get("steps_per_sec", 0) > 0
    assert os.listdir(tmp_path / "traces") == ["window_0.json"]


def test_ab_runs_each_checkout_with_this_checkouts_timer(tmp_path, capfd):
    """``obs.ab`` loads each checkout's chip_smoke.py with this checkout's
    Timer in place of its own: a stand-in checkout (an older commit's
    Timer, a main that reports which Timer it sees) runs once per time it
    is named, and its exit code comes back."""
    from rocket_tpu_torch.obs import ab

    source = ab.timer_source()
    assert source.startswith("class Timer") and "def launches_ms" in source
    (tmp_path / "chip_smoke.py").write_text(
        "class Timer:\n"
        "    OLD = True\n"
        "def main():\n"
        "    print('old' if hasattr(Timer, 'OLD') else 'new', hasattr(Timer, 'launches_ms'))\n"
        "    return 3\n")
    assert ab.main([str(tmp_path), str(tmp_path)]) == 3
    assert capfd.readouterr().out.splitlines() == ["new True", "new True"]

"""The port's ``Probe`` (``utils/probe.py``) against the JAX package's: the
same tree of probes under both packages' Launchers records the same
``(name, event)`` sequence with the same modes."""

import jax
import pytest

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu.utils.probe import Probe as JProbe
from rocket_tpu.utils.probe import ProbeEvent as JProbeEvent
from rocket_tpu_torch.utils.probe import Probe, ProbeEvent


def _tree(pkg, probe, trace):
    """Two phases (a train and an eval Looper) of prioritised probes."""
    train = pkg.Looper([probe("t_low", trace, priority=10), probe("t_high", trace, priority=2000)],
                       tag="train", repeats=2, progress=False)
    val = pkg.Looper([probe("v", trace)], tag="val", grad_enabled=False, repeats=1,
                     progress=False)
    return [probe("root", trace), train, val]


@pytest.mark.parametrize("epochs", [1, 2])
def test_probe_traces_match_the_reference(tmp_path, epochs):
    ours, theirs = [], []
    rt.Launcher(_tree(rt, Probe, ours), num_epochs=epochs,
                runtime=rt.Runtime(device="cpu")).launch()
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1],
                       project_dir=str(tmp_path))
    jrt.Launcher(_tree(jrt, JProbe, theirs), num_epochs=epochs, runtime=runtime).launch()
    assert [tuple(e) for e in ours] == [tuple(e) for e in theirs]
    assert [e.mode for e in ours] == [e.mode for e in theirs]
    assert all(a.t <= b.t for a, b in zip(ours, ours[1:]))
    assert ("t_high", "launch") in ours and ours.count(("v", "launch")) == epochs


def test_probe_event_is_its_tuple():
    event = ProbeEvent("a", "launch", 1.5, "train")
    assert event == ("a", "launch") == JProbeEvent("a", "launch", 1.5, "train")
    assert (event.name, event.event, event.t, event.mode) == ("a", "launch", 1.5, "train")

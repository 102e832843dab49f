"""The port's ``Dataset`` capsule against the reference ``DataLoader``.

* Batch indices and ``size`` equal, batch by batch, for n in {10, 12, 3}
  samples at ``batch_size=4``, seeds 0 and 1, epochs 0 and 1, shuffled
  and not, ``drop_last`` on and off: the shuffle is numpy's
  ``SeedSequence([seed, epoch, 0x90C3E7])`` and a short trailing batch is
  wrap-padded with ``size`` the real count, in both packages.
* A mid-epoch resume (``batch_idx`` restored, the reference's ``skip``)
  yields the rest of the same epoch.
* One cross-package ``Launcher`` tree with ``shuffle=True`` and
  ``drop_last=False`` (a padded trailing batch every epoch): per-step
  losses equal within 1e-5 (float32, the same math in another order).
* The device-resident path: its batches bitwise equal to streaming ones,
  the shared loader closed by its last holder, the ``cache_dtype`` warning
  on the streaming path, the ``"auto"`` size rule and a mid-epoch resume
  on the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.capsule import Capsule as JCapsule
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.loader import DataLoader
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.datasets import ArrayDataset
from rocket_tpu_torch.data.text import TokenDataset
from rocket_tpu_torch.models import transformer as tt


class _Indices:
    """A map-style dataset whose sample i is the integer i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


def _reference(n, shuffle, drop_last, seed, epoch, skip=0):
    loader = DataLoader(_Indices(n), batch_size=4, shuffle=shuffle, drop_last=drop_last,
                        seed=seed)
    loader.set_epoch(epoch)
    loader.skip(skip)
    return len(loader), [(np.asarray(b.data).tolist(), b.size, b.index) for b in loader]


def _port(n, shuffle, drop_last, seed, epoch, batch_idx=0):
    ds = rt.Dataset(_Indices(n), batch_size=4, shuffle=shuffle, drop_last=drop_last)
    ds.bind(rt.Runtime(device="cpu", seed=seed))
    ds.load_state_dict({"batch_idx": batch_idx})
    ds.set(Attributes(mode="train", launcher=Attributes(epoch_idx=epoch)))
    batches = []
    while True:
        attrs = Attributes(looper=Attributes())
        ds.launch(attrs)
        if attrs.looper.terminate:
            return ds.total, batches
        batches.append((attrs.batch.tolist(), attrs.batch_info.size, attrs.batch_info.index))


@pytest.mark.parametrize("n", [10, 12, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batches_match_the_reference_loader(n, shuffle, drop_last):
    for seed in (0, 1):
        for epoch in (0, 1):
            assert _port(n, shuffle, drop_last, seed, epoch) == \
                _reference(n, shuffle, drop_last, seed, epoch), (seed, epoch)


def test_worked_example_n10():
    """The batches at n = 10, batch_size 4, seed 0, epoch 0."""
    _, plain = _port(10, False, False, 0, 0)
    assert plain[-1] == ([8, 9, 0, 1], 2, 2)
    _, shuffled = _port(10, True, False, 0, 0)
    assert [b[0] for b in shuffled] == [[7, 2, 6, 8], [4, 9, 3, 5], [0, 1, 7, 2]]
    assert [b[1] for b in shuffled] == [4, 4, 2]


@pytest.mark.parametrize("shuffle", [False, True])
def test_mid_epoch_resume_skips_like_the_reference(shuffle):
    total, whole = _port(10, shuffle, False, 1, 1)
    _, resumed = _port(10, shuffle, False, 1, 1, batch_idx=1)
    assert resumed == whole[1:]
    assert (total, resumed) == _reference(10, shuffle, False, 1, 1, skip=1)


# -- one Launcher tree in both packages ---------------------------------------

CFG = dict(vocab_size=64, max_seq_len=32, dim=32, num_layers=1, num_heads=2, dropout=0.0,
           loss_chunk=16)
B, T, WINDOWS, EPOCHS = 2, 16, 5, 2


class _JLosses(JCapsule):
    def __init__(self):
        super().__init__(priority=10)
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(float(np.asarray(attrs.step_metrics["loss"])))


class _Losses(Capsule):
    def __init__(self):
        super().__init__(priority=10)
        self.rows = []

    def launch(self, attrs=None):
        self.rows.append(float(attrs.step_metrics["loss"]))


def test_shuffled_padded_launcher_tree_matches_the_jax_tree(tmp_path):
    """Five windows in batches of 2, shuffled, no drop_last: three steps an
    epoch, the last on a wrap-padded batch, two epochs, plain SGD."""
    tokens = np.random.default_rng(7).integers(0, CFG["vocab_size"], WINDOWS * T + 1)
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(2))["params"])

    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=3,
                        project_dir=str(tmp_path))
    jruntime.models.add(jmodel, JPrepared(jmodel, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32),
        "base_key": jax.random.key_data(jax.random.key(0))}))
    jmodule = jrt.Module(jmodel, [jrt.Loss(jt.next_token_loss()),
                                  jrt.Optimizer(joptim.sgd()),
                                  jrt.Scheduler(joptim.constant_lr(0.5))])
    jrec = _JLosses()
    jrt.Launcher([jrt.Looper([jrt.Dataset(JTokenDataset(tokens, T), batch_size=B, shuffle=True),
                              jmodule, jrec], progress=False)],
                 num_epochs=EPOCHS, runtime=jruntime).launch()

    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    runtime = rt.Runtime(device="cpu", seed=3)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()), rt.Optimizer(toptim.sgd()),
                               rt.Scheduler(toptim.constant_lr(0.5))])
    rec = _Losses()
    rt.Launcher([rt.Looper([rt.Dataset(TokenDataset(tokens, T), batch_size=B, shuffle=True),
                            module, rec], progress=False)],
                num_epochs=EPOCHS, runtime=runtime).launch()

    assert len(rec.rows) == len(jrec.rows) == EPOCHS * 3
    np.testing.assert_allclose(rec.rows, jrec.rows, atol=1e-5, rtol=1e-5)


# -- the device-resident path behind the capsule ---------------------------------


def _launcher_batches(data, epochs=2, **kw):
    """Every (batch, size, index) a Dataset capsule hands a Launcher tree,
    as numpy, over ``epochs`` epochs (the runtime's seed 3)."""
    seen = []

    class Grab(Capsule):
        def launch(self, attrs=None):
            seen.append(({k: v.numpy() for k, v in attrs.batch.items()},
                         attrs.batch_info.size, attrs.batch_info.index))

    ds = rt.Dataset(data, **kw)
    rt.Launcher([rt.Looper([ds, Grab()], progress=False)], num_epochs=epochs,
                runtime=rt.Runtime(device="cpu", seed=3)).launch()
    return ds, seen


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_cache_batches_equal_the_streaming_ones_bitwise(shuffle):
    rng = np.random.default_rng(0)
    data = ArrayDataset(rng.normal(size=(10, 4, 4, 3)).astype(np.float32),
                        rng.integers(0, 10, 10).astype(np.int32))
    cached, got = _launcher_batches(data, batch_size=4, shuffle=shuffle)
    streamed, want = _launcher_batches(data, batch_size=4, shuffle=shuffle, device_cache=False)
    assert cached.device_resident and not streamed.device_resident
    assert len(got) == len(want) == 6
    for (g, gs, gi), (w, ws, wi) in zip(got, want):
        assert (gs, gi) == (ws, wi) and g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


def test_the_last_destroy_closes_a_shared_loader(monkeypatch):
    """Two capsules with one dataset and one batching share one streaming
    loader; the first destroy leaves it open, the second closes it."""
    data = ArrayDataset(np.zeros((8, 2), np.float32), np.arange(8, dtype=np.int32))
    runtime = rt.Runtime(device="cpu")
    a, b = (rt.Dataset(data, batch_size=4, device_cache=False, statefull=False,
                       runtime=runtime) for _ in range(2))
    a.setup()
    a.setup()  # set up twice: still one holder
    b.setup()
    assert a._dataloader is b._dataloader and len(runtime.dataloaders) == 1
    closed = []
    monkeypatch.setattr(a._dataloader, "close", lambda: closed.append(True))
    a.destroy()
    assert closed == [] and len(runtime.dataloaders) == 1
    b.destroy()
    assert closed == [True] and len(runtime.dataloaders) == 0


def test_cache_dtype_warns_on_the_streaming_path(caplog):
    data = ArrayDataset(np.zeros((8, 2), np.float32), np.arange(8, dtype=np.int32))
    ds = rt.Dataset(data, batch_size=4, device_cache=False, cache_dtype="bfloat16",
                    statefull=False, runtime=rt.Runtime(device="cpu"))
    with caplog.at_level("WARNING", logger="rocket_tpu_torch.dataset"):
        ds.setup()
    assert not ds.device_resident
    assert any("cache_dtype" in r.getMessage() for r in caplog.records)
    caplog.clear()
    cached = rt.Dataset(data, batch_size=4, cache_dtype="bfloat16", statefull=False,
                        runtime=rt.Runtime(device="cpu"))
    with caplog.at_level("WARNING", logger="rocket_tpu_torch.dataset"):
        cached.setup()
    assert cached.device_resident and not caplog.records


def test_auto_streams_past_the_size_rule():
    data = ArrayDataset(np.zeros((8, 2), np.float32), np.arange(8, dtype=np.int32))
    # The images fit, the labels beside them do not.
    small = {"device": "cpu", "device_cache_bytes": 8 * 2 * 4}
    ds = rt.Dataset(data, batch_size=4, statefull=False, runtime=rt.Runtime(**small))
    ds.setup()
    assert not ds.device_resident
    forced = rt.Dataset(data, batch_size=4, device_cache=True, statefull=False,
                        runtime=rt.Runtime(**small))
    forced.setup()
    assert forced.device_resident


@pytest.mark.parametrize("shuffle", [False, True])
def test_mid_epoch_resume_on_the_device_cache(shuffle):
    """A resumed capsule (``batch_idx`` restored) on the cache yields the
    rest of the epoch in train mode, and the whole epoch in eval."""
    def batches(batch_idx, mode):
        ds = rt.Dataset(_Indices(10), batch_size=4, shuffle=shuffle, device_cache=True)
        ds.bind(rt.Runtime(device="cpu", seed=1))
        ds.load_state_dict({"batch_idx": batch_idx})
        ds.set(Attributes(mode=mode, launcher=Attributes(epoch_idx=1)))
        assert ds.device_resident
        out = []
        while True:
            attrs = Attributes(looper=Attributes())
            ds.launch(attrs)
            if attrs.looper.terminate:
                return out
            out.append((attrs.batch.tolist(), attrs.batch_info.size, attrs.batch_info.index))

    whole = batches(0, "train")
    assert batches(2, "train") == whole[2:]
    assert batches(2, "eval") == whole
    assert whole == _reference(10, shuffle, False, 1, 1)[1]


@pytest.mark.parametrize("device_cache", [True, False])
def test_a_resume_at_the_epochs_end_leaves_the_next_epoch_whole(device_cache):
    """A checkpoint saved in an epoch's last wave resumes with the Dataset's
    position at the epoch's end: that epoch's pass is set up but never
    advanced (no wave is left), and the next epoch's pass is whole. The
    pending skip belongs to the pass it was set for."""
    def epochs(batch_idx):
        ds = rt.Dataset(_Indices(10), batch_size=4, shuffle=True, device_cache=device_cache)
        ds.bind(rt.Runtime(device="cpu", seed=1))
        ds.load_state_dict({"batch_idx": batch_idx})
        ds.set(Attributes(mode="train", launcher=Attributes(epoch_idx=1)))
        ds.reset(Attributes())
        ds.set(Attributes(mode="train", launcher=Attributes(epoch_idx=2)))
        assert ds.device_resident is device_cache
        out = []
        while True:
            attrs = Attributes(looper=Attributes())
            ds.launch(attrs)
            if attrs.looper.terminate:
                return out
            out.append(attrs.batch_info.index)

    assert epochs(3) == epochs(0) == [0, 1, 2]

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

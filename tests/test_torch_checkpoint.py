"""The port's checkpoint I/O and completeness scan against the JAX
package's: the on-disk format is shared, so each package reads what the
other writes.

* ``checkpoint_io`` round trips nested tensors, numpy arrays and JSON
  scalars bitwise, with the reference's ``index.json`` keys;
* params saved by JAX's ``save_pytree`` load into the port and give the
  JAX logits (float32, 1e-5: the same math in another order), and JAX's
  ``load_pytree(path, template)`` reads params the port saved, bitwise;
* ``is_complete_checkpoint`` / ``newest_complete_step`` answer as the JAX
  functions do on complete and torn step directories;
* ``atomic_write`` commits through write -> fsync -> replace, and an
  ``AsyncWriter`` error surfaces on the next wait.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocket_tpu.models import transformer as jt
from rocket_tpu.resilience import supervisor as jsup
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.resilience import supervisor as tsup
from rocket_tpu_torch.runtime import checkpoint_io as tio

CFG = dict(vocab_size=64, max_seq_len=32, dim=64, num_layers=2, num_heads=2)


def test_round_trip_is_bitwise_with_the_reference_index(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {
        "params": {"w": torch.randn(3, 4, generator=gen), "b": torch.randn(4, generator=gen)},
        "moments": [torch.randn(2, generator=gen).double(), np.arange(5, dtype=np.int32)],
        "step": 7, "lr": 3e-4, "tag": "char_lm", "nothing": None, "flag": True,
        "count": torch.tensor(3, dtype=torch.int64),
    }
    tio.save_pytree(str(tmp_path), tree)
    index = json.loads((tmp_path / "index.json").read_text())
    assert sorted(os.listdir(tmp_path)) == ["index.json", "shard_p0.npz"]
    assert index["params/w"]["kind"] == "array"
    assert set(index["params/w"]) == {"kind", "shape", "dtype", "chunks"}
    assert set(index["params/w"]["chunks"][0]) == {"file", "key", "index"}
    assert index["step"] == {"kind": "json", "value": 7}
    flat = tio.load_pytree(str(tmp_path))
    assert flat["tag"] == "char_lm" and flat["nothing"] is None and flat["flag"] is True
    assert flat["lr"] == 3e-4 and flat["step"] == 7
    np.testing.assert_array_equal(flat["moments/1"], np.arange(5, dtype=np.int32))
    restored = tio.load_pytree(str(tmp_path), template=tree)
    for key in ("w", "b"):
        assert torch.equal(restored["params"][key], tree["params"][key])
    assert restored["moments"][0].dtype == torch.float64
    assert torch.equal(restored["moments"][0], tree["moments"][0])
    assert torch.equal(restored["count"], tree["count"])
    assert tio.load_leaf(str(tmp_path), "step") == 7
    assert tio.unflatten(flat)["params"]["w"].shape == (3, 4)
    with pytest.raises(ValueError, match="shape"):
        tio.load_pytree(str(tmp_path), template={"params": {"w": torch.zeros(4, 3)}})


def test_bfloat16_leaves_raise():
    with pytest.raises(TypeError, match="bfloat16"):
        tio.snapshot({"w": torch.zeros(2, dtype=torch.bfloat16)})


def _jax_model():
    model = jt.TransformerLM(jt.TransformerConfig(**CFG))
    return model, jax.jit(model.init)(jax.random.key(0))["params"]


def test_the_port_reads_jax_params_and_jax_reads_the_ports(tmp_path):
    jmodel, jparams = _jax_model()
    jio.save_pytree(str(tmp_path / "jax"), {"params": jparams})
    tokens = np.random.default_rng(1).integers(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    jlogits, _ = jmodel.apply({"params": jparams, "state": {}}, {"tokens": jnp.asarray(tokens)},
                              mode="eval")
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    template = {"params": model.init(device="cpu")}
    params = tio.load_pytree(str(tmp_path / "jax"), template)["params"]
    logits = model.apply(params, {"tokens": torch.from_numpy(tokens)}, mode="eval")["logits"]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits["logits"]),
                               atol=1e-5, rtol=1e-5)

    tio.save_pytree(str(tmp_path / "port"), {"params": template["params"]})
    back = jio.load_pytree(str(tmp_path / "port"), {"params": jparams})["params"]
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), template["params"]))):
        np.testing.assert_array_equal(np.asarray(got), want)


def _step_dirs(root):
    """Step directories: complete (2), missing rng.json (4), missing shard
    (6), a complete one without models (8) and a model without its index
    (10)."""
    for step in (2, 4, 6, 8, 10):
        d = root / str(step)
        if step != 8:
            tio.save_pytree(str(d / "model_0"), {"w": torch.ones(2)})
        if step != 4:
            (d / "rng.json").parent.mkdir(parents=True, exist_ok=True)
            (d / "rng.json").write_text("{}")
    os.remove(root / "6" / "model_0" / "shard_p0.npz")
    os.remove(root / "10" / "model_0" / "index.json")


def test_completeness_scan_answers_as_the_reference(tmp_path):
    _step_dirs(tmp_path)
    for step in (2, 4, 6, 8, 10, 99):
        path = str(tmp_path / str(step))
        assert tsup.is_complete_checkpoint(path) == jsup.is_complete_checkpoint(path)
    assert [tsup.is_complete_checkpoint(str(tmp_path / str(s))) for s in (2, 4, 6, 8, 10)] == [
        True, False, False, True, False]
    assert tsup.newest_complete_step(str(tmp_path)) == jsup.newest_complete_step(str(tmp_path))
    assert tsup.newest_complete_step(str(tmp_path)) == 8
    os.remove(tmp_path / "8" / "rng.json")
    assert tsup.newest_complete_step(str(tmp_path)) == jsup.newest_complete_step(
        str(tmp_path)) == 2
    assert tsup.newest_complete_step(str(tmp_path / "absent")) is None
    assert tsup.newest_complete_step(None) is None


class _Recorder(tio.HostFS):
    def __init__(self):
        self.log = []

    def write(self, path, data):
        self.log.append("write")
        super().write(path, data)

    def fsync(self, path):
        self.log.append("fsync")
        super().fsync(path)

    def replace(self, src, dst):
        self.log.append(("replace", os.path.basename(dst)))
        super().replace(src, dst)


def test_atomic_write_order_and_async_errors(tmp_path):
    with tio.use_fs(_Recorder()) as fs:
        tio.atomic_write(str(tmp_path / "a.bin"), b"abc")
    assert fs.log == ["write", "fsync", ("replace", "a.bin")]
    assert (tmp_path / "a.bin").read_bytes() == b"abc"
    assert [p.name for p in tmp_path.iterdir()] == ["a.bin"]  # no temp file left

    writer = tio.AsyncWriter()
    writer.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    writer.submit(lambda: None)
    writer.wait()

"""The char-LM slice of the port against the JAX package: the training
tree with its Checkpointer and Tracker, resume, ``config.json``, generate
and serve from a checkpoint. Small sizes: dim 64, 2 layers, 2 heads, T=32,
B=4, float32, dropout 0 wherever the two packages are compared (their
dropout bits differ by design).

Tolerances: the two packages' per-step losses 1e-4 (float32; the same
math in another order, compounded over ten AdamW updates); a resumed run
against an uninterrupted one in the same package: bitwise.
"""

import dataclasses
import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu import optim as joptim
from rocket_tpu.core.checkpoint import Checkpointer as JCheckpointer
from rocket_tpu.core.module import PreparedModule as JPrepared
from rocket_tpu.data.text import TokenDataset as JTokenDataset
from rocket_tpu.models import transformer as jt
from rocket_tpu.runtime import checkpoint_io as jio
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch import optim as toptim
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.core.module import PreparedModule
from rocket_tpu_torch.data.text import CharTokenizer, TokenDataset, synthetic_corpus
from rocket_tpu_torch.examples import char_lm
from rocket_tpu_torch.examples import generate as tgen
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.optim import param_leaves
from rocket_tpu_torch.serve import __main__ as serve_cli

CFG = dict(vocab_size=48, max_seq_len=32, dim=64, num_layers=2, num_heads=2, dropout=0.0)
B, T = 4, 32
STEPS_PER_EPOCH = 5


def _tokens(seed=0):
    """20 windows of T tokens: five batches of four per epoch."""
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], 20 * T + 10)


def _losses(path):
    with open(path) as f:
        return [row["train/loss"] for row in map(json.loads, f) if "train/loss" in row]


# -- the two packages' trees ----------------------------------------------------


def _jax_run(tmp, jparams, num_epochs, resume_from=None):
    model = jt.TransformerLM(jt.TransformerConfig(**CFG))
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                       project_dir=str(tmp))
    runtime.models.add(model, JPrepared(model, {
        "params": jax.tree.map(jnp.asarray, jparams), "model_state": {},
        "step": jnp.zeros((), jnp.int32), "base_key": jax.random.key_data(jax.random.key(0))}))
    module = jrt.Module(model, [jrt.Loss(jt.next_token_loss()),
                                jrt.Optimizer(joptim.adamw(weight_decay=0.1)),
                                jrt.Scheduler(joptim.warmup_cosine_lr(3e-4, 1, 10))])
    jrt.Launcher([jrt.Looper([
        jrt.Dataset(JTokenDataset(_tokens(), T), batch_size=B, drop_last=True), module,
        jrt.Checkpointer(output_dir=str(tmp / "ckpt"), save_every=2, keep_last=2,
                         resume_from=resume_from),
        jrt.Tracker(backend="jsonl", project="char_lm", directory=str(tmp / "runs")),
    ], tag="train", progress=False)], num_epochs=num_epochs, statefull=True,
        runtime=runtime).launch()


def _port_run(tmp, jparams, num_epochs, resume_from=None):
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    runtime = rt.Runtime(device="cpu", seed=0)
    runtime.models.add(model, PreparedModule(model, {"params": params_from_jax(jparams)}))
    module = rt.Module(model, [rt.Loss(tt.next_token_loss()),
                               rt.Optimizer(toptim.adamw(weight_decay=0.1)),
                               rt.Scheduler(toptim.warmup_cosine_lr(3e-4, 1, 10))])
    rt.Launcher([rt.Looper([
        rt.Dataset(TokenDataset(_tokens(), T), batch_size=B, drop_last=True), module,
        rt.Checkpointer(output_dir=str(tmp / "ckpt"), save_every=2, keep_last=2,
                        resume_from=resume_from),
        rt.Tracker(backend="jsonl", project="char_lm", directory=str(tmp / "runs")),
    ], tag="train", progress=False)], num_epochs=num_epochs, statefull=True,
        runtime=runtime).launch()


@pytest.fixture(scope="module")
def both_trees(tmp_path_factory):
    """Each package: one epoch, then a fresh tree resumed from "latest" for
    a second; the step directories after each phase and the losses."""
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    jparams = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(1))["params"])
    out = {"jparams": jparams}
    for name, run in (("jax", _jax_run), ("port", _port_run)):
        tmp = tmp_path_factory.mktemp(name)
        run(tmp, jparams, 1)
        dirs = [sorted(os.listdir(tmp / "ckpt"))]
        run(tmp, jparams, 2, resume_from="latest")
        dirs.append(sorted(os.listdir(tmp / "ckpt")))
        out[name] = {"dirs": dirs, "losses": _losses(tmp / "runs" / "char_lm.jsonl"),
                     "dir": tmp}
    return out


def test_trees_of_both_packages_give_the_same_losses(both_trees):
    port, jax_ = both_trees["port"]["losses"], both_trees["jax"]["losses"]
    # Epoch one (5 steps), then the resumed run: step 5 again (the save at
    # step 4 came before it) and epoch two.
    assert len(port) == len(jax_) == 2 * STEPS_PER_EPOCH + 1
    np.testing.assert_allclose(port, jax_, atol=1e-4, rtol=1e-4)
    assert port[-1] < port[0]


def test_keep_last_prunes_as_the_jax_checkpointer(both_trees):
    assert both_trees["port"]["dirs"] == both_trees["jax"]["dirs"] == [["2", "4"], ["10", "8"]]


def test_greedy_generate_from_a_jax_checkpoint_matches_jax(both_trees):
    ckpt = str(both_trees["jax"]["dir"] / "ckpt")
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    latest = JCheckpointer(output_dir=ckpt, resume_from="latest")._resolve_resume_path("latest")
    jparams = jio.load_pytree(os.path.join(latest, "model_0"),
                              {"params": jax.jit(jmodel.init)(jax.random.key(0))["params"]})
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    want = jt.generate(jmodel, {"params": jparams["params"], "state": {}}, prompt, 16,
                       temperature=0.0)
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    params = tgen.load_params(model, ckpt, device="cpu")
    got = tt.generate(model, params, prompt, 16, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- resume within the port -----------------------------------------------------


class _Recorded(TokenDataset):
    """Token windows that log the indices of every batch drawn."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.drawn = []

    def get_batch(self, indices):
        self.drawn.append([int(i) for i in indices])
        return super().get_batch(indices)


def _char_lm_run(root, num_epochs, resume_from=None):
    """``examples.char_lm.build``'s tree (shuffled Dataset, Checkpointer at
    every epoch end, jsonl Tracker) at the small size; its cwd is ``root``.
    Returns (losses, the final prepared state, the indices drawn)."""
    root.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        config = tt.TransformerConfig(**CFG)
        data = _Recorded(_tokens(), seq_len=T)
        # device_cache_bytes=0: the streaming loader, whose host reads this
        # test records. Its first read is the whole dataset, by which
        # Dataset(device_cache="auto") sizes it (the reference's rule).
        runtime = rt.Runtime(device="cpu", seed=0, device_cache_bytes=0)
        run = char_lm.build(data, config, batch_size=B, num_epochs=num_epochs, out_dir="ckpt",
                            runtime=runtime, resume_from=resume_from)
        model = run["model"]
        prepared = PreparedModule(model, {"params": model.init(
            torch.Generator().manual_seed(2), device="cpu")})
        runtime.models.add(model, prepared)
        run["launcher"].launch()
        return _losses("runs/char_lm.jsonl"), prepared.state, data.drawn
    finally:
        os.chdir(cwd)


def test_resume_from_latest_ends_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    """An uninterrupted two-epoch run, and a fresh tree resumed from that
    run's epoch-one checkpoint (the schedule spans the run's total steps,
    so the checkpoint must come from a two-epoch run) that trains the
    second epoch only."""
    whole, want, drawn_whole = _char_lm_run(tmp_path / "b", 2)
    assert sorted(os.listdir(tmp_path / "b" / "ckpt"), key=int) == ["5", "10"]
    shutil.copytree(tmp_path / "b" / "ckpt" / "5", tmp_path / "a" / "ckpt" / "5")
    resumed, state, drawn_resumed = _char_lm_run(tmp_path / "a", 2, resume_from="latest")
    assert len(whole) == 2 * STEPS_PER_EPOCH
    assert resumed == whole[STEPS_PER_EPOCH:]                       # each loss, bitwise
    everything = list(range(20))                                    # _tokens()'s windows
    assert drawn_whole[0] == drawn_resumed[0] == everything         # the sizing read
    assert drawn_resumed[1:] == drawn_whole[1 + STEPS_PER_EPOCH:]   # the same batches
    assert state["step"] == want["step"] == 2 * STEPS_PER_EPOCH
    assert state["base_key"] == want["base_key"]
    for p, q in zip(param_leaves(state["params"]), param_leaves(want["params"])):
        assert torch.equal(p, q)
    opt, opt_want = state["optimizer"], want["optimizer"]
    for p, q in zip(param_leaves(state["params"]), param_leaves(want["params"])):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt_want.state[q][key])


def test_overwrite_false_refuses_an_existing_step(tmp_path):
    model = tt.TransformerLM(tt.TransformerConfig(**CFG))
    runtime = rt.Runtime(device="cpu", seed=0)
    ckpt = rt.Checkpointer(output_dir=str(tmp_path), overwrite=False)
    ckpt.bind(runtime)
    runtime.models.add(model, PreparedModule(model, {"params": model.init(device="cpu"),
                                                     "step": 0, "base_key": 1}))
    ckpt.setup()
    ckpt.save(step=3)
    ckpt._writer.wait()
    with pytest.raises(RuntimeError, match="overwrite"):
        ckpt.save(step=3)
    ckpt.destroy()
    with open(tmp_path / "3" / "capsules.pkl", "rb") as f:
        assert pickle.load(f) == [{"iter_idx": 0, "saved_steps": [3]}]
    assert json.loads((tmp_path / "3" / "rng.json").read_text()) == {"seed": 0,
                                                                     "key_counter": 0}


def test_config_json_is_the_same_in_both_packages(tmp_path):
    jcfg = dataclasses.asdict(jt.TransformerConfig.char_lm(vocab_size=65, max_seq_len=256))
    tcfg = dataclasses.asdict(tt.TransformerConfig.char_lm(vocab_size=65, max_seq_len=256))
    assert json.dumps(tcfg) == json.dumps(jcfg)
    (tmp_path / "config.json").write_text(json.dumps(jcfg, indent=1))
    loaded = tt.TransformerConfig(**json.loads((tmp_path / "config.json").read_text()))
    assert loaded == tt.TransformerConfig.char_lm(vocab_size=65, max_seq_len=256)
    tt.TransformerLM(loaded)  # validates
    moe = tt.TransformerLM(dataclasses.replace(loaded, num_experts=4))  # MoE is ported
    assert moe.blocks[0].moe.num_experts == 4
    # The pipeline is ported: its config builds, and 1F1B without a pipe
    # axis raises as the reference's validate does.
    tt.TransformerLM(dataclasses.replace(loaded, pipeline_axis="pipe", scan_layers=True))
    with pytest.raises(ValueError, match="requires pipeline_axis"):
        tt.TransformerLM(dataclasses.replace(loaded, pipeline_schedule="1f1b"))
    tt.TransformerLM(dataclasses.replace(loaded, scan_layers=True, attention_impl="xla"))


# -- the Tracker --------------------------------------------------------------


def _script(capsule_cls):
    class Script(capsule_cls):
        """Publishes scripted scalars; the sync boundary every other step."""

        def __init__(self):
            super().__init__(priority=500)
            self.i = 0

        def launch(self, attrs=None):
            self.i += 1
            attrs.sync_gradients = self.i % 2 == 0
            attrs.tracker.scalars["loss"] = 1.0 / self.i
            attrs.tracker.scalars["lr"] = 0.5 * self.i

    return Script


def _tracker_lines(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in row.items() if k != "time"} for row in rows
            if not any(k.startswith(("obs/", "health/")) for k in row)]


def test_tracker_lines_equal_the_jax_trackers(tmp_path):
    jruntime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=0,
                        project_dir=str(tmp_path))
    jrt.Launcher([
        jrt.Looper([_script(jrt.Capsule)(), jrt.Tracker(project="p", config={"dim": 64},
                                                        directory=str(tmp_path / "jax"))],
                   tag="train", repeats=5, progress=False),
        jrt.Looper([_script(jrt.Capsule)(), jrt.Tracker(project="p",
                                                        directory=str(tmp_path / "jax"))],
                   tag="val", grad_enabled=False, repeats=2, progress=False),
    ], num_epochs=2, runtime=jruntime).launch()
    rt.Launcher([
        rt.Looper([_script(rt.Capsule)(), rt.Tracker(project="p", config={"dim": 64},
                                                     directory=str(tmp_path / "port"))],
                  tag="train", repeats=5, progress=False),
        rt.Looper([_script(rt.Capsule)(), rt.Tracker(project="p",
                                                     directory=str(tmp_path / "port"))],
                  tag="val", grad_enabled=False, repeats=2, progress=False),
    ], num_epochs=2, runtime=rt.Runtime(device="cpu")).launch()
    got = _tracker_lines(tmp_path / "port" / "p.jsonl")
    want = _tracker_lines(tmp_path / "jax" / "p.jsonl")
    assert got == want and len(got) > 8
    assert {"step": 0, "config/dim": 64} in got


def test_tracker_falls_back_to_jsonl_when_a_backend_cannot_import(tmp_path):
    def unavailable(project, directory):
        raise ImportError("no such package")

    rt.register_tracker_backend("unavailable", unavailable)
    rt.Launcher([rt.Looper([_script(rt.Capsule)(), rt.Tracker(
        backend="unavailable", project="p", directory=str(tmp_path))], repeats=2,
        progress=False)], runtime=rt.Runtime(device="cpu")).launch()
    assert _tracker_lines(tmp_path / "p.jsonl") == [{"step": 0, "train/loss": 0.5,
                                                     "train/lr": 1.0}]
    with pytest.raises(RuntimeError, match="unknown backend"):
        rt.Launcher([rt.Looper([rt.Tracker(backend="nope")], repeats=1, progress=False)],
                    runtime=rt.Runtime(device="cpu")).launch()


# -- the example end to end ---------------------------------------------------


def test_char_lm_main_then_generate_and_serve_from_its_checkpoint(tmp_path, monkeypatch,
                                                                  capsys):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "tinyshakespeare.txt").write_text(synthetic_corpus(3000))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROCKET_TPU_BLOCK_ATTN", "fused")
    run = char_lm.main(num_epochs=1, batch_size=4, seq_len=256, out_dir="ckpt", device="cpu")
    vocab = CharTokenizer(synthetic_corpus(3000)).vocab_size
    config = json.loads((tmp_path / "ckpt" / "config.json").read_text())
    assert config == dataclasses.asdict(tt.TransformerConfig.char_lm(vocab, 256))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "config.json"]
    assert len(_losses(tmp_path / "runs" / "char_lm.jsonl")) == run["total_steps"] == 2
    assert run["sample"].startswith("the ") and len(run["sample"]) == 4 + 64

    text = tgen.main(["--ckpt", "ckpt", "--device", "cpu", "--greedy", "--tokens", "12"])
    assert len(text) == len("the ") + 12
    assert "loaded params from ckpt/2" in capsys.readouterr().out
    assert serve_cli.main(["run", "--config", "charlm", "--checkpoint", "ckpt", "--device",
                           "cpu", "--requests", "2", "--max-new-tokens", "4", "--show", "0"]) == 0
    assert "loaded params from ckpt/2" in capsys.readouterr().out
    assert serve_cli.main(["run", "--config", "charlm", "--checkpoint", "nowhere", "--device",
                           "cpu", "--requests", "1", "--max-new-tokens", "2", "--show", "0"]) == 0
    assert "using random-init params" in capsys.readouterr().err

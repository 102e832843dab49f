"""The port's data stack (``rocket_tpu_torch/data``: collate, loader,
prefetch, workers, device cache) against the reference's, on the CPU.

Every comparison is exact: the batches are the same numpy draws, in the
same order, gathered or sliced without arithmetic (the bf16 cache casts
once, round-to-nearest-even in both packages).
"""

import jax
import numpy as np
import pytest
import torch

import rocket_tpu_torch as rt
from rocket_tpu.data.collate import default_collate as jcollate
from rocket_tpu.data.datasets import SyntheticMNIST as JSyntheticMNIST
from rocket_tpu.data.device_cache import DeviceCachedLoader as JDeviceCachedLoader
from rocket_tpu.data.device_cache import materialize_marker
from rocket_tpu.data.loader import DataLoader as JDataLoader
from rocket_tpu.runtime.context import Runtime as JRuntime
from rocket_tpu_torch.core import dataset as core_dataset
from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.data.collate import default_collate, default_move
from rocket_tpu_torch.data.datasets import ArrayDataset, SyntheticMNIST
from rocket_tpu_torch.data.device_cache import DeviceCachedLoader, pytree_nbytes
from rocket_tpu_torch.data.loader import DataLoader
from rocket_tpu_torch.data.prefetch import PrefetchIterator
from rocket_tpu_torch.data.workers import WorkerPool, default_start_method


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops under a tier-1 run that shares the CPU among workers: one
    intra-op thread each, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    """Equal structure (list vs array vs dict), types of containers and
    values, bitwise."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), type(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert type(got) is type(want) and list(got) == list(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert type(got) is type(want) and got == want


# -- default_collate: the fault of the parent's inline collate -----------------

_A, _B = np.arange(4.0).reshape(2, 2), -np.arange(4.0).reshape(2, 2)
COLLATE_CASES = {
    "strings": ["a", "b"],
    "tuples": [(_A, 1), (_A, 2)],
    "floats": [1.0, 2.0],
    "lists": [[_A, _B], [_B, _A]],
    "arrays": [_A, _B],
    "dicts": [{"x": _A, "y": 1, "s": "p"}, {"x": _B, "y": 2, "s": "q"}],
    "numpy_scalars": [np.int64(3), np.int64(4)],
    "nested": [{"pair": [np.float32(1), "u"]}, {"pair": [np.float32(2), "v"]}],
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_default_collate_matches_the_reference(case):
    samples = COLLATE_CASES[case]
    _same(default_collate(samples), jcollate(samples))
    # The name core.dataset.default_collate stays importable, the same function.
    assert core_dataset.default_collate is default_collate


def test_default_collate_stacks_tensors_and_refuses_no_samples():
    got = default_collate([torch.ones(3), torch.zeros(3)])
    assert isinstance(got, torch.Tensor) and got.shape == (2, 3)
    with pytest.raises(ValueError, match="no samples"):
        default_collate([])


def test_default_move_keeps_the_containers():
    moved = default_move({"x": np.zeros((2, 2), np.float32), "s": "keep", "n": 5,
                          "t": (np.ones(2), "y"), "l": [np.arange(3)]}, "cpu")
    assert isinstance(moved["x"], torch.Tensor) and moved["x"].dtype == torch.float32
    assert moved["s"] == "keep" and moved["n"] == 5
    assert isinstance(moved["t"], tuple) and isinstance(moved["t"][0], torch.Tensor)
    assert moved["t"][1] == "y" and isinstance(moved["l"][0], torch.Tensor)


# -- DataLoader ----------------------------------------------------------------


class _Rows:
    """Map-style: sample i is {"x": (3,) f32 of i, "i": int}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "i": int(i)}


class _Stream:
    """Iterable only: the same samples as _Rows, in order."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(_Rows(self.n)[i] for i in range(self.n))


def _rows(loader, epoch=0, skip=0):
    loader.set_epoch(epoch)
    loader.skip(skip)
    return [(b.data, b.size, b.index) for b in loader]


@pytest.mark.parametrize("n", [3, 10, 12])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_the_reference(n, shuffle, drop_last):
    for seed, epoch, skip in ((0, 0, 0), (1, 1, 0), (1, 1, 1), (2, 3, 2)):
        kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=seed)
        port, ref = DataLoader(_Rows(n), **kw), JDataLoader(_Rows(n), **kw)
        assert port.total == ref.total
        got, want = _rows(port, epoch, skip), _rows(ref, epoch, skip)
        assert len(got) == len(want)
        for (gd, gs, gi), (wd, ws, wi) in zip(got, want):
            _same(gd, wd)
            assert (gs, gi) == (ws, wi)


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_batches_match_the_reference(n, drop_last):
    for skip in (0, 1):
        port = DataLoader(_Stream(n), batch_size=3, drop_last=drop_last)
        ref = JDataLoader(_Stream(n), batch_size=3, drop_last=drop_last)
        assert port.total is None and ref.total is None
        got, want = _rows(port, skip=skip), _rows(ref, skip=skip)
        assert len(got) == len(want)
        for (gd, gs, gi), (wd, ws, wi) in zip(got, want):
            _same(gd, wd)
            assert (gs, gi) == (ws, wi)


def test_loader_refuses_other_processes_and_bad_datasets():
    # Other processes stripe a global batch that divides over them.
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(_Rows(4), batch_size=3, process_index=1, process_count=2)
    with pytest.raises(ValueError, match="not one of 2 processes"):
        DataLoader(_Rows(4), batch_size=2, process_index=2, process_count=2)
    with pytest.raises(TypeError):
        DataLoader(object())
    with pytest.raises(ValueError, match="map-style"):
        DataLoader(_Stream(4), num_workers=2)


# -- PrefetchIterator ----------------------------------------------------------


def test_prefetch_yields_the_same_sequence_and_reraises():
    assert list(PrefetchIterator(range(20), depth=3)) == list(range(20))

    def failing():
        yield 1
        raise KeyError("boom")

    it = PrefetchIterator(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_close_stops_the_thread_early():
    it = PrefetchIterator(iter(range(10**6)), depth=2)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=10)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(ValueError):
        PrefetchIterator(range(3), depth=0)


# -- WorkerPool ----------------------------------------------------------------


def test_workers_give_the_serial_batches_in_order():
    """Two forkserver (or spawn) workers reading per-sample SyntheticMNIST
    batches, shuffled with a wrap-filled last batch, over two epochs."""
    assert default_start_method() in ("forkserver", "spawn")
    data = SyntheticMNIST(num_samples=30)
    pooled = DataLoader(data, batch_size=8, shuffle=True, seed=3, num_workers=2)
    serial = DataLoader(data, batch_size=8, shuffle=True, seed=3)
    try:
        for epoch in (0, 1):
            got, want = _rows(pooled, epoch), _rows(serial, epoch)
            assert [(s, i) for _, s, i in got] == [(s, i) for _, s, i in want] == [
                (8, 0), (8, 1), (8, 2), (6, 3)]
            for (gd, _, _), (wd, _, _) in zip(got, want):
                _same(gd, wd)
        assert isinstance(pooled._pool, WorkerPool)
        assert pooled._pool.start_method == default_start_method()
    finally:
        pooled.close()
    assert pooled._pool is None


# -- DeviceCachedLoader ----------------------------------------------------------


def _cache_data(n=10):
    rng = np.random.default_rng(4)
    return {"image": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _jax_cache_rows(tmp_path, data, dtype=None, epoch=0, skip=0, **kw):
    runtime = JRuntime(mesh_shape={"data": 1}, devices=jax.devices()[:1], seed=kw.pop("seed"),
                       project_dir=str(tmp_path))
    loader = JDeviceCachedLoader(data, runtime=runtime, seed=runtime.seed, cache_dtype=dtype,
                                 **kw)
    loader.set_epoch(epoch)
    loader.skip(skip)
    out = []
    for b in loader:
        rows = materialize_marker(b.data)
        out.append(({k: np.asarray(v.astype("float32") if k == "image" else v)
                     for k, v in rows.items()}, b.size, b.index))
    return out


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_device_cache_rows_match_the_reference(tmp_path, shuffle, drop_last, bf16):
    data = _cache_data()
    for seed, epoch, skip in ((0, 0, 0), (5, 2, 1)):
        kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=seed)
        port = DeviceCachedLoader(data, device="cpu", cache_dtype=torch.bfloat16 if bf16 else None,
                                  **kw)
        port.set_epoch(epoch)
        port.skip(skip)
        got = [({k: (v.float() if k == "image" else v).numpy() for k, v in b.data.items()},
                b.size, b.index) for b in port]
        want = _jax_cache_rows(tmp_path, data, "bfloat16" if bf16 else None, epoch, skip, **kw)
        assert len(got) == len(want) == port.total - skip
        for (gd, gs, gi), (wd, ws, wi) in zip(got, want):
            _same(gd, wd)
            assert (gs, gi) == (ws, wi)
        assert port.cache["image"].dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert port.cache["label"].dtype == torch.int32


def test_device_cache_rows_equal_the_streaming_loader():
    data = _cache_data(11)
    for shuffle in (False, True):
        cached = DeviceCachedLoader(data, batch_size=4, device="cpu", shuffle=shuffle, seed=9)
        stream = DataLoader(ArrayDataset(data["image"], data["label"]), batch_size=4,
                            shuffle=shuffle, seed=9)
        for epoch in (0, 1):
            got, want = _rows(cached, epoch), _rows(stream, epoch)
            assert [(s, i) for _, s, i in got] == [(s, i) for _, s, i in want]
            for (gd, _, _), (wd, _, _) in zip(got, want):
                _same({k: v.numpy() for k, v in gd.items()}, wd)
    assert pytree_nbytes(data) == 11 * 6 * 4 + 11 * 4
    assert pytree_nbytes(cached.cache) == pytree_nbytes(data)


def test_one_upload_is_shared_by_the_train_and_val_loaders():
    """A train (shuffled) and a val (sequential) Dataset over one raw
    dataset: two loaders, one device-resident copy."""
    raw = ArrayDataset(*_cache_data(12).values())
    runtime = rt.Runtime(device="cpu", seed=0)
    train = rt.Dataset(raw, batch_size=4, shuffle=True, drop_last=True, statefull=False,
                       runtime=runtime)
    val = rt.Dataset(raw, batch_size=6, statefull=False, runtime=runtime)
    train.setup()
    val.setup()
    assert train.device_resident and val.device_resident
    assert train._dataloader is not val._dataloader
    assert len(runtime.device_cache_store) == 1
    for key in ("image", "label"):
        assert train._dataloader.cache[key] is val._dataloader.cache[key]
    val.set(Attributes(mode="eval"))
    attrs = Attributes(looper=Attributes())
    val.launch(attrs)
    np.testing.assert_array_equal(attrs.batch["label"].numpy(),
                                  raw.get_batch(np.arange(6))["label"])
    train.destroy()
    val.destroy()
    assert len(runtime.dataloaders) == 0


def test_loaders_close_after_the_last_epoch_and_stores_differ_by_dtype():
    raw = [{"x": np.full((4,), float(i), np.float32), "y": np.int32(i)} for i in range(8)]
    runtime = rt.Runtime(device="cpu")
    half = rt.Dataset(raw, batch_size=4, cache_dtype="bfloat16", statefull=False,
                      runtime=runtime)
    full = rt.Dataset(raw, batch_size=4, statefull=False, runtime=runtime)
    half.setup()
    full.setup()
    assert half._dataloader.cache["x"].dtype == torch.bfloat16
    assert half._dataloader.cache["y"].dtype == torch.int32
    assert full._dataloader.cache["x"].dtype == torch.float32
    assert len(runtime.device_cache_store) == 2
    with pytest.raises(ValueError, match="cache_dtype"):
        rt.Dataset(raw, cache_dtype="not_a_dtype")

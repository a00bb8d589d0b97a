"""The port's input-pipeline adapters (flowgen_torch/pipeline/adapters.py),
the cases of tests/test_adapters.py on the CPU: Grain-style random access
equals the sequential stream, the torch IterableDataset under a DataLoader
with 0 and 2 spawned workers yields every step once and in order,
caffe-style tops, the numpy and torch iterators, and the tf.data gate.
Batches are compared bit for bit."""

import importlib.util
import itertools

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import flowgen_torch
from flowgen_torch.pipeline import adapters

torch.set_num_threads(1)

W, H = 128, 96


def _cfg(**kw):
    kw.setdefault("mode", 1)
    kw.setdefault("batch_size", 2)
    kw.setdefault("width", W)
    kw.setdefault("height", H)
    kw.setdefault("seed", 5)
    return flowgen_torch.DataGenConfig(**kw)


@pytest.fixture(scope="module")
def atlas():
    return flowgen_torch.procedural_atlas(3, height=H, width=W)


@pytest.fixture(scope="module")
def stream_ref(atlas):
    """First three batches off the sequential Generator stream."""
    gen = flowgen_torch.Generator(_cfg(), atlas=atlas, as_numpy=True,
                                  device="cpu").start()
    batches = [gen.retrieve_batch() for _ in range(3)]
    gen.stop()
    return batches


def test_datasource_random_access_matches_stream(atlas, stream_ref):
    src = adapters.FlowStepDataSource(_cfg(), num_steps=3, atlas=atlas,
                                      device="cpu")
    assert len(src) == 3
    for i in (2, 0, 1):
        got = src[i]
        assert set(got) == set(stream_ref[i])
        for k in got:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], stream_ref[i][k])
    with pytest.raises(IndexError):
        src[3]
    np.testing.assert_array_equal(src[-1]["flow0"], stream_ref[2]["flow0"])
    with pytest.raises(ValueError):
        adapters.FlowStepDataSource(_cfg(), num_steps=0)


def test_datasource_start_step_offset(atlas, stream_ref):
    src = adapters.FlowStepDataSource(_cfg(), num_steps=2, atlas=atlas,
                                      start_step=1, device="cpu")
    np.testing.assert_array_equal(src[0]["image0"], stream_ref[1]["image0"])


def test_worker_steps_partition():
    seen = sorted(
        itertools.chain.from_iterable(
            itertools.islice(adapters._worker_steps(10, w, 3), 4)
            for w in range(3)
        )
    )
    assert seen == list(range(10, 22))
    assert list(itertools.islice(adapters._worker_steps(0, 0, 1), 3)) == [0, 1, 2]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_torch_iterable_dataset(atlas, stream_ref, num_workers):
    """Workers are spawned, as a source on the card needs (and as a process
    that holds other libraries' threads should)."""
    ds = adapters.torch_iterable_dataset(_cfg(), atlas=atlas, device="cpu")
    ctx = "spawn" if num_workers else None
    loader = DataLoader(ds, batch_size=None, num_workers=num_workers,
                        multiprocessing_context=ctx)
    it = iter(loader)
    for i in range(3):
        batch = next(it)
        assert isinstance(batch["image0"], torch.Tensor)
        for k in stream_ref[i]:
            np.testing.assert_array_equal(batch[k].numpy(), stream_ref[i][k])
    del it


def test_caffe_style_tops(stream_ref):
    i0, i1, f0 = adapters.caffe_style_tops(stream_ref[0])
    assert i0.shape == i1.shape == (2, H, W, 3)
    assert f0.shape == (2, H, W, 2)


def test_numpy_and_torch_iterators(atlas, stream_ref):
    gen = flowgen_torch.Generator(_cfg(), atlas=atlas, device="cpu")
    batch = next(adapters.as_numpy_iterator(gen))
    assert isinstance(batch["image0"], np.ndarray)
    np.testing.assert_array_equal(batch["flow0"], stream_ref[0]["flow0"])
    tbatch = next(adapters.as_torch_iterator(gen))
    assert tbatch["image0"].device == gen.device
    np.testing.assert_array_equal(tbatch["image0"].numpy(),
                                  stream_ref[1]["image0"])
    gen.stop()


def test_as_tfdata_gated(atlas, stream_ref):
    """Without tensorflow, ImportError; with it, the stream's batches."""
    if importlib.util.find_spec("tensorflow") is None:
        with pytest.raises(ImportError):
            adapters.as_tfdata(_cfg(), atlas=atlas, device="cpu")
        return
    ds = adapters.as_tfdata(_cfg(), atlas=atlas, start_step=1, device="cpu")
    batch = next(iter(ds.take(1)))
    assert batch["image0"].shape == (2, H, W, 3)
    np.testing.assert_array_equal(batch["flow0"].numpy(),
                                  stream_ref[1]["flow0"])

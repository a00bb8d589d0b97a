"""Framework adapters for consuming the generated stream (port of
``flowgen/pipeline/adapters.py``).

* :func:`as_numpy_iterator` / :func:`as_torch_iterator`: plain iterators
  over a ``Generator``.
* :class:`FlowStepDataSource`: a Grain-protocol random-access source
  (``__len__`` + ``__getitem__``). Every batch is a pure function of
  ``(seed, step)``, so random access is exact.
* :func:`torch_iterable_dataset`: a ``torch.utils.data.IterableDataset``
  whose workers stride the step counter, so ``DataLoader(ds,
  batch_size=None, num_workers=N)`` yields every step exactly once for any
  N.
* :func:`as_tfdata`: a ``tf.data.Dataset`` wrapper, gated on tensorflow
  being importable (it is not a dependency).

Every adapter emits whole generated batches; ``batch_size=None`` in a
``DataLoader`` keeps them whole.

CUDA cannot be initialized in a forked process once its parent has used
it. A ``DataLoader`` with ``num_workers > 0`` over a source on the card
therefore needs ``multiprocessing_context="spawn"``; a forked worker raises
a ``RuntimeError`` that says so. Generating on the card, ``num_workers=0``
is the usual choice: the generator already keeps steps in flight.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils import data as torch_data

from ..config import DataGenConfig
from .generator import Generator, make_generate_fn, resolve_device


def _numpy(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def as_numpy_iterator(gen: Generator) -> Iterator[dict]:
    """Yield batches as host numpy dicts."""
    gen.start()
    while True:
        yield {k: _numpy(v) for k, v in gen.retrieve_batch().items()}


def as_torch_iterator(gen: Generator, device=None) -> Iterator[dict]:
    """Yield batches as torch tensors on ``device`` (default the
    generator's): the generator's own tensors when that is where they
    already are, with no host round trip; a copy otherwise. Images float32
    0..255, flow float32 pixels, layout per ``cfg.layout``."""
    dev = gen.device if device is None else torch.device(device)
    gen.start()
    while True:
        yield {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(dev)
               for k, v in gen.retrieve_batch().items()}


def caffe_style_tops(batch):
    """Split a batch dict into the reference layer's three tops in order:
    (first-image, second-image, optical-flow-groundtruth)
    (train.prototxt:5-7)."""
    return batch["image0"], batch["image1"], batch["flow0"]


def _check_not_forked(device: torch.device):
    if device.type == "cuda" and torch.cuda._is_in_bad_fork():
        raise RuntimeError(
            "flowgen_torch: this DataLoader worker was forked from a process "
            "that had initialized CUDA, and CUDA cannot run in it; pass "
            "multiprocessing_context='spawn' to the DataLoader, or use "
            "num_workers=0")


class FlowStepDataSource:
    """Grain-style random-access data source over the deterministic stream.

    Implements the ``grain.RandomAccessDataSource`` protocol (``__len__`` /
    ``__getitem__``) without importing grain: item ``i`` is the full batch
    of step ``start_step + i`` as a numpy dict, recomputable in any order
    from ``(cfg.seed, step)`` alone. ``num_steps`` only bounds
    ``__len__`` (the stream itself is unbounded). The generating function
    is built on first use, in the process that uses it; ``device`` as for
    every entry point (default ``cuda``)."""

    def __init__(self, cfg: DataGenConfig, num_steps: int,
                 atlas: Optional[np.ndarray] = None, start_step: int = 0,
                 device=None):
        if num_steps <= 0:
            raise ValueError("num_steps must be positive")
        self._cfg = cfg
        self._atlas = atlas
        self._start = start_step
        self._n = num_steps
        self._device = device
        self._fn = None

    def _tensors(self, step: int) -> dict:
        """The batch of ``step`` as the generator's tensors."""
        if self._fn is None:
            from .. import texture_io
            from ..random.streams import root_key

            dev = resolve_device(self._device)
            _check_not_forked(dev)
            if self._atlas is None:
                self._atlas = texture_io.atlas_for_config(self._cfg)
            self._fn = make_generate_fn(self._cfg, dev)
            self._root = root_key(self._cfg.seed, dev)
        return self._fn(self._root, int(step), self._atlas)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict:
        if not (-self._n <= i < self._n):
            raise IndexError(i)
        out = self._tensors(self._start + (i % self._n))
        return {k: _numpy(v) for k, v in out.items()}


def _worker_steps(start_step: int, worker_id: int, num_workers: int
                  ) -> Iterator[int]:
    """Unbounded step schedule for one worker: steps are strided so the union
    over workers enumerates every step exactly once regardless of N."""
    step = start_step + worker_id
    stride = max(1, num_workers)
    while True:
        yield step
        step += stride


class FlowIterableDataset(torch_data.IterableDataset):
    """The stream as a ``torch.utils.data.IterableDataset``: one item is one
    generated batch, as tensors on the generating device. Worker ``w`` of
    ``N`` generates steps ``start_step + w, + w + N, ...``. Defined at
    module level so that spawned workers can unpickle it."""

    def __init__(self, cfg: DataGenConfig, atlas=None, start_step: int = 0,
                 device=None):
        self.cfg = cfg
        self.atlas = atlas
        self.start_step = start_step
        self.device = device

    def __iter__(self):
        source = FlowStepDataSource(self.cfg, num_steps=1, atlas=self.atlas,
                                    device=self.device)
        info = torch_data.get_worker_info()
        wid = info.id if info is not None else 0
        nw = info.num_workers if info is not None else 1
        for step in _worker_steps(self.start_step, wid, nw):
            yield source._tensors(step)


def torch_iterable_dataset(cfg: DataGenConfig,
                           atlas: Optional[np.ndarray] = None,
                           start_step: int = 0, device=None):
    """``torch.utils.data.IterableDataset`` over the stream (one item = one
    generated batch of ``cfg.batch_size``; use ``DataLoader(ds,
    batch_size=None)``). Under ``num_workers=N`` each worker generates a
    strided slice of the step counter (worker w: steps w, w+N, ...), so the
    loader's interleaved output covers each step exactly once. On the card
    (the default ``device``) use ``num_workers=0``, or
    ``multiprocessing_context="spawn"`` with workers."""
    return FlowIterableDataset(cfg, atlas, start_step, device)


def as_tfdata(cfg: DataGenConfig, atlas: Optional[np.ndarray] = None,
              start_step: int = 0, device=None):
    """``tf.data.Dataset`` of numpy batch dicts via ``from_generator``,
    generated on ``device`` (default ``cuda``). Requires tensorflow (not a
    dependency); raises ImportError otherwise."""
    import tensorflow as tf  # noqa: F401 — optional consumer dependency

    source = FlowStepDataSource(cfg, num_steps=1, atlas=atlas, device=device)
    probe = {k: _numpy(v) for k, v in source._tensors(start_step).items()}
    spec = {
        k: tf.TensorSpec(shape=v.shape, dtype=v.dtype) for k, v in probe.items()
    }

    def gen():
        step = start_step
        while True:
            yield {k: _numpy(v) for k, v in source._tensors(step).items()}
            step += 1

    return tf.data.Dataset.from_generator(gen, output_signature=spec)

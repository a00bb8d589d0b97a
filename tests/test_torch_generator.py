"""The port's streaming runtime on the CPU: ``Generator`` yields exactly the
batches ``generate_batch`` makes for the same (seed, step), keeps
``prefetch`` steps in flight, and its step counter, ``seek``, pause and
resume keep the stream exact. The port alone: the JAX package's runtime is
held against it through ``generate_batch`` in ``test_torch_fused.py``."""

import numpy as np
import pytest
import torch

import flowgen_torch
from flowgen_torch.pipeline.generator import Generator, generate_batch

torch.set_num_threads(1)

W, H, B, SEED = 128, 96, 2, 4


@pytest.fixture(scope="module")
def setup():
    cfg = flowgen_torch.DataGenConfig(mode=7, batch_size=B, width=W, height=H,
                                      seed=SEED)
    atlas = flowgen_torch.procedural_atlas(3, height=H, width=W)
    ref = {s: generate_batch(SEED, s, atlas, cfg, device="cpu") for s in (0, 1, 2)}
    return cfg, atlas, ref


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(torch.as_tensor(a[k]), b[k], rtol=0, atol=0)


def test_generator_stream_matches_generate_batch(setup):
    cfg, atlas, ref = setup
    gen = Generator(cfg, atlas=atlas, start_step=1, device="cpu")
    _equal(gen.retrieve_batch(), ref[1])
    assert gen.has_retrievable_batches()
    assert gen.step == 1 + 1 + cfg.prefetch   # dispatched, in flight included
    _equal(next(gen), ref[2])
    gen.seek(0)
    _equal(gen.retrieve_batch(), ref[0])
    gen.stop()
    assert not gen.has_retrievable_batches()


def test_generator_pause_resume_and_numpy(setup):
    cfg, atlas, ref = setup
    gen = Generator(cfg, atlas=atlas, as_numpy=True, device="cpu")
    gen.pause().start()
    assert not gen.has_retrievable_batches()   # paused: nothing dispatched
    assert gen.step == 0
    gen.resume()
    assert gen.step == cfg.prefetch
    out = gen.retrieve_batch()
    assert all(isinstance(v, np.ndarray) for v in out.values())
    _equal(out, ref[0])
    gen.stop()

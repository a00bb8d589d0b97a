"""The port's FlowNetS trainer (flowgen_torch/train/) against the JAX
package's flax model on the CPU: the forward pass on weights carried by
``interop.flownet_params_from_flax`` (64x128, width 4), the resizes of the
multiscale objective, the gradient and one Adam step against optax's, the
loss falling over 16 fused generate-and-train steps on one batch (as
tests/test_train.py), and a checkpoint round trip that resumes the stream.

Tolerances: the forward pass and the resizes differ from XLA:CPU's only by
float32 summation order, held to |d| <= 1e-5 + 1e-4 |want|; gradients,
whose sums are longer, to |d| <= 1e-4 max|grad| + 1e-3 |want|; the
parameters after one Adam step from the same gradient (a step of about
the learning rate on each) to |d| <= 1e-5 lr + 2^-22 |want|: the
update's own rounding, and two ulps of the parameter it is added to."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flowgen_torch
from flowgen.train import flownet as jfn
from flowgen_torch.interop import flownet_params_from_flax
from flowgen_torch.train import checkpoints
from flowgen_torch.train import flownet as tfn

torch.set_num_threads(1)

H, W = 64, 128


@pytest.fixture(scope="module")
def models():
    jm = jfn.create_model(width=4)
    params = jfn.init_params(jm, jax.random.key(0), H, W)
    tm = tfn.create_model(width=4)
    tm.load_state_dict(flownet_params_from_flax(jax.tree.map(np.asarray,
                                                             params)))
    return jm, params, tm


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {
        "image0": rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
        "image1": rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
        "flow0": rng.normal(0, 4, (b, H, W, 2)).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_matches_flax(models):
    jm, params, tm = models
    batch = _batch()
    want = jm.apply({"params": params}, jfn.preprocess(batch))
    with torch.no_grad():
        got = tm(tfn.preprocess(_t(batch)))
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (2, 2) + w.shape[1:3]
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-5)
    assert float(np.abs(np.asarray(want[0])).max()) > 1e-3


@pytest.mark.parametrize("factor", [2, 4, 8, 16, 32, 64])
def test_resizes_match_jax(factor):
    rng = np.random.default_rng(factor)
    flow = rng.normal(0, 5, (2, 384, 512, 2)).astype(np.float32)
    tflow = torch.from_numpy(flow).permute(0, 3, 1, 2)
    if factor == 2:
        small = flow[:, ::32, ::32]
        want = jfn._upflow(jnp.asarray(small))
        got = tfn._upflow(torch.from_numpy(small.copy()).permute(0, 3, 1, 2))
    else:
        want = jfn._downsample_flow(jnp.asarray(flow), factor)
        got = tfn._downsample_flow(tflow, factor)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)


def test_loss_grad_and_adam_step_match_optax(models):
    jm, params, _ = models
    tm = tfn.create_model(width=4)
    tm.load_state_dict(flownet_params_from_flax(jax.tree.map(np.asarray,
                                                             params)))
    batch = _batch(1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jfn.loss_fn(jm, p, batch))(params)
    loss = tfn.loss_fn(tm, _t(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want_g = flownet_params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max())

    # One Adam step from the same gradient on both sides.
    lr = 1e-3
    tx = optax.adam(lr)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want_p = flownet_params_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates)))
    opt = tfn.make_optimizer(tm, lr)
    for name, p in tm.named_parameters():
        p.grad = want_g[name].clone()
    opt.step()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=2.0**-22, atol=1e-5 * lr)


def test_fused_generate_and_train_step_decreases_loss():
    cfg = flowgen_torch.DataGenConfig(mode=1, batch_size=2, width=W, height=H,
                                      seed=0)
    atlas = flowgen_torch.procedural_atlas(2, height=H, width=W)
    torch.manual_seed(0)
    model = tfn.create_model(width=4)
    opt = tfn.make_optimizer(model, 1e-3)
    fused = tfn.make_generate_and_train_step(cfg, model, opt, device="cpu")
    root = flowgen_torch.pipeline.generator.root_key(0)
    losses = [float(fused(root, 0, atlas)) for _ in range(16)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_checkpoint_round_trip_resumes_the_stream(tmp_path):
    cfg = flowgen_torch.DataGenConfig(mode=1, batch_size=1, width=W, height=H,
                                      seed=3)
    atlas = flowgen_torch.procedural_atlas(2, height=H, width=W)
    torch.manual_seed(1)
    model = tfn.create_model(width=4)
    opt = tfn.make_optimizer(model, 1e-3)
    step = tfn.make_train_step(model, opt)
    gen = flowgen_torch.Generator(cfg, atlas=atlas, device="cpu")
    for _ in range(8):
        step(gen.retrieve_batch())
    ckdir = str(tmp_path / "ck")
    checkpoints.save_checkpoint(ckdir, 4, model, opt)
    checkpoints.save_checkpoint(ckdir, 8, model, opt)   # 8 batches consumed
    restored = checkpoints.restore_checkpoint(ckdir)
    assert restored["step"] == 8
    assert checkpoints.restore_checkpoint(ckdir, 4)["step"] == 4

    model2 = tfn.create_model(width=4)
    model2.load_state_dict(restored["model"])
    opt2 = tfn.make_optimizer(model2, 1e-3)
    opt2.load_state_dict(restored["optimizer"])
    gen2 = flowgen_torch.Generator(cfg, atlas=atlas, device="cpu",
                                   start_step=restored["step"])
    a, b = gen.retrieve_batch(), gen2.retrieve_batch()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    step(a)
    tfn.make_train_step(model2, opt2)(b)
    for (n, p), q in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    gen.stop()
    gen2.stop()
    with pytest.raises(FileNotFoundError):
        checkpoints.restore_checkpoint(str(tmp_path))

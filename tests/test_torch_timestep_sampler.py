"""The port's timestep samplers (``diffsheg_tpu_torch/diffusion/
timestep_sampler.py``) against the JAX package's: the loss history's
update and the sampling distribution bit for bit, the draws by their
contract (torch cannot replay JAX's key chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffsheg_tpu.diffusion import timestep_sampler as js
from diffsheg_tpu_torch.diffusion import timestep_sampler as ts

N_STEPS, K = 20, 4


def both_states():
    return js.LossAwareState.create(N_STEPS, K), ts.LossAwareState.create(
        N_STEPS, K)


def update_both(jstate, tstate, t, losses):
    jstate = js.update_loss_history(jstate, jnp.asarray(t),
                                    jnp.asarray(losses))
    tstate = ts.update_loss_history(tstate, torch.from_numpy(t),
                                    torch.from_numpy(losses))
    return jstate, tstate


def assert_same(jstate, tstate):
    np.testing.assert_array_equal(tstate.history.numpy(),
                                  np.asarray(jstate.history))
    np.testing.assert_array_equal(tstate.counts.numpy(),
                                  np.asarray(jstate.counts))


def test_update_loss_history_fifo_with_repeats():
    """A timestep drawn several times in one batch shifts once per draw,
    in batch order, before and after its row is full."""
    rs = np.random.RandomState(0)
    jstate, tstate = both_states()
    # timestep 3 six times in one batch: fills past K and shifts twice
    t = np.array([3, 5, 3, 3, 7, 3, 3, 3], np.int32)
    jstate, tstate = update_both(jstate, tstate, t,
                                 rs.rand(8).astype(np.float32))
    assert_same(jstate, tstate)
    assert int(tstate.counts[3]) == K
    for _ in range(6):
        t = rs.randint(0, N_STEPS, 16).astype(np.int32)
        jstate, tstate = update_both(jstate, tstate, t,
                                     rs.rand(16).astype(np.float32))
        assert_same(jstate, tstate)


def test_loss_aware_weights_cold_and_warm():
    rs = np.random.RandomState(1)
    jstate, tstate = both_states()
    # cold: uniform
    np.testing.assert_array_equal(ts.loss_aware_weights(tstate).numpy(),
                                  np.asarray(js.loss_aware_weights(jstate)))
    assert not bool(tstate.warmed_up)
    while not bool(tstate.warmed_up):
        t = np.tile(np.arange(N_STEPS, dtype=np.int32), 2)
        jstate, tstate = update_both(jstate, tstate, t,
                                     rs.rand(2 * N_STEPS).astype(np.float32))
    assert bool(jstate.warmed_up)
    for prob in (0.001, 0.25):
        ref = np.asarray(js.loss_aware_weights(jstate, prob))
        got = ts.loss_aware_weights(tstate, prob).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
        assert abs(got.sum() - 1.0) < 1e-5


def test_draws_follow_the_contract():
    gen = torch.Generator().manual_seed(0)
    t, w = ts.sample_uniform(gen, 4096, N_STEPS)
    assert t.min() >= 0 and t.max() < N_STEPS and (w == 1).all()
    jt, jw = js.sample_uniform(jax.random.PRNGKey(0), 4096, N_STEPS)
    assert jt.shape == t.shape and jw.shape == w.shape
    # warm, one timestep carrying all the loss: it is drawn almost always,
    # and each weight is 1 / (T p(t))
    _, tstate = both_states()
    hist = torch.zeros(N_STEPS, K)
    hist[5] = 10.0
    tstate = ts.LossAwareState(hist, torch.full((N_STEPS,), K,
                                                dtype=torch.int32))
    t, w = ts.sample_loss_aware(gen, 4096, tstate)
    p = ts.loss_aware_weights(tstate)
    assert (t == 5).float().mean() > 0.99
    torch.testing.assert_close(w, 1.0 / (N_STEPS * p[t]))
    # the same generator state draws the same timesteps
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(ts.sample_loss_aware(g1, 64, tstate)[0],
                       ts.sample_loss_aware(g2, 64, tstate)[0])

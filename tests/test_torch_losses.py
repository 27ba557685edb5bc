"""The port's training losses (``diffsheg_tpu_torch/diffusion/losses.py``)
and ``q_sample`` against the JAX package's, on the same seeded inputs:
every term within rel 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsheg_tpu.config import TrainConfig as JTrain
from diffsheg_tpu.diffusion import losses as jl
from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule as jbetas
from diffsheg_tpu.diffusion.schedule import make_schedule as jmake
from diffsheg_tpu_torch.config import TrainConfig as TTrain
from diffsheg_tpu_torch.diffusion import losses as tl
from diffsheg_tpu_torch.diffusion.schedule import (get_named_beta_schedule,
                                                   make_schedule)

B, T, C = 4, 8, 12
TOL = 1e-6


def inputs(seed, mean_type="epsilon"):
    """A batch at the scales training feeds the loss: x0 in [-1, 1] (two
    entries on the bin edges), x_t drawn from q(x_t | x_0), the model's
    prediction near the truth (the noise, or x0 for ``start_x``), a raw
    variance in [-1, 1).  Far from the truth the t = 0 term's bin
    probability is a difference of two CDFs that cancel to their last
    bits, where float32 tanh implementations differ (see
    ``test_torch_ancestral.py``)."""
    rs = np.random.RandomState(seed)
    sched = make_schedule(get_named_beta_schedule("linear", 1000))
    t = rs.randint(0, 1000, B).astype(np.int32)
    t[0] = 0                        # the decoder-NLL row of the VLB
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    x0 = np.clip(0.6 * f(B, T, C), -1, 1)
    x0[0, 0, :2] = (-1.0, 1.0)
    noise = f(B, T, C)
    x_t = sched.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                         torch.from_numpy(noise)).numpy()
    # an x0 prediction within the t = 0 posterior's std (~0.01) of x0
    pred = (x0 + 5e-4 * f(B, T, C) if mean_type == "start_x"
            else noise + 0.05 * f(B, T, C))
    return dict(
        model_out=pred, x_start=x0, x_t=x_t, t=t,
        noise=noise, src_mask=(rs.rand(B, T) > 0.2).astype(np.float32),
        sem_score=rs.rand(B, T).astype(np.float32),
        t_weights=(0.5 + rs.rand(B)).astype(np.float32),
        var_out=rs.uniform(-1, 1, (B, T, C)).astype(np.float32))


CASES = {
    "mse-sem": dict(),
    "mse-no-sem": dict(train=dict(use_sem_weighting=False)),
    "mse-vel-gated": dict(vel_loss_active=False),
    "mse-mask-weights": dict(use=("src_mask", "t_weights")),
    "rescaled-mse-learned-range": dict(train=dict(loss_type="rescaled_mse"),
                                       use=("var_out",)),
    "mse-learned-weights": dict(use=("var_out", "t_weights")),
    "mse-learned-start-x": dict(use=("var_out",), mean_type="start_x"),
    "mse-learned-var": dict(use=("var_out",), var_type="learned"),
    "kl-fixed-small": dict(train=dict(loss_type="kl"),
                           var_type="fixed_small"),
    "kl-fixed-large": dict(train=dict(loss_type="kl"),
                           var_type="fixed_large"),
    "rescaled-kl-learned": dict(train=dict(loss_type="rescaled_kl"),
                                use=("var_out", "t_weights")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diffusion_loss_matches_jax(case):
    spec = CASES[case]
    x = inputs(sorted(CASES).index(case), spec.get("mean_type", "epsilon"))
    jsched, tsched = (jmake(jbetas("linear", 1000)),
                      make_schedule(get_named_beta_schedule("linear", 1000)))
    jcfg = dataclasses.replace(JTrain(), **spec.get("train", {}))
    tcfg = dataclasses.replace(TTrain(), **spec.get("train", {}))
    opt = {k: x[k] for k in spec.get("use", ())}
    kw = dict(vel_loss_active=spec.get("vel_loss_active", True),
              var_type=spec.get("var_type", "learned_range"),
              mean_type=spec.get("mean_type", "epsilon"))
    core = ("model_out", "x_start", "x_t", "t", "noise")
    ref = jl.diffusion_loss(jsched, *(jnp.asarray(x[k]) for k in core), jcfg,
                            sem_score=jnp.asarray(x["sem_score"]),
                            **{k: jnp.asarray(v) for k, v in opt.items()},
                            **kw)
    got = tl.diffusion_loss(tsched, *(torch.from_numpy(x[k]) for k in core),
                            tcfg, sem_score=torch.from_numpy(x["sem_score"]),
                            **{k: torch.from_numpy(v) for k, v in opt.items()},
                            **kw)
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        b = float(b)
        assert abs(float(a) - b) <= TOL * max(abs(b), 1e-30), (name, a, b)
    assert np.isfinite(float(got.total)) and float(got.total) != 0.0


def test_huber_and_masked_time_mean_match_jax():
    x = inputs(40)
    p, q, w = x["model_out"], x["x_start"], x["t_weights"]
    for beta in (0.1, 1.0):
        for weights in (None, w):
            ref = float(jl.huber(jnp.asarray(p), jnp.asarray(q), beta,
                                 None if weights is None else
                                 jnp.asarray(weights)))
            got = float(tl.huber(torch.from_numpy(p), torch.from_numpy(q),
                                 beta, None if weights is None else
                                 torch.from_numpy(weights)))
            assert got == pytest.approx(ref, rel=TOL)
    per_frame, mask = x["sem_score"], x["src_mask"]
    ref = float(jl.masked_time_mean(jnp.asarray(per_frame),
                                    jnp.asarray(mask)))
    got = float(tl.masked_time_mean(torch.from_numpy(per_frame),
                                    torch.from_numpy(mask)))
    assert got == pytest.approx(ref, rel=TOL)
    # an all-invalid mask divides by 1, not 0
    assert float(tl.masked_time_mean(torch.ones(2, 3),
                                     torch.zeros(2, 3))) == 0.0


def test_q_sample_matches_jax():
    x = inputs(41)
    jsched = jmake(jbetas("cosine", 1000))
    tsched = make_schedule(get_named_beta_schedule("cosine", 1000))
    ref = np.asarray(jsched.q_sample(jnp.asarray(x["x_start"]),
                                     jnp.asarray(x["t"]),
                                     jnp.asarray(x["noise"])))
    got = tsched.q_sample(torch.from_numpy(x["x_start"]),
                          torch.from_numpy(x["t"]),
                          torch.from_numpy(x["noise"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)

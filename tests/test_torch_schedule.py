"""Port parity: schedule tables, respacing and RePaint step programs.

Tables are computed in float64 on the host and stored as float32 by both
packages, so they must agree exactly; step programs are integer walks.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from diffsheg_tpu.diffusion import jump as jjump  # noqa: E402
from diffsheg_tpu.diffusion import respace as jrespace  # noqa: E402
from diffsheg_tpu.diffusion import schedule as jschedule  # noqa: E402
from diffsheg_tpu_torch.diffusion import jump as tjump  # noqa: E402
from diffsheg_tpu_torch.diffusion import respace as trespace  # noqa: E402
from diffsheg_tpu_torch.diffusion import schedule as tschedule  # noqa: E402


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_tables_identical(name):
    jb = jschedule.get_named_beta_schedule(name, 1000)
    tb = tschedule.get_named_beta_schedule(name, 1000)
    np.testing.assert_array_equal(jb, tb)
    js = jschedule.make_schedule(jb)
    ts = tschedule.make_schedule(tb)
    for field in jschedule.DiffusionSchedule._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, field)),
                                      getattr(ts, field), err_msg=field)


@pytest.mark.parametrize("spacing", ["ddim25", "ddim50", "10,15"])
def test_respaced_identical(spacing):
    base = jschedule.get_named_beta_schedule("linear", 1000)
    use_j = jrespace.space_timesteps(1000, spacing)
    assert use_j == trespace.space_timesteps(1000, spacing)
    js, jmap = jrespace.make_respaced_schedule(base, use_j)
    ts, tmap = trespace.make_respaced_schedule(base, use_j)
    np.testing.assert_array_equal(np.asarray(jmap), tmap)
    for field in jschedule.DiffusionSchedule._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, field)),
                                      getattr(ts, field), err_msg=field)


@pytest.mark.parametrize("jump_n_sample", [2, 5])
def test_ddim25_programs_identical(jump_n_sample):
    walk_j = jjump.jump_schedule_ddim(25, 3, jump_n_sample)
    walk_t = tjump.jump_schedule_ddim(25, 3, jump_n_sample)
    assert walk_j == walk_t
    pj = jjump.make_step_program(walk_j)
    pt = tjump.make_step_program(walk_t)
    np.testing.assert_array_equal(np.asarray(pj.t), pt.t)
    np.testing.assert_array_equal(np.asarray(pj.denoise), pt.denoise)
    assert pj.num_model_calls == pt.num_model_calls
    plain_j, plain_t = jjump.plain_program(25), tjump.plain_program(25)
    np.testing.assert_array_equal(np.asarray(plain_j.t), plain_t.t)
    np.testing.assert_array_equal(np.asarray(plain_j.denoise), plain_t.denoise)


def test_serving_model_call_counts():
    # ddim25 jump_n_sample 2: 25 model calls for a first window and 27 for
    # each continuation (the counts the kernel launch budget is built on)
    assert tjump.plain_program(25).num_model_calls == 25
    prog = tjump.make_step_program(tjump.jump_schedule_ddim(25, 3, 2))
    assert prog.num_model_calls == 27


def test_undo_matches():
    import jax.numpy as jnp
    import torch
    base = jschedule.get_named_beta_schedule("linear", 1000)
    js = jschedule.make_schedule(base)
    ts = tschedule.make_schedule(base)
    rng = np.random.RandomState(0)
    x, n = rng.randn(2, 5, 3).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    for t in (0, 17, 999):
        ref = js.undo(jnp.asarray(x), jnp.full((2,), t, jnp.int32), jnp.asarray(n))
        got = ts.undo(torch.tensor(x), t, torch.tensor(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)

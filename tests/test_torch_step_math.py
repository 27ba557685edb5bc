"""Port parity: the streamlined DDIM + RePaint step against the JAX Pallas
step kernel (interpret mode), and the general DDIM step and the
schedule's closed forms against JAX's.

On the CPU the port's ``fused_ddim_repaint_step`` runs its plain version;
the same numpy inputs and the same float32 level scalars go to both.
Every switch: no GT; GT; GT with a saved tail valid and invalid;
``add_blend`` on and off; ``ov`` = 1; a level whose sqrt(1 - ab_prev)
lies on either side of 0.2.  Tolerance 1e-6 absolute (inputs of unit
scale, scalars of a DDIM-25 schedule).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffsheg_tpu.diffusion import sampler as JS  # noqa: E402
from diffsheg_tpu.diffusion.respace import (  # noqa: E402
    make_respaced_schedule as j_respaced, space_timesteps as j_space)
from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule  # noqa: E402
from diffsheg_tpu.ops.step_math import fused_ddim_repaint_step as j_step  # noqa: E402
from diffsheg_tpu_torch.diffusion import sampler as PS  # noqa: E402
from diffsheg_tpu_torch.diffusion.respace import (  # noqa: E402
    make_respaced_schedule as p_respaced, space_timesteps as p_space)
from diffsheg_tpu_torch.ops.step_math import (  # noqa: E402
    _step_plan, fused_ddim_repaint_step)

BETAS = get_named_beta_schedule("linear", 1000)
J_SCHED, _ = j_respaced(BETAS, j_space(1000, "ddim25"))
P_SCHED, _ = p_respaced(BETAS, p_space(1000, "ddim25"))
B, T, C = 2, 12, 8


def _scal(ab_prev, t, valid):
    return (np.float32(ab_prev), P_SCHED.sqrt_recip_alphas_cumprod[t],
            P_SCHED.sqrt_recipm1_alphas_cumprod[t], np.float32(valid))


def _inputs(seed, ov):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((B, T, C), (B, T, C), (B, T, C), (B, T, C), (B, ov, C))]


# 0.2 ** 2 = 0.04: ab_prev = 0.96 +/- a few ulps puts sqrt(1 - ab_prev)
# just below / just above 0.2 in float32
NEAR = np.float32(0.96)
CASES = {
    "no_gt": dict(gt=False, tail=None, blend=True, ov=4, ab=None),
    "gt": dict(gt=True, tail=None, blend=True, ov=4, ab=None),
    "gt_tail_valid": dict(gt=True, tail=1.0, blend=True, ov=4, ab=None),
    "gt_tail_invalid": dict(gt=True, tail=0.0, blend=True, ov=4, ab=None),
    "no_blend": dict(gt=True, tail=None, blend=False, ov=4, ab=None),
    "ov1": dict(gt=True, tail=1.0, blend=True, ov=1, ab=None),
    "noise_w_below_0.2": dict(gt=True, tail=None, blend=True, ov=4,
                              ab=np.nextafter(NEAR, np.float32(1))),
    "noise_w_above_0.2": dict(gt=True, tail=None, blend=True, ov=4,
                              ab=np.nextafter(NEAR, np.float32(0))),
}


@pytest.mark.parametrize("t", [3, 24])
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_pallas_kernel(case, t):
    c = CASES[case]
    ov = c["ov"]
    x, eps, gt, gtn, tail = _inputs(t + len(case), ov)
    ab = P_SCHED.alphas_cumprod_prev[t] if c["ab"] is None else c["ab"]
    scal = _scal(ab, t, c["tail"] or 0.0)
    use_tail = c["tail"] is not None
    args = (gt if c["gt"] else None, gtn if c["gt"] else None,
            tail if use_tail else None)
    ref = np.asarray(j_step(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(np.array(scal, np.float32)),
        *(None if a is None else jnp.asarray(a) for a in args), ov,
        c["blend"], interpret=True))
    before = fused_ddim_repaint_step.launches
    got = fused_ddim_repaint_step(
        torch.tensor(x), torch.tensor(eps), scal,
        *(None if a is None else torch.tensor(a) for a in args), ov,
        c["blend"]).numpy()
    assert fused_ddim_repaint_step.launches == before      # CPU: no launch
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if c["ab"] is not None and c["gt"]:
        noise_w = np.sqrt(np.float32(1) - np.float32(ab))
        blended = noise_w < np.float32(0.2)
        assert blended == case.endswith("below_0.2")
        # the blend moves the last head frame to the mean; else it is GT
        head = np.sqrt(np.float32(ab)) * gt + noise_w * gtn
        assert np.allclose(got[:, ov - 1], head[:, ov - 1],
                           atol=1e-6) != blended


@pytest.mark.parametrize("mean_type,clip", [("epsilon", False),
                                            ("start_x", False),
                                            ("previous_x", False),
                                            ("epsilon", True)],
                         ids=["epsilon", "start_x", "previous_x", "clip"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_general_step_matches_jax(mean_type, clip, eta):
    # _pred_xstart + ddim_update + repaint_project with a valid saved tail
    t = 11
    x, out, gt, gtn, tail = _inputs(40 + t, 4)
    noise = np.random.RandomState(41).randn(B, T, C).astype(np.float32)
    spec_j = JS.RepaintSpec(overlap_len=4)
    spec_p = PS.RepaintSpec(overlap_len=4)
    tj = jnp.full((B,), t, jnp.int32)
    x0 = JS._pred_xstart(J_SCHED, mean_type, jnp.asarray(x), tj,
                         jnp.asarray(out), clip)
    ref = JS.repaint_project(J_SCHED, spec_j, JS.ddim_update(
        J_SCHED, jnp.asarray(x), tj, x0, jnp.asarray(noise), eta), tj,
        jnp.asarray(gt), jnp.asarray(gtn), jnp.asarray(tail),
        jnp.asarray(True))
    px = torch.tensor(x)
    p0 = PS._pred_xstart(P_SCHED, mean_type, px, t, torch.tensor(out), clip)
    got = PS.repaint_project(P_SCHED, spec_p, PS.ddim_update(
        P_SCHED, px, t, p0, torch.tensor(noise), eta), t, torch.tensor(gt),
        torch.tensor(gtn), torch.tensor(tail), True)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["predict_xstart_from_eps",
                                  "predict_eps_from_xstart",
                                  "predict_xstart_from_xprev"])
def test_schedule_closed_forms_match_jax(name):
    t = 7
    x, y = _inputs(50, 1)[:2]
    ref = getattr(J_SCHED, name)(jnp.asarray(x), jnp.full((B,), t, jnp.int32),
                                 jnp.asarray(y))
    got = getattr(P_SCHED, name)(torch.tensor(x), t, torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("C,aligned,vec", [(192, True, True),
                                           (232, True, True),
                                           (231, True, False),
                                           (192, False, False)],
                         ids=["C192", "C232", "C231", "C192_unaligned"])
def test_step_launch_plan(C, aligned, vec):
    # four channels a thread only where C % 4 == 0 and the pointers allow
    # 16-byte loads; every channel of every frame row is covered
    B, T = 2, 88
    plan = _step_plan(B, T, C, aligned)
    assert plan.vec == vec
    lanes = C // 4 if vec else C
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert (plan.grid_x - 1) * plan.threads < lanes <= plan.grid_x * plan.threads
    assert plan.grid_y == B * T
    assert _step_plan(1, 70000, 8).grid_y == 65535     # rows walked in a loop

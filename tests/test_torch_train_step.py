"""The port's training step (``diffsheg_tpu_torch/train/step.py``) against
the JAX package's ``make_train_step(..., inject_randoms=True)``.

Both steps get the same weights, batch, timesteps and noise; three steps
of each are compared: the loss terms of every step (rel 1e-5), and after
them the parameters (every leaf rel-RMS <= 1e-4, all of them as one
vector <= 1e-5), the BatchNorm statistics (every leaf <= 1e-5) and the
Adam moments (mu and sqrt(nu), each as one vector <= 1e-5).  A leaf is
held to 1e-4 and not 1e-5 because some gradients are zero in exact
arithmetic and rounding noise in both packages (the key bias: the softmax
over time does not see it), and Adam normalises that noise to a
full-size update.  bf16 compute is held to the bf16 band, 2.5e-2.  JAX
runs on the CPU, where its linear attention takes the plain reference.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import config_pair, rel_rms

from diffsheg_tpu.diffusion.schedule import get_named_beta_schedule as jbetas
from diffsheg_tpu.diffusion.schedule import make_schedule as jmake
from diffsheg_tpu.models.factory import stack_scan_layers, unstack_scan_layers
from diffsheg_tpu.train import step as jstep
from diffsheg_tpu_torch.compat.from_jax import (export_flax_tree,
                                                load_flax_train_state,
                                                load_flax_tree)
from diffsheg_tpu_torch.diffusion.schedule import get_named_beta_schedule
from diffsheg_tpu_torch.diffusion.schedule import make_schedule
from diffsheg_tpu_torch.models.factory import build_denoiser, random_init_
from diffsheg_tpu_torch.train import step as tstep

B, T, N_STEPS = 8, 8, 1000
SMALL = dict(num_layers=1)

CASES = {
    # (i) the joint BEAT model with the HuBERT conv encoder
    "beat-hubert-conv": dict(),
    # (ii) a learned-range variance head trained by the hybrid loss
    "learned-range-rescaled-mse": dict(
        model=dict(learned_variance=True),
        diffusion=dict(var_type="learned_range"),
        train=dict(loss_type="rescaled_mse")),
    # (iii) SHOW: classifier-free null rows, no semantic weighting
    "show-cfg-no-sem": dict(preset="show"),
    # (iv) the gesture branch conditioned on the given expression
    "exp-condition-gesture": dict(
        model=dict(branch_mode="exp_condition_gesture")),
    # (v) text and emotion labels
    "text-emotion": dict(model=dict(add_text_cond=True, add_emo_cond=True)),
    # (vi) weights in the scan_layers layout (two layers to stack)
    "scan-layers": dict(model=dict(scan_layers=True, num_layers=2)),
    # (vii) a global-norm clip that triggers
    "clip-triggers": dict(train=dict(grad_clip=1e-3)),
    # the loss-aware timestep sampler's history update
    "loss-aware": dict(train=dict(timestep_sampler="loss-second-moment")),
}


def make_pair(preset="beat", model=None, diffusion=None, train=None):
    model = dict(SMALL, **(model or {}))
    return config_pair(preset, model=model, diffusion=diffusion,
                       data=dict(n_poses=T), train=train)


def seeded_variables(tcfg, seed):
    """Random weights made in the port (every leaf perturbed, so no
    projection is zero), as a Flax tree; a learned-variance head emits a
    constant in [-1, 1) per channel (a random one overflows the variance)."""
    model = random_init_(build_denoiser(tcfg.model), seed, perturb=0.05)
    tree = export_flax_tree(model)
    if tcfg.model.learned_variance:
        rng = np.random.RandomState(seed)
        for branch in tree["params"].values():
            out = branch.get("out") if isinstance(branch, dict) else None
            if out is not None:
                n = out["bias"].shape[0] // 2
                out["kernel"][:, n:] = 0.0
                out["bias"][n:] = rng.uniform(-1, 1, n).astype(np.float32)
    return tree


def make_batch(jcfg, seed):
    rs = np.random.RandomState(seed)
    m = jcfg.model
    C = {"expression_only": m.expression_dim,
         "gesture_only": m.pose_dim,
         "exp_condition_gesture": m.pose_dim}.get(m.branch_mode,
                                                  m.motion_dim)
    b = {"motion": rs.randn(B, T, C).astype(np.float32) * 0.5,
         "mel": rs.randn(B, T, m.audio_dim).astype(np.float32),
         "pid": np.eye(m.style_dim, dtype=np.float32)[
             np.arange(B) % m.style_dim],
         "sem": rs.rand(B, T).astype(np.float32)}
    if m.add_hubert:
        b["hubert"] = rs.randn(B, T, m.hubert_dim).astype(np.float32) * 0.5
    if m.branch_mode == "exp_condition_gesture":
        b["exp_cond"] = rs.randn(B, T, m.expression_dim).astype(np.float32)
    if m.add_text_cond:
        b["word"] = rs.randint(-1, m.word_vocab, (B, T)).astype(np.int32)
    if m.add_emo_cond:
        b["emo"] = rs.randint(0, m.num_emotions, (B, T)).astype(np.int32)
    return b


def draws(C, seed, n=3):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, N_STEPS, B).astype(np.int32),
             rs.randn(B, T, C).astype(np.float32)) for _ in range(n)]


def jax_state(jcfg, tree):
    params = tree["params"]
    if jcfg.model.scan_layers:
        params = stack_scan_layers(params, jcfg.model.num_layers)
    variables = {"params": params, "batch_stats": tree["batch_stats"]}
    return jstep.create_train_state(jcfg, jax.tree.map(jnp.asarray,
                                                       variables))


def torch_state(tcfg, tree):
    model = load_flax_tree(build_denoiser(tcfg.model), tree)
    return tstep.create_train_state(tcfg, model, "cpu")


def run_jax(jcfg, state, batch, rolls):
    step = jstep.make_train_step(jcfg, jmake(jbetas("linear", N_STEPS)),
                                 inject_randoms=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    terms = []
    for t, n in rolls:
        state, tm = step(state, jb, jnp.asarray(t), jnp.asarray(n))
        terms.append({k: float(v) for k, v in tm._asdict().items()})
    return jax.tree.map(np.asarray, state), terms


def run_torch(tcfg, state, batch, rolls):
    step = tstep.make_train_step(
        tcfg, make_schedule(get_named_beta_schedule("linear", N_STEPS)),
        inject_randoms=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    terms = []
    for t, n in rolls:
        state, tm = step(state, tb, torch.from_numpy(t).long(),
                         torch.from_numpy(n))
        terms.append({k: float(v) for k, v in tm._asdict().items()})
    return state, terms


def moments(state):
    """The port's Adam moments as Flax trees (the weights' layout)."""
    out = {}
    for key in ("exp_avg", "exp_avg_sq"):
        scratch = copy.deepcopy(state.model)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), scratch.parameters()):
                q.copy_(state.optimizer.state[p][key])
        out[key] = export_flax_tree(scratch)["params"]
    return out


def unrolled(jcfg, params):
    if jcfg.model.scan_layers:
        return unstack_scan_layers(params, jcfg.model.num_layers)
    return params


def flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def compare_states(jcfg, js, ts, jterms, tterms, tol):
    for a, b in zip(tterms, jterms):
        for k in b:
            assert abs(a[k] - b[k]) <= tol * max(abs(b[k]), 1e-30), (k, a, b)
    ours = export_flax_tree(ts.model)
    jp = unrolled(jcfg, js.params)
    leaf = jax.tree.map(lambda x, y: rel_rms(y, x), jp, ours["params"])
    assert max(jax.tree.leaves(leaf)) <= 10 * tol, leaf
    assert rel_rms(flat(ours["params"]), flat(jp)) <= tol
    stats = jax.tree.map(lambda x, y: rel_rms(y, x), js.batch_stats,
                         ours["batch_stats"])
    assert max(jax.tree.leaves(stats) or [0.0]) <= tol, stats
    adam = js.opt_state[1].inner_state[0]
    m = moments(ts)
    assert rel_rms(flat(m["exp_avg"]), flat(unrolled(jcfg, adam.mu))) <= tol
    # the second moment in gradient units (sqrt(nu), what Adam divides
    # by): nu itself doubles the gradients' relative error
    assert rel_rms(np.sqrt(flat(m["exp_avg_sq"])),
                   np.sqrt(flat(unrolled(jcfg, adam.nu)))) <= tol
    assert ts.step == int(js.step) == 3
    assert all(float(ts.optimizer.state[p]["step"]) == int(adam.count)
               for p in ts.model.parameters())


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_injected_steps_match_jax(case):
    spec = dict(CASES[case])
    jcfg, tcfg = make_pair(spec.pop("preset", "beat"), **spec)
    tree = seeded_variables(tcfg, 7)
    batch = make_batch(jcfg, 8)
    rolls = draws(batch["motion"].shape[-1], 9)
    js, jterms = run_jax(jcfg, jax_state(jcfg, tree), batch, rolls)
    ts, tterms = run_torch(tcfg, torch_state(tcfg, tree), batch, rolls)
    compare_states(jcfg, js, ts, jterms, tterms, 1e-5)
    if tcfg.train.timestep_sampler == "loss-second-moment":
        # the history is copied losses: equal to f32 rounding of the loss
        np.testing.assert_array_equal(ts.t_state.counts.numpy(),
                                      np.asarray(js.t_state.counts))
        np.testing.assert_allclose(ts.t_state.history.numpy(),
                                   np.asarray(js.t_state.history),
                                   rtol=1e-5)


def test_bf16_compute_within_the_bf16_band():
    jcfg, tcfg = make_pair(model=dict(compute_dtype="bfloat16"))
    tree = seeded_variables(tcfg, 11)
    batch = make_batch(jcfg, 12)
    rolls = draws(192, 13)
    js, jterms = run_jax(jcfg, jax_state(jcfg, tree), batch, rolls)
    ts, tterms = run_torch(tcfg, torch_state(tcfg, tree), batch, rolls)
    # the master weights stay f32 and get f32 gradients
    assert all(p.dtype == torch.float32 for p in ts.model.parameters())
    for a, b in zip(tterms, jterms):
        for k in ("total", "eps_mse", "vel_mse", "x0_huber"):
            assert abs(a[k] - b[k]) <= 2.5e-2 * abs(b[k]), (k, a, b)
    ours = export_flax_tree(ts.model)["params"]
    assert rel_rms(flat(ours), flat(js.params)) <= 2.5e-2


def test_jax_state_continues_in_the_port():
    """Two steps in JAX, the state carried into the port, one more step
    in each."""
    jcfg, tcfg = make_pair(train=dict(timestep_sampler="loss-second-moment"))
    tree = seeded_variables(tcfg, 21)
    batch = make_batch(jcfg, 22)
    rolls = draws(192, 23)
    js, jterms = run_jax(jcfg, jax_state(jcfg, tree), batch, rolls[:2])
    ts = load_flax_train_state(torch_state(tcfg, tree), js)
    assert ts.step == 2
    assert tstep.current_learning_rate(ts.optimizer) == pytest.approx(
        jcfg.train.lr)
    js3, j3 = run_jax(jcfg, jax.tree.map(jnp.asarray, js), batch, rolls[2:])
    ts3, t3 = run_torch(tcfg, ts, batch, rolls[2:])
    compare_states(jcfg, js3, ts3, j3, t3, 1e-5)
    np.testing.assert_allclose(ts3.t_state.history.numpy(),
                               np.asarray(js3.t_state.history), rtol=1e-5)


def test_remat_equals_no_remat():
    """``model.remat`` recomputes each layer in the backward pass: the
    same loss and parameters (rel 1e-6), with dropout on, whose draws the
    recompute replays."""
    out = []
    for remat in (False, True):
        _, tcfg = make_pair(model=dict(remat=remat, dropout=0.1,
                                       num_layers=2))
        tree = seeded_variables(tcfg, 31)
        batch = make_batch(tcfg, 32)
        state = torch_state(tcfg, tree)
        step = tstep.make_train_step(
            tcfg, make_schedule(get_named_beta_schedule("linear", N_STEPS)))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        terms = [step(state, tb)[1].total.item() for _ in range(2)]
        out.append((terms, torch.cat([p.detach().flatten() for p in
                                      state.model.parameters()])))
    (t0, p0), (t1, p1) = out
    np.testing.assert_allclose(t1, t0, rtol=1e-6)
    assert rel_rms(p1.numpy(), p0.numpy()) <= 1e-6


def test_step_randomness_comes_from_seed_and_step():
    """Without injected draws, the step's timesteps, noise and dropout
    follow (train.seed, step): a state restored at step k draws what the
    uninterrupted run drew at step k."""
    _, tcfg = make_pair(model=dict(dropout=0.1))
    tree = seeded_variables(tcfg, 41)
    tb = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, 42).items()}
    sched = make_schedule(get_named_beta_schedule("linear", N_STEPS))
    step = tstep.make_train_step(tcfg, sched)
    a = torch_state(tcfg, tree)
    ta = [step(a, tb)[1].total.item() for _ in range(3)]
    b = torch_state(tcfg, tree)
    step(b, tb)
    snapshot = copy.deepcopy(b)
    tb2 = [step(b, tb)[1].total.item() for _ in range(2)]
    tc = [step(snapshot, tb)[1].total.item() for _ in range(2)]
    assert ta[1:] == tb2 == tc
    assert len(set(ta)) == 3


def test_clip_follows_optax():
    """Scaled by max / norm only when the norm reaches max, else
    untouched (``clip_grad_norm_`` would scale by max / (norm + 1e-6))."""
    import optax
    rs = np.random.RandomState(0)
    gs = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)))
    for max_norm in (0.5 * norm, 2.0 * norm, norm):
        ref = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())[0]
        ours = [torch.from_numpy(g.copy()) for g in gs]
        tstep.clip_grad_global_norm_(ours, max_norm)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7)


def test_reset_learning_rate():
    _, tcfg = make_pair()
    state = torch_state(tcfg, seeded_variables(tcfg, 51))
    assert tstep.current_learning_rate(state.optimizer) == tcfg.train.lr
    tstep.reset_learning_rate(state.optimizer, 5e-5)
    assert tstep.current_learning_rate(state.optimizer) == 5e-5
    # the JAX helpers on the same numbers
    jcfg, _ = make_pair()
    js = jstep.create_train_state(jcfg, jax.tree.map(
        jnp.asarray, seeded_variables(tcfg, 51)))
    opt = jstep.reset_learning_rate(js.opt_state, 5e-5)
    assert jstep.current_learning_rate(opt) == pytest.approx(5e-5)


def test_unknown_timestep_sampler_is_refused():
    _, tcfg = make_pair(train=dict(timestep_sampler="bogus"))
    with pytest.raises(ValueError, match="timestep_sampler"):
        torch_state(tcfg, seeded_variables(make_pair()[1], 1))


def test_null_rows_equal_jax_linspace():
    """The training null-condition rows equal JAX's f32 ``linspace(0, 1,
    B) < p`` for every batch up to the published 2500 at the configs'
    p = 0.2 (and at 0.1, 0.5).  JAX compiles one program a batch size
    (~80 ms each), so it is asked directly where its rounding decides a
    row (some i / (B - 1) and its f32 rounding fall on either side of p)
    and at a spread of other sizes; the port's rule covers the rest."""
    from diffsheg_tpu_torch.models.denoiser import null_rows
    sizes = set(range(1, 41)) | {255, 256, 950, 2500}
    for p in (0.2, 0.1, 0.5):
        for batch in range(2, 2501):
            i = np.arange(batch)
            exact = i / (batch - 1) < p         # float64 division
            if not np.array_equal(null_rows(batch, p).numpy(), exact):
                sizes.add(batch)
    assert len(sizes) > 50                      # rounding does decide rows
    for batch in sorted(sizes):
        lin = np.asarray(jnp.linspace(0.0, 1.0, batch))
        for p in (0.2, 0.1, 0.5):
            # JAX compares with p cast to f32, as numpy does here
            assert np.array_equal(null_rows(batch, p).numpy(),
                                  lin < np.float32(p)), (p, batch)


def test_dropout_only_in_training_scaled_and_reproducible():
    from diffsheg_tpu_torch.models.blocks import dropout
    x = torch.randn(64, 32)
    assert dropout(x, 0.25, False) is x and dropout(x, 0.0, True) is x
    torch.manual_seed(3)
    y = dropout(x, 0.25, True)
    kept = y != 0
    assert 0.6 < kept.float().mean() < 0.9
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    torch.manual_seed(3)
    assert torch.equal(dropout(x, 0.25, True), y)
    # through the model: inactive without train, seeded with it
    _, tcfg = make_pair(model=dict(dropout=0.3, pe_type="ppe_sinu_dropout"))
    _, off = make_pair(model=dict(dropout=0.0, pe_type="ppe_sinu"))
    tree = seeded_variables(tcfg, 61)
    model, ref = (load_flax_tree(build_denoiser(c.model), tree)
                  for c in (tcfg, off))
    b = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, 62).items()}
    t = torch.arange(B) * 100
    args = (torch.randn(B, T, 192), t, (1.0, 0.5), b["mel"], b["pid"])
    kw = dict(hubert=b["hubert"])
    with torch.no_grad():
        assert torch.equal(model(*args, **kw), ref(*args, **kw))
        outs = []
        for seed in (5, 5, 6):
            torch.manual_seed(seed)
            outs.append(model(*args, train=True, **kw))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_batchnorm_training_matches_flax():
    """Training mode normalises with the batch's biased variance and moves
    the running statistics by momentum 0.9 with that same variance, as
    Flax's ``BatchNorm`` (``torch.nn.functional.batch_norm`` would store
    the unbiased one)."""
    from flax import linen as fnn
    from diffsheg_tpu_torch.models.denoiser import BatchNorm
    rs = np.random.RandomState(7)
    x = (rs.randn(8, 8, 5) * 2 + 1).astype(np.float32)
    scale, bias = rs.rand(5).astype(np.float32) + 0.5, rs.randn(5).astype(
        np.float32)
    mean, var = rs.randn(5).astype(np.float32), rs.rand(5).astype(
        np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    ref, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean, "var": var}},
                        jnp.asarray(x), mutable=["batch_stats"])
    ours = BatchNorm(5)
    with torch.no_grad():
        for t, v in ((ours.weight, scale), (ours.bias, bias),
                     (ours.running_mean, mean), (ours.running_var, var)):
            t.copy_(torch.from_numpy(v))
    got = ours(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)

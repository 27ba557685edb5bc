"""The plain reference against the port's CPU path at a tiny size (both
f32: they agree to rounding), and the check's verdict on a run whose
timed path is broken underneath: each fault a cell can have makes
``correct`` false."""

import pytest
import torch

from benchmark.tests.tiny import dry_run


@pytest.mark.parametrize("cell", ["beat-stream-bf16", "show-stream-cfg-bf16"])
def test_stream_reference_agrees_with_the_port(cell):
    res = dry_run(cell)
    assert res["correct"] and res["attempted"] >= 1
    assert res["checks"]["window_rel_rms"]["value"] < 1e-5


def test_train_reference_agrees_with_the_port():
    res = dry_run("beat-train-f32")
    assert res["correct"] and res["attempted"] >= 1
    c = res["checks"]
    assert c["loss_rel_gap"]["value"] < 1e-5
    assert c["first_grad_leaf_gap"]["value"] < 1e-5
    assert c["change_leaf_gap"]["value"] < 1e-4


def test_stream_answer_altered_is_not_correct(monkeypatch):
    from diffsheg_tpu_torch.sampling import streamer
    real = streamer.StreamingGenerator.generate_fused

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        out[:, 20] = 2 * out[:, 20] + 1   # one frame, where it is made
        return out

    monkeypatch.setattr(streamer.StreamingGenerator, "generate_fused", altered)
    assert not dry_run("beat-stream-bf16")["correct"]


def test_stream_step_returning_its_state_is_not_correct(monkeypatch):
    from diffsheg_tpu_torch.diffusion import sampler
    monkeypatch.setattr(sampler, "ddim_repaint_step_reference",
                        lambda x, *a, **kw: x)
    assert not dry_run("beat-stream-bf16")["correct"]


def test_show_half_the_guided_batch_left_out_is_not_correct(monkeypatch):
    from diffsheg_tpu_torch.models import fast_forward
    real = fast_forward._branch_forward

    def conditional_only(cfg, bp, x, cache, exp_cond, cfg_inference,
                         chain=False):
        return real(cfg, bp, x, cache, exp_cond, False, chain)

    monkeypatch.setattr(fast_forward, "_branch_forward", conditional_only)
    assert not dry_run("show-stream-cfg-bf16")["correct"]


def test_train_step_returning_its_state_is_not_correct(monkeypatch):
    real = torch.optim.Adam.step

    @torch.no_grad()
    def unchanged(self, *a, **kw):
        params = [p for g in self.param_groups for p in g["params"]]
        keep = [p.clone() for p in params]
        real(self, *a, **kw)
        for p, k in zip(params, keep):
            p.copy_(k)

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    assert not dry_run("beat-train-f32")["correct"]


def test_train_half_the_batch_left_out_is_not_correct(monkeypatch):
    from diffsheg_tpu_torch.train import step as step_mod
    real = step_mod.make_train_step

    def halved(*a, **kw):
        fn = real(*a, **kw)

        def step(state, batch, t, noise):
            n = t.shape[0] // 2
            return fn(state, {k: v[:n] for k, v in batch.items()}, t[:n],
                      noise[:n])
        return step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    assert not dry_run("beat-train-f32")["correct"]

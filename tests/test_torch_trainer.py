"""The port's trainer and checkpoints (``diffsheg_tpu_torch/train/
{trainer,checkpoint}.py``) on the CPU: fit, resume, evaluation on the
current weights, the checkpoint policy, the model-batch assembly against
the JAX trainer's, the speech frontend in the step, and the mesh-size
error."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from diffsheg_tpu_torch.config import beat_config
from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
from diffsheg_tpu_torch.train import checkpoint as ckpt
from diffsheg_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def tiny_cfg(**train):
    cfg = beat_config()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, latent_dim=32, num_layers=1, num_heads=2, ff_size=64,
            hubert_latent_dim=16, add_hubert=False),
        data=dataclasses.replace(cfg.data, n_poses=8),
        train=dataclasses.replace(
            cfg.train, **dict(dict(batch_size=8, num_epochs=2, log_every=1,
                                   save_every_epochs=0, eval_every_epochs=0),
                              **train)))


class SynthDs:
    """16 synthetic windows with the BeatDataset batch contract."""

    def __init__(self, cfg, n=16, T=8, seed=0):
        rng = np.random.RandomState(seed)
        m = cfg.model
        self.data = {
            "motion": rng.randn(n, T, m.motion_dim).astype(np.float32) * .5,
            "mel": rng.randn(n, T, m.audio_dim).astype(np.float32),
            "sem": rng.rand(n, T).astype(np.float32),
            "id": rng.randint(0, m.style_dim, (n, 1)).astype(np.int32),
        }
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


def loader(cfg, seed=0, n=16):
    return ShardedBatchLoader(SynthDs(cfg, n=n, seed=seed),
                              global_batch_size=8, prefetch=0)


def params(tr):
    return [p.detach().clone() for p in tr.state.model.parameters()]


def test_fit_two_epochs_and_resume(tmp_path):
    cfg = tiny_cfg()
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    assert not tr.try_resume()
    tr.fit(loader(cfg), num_epochs=2)
    assert tr.epoch == 2 and tr.total_it == 4 and tr.state.step == 4
    recs = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert sum("total" in r for r in recs) == 4
    assert json.loads(open(tmp_path / "run" / "config.json").read())[
        "train"]["batch_size"] == 8

    tr2 = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    assert tr2.try_resume()
    assert (tr2.epoch, tr2.total_it, tr2.state.step) == (2, 4, 4)
    assert all(torch.equal(a, b) for a, b in zip(params(tr), params(tr2)))
    for p, q in zip(tr.state.model.parameters(),
                    tr2.state.model.parameters()):
        a, b = tr.state.optimizer.state[p], tr2.state.optimizer.state[q]
        assert all(torch.equal(a[k], b[k]) for k in a)
    tr2.fit(loader(cfg), num_epochs=2)            # already there: no-op
    assert tr2.epoch == 2


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """Each step's draws follow (seed, step): one epoch, a resume, and a
    second epoch end exactly where two epochs in one go end."""
    cfg = tiny_cfg()
    a = Trainer(cfg, str(tmp_path / "a"), device="cpu")
    a.fit(loader(cfg), num_epochs=1)
    a2 = Trainer(cfg, str(tmp_path / "a"), device="cpu")
    assert a2.try_resume()
    a2.fit(loader(cfg), num_epochs=2)
    b = Trainer(cfg, str(tmp_path / "b"), device="cpu")
    b.fit(loader(cfg), num_epochs=2)
    assert all(torch.equal(x, y) for x, y in zip(params(a2), params(b)))


def test_reset_lr_on_resume(tmp_path):
    cfg = tiny_cfg()
    Trainer(cfg, str(tmp_path), device="cpu").fit(loader(cfg), num_epochs=1)
    lower = cfg.replace(train=dataclasses.replace(cfg.train, lr=1e-5))
    kept = Trainer(lower, str(tmp_path), device="cpu")
    kept.try_resume()
    assert kept.state.optimizer.param_groups[0]["lr"] == cfg.train.lr
    reset = lower.replace(train=dataclasses.replace(lower.train,
                                                    reset_lr=True))
    forced = Trainer(reset, str(tmp_path), device="cpu")
    forced.try_resume()
    assert forced.state.optimizer.param_groups[0]["lr"] == 1e-5


def test_evaluate_sees_each_steps_weights(tmp_path):
    """The window generator is built once and reloaded at every
    evaluation: after a training step the same noise gives another
    sample, from the trainer's current weights."""
    cfg = tiny_cfg()
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    val = loader(cfg, seed=1)
    first = tr.evaluate(val, seed=3)
    vals = [first.mse, first.pck, first.pck2, first.diversity]
    assert all(np.isfinite(v) for v in vals) and np.isnan(first.fgd)
    again = tr.evaluate(val, seed=3)
    assert again == first
    batch = tr._on_device(tr._to_model_batch(SynthDs(cfg).batch(
        np.arange(8))))
    tr.state, _ = tr._step_full(tr.state, batch)
    second = tr.evaluate(val, seed=3)
    assert second.mse != first.mse
    gen = tr._generator
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in
               zip(gen.model.state_dict().values(),
                   tr.state.model.state_dict().values()))
    assert not gen.use_fast or len(gen._fast) == 1


def test_fit_saves_tagged_and_best(tmp_path):
    cfg = tiny_cfg(save_every_epochs=1, eval_every_epochs=1)
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    tr.fit(loader(cfg), loader(cfg, seed=1, n=8), num_epochs=2)
    root = tmp_path / "ckpt"
    for name in ("epoch_0001", "epoch_0002", "mse_best", "pck_best"):
        assert (root / name / "state.pt").exists(), name
        assert json.load(open(root / f"{name}.meta.json"))["epoch"] >= 1
    best = json.load(open(root / "best_metrics.json"))
    assert set(best) == {"mse", "pck"}
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert sum("val_mse" in r for r in recs) == 2


def test_checkpoint_policy(tmp_path):
    cfg = tiny_cfg()
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    mngr = ckpt.CheckpointManager(str(tmp_path / "c"), max_keep=3)
    assert mngr.restore_latest(tr.state) is None
    for step in range(1, 6):
        tr.state.step = step
        mngr.save_latest(step, tr.state, {"epoch": step})
    assert mngr.all_steps() == [3, 4, 5]
    metas = sorted(os.listdir(tmp_path / "c"))
    assert [m for m in metas if m.startswith("latest_")] == [
        "latest_3.meta.json", "latest_4.meta.json", "latest_5.meta.json"]
    tr.state.step = 0
    state, meta = mngr.restore_latest(tr.state)
    assert state.step == 5 and meta == {"epoch": 5}
    mngr.save_tagged("epoch_0007", tr.state, {"epoch": 7})
    assert mngr.restore_tagged("epoch_0007", tr.state)[1] == {"epoch": 7}
    assert mngr.update_best("mse", 2.0, tr.state)
    assert not mngr.update_best("mse", 3.0, tr.state)
    assert mngr.update_best("mse", 1.0, tr.state)
    assert mngr.update_best("pck", 0.2, tr.state, lower_is_better=False)
    assert not mngr.update_best("pck", 0.1, tr.state, lower_is_better=False)
    assert ckpt.CheckpointManager(str(tmp_path / "c")).best_metrics == {
        "mse": 1.0, "pck": 0.2}
    # a checkpoint of the loss-aware sampler does not load into a uniform
    # run
    other = tiny_cfg(timestep_sampler="loss-second-moment")
    tr2 = Trainer(other, str(tmp_path / "run2"), device="cpu")
    with pytest.raises(ValueError, match="timestep_sampler"):
        mngr.restore_latest(tr2.state)


def test_orbax_checkpoints_are_refused(tmp_path):
    """The JAX package's checkpoint directory (Orbax, written here by its
    own CheckpointManager) is refused by name."""
    from diffsheg_tpu.train.checkpoint import CheckpointManager as JMngr
    jm = JMngr(str(tmp_path / "jax"))
    jm.save_latest(1, {"a": np.zeros(3)}, {"epoch": 1})
    jm.save_tagged("epoch_0001", {"a": np.zeros(3)}, {"epoch": 1})
    tr = Trainer(tiny_cfg(), str(tmp_path / "run"), device="cpu")
    mngr = ckpt.CheckpointManager(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="Orbax checkpoint, which is the "
                                         "JAX package's format"):
        mngr.restore_latest(tr.state)
    with pytest.raises(ValueError, match="Orbax"):
        mngr.restore_tagged("epoch_0001", tr.state)


BATCH_CASES = {
    "joint": dict(model=dict(branch_mode="joint")),
    "expression-only": dict(model=dict(branch_mode="expression_only")),
    "gesture-only": dict(model=dict(branch_mode="gesture_only")),
    "exp-condition-gesture": dict(
        model=dict(branch_mode="exp_condition_gesture")),
    "zero-hubert": dict(model=dict(add_hubert=True)),
    "hubert-speaker": dict(model=dict(add_hubert=True), fields=(
        "hubert", "speaker")),
    "pid-text-emotion": dict(model=dict(add_text_cond=True,
                                        add_emo_cond=True),
                             fields=("pid", "word")),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_to_model_batch_matches_jax(case):
    from diffsheg_tpu import config as jconfig
    from diffsheg_tpu.train.trainer import Trainer as JTrainer
    from diffsheg_tpu_torch.train.trainer import Trainer as TTrainer
    spec = BATCH_CASES[case]
    rs = np.random.RandomState(5)
    B, T = 3, 6
    batch = {"motion": rs.randn(B, T, 192).astype(np.float32),
             "pose_axis_angle": rs.randn(B, T, 141).astype(np.float32),
             "facial": rs.randn(B, T, 51).astype(np.float32),
             "mel": rs.randn(B, T, 128).astype(np.float32),
             "sem": rs.rand(B, T).astype(np.float32),
             "id": rs.randint(0, 30, (B, 1)).astype(np.int32)}
    extra = {"hubert": rs.randn(B, T, 1024).astype(np.float32),
             "speaker": np.eye(30, dtype=np.float32)[[1, 2, 3]],
             "pid": np.eye(30, dtype=np.float32)[[4, 5, 6]],
             "word": rs.randint(-1, 9, (B, T)).astype(np.int32)}
    batch.update({k: extra[k] for k in spec.get("fields", ())})
    out = []
    for mod, cls in ((jconfig, JTrainer), (None, TTrainer)):
        cfg = (jconfig.beat_config() if mod else beat_config())
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    **spec["model"]))
        texts = []
        fake = SimpleNamespace(cfg=cfg, logger=SimpleNamespace(
            log_text=texts.append))
        out.append((cls._to_model_batch(fake, dict(batch)), texts))
    (ref, ref_text), (got, got_text) = out
    assert sorted(got) == sorted(ref) and got_text == ref_text
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


class AudioDs(SynthDs):
    """The synthetic windows with the cache's raw 16 kHz audio."""

    def __init__(self, cfg, n=16, T=8, seed=0):
        super().__init__(cfg, n, T, seed)
        self.data["audio"] = (np.random.RandomState(seed + 1).randn(
            n, T * 16000 // 15) * 0.1).astype(np.float32)


@pytest.mark.parametrize("over,match", [
    # the on-device speech frontend now trains (the model's mel from the
    # raw audio); a mesh that does not lay out the one process is JAX's
    # mesh-size error
    (dict(train=dict(on_device_frontend=True)), None),
    (dict(mesh=dict(data_parallel=2)), r"mesh 2x1 != 1 devices"),
    (dict(mesh=dict(fsdp_parallel=2)), r"mesh 0x2 != 1 devices"),
])
def test_trainer_refusals(tmp_path, over, match):
    cfg = tiny_cfg()
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in over.items()})
    if match is not None:
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, str(tmp_path), device="cpu")
        return
    tr = Trainer(cfg, str(tmp_path), device="cpu")
    tr.fit(ShardedBatchLoader(AudioDs(cfg), global_batch_size=8,
                              prefetch=0), num_epochs=1)
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [np.isfinite(r["total"]) for r in recs if "total" in r] == [
        True, True]
    with pytest.raises(ValueError, match="raw 'audio' field"):
        tr._to_model_batch(SynthDs(cfg).batch(np.arange(2)))


def test_more_than_one_process_is_refused(tmp_path, monkeypatch):
    """Several processes join torchrun's group; only part of torchrun's
    variables (a world size of 2 with no rank or address) is an error,
    not a run that goes on alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for v in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE set without"):
        Trainer(tiny_cfg(), str(tmp_path), device="cpu")

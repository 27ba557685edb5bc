"""The port's command line (``python -m diffsheg_tpu_torch.cli``).

``--set`` parses as the JAX CLI's does (the same strings, the same
resulting fields, the same refusals) and a JAX ``config.json`` loads;
``serve --device cpu`` builds a ``MotionServer`` from its flags
(``serve_forever`` patched to run the accept loop in a thread and return
as SIGTERM does), drains and closes it, loads a reference ``.tar`` and
refuses a checkpoint directory; ``train``, ``eval`` and ``test-stream``
run on the CPU, with the reference's FGD autoencoder.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

SETS = [
    [],
    ["model.latent_dim=256", "model.add_hubert=false"],
    ["diffusion.fused_layer=chain", "diffusion.quantize=int8",
     "diffusion.jump_n_sample=2", "stream.overlap_len=6"],
    ["model.cond_scale=1.5", "model.classifier_free=yes",
     "stream.fix_very_first=1", "data.n_poses=12"],
    ["data.remove_hand=true"],
    ["stream.single_dispatch=false", "stream.same_overlap_noisy=true"],
    ["diffusion.scan_unroll=2"],
]
BAD = ["model.latent_dim", "latent_dim=3", "modle.latent_dim=3",
       "model.latnet_dim=3", "model.latent_dim=big"]

TINY = ["--set", "model.latent_dim=32", "--set", "model.num_layers=1",
        "--set", "model.num_heads=2", "--set", "model.ff_size=64",
        "--set", "model.add_hubert=false"]


def _fields(cfg, sections=("model", "diffusion", "stream", "data")):
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in sections}


@pytest.mark.parametrize("dataset", ["beat", "show"])
@pytest.mark.parametrize("sets", SETS, ids=[",".join(s) or "none"
                                           for s in SETS])
def test_set_overrides_match_jax(dataset, sets):
    import diffsheg_tpu.cli.main as J
    import diffsheg_tpu_torch.cli.main as P

    class Args:
        set = sets
    Args.dataset = dataset
    ours, ref = _fields(P._base_config(Args)), _fields(J._base_config(Args))
    for section, fields in ours.items():
        for name, value in fields.items():
            assert value == ref[section][name], (section, name)


@pytest.mark.parametrize("item", BAD)
def test_bad_overrides_refused_as_jax_does(item):
    import diffsheg_tpu.cli.main as J
    import diffsheg_tpu_torch.cli.main as P
    from diffsheg_tpu.config import beat_config as jbeat
    from diffsheg_tpu_torch.config import beat_config as pbeat
    with pytest.raises(SystemExit) as ours:
        P._apply_overrides(pbeat(), [item])
    with pytest.raises(SystemExit) as ref:
        J._apply_overrides(jbeat(), [item])
    assert (str(ours.value).split(" Valid ")[0]
            == str(ref.value).split(" Valid ")[0])


def _patched_server(monkeypatch):
    """``serve_forever`` runs the accept loop in a thread and returns as
    SIGTERM's handler does (KeyboardInterrupt), so ``serve`` drains and
    closes the server it built."""
    from diffsheg_tpu_torch.serving.server import MotionServer
    built = []

    def serve_forever(self):
        built.append(self)
        self.start_background()
        raise KeyboardInterrupt

    monkeypatch.setattr(MotionServer, "serve_forever", serve_forever)
    return built


def test_serve_builds_server_from_flags(monkeypatch, capsys):
    from diffsheg_tpu_torch.cli.main import main
    built = _patched_server(monkeypatch)
    rc = main(["serve", "--device", "cpu", "--port", "0", "--max-sessions",
               "3", "--max-batch", "5", "--idle-timeout", "7",
               "--client-geometry", "--max-stream-seconds", "9",
               "--prewarm", "1"] + TINY)
    assert rc == 0
    (srv,) = built
    assert srv.device.type == "cpu"
    assert (srv.max_batch, srv.idle_timeout, srv.client_geometry,
            srv.max_stream_seconds) == (5, 7.0, True, 9.0)
    assert srv.cfg.model.latent_dim == 32 and srv.hubert_fe is None
    assert len(srv._gens) == 1 and srv._pinned        # prewarmed
    err = capsys.readouterr().err
    assert "no checkpoint given" in err


@pytest.mark.parametrize("sets", [
    ["model.model_base=transformer_decoder"],
    ["diffusion.sampler=ancestral", "model.learned_variance=true",
     "diffusion.var_type=learned_range"],
    ["model.branch_mode=gesture_only", "model.add_text_cond=true"],
], ids=["decoder", "ancestral_learned_range", "gesture_only_text"])
def test_serve_builds_every_model_variant(monkeypatch, sets):
    # the model comes from init_denoiser, as the JAX CLI builds it, and a
    # prewarm session samples it
    from diffsheg_tpu_torch.cli.main import main
    built = _patched_server(monkeypatch)
    extra = [a for item in sets for a in ("--set", item)]
    assert main(["serve", "--device", "cpu", "--port", "0", "--prewarm",
                 "1"] + TINY + extra) == 0
    (srv,) = built
    (gen,) = srv._gens.values()
    m = srv.cfg.model
    assert not gen.use_cache
    assert gen.ancestral == (srv.cfg.diffusion.sampler == "ancestral")
    if m.model_base == "transformer_decoder":
        assert hasattr(srv.model.encoder_ges.layer_0, "ca_block")
    if m.branch_mode == "gesture_only":
        assert hasattr(srv.model.encoder, "text_embed")


def test_serve_loads_reference_tar_and_refuses_directory(monkeypatch,
                                                         tmp_path):
    from diffsheg_tpu_torch.cli.main import _base_config, main
    from diffsheg_tpu_torch.compat.torch_ckpt import save_reference_checkpoint
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser

    class Args:
        dataset = "beat"
        set = TINY[1::2]
    model = init_unidiffuser(_base_config(Args).model, seed=4)
    path = save_reference_checkpoint(model, str(tmp_path / "m.tar"))
    built = _patched_server(monkeypatch)
    assert main(["serve", "--device", "cpu", "--port", "0",
                 "--checkpoint", path] + TINY) == 0
    (srv,) = built
    assert torch.equal(srv.model.encoder_ges.out.weight,
                       model.encoder_ges.out.weight)
    with pytest.raises(SystemExit, match="Orbax"):
        main(["serve", "--device", "cpu", "--port", "0",
              "--checkpoint", str(tmp_path)] + TINY)


TRAIN_SETS = [["train.batch_size=64", "train.loss_type=kl"],
              ["train.vel_loss_start=10", "train.use_sem_weighting=false",
               "train.timestep_sampler=loss-second-moment"],
              ["mesh.data_parallel=4", "train.reset_lr=1"]]


@pytest.mark.parametrize("dataset", ["beat", "show"])
@pytest.mark.parametrize("sets", TRAIN_SETS, ids=[",".join(s)
                                                  for s in TRAIN_SETS])
def test_set_train_and_mesh_overrides_match_jax(dataset, sets):
    import diffsheg_tpu.cli.main as J
    import diffsheg_tpu_torch.cli.main as P

    class Args:
        set = sets
    Args.dataset = dataset
    sections = ("train", "mesh")
    assert _fields(P._base_config(Args), sections) == _fields(
        J._base_config(Args), sections)


def _train_cache(path, n=16, T=8, seed=0):
    import numpy as np
    from diffsheg_tpu_torch.data.cache import CacheWriter
    rs = np.random.RandomState(seed)
    w = CacheWriter(str(path), meta={"n_poses": T})
    for _ in range(n):
        w.add({"pose": rs.randn(T, 141).astype(np.float32),
               "pose_axis_angle": rs.randn(T, 141).astype(np.float32),
               "mel": rs.randn(T, 128).astype(np.float32),
               "facial": rs.randn(T, 51).astype(np.float32),
               "sem": rs.rand(T).astype(np.float32),
               "id": np.asarray([rs.randint(30)], np.int32)})
    w.finalize()
    return str(path)


def test_cli_train_resumes_and_feeds_generate(tmp_path, capsys):
    """``cli train --device cpu`` on a tiny cache, ``--resume`` for one
    more epoch, then ``generate --checkpoint <workdir>/ckpt`` samples
    with the newest checkpoint's weights."""
    import json
    import wave
    import numpy as np
    from diffsheg_tpu_torch.cli.main import _base_config, _load_model, main
    cache = _train_cache(tmp_path / "cache")
    val = _train_cache(tmp_path / "val", n=8, seed=1)
    work = str(tmp_path / "run")
    flags = (["train", "--device", "cpu", "--workdir", work,
              "--train-cache", cache, "--val-cache", val,
              "--set", "data.n_poses=8", "--set", "train.batch_size=8",
              "--set", "train.log_every=1",
              "--set", "train.eval_every_epochs=2"] + TINY)
    assert main(flags + ["--epochs", "1"]) == 0
    assert main(flags + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at epoch 1 (it 2)" in out and "epoch 2/2" in out
    ckpt = tmp_path / "run" / "ckpt"
    assert sorted(p.name for p in (ckpt / "latest").iterdir()) == ["1", "2"]
    recs = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert sum("total" in r for r in recs) == 4
    assert sum("val_mse" in r for r in recs) == 1
    assert (ckpt / "mse_best" / "state.pt").exists()

    class Args:
        dataset = "beat"
        set = TINY[1::2]
    model = _load_model(_base_config(Args), str(ckpt))
    saved = torch.load(ckpt / "latest" / "2" / "state.pt",
                       weights_only=True)["model"]
    assert all(torch.equal(v, saved[k]) for k, v in
               model.state_dict().items())
    wav = str(tmp_path / "a.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.RandomState(2).randn(16000) * 3000)
                      .astype("<i2").tobytes())
    assert main(["generate", "--device", "cpu", "--checkpoint", str(ckpt),
                 "--audio", wav, "--speakers", "1", "--out-dir",
                 str(tmp_path / "out")] + TINY) == 0
    assert "generated (1, 15, 192)" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    # the on-device speech frontend now trains, on a cache with raw audio
    pytest.param(["--set", "train.on_device_frontend=true"],
                 None, id="argv1-on_device_frontend"),
    pytest.param(["--set", "mesh.fsdp_parallel=2"], r"mesh 0x2 != 1 devices",
                 id="argv2-data-parallel and FSDP"),
])
def test_cli_train_refusals(tmp_path, argv, match):
    import json
    import numpy as np
    from diffsheg_tpu_torch.cli.main import main
    from diffsheg_tpu_torch.data.cache import CacheWriter
    cache = _train_cache(tmp_path / "cache", n=2)
    flags = ["train", "--device", "cpu", "--workdir", str(tmp_path / "w"),
             "--train-cache", cache] + TINY + argv
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            main(flags)
        return
    with pytest.raises(ValueError, match="raw 'audio' field"):
        main(flags)             # JAX's error: the cache holds no audio
    rs = np.random.RandomState(0)
    w = CacheWriter(str(tmp_path / "audio"), meta={"n_poses": 34})
    for i in range(2):
        w.add({"pose": rs.randn(34, 141), "pose_axis_angle": rs.randn(34, 141),
               "mel": rs.randn(34, 128), "facial": rs.randn(34, 51),
               "sem": rs.rand(34), "id": np.asarray([i], np.int32),
               "audio": (rs.randn(36266) * 0.1).astype(np.float32)})
    w.finalize()
    flags[flags.index(cache)] = str(tmp_path / "audio")
    assert main(flags + ["--epochs", "1", "--set",
                         "train.log_every=1"]) == 0
    recs = [json.loads(x) for x in open(tmp_path / "w" / "metrics.jsonl")]
    assert sum("total" in r for r in recs) == 1


@pytest.mark.parametrize("preset", ["beat", "show"])
def test_config_json_round_trips_with_jax(preset):
    from diffsheg_tpu import config as J
    from diffsheg_tpu_torch import config as P
    sets = ["diffusion.scan_unroll=3", "model.latent_dim=96"]
    import diffsheg_tpu.cli.main as JC
    import diffsheg_tpu_torch.cli.main as PC
    jcfg = JC._apply_overrides(getattr(J, f"{preset}_config")(), sets)
    pcfg = PC._apply_overrides(getattr(P, f"{preset}_config")(), sets)
    assert P.Config.from_json(jcfg.to_json()) == pcfg
    assert pcfg.diffusion.scan_unroll == 3
    assert J.Config.from_json(pcfg.to_json()) == jcfg


def test_serve_takes_seed(monkeypatch):
    from diffsheg_tpu_torch.cli.main import build_parser, main
    built = _patched_server(monkeypatch)
    assert main(["serve", "--device", "cpu", "--port", "0", "--seed", "7"]
                + TINY) == 0
    assert len(built) == 1
    assert build_parser().parse_args(["serve", "--seed", "7"]).seed == 7


def _fgd_checkpoint(path, T=34, C=192):
    """A reference-layout FGD autoencoder file (ae_300.bin) of a seeded
    net, with the options Namespace the reference saves beside it."""
    import argparse
    from torch_parity import reference_fgd_state_dict
    torch.save({"args": argparse.Namespace(vae_length=300), "epoch": 1,
                "model_state": reference_fgd_state_dict(T, C, seed=5)},
               str(path))
    return str(path)


def test_cli_train_with_fgd_and_hubert_checkpoints(tmp_path):
    # --fgd-checkpoint: the evaluation reports FGD and keeps fgd_best;
    # --hubert-checkpoint is accepted (the on-device frontend it feeds is
    # refused for now) and unused, as in JAX
    import json
    from diffsheg_tpu_torch.cli.main import main
    cache = _train_cache(tmp_path / "cache", n=8, T=34)
    val = _train_cache(tmp_path / "val", n=4, T=34, seed=1)
    work = tmp_path / "run"
    assert main(["train", "--device", "cpu", "--workdir", str(work),
                 "--train-cache", cache, "--val-cache", val,
                 "--fgd-checkpoint", _fgd_checkpoint(tmp_path / "ae.bin"),
                 "--hubert-checkpoint", str(tmp_path / "no-hubert"),
                 "--epochs", "1", "--set", "train.batch_size=4",
                 "--set", "train.eval_every_epochs=1"] + TINY) == 0
    recs = [json.loads(x) for x in open(work / "metrics.jsonl")]
    fgd = [r["val_fgd"] for r in recs if "val_fgd" in r]
    assert len(fgd) == 1 and fgd[0] == fgd[0] and fgd[0] > 0
    assert (work / "ckpt" / "fgd_best" / "state.pt").exists()


def _whole_clips(path, lengths=(50, 40), seed=2):
    import numpy as np
    from diffsheg_tpu_torch.data.cache import CacheWriter
    rs = np.random.RandomState(seed)
    w = CacheWriter(str(path), meta={"n_poses": 34, "is_test": True})
    for i, T in enumerate(lengths):
        w.add({"pose": rs.randn(T, 141).astype(np.float32),
               "pose_axis_angle": (rs.randn(T, 141) * 0.3).astype(np.float32),
               "audio": (rs.randn(int(T / 15 * 16000)) * 0.05).astype(
                   np.float32),
               "mel": rs.randn(T, 128).astype(np.float32),
               "facial": (rs.randn(T, 51) * 0.3).astype(np.float32),
               "sem": rs.rand(T).astype(np.float32),
               "id": np.asarray([i], np.int32)})
    w.finalize()
    return str(path)


def test_cli_eval_and_test_stream_on_cpu(tmp_path, capsys):
    import json
    import numpy as np
    from diffsheg_tpu_torch.cli.main import main
    from diffsheg_tpu_torch.data.beat import BeatStats
    from torch_parity import beat_template_text
    fgd = _fgd_checkpoint(tmp_path / "ae.bin")
    val = _train_cache(tmp_path / "val", n=4, T=34, seed=1)
    assert main(["eval", "--device", "cpu", "--val-cache", val,
                 "--fgd-checkpoint", fgd, "--workdir", str(tmp_path / "w")]
                + TINY) == 0
    out = capsys.readouterr().out
    ev = json.loads(out[out.index("{"):])
    assert sorted(ev) == ["diversity", "fgd", "mse", "pck", "pck2"]
    assert all(np.isfinite(v) for v in ev.values())
    assert (tmp_path / "w" / "config.json").exists()
    # test-stream: the exporter with a template BVH and players, FGD
    rs = np.random.RandomState(3)
    stats = str(tmp_path / "stats")
    BeatStats(rs.randn(141), 1 + rs.rand(141), rs.randn(141) * 0.1,
              0.5 + rs.rand(141), rs.rand(51), 0.5 + rs.rand(51)).save(stats)
    (tmp_path / "t.bvh").write_text(beat_template_text(frames=1, seed=4))
    test = _whole_clips(tmp_path / "test")
    flags = ["test-stream", "--device", "cpu", "--test-cache", test,
             "--stats-dir", stats, "--template-bvh", str(tmp_path / "t.bvh"),
             "--out-dir", str(tmp_path / "ts"), "--fgd-checkpoint", fgd,
             "--srgr-avg-weight", "0.165"] + TINY
    assert main(flags + ["--player", "--max-clips", "1"]) == 0
    out = capsys.readouterr().out
    m = json.loads(out[out.index("{"):])
    assert m["clips"] == 1.0 and m["srgr_norm"] == 0.165
    assert "fgd" not in m                 # one window: no covariance
    assert sorted(p.name for p in (tmp_path / "ts").iterdir()) == [
        "clip_00000.bvh", "clip_00000.npy", "clip_00000_face.json",
        "clip_00000_player.html"]
    assert main(flags) == 0
    out = capsys.readouterr().out
    m = json.loads(out[out.index("{"):])
    assert m["clips"] == 2.0 and np.isfinite(m["fgd"])
    # --output-gt writes the ground truth, as the JAX command does
    import diffsheg_tpu.cli.main as J
    for mod, tag in ((J, "j"), (None, "p")):
        argv = ["test-stream", "--test-cache", test, "--stats-dir", stats,
                "--out-dir", str(tmp_path / tag), "--output-gt"] + TINY
        if mod is None:
            assert main(argv[:1] + ["--device", "cpu"] + argv[1:]) == 0
        else:
            assert J.main(argv[:1] + ["--platform", "cpu"] + argv[1:]) == 0
        out = capsys.readouterr().out
        m = json.loads(out[out.index("{"):])
        m.pop("fps")
        if tag == "j":
            want = m
    assert m.keys() == want.keys()
    for k in want:
        if isinstance(want[k], str):
            assert m[k] == want[k], k
        else:
            np.testing.assert_allclose(m[k], want[k], rtol=0, atol=1e-9,
                                       err_msg=k)
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / "p_GT" / f"clip_0000{i}.npy"),
            np.load(tmp_path / "j_GT" / f"clip_0000{i}.npy"))

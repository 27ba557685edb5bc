"""Command-line entry points of the port.

Counterpart of ``diffsheg_tpu/cli/main.py``:

  python -m diffsheg_tpu_torch.cli build-cache --dataset beat \\
      --data-root data/BEAT --split train --stats-dir stats/ --out cache/train
  python -m diffsheg_tpu_torch.cli train --dataset beat --workdir runs/beat \\
      --train-cache cache/train --hubert-cache cache/hubert --resume
  torchrun --nproc-per-node 4 -m diffsheg_tpu_torch.cli train \\
      --dataset beat --workdir runs/beat --train-cache cache/train \\
      --set train.on_device_frontend=true --hubert-checkpoint hubert-large/
  python -m diffsheg_tpu_torch.cli eval --dataset beat --val-cache cache/val \\
      --checkpoint runs/beat/ckpt --fgd-checkpoint ae_300.bin
  python -m diffsheg_tpu_torch.cli test-stream --dataset beat \\
      --test-cache cache/test --checkpoint runs/beat/ckpt --stats-dir stats/ \\
      --template-bvh template.bvh --fgd-checkpoint ae_300.bin
  python -m diffsheg_tpu_torch.cli generate --dataset beat --audio clip.wav \\
      --checkpoint model.tar --hubert-checkpoint hubert-large/ \\
      --stats-dir stats/ --template-bvh template.bvh --speakers 1,3,5,7
  python -m diffsheg_tpu_torch.cli serve --dataset beat \\
      --checkpoint model.tar --hubert-checkpoint hubert-large/ --prewarm 1
  python -m diffsheg_tpu_torch.cli train --dataset beat --workdir runs/wavlm \\
      --train-cache cache/train --set train.on_device_frontend=true \\
      --speech-encoder wavlm-large --hubert-checkpoint wavlm-large/
  python -m diffsheg_tpu_torch.cli export-ckpt --checkpoint model.tar \\
      --out copy.tar
  python -m diffsheg_tpu_torch.cli view --bvh out/clip_0.bvh
  python -m diffsheg_tpu_torch.cli doctor --calibrate

with the JAX commands' flags, ``--device {cuda,cpu}`` (default ``cuda``;
it raises without a card) where JAX has ``--platform``, and any config
field reachable through ``--set section.field=value``.  ``--checkpoint``
takes a reference ``.tar`` (``compat/torch_ckpt.py``) or a training
checkpoint directory of the port (``<workdir>/ckpt``, its newest
``latest`` step); Orbax directories are the JAX package's format and are
refused.  ``--fgd-checkpoint`` takes the reference's frozen FGD
autoencoder (``ae_300.bin`` / ``gesture_expression.pth.tar``,
``compat/fgd_ckpt.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import tempfile
from typing import List, Optional

from diffsheg_tpu_torch.config import Config, beat_config, resolve, show_config


def _override_error(kind: str, name: str, valid, item: str) -> SystemExit:
    choices = ", ".join(sorted(valid))
    return SystemExit(
        f"--set {item!r}: unknown {kind} {name!r}. Valid {kind}s: {choices}")


def _apply_overrides(cfg: Config, sets: List[str]) -> Config:
    """``--set model.latent_dim=256`` style dotted overrides."""
    for item in sets:
        path, eq, raw = item.partition("=")
        section, dot, field = path.partition(".")
        if not eq or not dot:
            raise SystemExit(
                f"--set {item!r}: expected section.field=value "
                "(e.g. --set model.latent_dim=256)")
        sections = [f.name for f in dataclasses.fields(cfg)
                    if dataclasses.is_dataclass(getattr(cfg, f.name))]
        if section not in sections:
            raise _override_error("section", section, sections, item)
        sub = getattr(cfg, section)
        fields = {f.name for f in dataclasses.fields(sub)}
        if field not in fields:
            raise _override_error("field", f"{section}.{field}", fields, item)
        old = getattr(sub, field)
        try:
            val = _coerce(old, raw)
        except ValueError:
            raise SystemExit(
                f"--set {item!r}: cannot parse {raw!r} as "
                f"{type(old).__name__} (current value: {old!r})") from None
        cfg = cfg.replace(**{section: dataclasses.replace(sub,
                                                          **{field: val})})
    return cfg


def _coerce(old, raw: str):
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    return raw


def _base_config(args) -> Config:
    cfg = beat_config() if args.dataset == "beat" else show_config()
    if args.set:
        cfg = _apply_overrides(cfg, args.set)
    return resolve(cfg)


def _load_model(cfg: Config, checkpoint: Optional[str]):
    """The model ``cfg`` describes (any ``branch_mode`` / ``model_base``),
    random, from a reference ``.tar``, or from the newest checkpoint of a
    training directory of the port."""
    from diffsheg_tpu_torch.models.factory import build_denoiser, init_denoiser
    if not checkpoint:
        print("WARNING: no checkpoint given, using random init",
              file=sys.stderr)
        return init_denoiser(cfg.model, seed=0)
    if os.path.isdir(checkpoint):
        from diffsheg_tpu_torch.train.checkpoint import load_model_weights
        if not os.path.isdir(os.path.join(checkpoint, "latest")):
            raise SystemExit(
                f"--checkpoint {checkpoint}: not a training checkpoint "
                "directory of the port (latest/<step>/state.pt); a "
                "directory (an Orbax checkpoint) is the JAX package's "
                "format: export it as a reference .tar (python -m "
                "diffsheg_tpu.cli export-ckpt) and pass the .tar")
        try:
            return load_model_weights(checkpoint,
                                      build_denoiser(cfg.model))
        except ValueError as e:
            raise SystemExit(f"--checkpoint {checkpoint}: {e}") from None
    from diffsheg_tpu_torch.compat.torch_ckpt import load_reference_checkpoint
    return load_reference_checkpoint(checkpoint, cfg.model)


def _load_hubert(cfg: Config, path: Optional[str], hubert_config=None):
    """The speech encoder's weights of ``--hubert-checkpoint`` (a local HF
    checkpoint) in ``hubert_config``'s layout (``--speech-encoder``;
    default HuBERT-large), or None."""
    if not (path and cfg.model.add_hubert):
        return None
    from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
    return load_hf_hubert(path, hubert_config)


def _speech_encoder(args):
    """The ``HubertConfig`` that ``--speech-encoder`` names, or None."""
    if args.speech_encoder is None:
        return None
    from diffsheg_tpu_torch.models.hubert import speech_encoder_config
    return speech_encoder_config(args.speech_encoder)


def _load_stats(args):
    """Dataset-appropriate normalization stats (or None)."""
    if not args.stats_dir:
        return None
    if args.dataset == "show":
        from diffsheg_tpu_torch.data.show import ShowStats
        path = args.stats_dir
        if not path.endswith(".npy"):
            path = os.path.join(path, "talkshow_mean_std.npy")
        return ShowStats.load(path)
    from diffsheg_tpu_torch.data.beat import BeatStats
    return BeatStats.load(args.stats_dir)


def _load_fgd_net(args, cfg: Config, device):
    """The reference's frozen FGD autoencoder of ``--fgd-checkpoint``
    (ae_300.bin / gesture_expression.pth.tar) on ``device``, or None."""
    if not args.fgd_checkpoint:
        return None
    from diffsheg_tpu_torch.compat.fgd_ckpt import load_torch_fgd_checkpoint
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig
    return load_torch_fgd_checkpoint(args.fgd_checkpoint, FgdNetConfig(
        n_frames=cfg.data.n_poses, pose_dim=cfg.model.motion_dim), device)


def _open_dataset(args, cfg, cache_path, hubert_cache=None):
    if args.dataset == "show":
        from diffsheg_tpu_torch.data.show import ShowDataset
        if not args.stats_dir:
            raise SystemExit("--stats-dir required for show (a "
                             "talkshow_mean_std.npy file or its directory)")
        return ShowDataset(cache_path, _load_stats(args),
                           hubert_cache_dir=hubert_cache,
                           remove_hand=cfg.data.remove_hand,
                           audio_feat=cfg.data.audio_feat,
                           n_mfcc=cfg.data.n_mfcc, device=args.device)
    from diffsheg_tpu_torch.data.beat import BeatDataset
    return BeatDataset(cache_path, _load_stats(args),
                       hubert_cache_dir=hubert_cache,
                       remove_hand=cfg.data.remove_hand,
                       include_audio=cfg.train.on_device_frontend)


def cmd_train(args) -> int:
    """Train from a cache: epochs of the training step, metrics.jsonl,
    checkpoints under ``<workdir>/ckpt``, periodic evaluation on
    ``--val-cache`` (FGD with ``--fgd-checkpoint``).  With
    ``train.on_device_frontend`` the batches carry the cache's raw audio
    and ``--hubert-checkpoint`` is the speech frontend's HuBERT; it is
    unused otherwise, as in JAX.  Under ``torchrun --nproc-per-node N``
    each process trains on its block of every global batch, rounded to a
    multiple of N."""
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.device import (init_distributed, resolve_device,
                                           shutdown_distributed)
    from diffsheg_tpu_torch.parallel.collectives import (process_count,
                                                         process_index)
    from diffsheg_tpu_torch.train.trainer import Trainer, check_trainable
    device = init_distributed(resolve_device(args.device))
    try:
        cfg = _base_config(args)
        try:
            check_trainable(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        train_ds = _open_dataset(args, cfg, args.train_cache,
                                 hubert_cache=args.hubert_cache)
        val_ds = (_open_dataset(args, cfg, args.val_cache)
                  if args.val_cache else None)
        n = process_count()
        batch = min(cfg.train.batch_size, len(train_ds))
        batch = max(n, batch - batch % n)

        def loader(ds):
            return ShardedBatchLoader(ds, global_batch_size=batch,
                                      seed=cfg.train.seed,
                                      process_index=process_index(),
                                      process_count=n)

        hubert_model, speech = None, _speech_encoder(args)
        if cfg.train.on_device_frontend and cfg.model.add_hubert:
            hubert_model = _load_hubert(cfg, args.hubert_checkpoint, speech)
            if hubert_model is None:
                print("WARNING: train.on_device_frontend with "
                      "model.add_hubert but no --hubert-checkpoint — speech "
                      "features come from a RANDOM-INIT encoder.",
                      file=sys.stderr)
        trainer = Trainer(cfg, args.workdir, device=device,
                          fgd_net=_load_fgd_net(args, cfg, device),
                          hubert_model=hubert_model, hubert_config=speech)
        if args.resume:
            trainer.try_resume()
        trainer.fit(loader(train_ds), loader(val_ds) if val_ds else None,
                    num_epochs=args.epochs or None)
    finally:
        shutdown_distributed()
    return 0


def cmd_build_cache(args) -> int:
    """Build a dataset cache from a raw split: BEAT (``bvh_rot``,
    ``wave16k``, ``facial52``, ``sem``; statistics computed into
    ``--stats-dir`` when it has none) or SHOW (``.npz`` sequences;
    ``talkshow_mean_std.npy``).  The mel, MFCC and axis-angle conversion
    run on ``--device``."""
    from diffsheg_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    cfg = _base_config(args)
    split_dir = os.path.join(args.data_root, args.split)
    out = args.out or os.path.join(args.data_root, f"cache_{args.split}")
    if args.dataset == "show":
        import numpy as np
        from diffsheg_tpu_torch.data.show_cache import (ShowBuildConfig,
                                                        build_show_cache,
                                                        compute_show_stats,
                                                        iter_npz_dir)
        sc = ShowBuildConfig(n_poses=cfg.data.n_poses,
                             stride=cfg.data.stride,
                             pose_fps=cfg.data.fps, mel_sr=cfg.data.mel_sr,
                             mel_hop=cfg.data.mel_hop, n_mels=cfg.data.n_mels)
        if args.stats_dir:
            os.makedirs(args.stats_dir, exist_ok=True)
            stats_path = os.path.join(args.stats_dir,
                                      "talkshow_mean_std.npy")
            if not os.path.exists(stats_path):
                print("computing show statistics...")
                np.save(stats_path,
                        compute_show_stats(iter_npz_dir(split_dir)))
        n = build_show_cache(iter_npz_dir(split_dir), out, sc,
                             is_test=args.split == "test", device=device)
        print(f"show cache: {n} samples -> {out}")
        return 0
    from diffsheg_tpu_torch.data.beat import (BeatBuildConfig, BeatStats,
                                              build_beat_cache,
                                              compute_beat_stats)
    bc = BeatBuildConfig(n_poses=cfg.data.n_poses, stride=cfg.data.stride,
                         pose_fps=cfg.data.fps, mel_sr=cfg.data.mel_sr,
                         mel_hop=cfg.data.mel_hop, n_mels=cfg.data.n_mels)
    if args.stats_dir and os.path.exists(
            os.path.join(args.stats_dir, "axis_angle_mean.npy")):
        stats = BeatStats.load(args.stats_dir)
    else:
        print("computing dataset statistics...")
        stats = compute_beat_stats(split_dir, bc, device=device)
        if args.stats_dir:
            stats.save(args.stats_dir)
    n = build_beat_cache(split_dir, out, stats, bc,
                         is_test=args.split == "test", device=device)
    print(f"cache: {n} samples -> {out}")
    return 0


def cmd_eval(args) -> int:
    """The validation metrics of ``Trainer.evaluate`` (FGD with
    ``--fgd-checkpoint``) on ``--val-cache``, for ``--checkpoint``'s model
    (without one, the trainer's seeded initialisation); prints them as
    JSON."""
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.device import resolve_device
    from diffsheg_tpu_torch.train.trainer import Trainer
    device = resolve_device(args.device)
    cfg = _base_config(args)
    ds = _open_dataset(args, cfg, args.val_cache)
    with tempfile.TemporaryDirectory(prefix="diffsheg_eval") as tmp:
        trainer = Trainer(cfg, args.workdir or tmp, device=device,
                          fgd_net=_load_fgd_net(args, cfg, device))
        if args.checkpoint:
            trainer.state.model.load_state_dict(
                _load_model(cfg, args.checkpoint).state_dict())
        loader = ShardedBatchLoader(ds, global_batch_size=min(32, len(ds)),
                                    shuffle=False)
        res = trainer.evaluate(loader, seed=args.seed)
    print(json.dumps(res.as_dict(), indent=2))
    return 0


def cmd_test_stream(args) -> int:
    """The reference's ``test_arbitrary_len``: stream every whole clip of
    ``--test-cache``, save each (npy; with ``--stats-dir`` on BEAT the
    de-normalized npy, face JSON and, with ``--template-bvh``, a BVH),
    print the metrics as JSON."""
    from diffsheg_tpu_torch.device import resolve_device
    from diffsheg_tpu_torch.sampling.testset import generate_testset
    device = resolve_device(args.device)
    cfg = _base_config(args)
    ds = _open_dataset(args, cfg, args.test_cache)
    model = _load_model(cfg, args.checkpoint)
    exporter = None
    if args.dataset == "beat" and args.stats_dir:
        from diffsheg_tpu_torch.sampling.export import BeatMotionExporter
        st = _load_stats(args)
        exporter = BeatMotionExporter(
            cfg.model.pose_dim, cfg.data.fps, st.motion_mean, st.motion_std,
            template_bvh=args.template_bvh, player=args.player,
            device=device)
    metrics = generate_testset(
        cfg, model, ds, args.out_dir, seed=args.seed,
        fgd_net=_load_fgd_net(args, cfg, device),
        max_clips=args.max_clips, output_gt=args.output_gt,
        exporter=exporter, srgr_avg_weight=args.srgr_avg_weight,
        device=device)
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_generate(args) -> int:
    """Custom-audio generation: a wav to motion for each speaker style,
    exported as npy + BVH + face JSON (BEAT, with stats) or npy (SHOW)."""
    from diffsheg_tpu_torch.cli.generate import CustomAudioPipeline
    from diffsheg_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    cfg = _base_config(args)
    speakers = [int(s) for s in args.speakers.split(",")]
    bad = [s for s in speakers if not 0 <= s < cfg.model.style_dim]
    if bad:
        raise SystemExit(
            f"speaker ids {bad} out of range for style_dim="
            f"{cfg.model.style_dim} ({args.dataset}); pass --speakers "
            f"in [0, {cfg.model.style_dim - 1}]")
    stats = _load_stats(args)
    mean = stats.motion_mean if stats is not None else None
    std = stats.motion_std if stats is not None else None
    speech = _speech_encoder(args)
    pipe = CustomAudioPipeline(cfg, _load_model(cfg, args.checkpoint),
                               hubert_model=_load_hubert(
                                   cfg, args.hubert_checkpoint, speech),
                               hubert_config=speech,
                               motion_mean=mean, motion_std=std,
                               device=device)
    if args.warmup:
        from diffsheg_tpu_torch.audio.wav import load_wav
        y, sr = load_wav(args.audio)
        pipe.warmup(len(y) / sr, num_speakers=len(speakers))
    res = pipe.generate(args.audio, speakers, seed=args.seed)
    print(f"generated {res.motion.shape} | {res.fps:.1f} FPS "
          f"({res.rtf:.2f}x real-time) | stages: "
          + " ".join(f"{k}={v:.3f}s" for k, v in res.stages.items()))
    name = os.path.splitext(os.path.basename(args.audio))[0]
    if args.dataset == "beat" and mean is not None:
        files = pipe.export_beat(res.motion, args.out_dir, name,
                                 template_bvh=args.template_bvh,
                                 player=args.player)
    else:
        files = pipe.export_show(res.motion, args.out_dir, name,
                                 stats=stats)
    print("\n".join(files))
    return 0


def cmd_export_ckpt(args) -> int:
    """Re-export a model's weights as a reference-format ``.tar`` (what
    the upstream torch harness loads)."""
    from diffsheg_tpu_torch.compat.torch_ckpt import save_reference_checkpoint
    cfg = _base_config(args)
    model = _load_model(cfg, args.checkpoint)
    path = save_reference_checkpoint(model, args.out, epoch=args.epoch)
    print(f"exported: {path}")
    return 0


def cmd_view(args) -> int:
    """Write the self-contained HTML player for an exported BVH (+ face
    JSON)."""
    from diffsheg_tpu_torch.viz.player import export_bvh_player
    if args.stride < 1:
        raise SystemExit(f"--stride must be >= 1, got {args.stride}")
    out = args.out or (os.path.splitext(args.bvh)[0] + "_player.html")
    path = export_bvh_player(args.bvh, out, face_json=args.face,
                             stride=args.stride)
    print(f"player: {path}")
    return 0


def cmd_serve(args) -> int:
    """Streaming serving daemon: one TCP connection = one live session
    (push audio chunks, receive motion as windows complete).  ``--seed``
    is accepted and unused, as in JAX: each session's client sends its
    seed."""
    from diffsheg_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    cfg = _base_config(args)
    model = _load_model(cfg, args.checkpoint)

    hubert_fe = None
    if cfg.model.add_hubert:
        from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
        if not args.hubert_checkpoint:
            print("WARNING: model.add_hubert is on but no "
                  "--hubert-checkpoint was given — speech features come "
                  "from a RANDOM-INIT encoder.", file=sys.stderr)
        speech = _speech_encoder(args)
        hubert_fe = HubertFeatureExtractor(
            speech, model=_load_hubert(cfg, args.hubert_checkpoint, speech),
            device=device)

    from diffsheg_tpu_torch.serving.server import MotionServer
    server = MotionServer(cfg, model, hubert_extractor=hubert_fe,
                          host=args.host, port=args.port,
                          max_sessions=args.max_sessions,
                          max_batch=args.max_batch,
                          idle_timeout=args.idle_timeout,
                          client_geometry=args.client_geometry,
                          max_stream_seconds=args.max_stream_seconds,
                          device=device)
    if args.prewarm:
        try:
            sizes = tuple(int(x) for x in args.prewarm.split(","))
        except ValueError:
            raise SystemExit(f"--prewarm {args.prewarm!r}: expected "
                             "comma-separated batch sizes, e.g. 1,2,4") from None
        server.prewarm(sizes)

    # SIGTERM drains like Ctrl-C: stop accepting, give in-flight sessions
    # shutdown()'s bounded grace, then close
    def _term(signum, frame):
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        server.shutdown()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return 0


def cmd_doctor(args) -> int:
    """Environment diagnostics: versions, the card (bounded probe), dispatch
    latency, the kernels built and each launched once against its plain
    version, the native data plane, the kernels' build cache."""
    from diffsheg_tpu_torch.cli.doctor import run_doctor
    return run_doctor(device_timeout=args.device_timeout, device=args.device,
                      calibrate=args.calibrate)


def build_parser() -> argparse.ArgumentParser:
    from diffsheg_tpu_torch.models.hubert import SPEECH_ENCODERS
    p = argparse.ArgumentParser(prog="diffsheg_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def speech_encoder(sp):
        sp.add_argument("--speech-encoder", choices=list(SPEECH_ENCODERS),
                        help="the speech encoder, and the layout of "
                             "--hubert-checkpoint (default hubert-large); "
                             "without a checkpoint its weights are seeded "
                             "random")

    def common(sp):
        sp.add_argument("--dataset", choices=["beat", "show"],
                        default="beat")
        sp.add_argument("--set", action="append", default=[],
                        help="config override section.field=value")
        sp.add_argument("--seed", type=int, default=0)

    sp = sub.add_parser("train", help="train a model")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where it runs (cuda raises without a card)")
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--train-cache", required=True)
    sp.add_argument("--val-cache")
    sp.add_argument("--hubert-cache",
                    help="a cache whose 'hubert' field holds each training "
                         "window's HuBERT features")
    sp.add_argument("--stats-dir")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--epochs", type=int, default=0)
    sp.add_argument("--fgd-checkpoint",
                    help="reference FGD autoencoder (ae_300.bin / "
                         "gesture_expression.pth.tar) for eval FGD")
    sp.add_argument("--hubert-checkpoint",
                    help="HF HuBERT weights for the on-device speech "
                         "frontend (train.on_device_frontend); unused "
                         "otherwise")
    speech_encoder(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("build-cache", help="build a dataset cache")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the mel, MFCC and axis-angle conversion "
                         "run (cuda raises without a card)")
    sp.add_argument("--data-root", required=True)
    sp.add_argument("--split", default="train")
    sp.add_argument("--stats-dir")
    sp.add_argument("--out")
    sp.set_defaults(fn=cmd_build_cache)

    sp = sub.add_parser("eval", help="run validation metrics")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where it runs (cuda raises without a card)")
    sp.add_argument("--val-cache", required=True)
    sp.add_argument("--checkpoint",
                    help="reference DiffSHEG checkpoint (.tar) or the "
                         "port's training checkpoint directory")
    sp.add_argument("--stats-dir")
    sp.add_argument("--workdir",
                    help="where the trainer writes config.json and "
                         "metrics.jsonl (default: a temporary directory)")
    sp.add_argument("--fgd-checkpoint",
                    help="reference FGD autoencoder checkpoint")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser(
        "test-stream",
        help="arbitrary-length streaming generation over the test split")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where it runs (cuda raises without a card)")
    sp.add_argument("--test-cache", required=True)
    sp.add_argument("--checkpoint",
                    help="reference DiffSHEG checkpoint (.tar) or the "
                         "port's training checkpoint directory; without "
                         "it the weights are random")
    sp.add_argument("--stats-dir")
    sp.add_argument("--out-dir", default="outputs/test_stream")
    sp.add_argument("--max-clips", type=int, default=0)
    sp.add_argument("--fgd-checkpoint",
                    help="reference FGD autoencoder checkpoint")
    sp.add_argument("--output-gt", action="store_true",
                    help="write ground truth instead of generating "
                         "(reference --output_gt)")
    sp.add_argument("--template-bvh",
                    help="full-skeleton vis template; with --stats-dir, "
                         "per-clip BVH + face JSON are exported like the "
                         "reference's test result writing")
    sp.add_argument("--player", action="store_true",
                    help="also write a self-contained HTML player per clip "
                         "(needs --template-bvh)")
    sp.add_argument("--srgr-avg-weight", type=float, default=None,
                    help="SRGR semantic-weight normalizer; 0.165 (the BEAT "
                         "harness's test-split mean) for harness-comparable "
                         "numbers; default: the clip's own mean weight")
    sp.set_defaults(fn=cmd_test_stream)

    sp = sub.add_parser("generate", help="custom-audio generation")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where it runs (cuda raises without a card)")
    sp.add_argument("--audio", required=True)
    sp.add_argument("--checkpoint",
                    help="reference DiffSHEG checkpoint (.tar) or the "
                         "port's training checkpoint directory "
                         "(<workdir>/ckpt); without it the weights are "
                         "random")
    sp.add_argument("--stats-dir")
    sp.add_argument("--out-dir", default="outputs")
    sp.add_argument("--speakers", default="1,3,5,7",
                    help="comma-separated speaker indices")
    sp.add_argument("--template-bvh")
    sp.add_argument("--player", action="store_true",
                    help="also write a self-contained HTML player per clip "
                         "(needs --template-bvh)")
    sp.add_argument("--warmup", action="store_true",
                    help="run once on synthetic audio of the same length "
                         "first, so the reported RTF is steady-state")
    sp.add_argument("--hubert-checkpoint",
                    help="local HF HuBERT-large weights (pytorch_model.bin / "
                         "model.safetensors, or their directory); required "
                         "for faithful output when model.add_hubert is on")
    speech_encoder(sp)
    sp.set_defaults(fn=cmd_generate)

    sp = sub.add_parser(
        "export-ckpt", help="export weights as a reference-format .tar "
                            "(run them in the upstream torch harness)")
    common(sp)
    sp.add_argument("--checkpoint", required=True,
                    help="a reference .tar or the port's training "
                         "checkpoint directory to export")
    sp.add_argument("--out", required=True, help="output .tar path")
    sp.add_argument("--epoch", type=int, default=0,
                    help="epoch number recorded in the tar")
    sp.set_defaults(fn=cmd_export_ckpt)

    sp = sub.add_parser(
        "view", help="self-contained HTML motion player for an exported BVH")
    sp.add_argument("--bvh", required=True)
    sp.add_argument("--face", help="matching face JSON (blendshape bars)")
    sp.add_argument("--out", help="output .html (default: <bvh>_player.html)")
    sp.add_argument("--stride", type=int, default=1,
                    help="frame subsampling for long clips")
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser(
        "serve", help="streaming speech-to-motion serving daemon (TCP; one "
                      "connection = one live session)")
    common(sp)
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where sessions run (cuda raises without a card)")
    sp.add_argument("--checkpoint",
                    help="reference DiffSHEG checkpoint (.tar) or the "
                         "port's training checkpoint directory "
                         "(<workdir>/ckpt); without it the weights are "
                         "random")
    sp.add_argument("--hubert-checkpoint",
                    help="local HF HuBERT-large weights (pytorch_model.bin / "
                         "model.safetensors, or their directory)")
    speech_encoder(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7431)
    sp.add_argument("--max-sessions", type=int, default=8,
                    help="bound on concurrent live sessions")
    sp.add_argument("--max-batch", type=int, default=64,
                    help="bound on speakers (= device batch) per session")
    sp.add_argument("--idle-timeout", type=float, default=600.0,
                    help="seconds of client silence before a session is "
                         "reaped and its slot freed")
    sp.add_argument("--prewarm",
                    help="comma-separated batch sizes to run a silent "
                         "session at before serving (e.g. 1,2): builds the "
                         "generator, its fast-path weights and the kernels")
    sp.add_argument("--client-geometry", action="store_true",
                    help="let clients request custom window_frames/overlap "
                         "(each novel geometry is a new generator with its "
                         "own copy of the weights)")
    sp.add_argument("--max-stream-seconds", type=float, default=3600.0,
                    help="per-session audio cap (a live session retains "
                         "its stream until finish; this bounds its memory)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "doctor", help="check the environment: the card (bounded probe), "
                       "dispatch latency, the kernels, the native data "
                       "plane, the build cache")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu: check the rest without touching a card "
                         "(cuda fails without one)")
    sp.add_argument("--device-timeout", type=float, default=20.0,
                    help="seconds to wait for the card's properties before "
                         "declaring the CUDA runtime hung")
    sp.add_argument("--calibrate", action="store_true",
                    help="run the execution-sanity probes: sustained bf16 "
                         "TFLOP/s against the card's physical envelope, "
                         "dispatch round trip, host<->device bandwidth, "
                         "and a program's kernels recorded by the card")
    sp.set_defaults(fn=cmd_doctor)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

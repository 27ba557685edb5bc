"""Command-line entry point of the port.

Counterpart of ``diffsheg_tpu/cli/main.py`` for the serving daemon:

  python -m diffsheg_tpu_torch.cli serve --dataset beat \\
      --checkpoint model.tar --hubert-checkpoint hubert-large/ --prewarm 1

with the JAX command's flags, ``--device {cuda,cpu}`` (default ``cuda``;
it raises without a card) where JAX has ``--platform``, and any config
field reachable through ``--set section.field=value``.  ``--checkpoint``
takes a reference ``.tar`` (``compat/torch_ckpt.py``); Orbax directories
are the JAX package's format.  The other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
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
    random or from a reference ``.tar``."""
    from diffsheg_tpu_torch.models.factory import init_denoiser
    if not checkpoint:
        print("WARNING: no checkpoint given, using random init",
              file=sys.stderr)
        return init_denoiser(cfg.model, seed=0)
    if os.path.isdir(checkpoint):
        raise SystemExit(
            f"--checkpoint {checkpoint}: a directory (an Orbax checkpoint) "
            "is the JAX package's format; export it as a reference .tar "
            "(python -m diffsheg_tpu.cli export-ckpt) and pass the .tar")
    from diffsheg_tpu_torch.compat.torch_ckpt import load_reference_checkpoint
    return load_reference_checkpoint(checkpoint, cfg.model)


def cmd_serve(args) -> int:
    """Streaming serving daemon: one TCP connection = one live session
    (push audio chunks, receive motion as windows complete)."""
    from diffsheg_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    cfg = _base_config(args)
    model = _load_model(cfg, args.checkpoint)

    hubert_fe = None
    if cfg.model.add_hubert:
        from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
        hubert = None
        if args.hubert_checkpoint:
            from diffsheg_tpu_torch.compat.hubert_ckpt import load_hf_hubert
            hubert = load_hf_hubert(args.hubert_checkpoint)
        else:
            print("WARNING: model.add_hubert is on but no "
                  "--hubert-checkpoint was given — speech features come "
                  "from a RANDOM-INIT encoder.", file=sys.stderr)
        hubert_fe = HubertFeatureExtractor(model=hubert, device=device)

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="diffsheg_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser(
        "serve", help="streaming speech-to-motion serving daemon (TCP; one "
                      "connection = one live session)")
    sp.add_argument("--dataset", choices=["beat", "show"], default="beat")
    sp.add_argument("--set", action="append", default=[],
                    help="config override section.field=value")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where sessions run (cuda raises without a card)")
    sp.add_argument("--checkpoint",
                    help="reference DiffSHEG checkpoint (.tar); without it "
                         "the weights are random")
    sp.add_argument("--hubert-checkpoint",
                    help="local HF HuBERT-large weights (pytorch_model.bin / "
                         "model.safetensors, or their directory)")
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

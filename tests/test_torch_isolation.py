"""The port stands alone: no JAX, Flax or diffsheg_tpu import anywhere in
``diffsheg_tpu_torch`` or in ``chip_smoke.py``, and its entry points run
on the GPU unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffsheg_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffsheg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_file_imports_jax():
    import diffsheg_tpu_torch
    pkg = os.path.dirname(diffsheg_tpu_torch.__file__)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        bad = [m for m in _imports(f) if _forbidden(m)]
        assert not bad, (f, bad)


def test_kernel_sources_are_package_data():
    import diffsheg_tpu_torch.ops.build as build
    for src in build.SOURCES:
        assert (build.CSRC / src).exists()
    # nothing is built at import
    assert not build._loaded


@pytest.mark.parametrize("entry", ["generator", "hubert", "mel", "live",
                                   "server", "cli", "export", "generate",
                                   "cli-generate", "trainer", "cli-train",
                                   "mfcc", "beat-cache", "show-cache",
                                   "fgd-net", "testset", "cli-build-cache",
                                   "cli-eval", "cli-test-stream",
                                   "frontend", "mp-lockstep"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from diffsheg_tpu_torch.audio.hubert_runner import HubertFeatureExtractor
    from diffsheg_tpu_torch.audio.mel import MelFrontend
    from diffsheg_tpu_torch.cli.generate import CustomAudioPipeline
    from diffsheg_tpu_torch.cli.main import main
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise
    from diffsheg_tpu_torch.models.hubert import HubertConfig, HubertModel
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser
    from diffsheg_tpu_torch.sampling.export import BeatMotionExporter
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.live import LiveSession
    from diffsheg_tpu_torch.serving.server import MotionServer
    tiny_hub = HubertConfig(hidden_size=16, num_layers=1, num_heads=2,
                            intermediate_size=32, conv_dim=(8,) * 7)
    import dataclasses
    cfg = beat_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, latent_dim=32, num_layers=1, num_heads=2, ff_size=64,
        hubert_dim=16, hubert_latent_dim=8))
    pid = torch.nn.functional.one_hot(torch.tensor([1]), 30).float()

    def server(**kw):
        srv = MotionServer(cfg, init_unidiffuser(cfg.model), port=0,
                           log=lambda *a: None, **kw)
        srv._server.server_close()
        return srv

    def cli(**kw):
        # stop as SIGTERM does before serving; the drain closes the socket
        def interrupt(self):
            raise KeyboardInterrupt
        monkeypatch.setattr(MotionServer, "serve_forever", interrupt)
        monkeypatch.setattr(MotionServer, "shutdown",
                            lambda self: self._server.server_close())
        dev = ["--device", kw["device"]] if kw else []
        return main(["serve", "--port", "0", "--set", "model.latent_dim=32",
                     "--set", "model.num_layers=1",
                     "--set", "model.add_hubert=false"] + dev)

    def cli_generate(**kw):
        import wave
        wav = str(tmp_path / "a.wav")
        with wave.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(b"\0\0" * 16000)
        dev = ["--device", kw["device"]] if kw else []
        return main(["generate", "--audio", wav, "--speakers", "1",
                     "--out-dir", str(tmp_path / "out"),
                     "--set", "model.latent_dim=32",
                     "--set", "model.num_layers=1",
                     "--set", "model.add_hubert=false"] + dev)

    def cli_train(**kw):
        from diffsheg_tpu_torch.data.cache import CacheWriter
        w = CacheWriter(str(tmp_path / "cache"))
        rs = np.random.RandomState(0)
        for _ in range(2):
            w.add({"pose": rs.randn(8, 141), "pose_axis_angle":
                   rs.randn(8, 141), "mel": rs.randn(8, 128),
                   "facial": rs.randn(8, 51), "sem": rs.rand(8),
                   "id": np.zeros(1, np.int32)})
        w.finalize()
        dev = ["--device", kw["device"]] if kw else []
        return main(["train", "--workdir", str(tmp_path / "run"),
                     "--train-cache", str(tmp_path / "cache"),
                     "--epochs", "1", "--set", "model.latent_dim=32",
                     "--set", "model.num_layers=1",
                     "--set", "model.add_hubert=false"] + dev)

    def beat_split():
        from torch_parity import write_beat_split
        root = tmp_path / "raw"
        if not root.exists():
            write_beat_split(root / "train", {"2_a_0_1_1": dict(secs=3)})
        return root

    def beat_cache(**kw):
        from diffsheg_tpu_torch.data.beat import (build_beat_cache,
                                                  compute_beat_stats)
        split = str(beat_split() / "train")
        stats = compute_beat_stats(split, log=lambda *a: None, device="cpu")
        return build_beat_cache(split, str(tmp_path / "bc"), stats,
                                log=lambda *a: None, **kw)

    def show_cache(**kw):
        from diffsheg_tpu_torch.data.show_cache import build_show_cache
        from torch_parity import write_show_split
        from diffsheg_tpu_torch.data.show_cache import iter_npz_dir
        root = write_show_split(tmp_path / "show", [90])
        return build_show_cache(iter_npz_dir(root), str(tmp_path / "sc"),
                                log=lambda *a: None, **kw)

    def cli_build_cache(**kw):
        dev = ["--device", kw["device"]] if kw else []
        return main(["build-cache", "--data-root", str(beat_split()),
                     "--out", str(tmp_path / "cbc")] + dev)

    def test_cache():
        from diffsheg_tpu_torch.data.cache import CacheWriter
        w = CacheWriter(str(tmp_path / "test"), meta={"is_test": True})
        rs = np.random.RandomState(1)
        w.add({"pose_axis_angle": rs.randn(40, 141), "mel":
               rs.randn(40, 128), "facial": rs.randn(40, 51),
               "pose": rs.randn(40, 141), "id": np.zeros(1, np.int32)})
        w.finalize()
        return str(tmp_path / "test")

    def testset(**kw):
        from diffsheg_tpu_torch.data.beat import BeatDataset
        from diffsheg_tpu_torch.sampling.testset import generate_testset
        return generate_testset(cfg, init_unidiffuser(cfg.model),
                                BeatDataset(test_cache()),
                                str(tmp_path / "ts"), log=lambda *a: None,
                                **kw)

    def cli_eval(**kw):
        dev = ["--device", kw["device"]] if kw else []
        cli_train(device="cpu")
        return main(["eval", "--val-cache", str(tmp_path / "cache"),
                     "--set", "model.latent_dim=32",
                     "--set", "model.num_layers=1",
                     "--set", "model.add_hubert=false",
                     "--set", "data.n_poses=8"] + dev)

    def cli_test_stream(**kw):
        dev = ["--device", kw["device"]] if kw else []
        return main(["test-stream", "--test-cache", test_cache(),
                     "--out-dir", str(tmp_path / "cts"),
                     "--set", "model.latent_dim=32",
                     "--set", "model.num_layers=1",
                     "--set", "model.add_hubert=false"] + dev)

    def mp_lockstep(**kw):
        # a worker of one process; what it sets of torchrun's variables
        # and of torch's threads is undone when the test ends
        from diffsheg_tpu_torch.device import LAUNCH_VARS
        from diffsheg_tpu_torch.parallel import mp_lockstep as mp
        for v in LAUNCH_VARS:
            monkeypatch.setenv(v, "")
            monkeypatch.delenv(v)
        monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
        dev = ["--device", kw["device"]] if kw else []
        return mp.worker_main(["--port", str(mp._free_port()),
                               "--num-processes", "1", "--process-id", "0",
                               "--timeout", "60"] + dev)

    from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
    from diffsheg_tpu_torch.audio.mfcc import MfccFrontend
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig, init_fgd_net
    from diffsheg_tpu_torch.train.trainer import Trainer
    make = {
        "generator": lambda **kw: WindowGenerator(
            cfg, init_unidiffuser(cfg.model), **kw),
        "hubert": lambda **kw: HubertFeatureExtractor(tiny_hub, **kw),
        "mel": lambda **kw: MelFrontend(**kw),
        "live": lambda **kw: LiveSession.create(
            cfg, init_unidiffuser(cfg.model), pid,
            GeneratorNoise(0, kw.get("device", "cpu")), **kw),
        "server": server,
        "cli": cli,
        "export": lambda **kw: BeatMotionExporter(
            141, 15.0, np.zeros(192), np.ones(192), **kw),
        "generate": lambda **kw: CustomAudioPipeline(
            cfg, init_unidiffuser(cfg.model),
            hubert_model=HubertModel(tiny_hub), **kw),
        "cli-generate": cli_generate,
        "trainer": lambda **kw: Trainer(cfg, str(tmp_path / "tr"), **kw),
        "cli-train": cli_train,
        "mfcc": lambda **kw: MfccFrontend(**kw),
        "beat-cache": beat_cache,
        "show-cache": show_cache,
        "fgd-net": lambda **kw: init_fgd_net(FgdNetConfig(), **kw),
        "testset": testset,
        "cli-build-cache": cli_build_cache,
        "cli-eval": cli_eval,
        "cli-test-stream": cli_test_stream,
        "frontend": lambda **kw: make_speech_frontend(
            cfg, HubertModel(tiny_hub), **kw),
        "mp-lockstep": mp_lockstep,
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert make(device="cpu") is not None


def test_chip_smoke_refuses_without_cuda():
    # no card here: the script exits non-zero and prints no result
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_walk_covers_the_slice():
    import diffsheg_tpu_torch as p
    names = {m.name for m in pkgutil.walk_packages(p.__path__, "diffsheg_tpu_torch.")}
    for mod in ("config", "diffusion.schedule", "diffusion.respace",
                "diffusion.jump", "diffusion.sampler", "models.embeddings",
                "models.attention", "models.blocks", "models.denoiser",
                "models.level_cache", "models.fast_forward", "models.hubert",
                "ops.fused_layer", "ops.linear_attention", "ops.step_math",
                "sampling.generator", "sampling.streamer",
                "sampling.pipeline", "sampling.live", "audio.mel",
                "audio.hubert_runner", "compat.from_jax",
                "compat.torch_ckpt", "compat.hubert_ckpt",
                "serving.protocol", "serving.server", "cli.main",
                "audio.wav", "utils.profiling", "utils.filters",
                "geometry.rotations", "geometry.quaternion",
                "geometry.joints", "geometry.bvh", "geometry.face",
                "data.beat", "data.show", "viz.player", "sampling.export",
                "cli.generate", "config", "diffusion.losses",
                "diffusion.timestep_sampler", "train.step",
                "train.checkpoint", "train.trainer", "data.cache",
                "data.loader", "eval.metrics", "utils.logging",
                "runtime", "audio.mfcc", "audio.onsets", "data.show_cache",
                "data.beat_preprocess", "eval.fgd_net", "eval.fgd",
                "compat.fgd_ckpt", "sampling.testset", "audio.resample",
                "audio.frontend", "parallel", "parallel.collectives",
                "parallel.mesh", "parallel.mp_lockstep"):
        assert f"diffsheg_tpu_torch.{mod}" in names, mod


# the modules the port keeps as its own numpy copies: the same public
# functions, classes and constants as the JAX package's (no import of it)
OWN_COPIES = {"geometry/joints.py": None, "geometry/bvh.py": None,
              "geometry/face.py": None, "viz/player.py": None,
              "audio/wav.py": None,
              "data/beat.py": None,
              "data/show.py": {"ShowStats", "extract_gesture",
                               "split_smplx_pose", "standardize",
                               "inv_standardize", "ShowDataset",
                               "combine_expression"},
              "data/cache.py": None, "data/loader.py": {
                  "ShardedBatchLoader"},
              "eval/metrics.py": None,
              "utils/logging.py": None,
              "runtime/__init__.py": {"parse_float_text",
                                      "parse_frames_file", "gather_rows"},
              "audio/mfcc.py": None, "audio/onsets.py": None,
              "data/show_cache.py": None, "data/beat_preprocess.py": None,
              "eval/fgd_net.py": None, "eval/fgd.py": None,
              "compat/fgd_ckpt.py": None, "sampling/testset.py": {
                  "generate_testset"},
              "audio/resample.py": None, "audio/frontend.py": None,
              "parallel/collectives.py": None,
              # the mesh's helpers; JAX's data_sharding, replicated and
              # to_global_replicated place jax.Arrays on devices, while
              # each of the port's processes holds plain tensors of its rows
              "parallel/mesh.py": {"make_mesh", "shard_batch",
                                   "fsdp_sharding", "shard_params_fsdp"},
              # JAX's run_lockstep wraps its own test; the port's callers
              # spawn the workers and run the checks themselves
              "parallel/mp_lockstep.py": {
                  "DS_LEN", "GLOBAL_BATCH", "REPO_ROOT", "SynthDataset",
                  "T_FRAMES", "TestsetSynthClips", "check_collectives",
                  "check_loader_partition", "check_testset_shard",
                  "compute_lockstep", "injected_randoms", "spawn_workers",
                  "testset_payload", "tiny_config", "worker_main"}}


def _public_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(OWN_COPIES))
def test_own_copies_carry_the_jax_modules_names(rel):
    ours = _public_names(os.path.join(ROOT, "diffsheg_tpu_torch", rel))
    ref = _public_names(os.path.join(ROOT, "diffsheg_tpu", rel))
    want = OWN_COPIES[rel] or ref
    assert want <= ref and want <= ours, sorted(want - ours)

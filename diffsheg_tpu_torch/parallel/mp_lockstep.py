"""Multi-process data-parallel training, run for real: the lockstep harness.

The port's counterpart of ``diffsheg_tpu/parallel/mp_lockstep.py``, with
its payload and checks.  The reference spawns one process per GPU and
exchanges gradients over NCCL (reference runner.py:86 ``mp.spawn``, :107
``dist.init_process_group``).  :func:`spawn_workers` spawns N worker
processes (``python -m diffsheg_tpu_torch.parallel.mp_lockstep``), which
join one ``torch.distributed`` group (gloo, on a free local port, a
timeout on every wait) through ``device.py::init_distributed``, on the
card unless ``--device cpu`` asks for the CPU, and each:

  - exercises every function of ``parallel/collectives.py``
    (:func:`check_collectives`) and checks that the loader's process
    blocks tile the epoch (:func:`check_loader_partition`);
  - runs 3 training steps with injected global-batch randomness on its
    loader block (:func:`compute_lockstep`: ``loss_k`` and the parameters'
    L1 norm ``pnorm``), data-parallel or, with ``--fsdp``, sharded by
    ``fully_shard``;
  - optionally evaluates its rows of a batch with ``Trainer.evaluate``
    (:func:`check_evaluate`) and streams its share of a 4-clip test split
    through ``generate_testset`` (:func:`check_testset_shard`).

The parent asserts that the ranks agree bit for bit and that they match
one process at rtol 2e-5 / atol 1e-6 (:func:`check_workers`,
:func:`check_lockstep`), and checks the test-set files and metrics as the
JAX harness's ``_verify_testset`` does (:func:`verify_testset`).  Like
every entry point of the port, each function runs on the card unless its
``device`` names the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

from diffsheg_tpu_torch.device import DeviceLike, resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# -- shared payload ---------------------------------------------------------

GLOBAL_BATCH = 16
T_FRAMES = 6
DS_LEN = 64
HUBERT_DIM = 8


def tiny_config(hubert: bool = False, fsdp: int = 1,
                dropout: bool = False):
    """The JAX harness's small joint model; with ``hubert`` its speech
    features through the conv encoder (whose BatchNorm takes the global
    batch's statistics), with ``dropout`` dropout 0.1 and classifier-free
    null rows (both drawn for the global batch), with ``fsdp`` above 1 its
    parameters sharded."""
    from diffsheg_tpu_torch.config import (Config, DiffusionConfig,
                                           MeshConfig, ModelConfig,
                                           TrainConfig)
    return Config(
        model=ModelConfig(
            pose_dim=8, expression_dim=4, latent_dim=32, num_layers=2,
            num_heads=4, ff_size=64, audio_dim=16, aud_latent_dim=16,
            style_dim=4, add_hubert=hubert, encode_hubert=hubert,
            hubert_dim=HUBERT_DIM, hubert_latent_dim=8,
            dropout=0.1 if dropout else 0.0, classifier_free=dropout,
            null_cond_prob=0.25),
        diffusion=DiffusionConfig(num_steps=50, respacing=""),
        train=TrainConfig(batch_size=GLOBAL_BATCH, use_sem_weighting=False,
                          seed=0),
        mesh=MeshConfig(fsdp_parallel=fsdp),
    )


def beat_payload():
    """The same payload at BEAT's full width (f32, HuBERT features through
    the conv encoder): global batch 256 of 34-frame windows."""
    from diffsheg_tpu_torch.config import beat_config
    return beat_config(), 256, 34


class SynthDataset:
    """Deterministic indexable dataset — identical on every process."""

    def __init__(self, cfg, frames: int = T_FRAMES, length: int = DS_LEN):
        self.C = cfg.model.motion_dim
        self.A = cfg.model.audio_dim
        self.S = cfg.model.style_dim
        self.H = cfg.model.hubert_dim if cfg.model.add_hubert else 0
        self.frames, self.length = frames, length

    def __len__(self):
        return self.length

    def batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        t = np.arange(self.frames)[None, :, None]
        base = idx[:, None, None].astype(np.float32)
        motion = np.sin(0.1 * base * (t + 1)
                        + 0.05 * np.arange(self.C)[None, None, :])
        mel = np.cos(0.07 * base * (t + 1)
                     + 0.03 * np.arange(self.A)[None, None, :])
        pid = np.eye(self.S, dtype=np.float32)[idx % self.S]
        out = {"motion": motion.astype(np.float32),
               "mel": mel.astype(np.float32), "pid": pid}
        if self.H:
            out["hubert"] = (2.0 * np.sin(0.13 * base * (t + 2)
                                          + 0.4 * np.arange(self.H))
                             + 0.5).astype(np.float32)
        return out


def injected_randoms(cfg, batch: int = GLOBAL_BATCH, frames: int = T_FRAMES):
    """Seeded (t, noise) of the global batch — keyed by global row, so
    1-process and N-process runs see the same randomness per row."""
    rng = np.random.RandomState(42)
    t = rng.randint(0, cfg.diffusion.num_steps, size=(batch,))
    noise = rng.randn(batch, frames, cfg.model.motion_dim).astype(np.float32)
    return t.astype(np.int64), noise


def save_weights(path: str, variables) -> None:
    """A Flax variables tree (nested dicts of arrays) -> one ``.npz``."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk(variables, "")
    np.savez(path, **flat)


def load_weights(path: str):
    tree: Dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return tree


# -- the computation under test --------------------------------------------

def compute_lockstep(cfg=None, n_steps: int = 3, weights=None,
                     device: DeviceLike = None, ckpt_dir: str = "",
                     fsdp: bool = False, global_batch: int = GLOBAL_BATCH,
                     frames: int = T_FRAMES) -> Dict[str, float]:
    """Run ``n_steps`` training steps with injected randomness over this
    process's loader block (the whole batch in one process); returns
    {loss_k, pnorm} (and with HuBERT ``bn_mean`` / ``bn_var``, the sums of
    the BatchNorm running statistics).  ``weights``: a Flax variables tree
    to start from (default: the port's seeded init).  ``fsdp``: shard the
    parameters over the mesh's ``fsdp`` dimension (a group must be
    initialised).  ``ckpt_dir``: save the state there after the steps."""
    import torch

    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.diffusion.schedule import (
        get_named_beta_schedule, make_schedule)
    from diffsheg_tpu_torch.models.factory import (build_denoiser,
                                                   init_denoiser)
    from diffsheg_tpu_torch.parallel import collectives as col
    from diffsheg_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from diffsheg_tpu_torch.train.step import (create_train_state,
                                               make_train_step)

    cfg = cfg or tiny_config()
    dev = resolve_device(device)
    sched = make_schedule(get_named_beta_schedule(
        cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
    model = (init_denoiser(cfg.model, seed=cfg.train.seed) if weights is None
             else load_flax_tree(build_denoiser(cfg.model), weights))
    mesh = make_mesh(cfg.mesh, dev.type) if fsdp else None
    state = create_train_state(cfg, model, dev, mesh=mesh)
    step = make_train_step(cfg, sched, inject_randoms=True)
    loader = ShardedBatchLoader(
        SynthDataset(cfg, frames, max(DS_LEN, n_steps * global_batch)),
        global_batch_size=global_batch, seed=cfg.train.seed,
        process_index=col.process_index(),
        process_count=col.process_count(), prefetch=0)
    t_np, noise_np = injected_randoms(cfg, global_batch, frames)

    out: Dict[str, float] = {}
    it = iter(loader)
    for k in range(n_steps):
        batch = shard_batch(next(it), dev)
        state, terms = step(state, batch, torch.from_numpy(t_np),
                            torch.from_numpy(noise_np))
        out[f"loss_{k}"] = float(terms.total)
    out["pnorm"] = params_l1(state.model)
    for key, leaf in (("bn_mean", "running_mean"), ("bn_var", "running_var")):
        bufs = [b for n, b in state.model.named_buffers()
                if n.endswith(leaf)]
        if bufs:
            out[key] = float(sum(b.double().sum() for b in bufs))
    if ckpt_dir:
        from diffsheg_tpu_torch.train.checkpoint import CheckpointManager
        CheckpointManager(ckpt_dir).save_latest(n_steps, state, {})
    return out


def params_l1(model) -> float:
    """Sum of |parameter| over the model (gathered when sharded)."""
    total = 0.0
    for p in model.parameters():
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        total += float(full.detach().double().abs().sum())
    return total


def check_evaluate(device: DeviceLike = None, fsdp: bool = False
                   ) -> Dict[str, float]:
    """``Trainer.evaluate`` of one global batch of the synthetic windows
    (with ``fsdp`` by a trainer whose parameters are sharded over every
    process), each process on its rows, with the evaluation's own noise:
    MSE, PCK, PCK@2 (diversity groups its own rows, so it is not
    compared)."""
    import tempfile

    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.parallel import collectives as col
    from diffsheg_tpu_torch.train.trainer import Trainer

    cfg = tiny_config(fsdp=col.process_count() if fsdp else 1)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, n_poses=T_FRAMES))
    loader = ShardedBatchLoader(
        SynthDataset(cfg), global_batch_size=GLOBAL_BATCH, seed=1,
        process_index=col.process_index(),
        process_count=col.process_count(), prefetch=0)
    with tempfile.TemporaryDirectory() as work:
        res = Trainer(cfg, work, device=device).evaluate(
            loader, seed=9, max_batches=1)
    return {k: getattr(res, k) for k in ("mse", "pck", "pck2")}


def check_collectives(device: DeviceLike = None) -> Dict[str, float]:
    """Exercise every function of parallel/collectives.py."""
    import torch

    from diffsheg_tpu_torch.parallel import collectives as col

    col.barrier("mp_lockstep_start")
    p = col.process_index()
    n = col.process_count()
    # weighted metric mean: process p contributes value (p+1) with weight
    # (p+1) -> expected sum((p+1)^2) / sum(p+1)
    reduced = col.all_reduce_mean_metrics({"m": float(p + 1)},
                                          weight=float(p + 1))
    expect = sum((i + 1) ** 2 for i in range(n)) / sum(i + 1 for i in range(n))
    gathered = col.gather_arrays(np.asarray([p * 10.0, p * 10.0 + 1.0]))
    want = np.concatenate([[i * 10.0, i * 10.0 + 1.0] for i in range(n)])
    # ragged gather: process p contributes p+1 rows
    rag = col.gather_arrays_ragged(
        np.full((p + 1, 2), float(p), dtype=np.float32))
    rag_want = np.concatenate(
        [np.full((i + 1, 2), float(i), dtype=np.float32) for i in range(n)])
    # NaN-safe mean: only rank 0 measured "nm"; nobody measured "none"
    nm = col.all_reduce_nanmean_metrics(
        {"nm": 7.5 if p == 0 else float("nan"), "none": float("nan")},
        weight=float(p + 1))
    # the step's tensor collectives, on the given device
    dev = resolve_device(device)
    mean = col.mean_across_processes_(torch.full((3,), float(p), device=dev))
    rows = col.gather_rows(torch.full((2, 3), float(p), device=dev))
    x = torch.full((2,), float(p + 1), device=dev, requires_grad=True)
    summed = col.sum_across_processes(x)
    (summed * float(p + 1)).sum().backward()
    col.barrier("mp_lockstep_end")
    return {
        "metric_ok": float(abs(reduced["m"] - expect) < 1e-12),
        "gather_ok": float(np.array_equal(gathered, want)),
        "ragged_ok": float(np.array_equal(rag, rag_want)),
        "nanmean_ok": float(abs(nm["nm"] - 7.5) < 1e-12
                            and np.isnan(nm["none"])),
        "tensor_ok": float(
            torch.equal(mean.cpu(), torch.full((3,), (n - 1) / 2))
            and torch.equal(rows.cpu(), torch.arange(n).float()
                            .repeat_interleave(2)[:, None].expand(-1, 3))
            and torch.equal(summed.detach().cpu(),
                            torch.full((2,), n * (n + 1) / 2))
            # d/dx_p of sum_q (q+1) * sum_r x_r = sum_q (q+1)
            and torch.equal(x.grad.cpu(), torch.full((2,), n * (n + 1) / 2))
            and {mean.device.type, rows.device.type,
                 summed.device.type} == {dev.type}),
    }


def check_loader_partition() -> Dict[str, float]:
    """The per-process loader blocks must tile the global epoch order."""
    from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
    from diffsheg_tpu_torch.parallel import collectives as col

    class _IndexDs:
        def __len__(self):
            return DS_LEN

        def batch(self, indices):
            return {"i": np.asarray(indices)}

    ld = ShardedBatchLoader(
        _IndexDs(), global_batch_size=GLOBAL_BATCH, seed=3,
        process_index=col.process_index(),
        process_count=col.process_count(), prefetch=0)
    local = np.concatenate([b["i"] for b in ld])
    world = col.gather_arrays(local)
    n_batches = DS_LEN // GLOBAL_BATCH
    ok_cover = len(np.unique(world)) == n_batches * GLOBAL_BATCH \
        and len(world) == n_batches * GLOBAL_BATCH
    return {"loader_ok": float(ok_cover)}


class TestsetSynthClips:
    """Four deterministic whole-clip samples for the test-set shard check.

    Every clip is two windows long.  Only clips 0-2 carry raw audio: under
    a 2-process stride rank0 (clips 0, 2) is all-audio while rank1 (clips
    1, 3) holds a MIX, so the beat-align reduction must weight by
    audio-clip count, not total clips, to match one process.
    """

    N_CLIPS = 4

    def __init__(self, cfg):
        self.cfg = cfg

    def __len__(self):
        return self.N_CLIPS

    def __getitem__(self, i):
        rs = np.random.RandomState(100 + i)
        c = self.cfg
        T = 2 * c.data.n_poses
        s = {
            "motion": rs.randn(T, c.model.motion_dim).astype(np.float32),
            "mel": (rs.randn(T, c.model.audio_dim) * 0.1).astype(np.float32),
            "id": np.asarray([i % c.model.style_dim]),
        }
        if i < 3:
            sr = c.data.audio_sr
            t = np.arange(int(T / c.data.fps * sr)) / sr
            s["audio"] = (0.1 * np.sin(2 * np.pi * 220 * t)
                          * (np.sin(2 * np.pi * 2.0 * t) > 0)
                          ).astype(np.float32)
        return s


def testset_payload(full_width: bool = False):
    """A streaming config (tiny, or BEAT's full width without HuBERT), its
    model and a full-size FGD net, the same on every process (seeded
    init)."""
    from diffsheg_tpu_torch.config import beat_config
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig, init_fgd_net
    from diffsheg_tpu_torch.models.unidiffuser import init_unidiffuser

    cfg = beat_config()
    small = {} if full_width else dict(latent_dim=16, num_layers=1,
                                       num_heads=2, ff_size=32)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, add_hubert=False,
                                                **small))
    model = init_unidiffuser(cfg.model, seed=11)
    fgd_net = init_fgd_net(FgdNetConfig(n_frames=cfg.data.n_poses,
                                        pose_dim=cfg.model.motion_dim),
                           seed=5, device="cpu")
    return cfg, model, fgd_net, TestsetSynthClips(cfg)


def check_testset_shard(out_dir: str, clips: int = 0,
                        device: DeviceLike = None,
                        full_width: bool = False) -> Dict:
    """``generate_testset`` over this process's share of the clips (the
    first ``clips``, all without): its files, its (reduced) metrics and
    each file's sum."""
    import glob

    from diffsheg_tpu_torch.parallel import collectives as col
    from diffsheg_tpu_torch.sampling.testset import generate_testset

    cfg, model, fgd_net, ds = testset_payload(full_width)
    metrics = generate_testset(cfg, model, ds, out_dir, seed=123,
                               fgd_net=fgd_net, log=lambda *a: None,
                               max_clips=clips, device=device)
    sfx = (f"_rank{col.process_index()}.npy"
           if col.process_count() > 1 else ".npy")
    files = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(out_dir, "*.npy"))
                   if f.endswith(sfx))
    sums = {}
    for f in files:
        arr = np.load(os.path.join(out_dir, f)).astype(np.float64)
        sums[f.split("_rank")[0].replace(".npy", "")] = float(arr.sum())
    return {"testset_metrics": {k: metrics[k] for k in
                                ("mse", "pck", "beat_align", "fgd", "clips")},
            "testset_files": files,
            "testset_sums": sums}


# -- worker entry -----------------------------------------------------------

@contextlib.contextmanager
def kernel_launches():
    """Yields a dict that holds, once the block ends, the launches each
    CUDA kernel of the port made in it, by name and by shape."""
    from diffsheg_tpu_torch.ops.fused_layer import fused_branch, fused_layer
    from diffsheg_tpu_torch.ops.linear_attention import fused_linear_attention
    from diffsheg_tpu_torch.ops.products import gemm_tf32x3
    from diffsheg_tpu_torch.ops.step_math import fused_ddim_repaint_step
    fns = {"fused_branch": fused_branch, "fused_layer": fused_layer,
           "fused_linear_attention": fused_linear_attention,
           "fused_ddim_repaint_step": fused_ddim_repaint_step,
           "gemm_tf32x3": gemm_tf32x3}
    before = {n: f.launches for n, f in fns.items()}
    shapes = {n: dict(fns[n].launches_by_shape)
              for n in ("fused_layer", "fused_linear_attention",
                        "gemm_tf32x3")}
    out: Dict = {}
    yield out
    out.update({n: f.launches - before[n] for n, f in fns.items()})
    for n, old in shapes.items():
        now = fns[n].launches_by_shape
        out[f"{n}_by_shape"] = {"x".join(map(str, k)): v - old.get(k, 0)
                                for k, v in now.items()
                                if v != old.get(k, 0)}


def worker_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; processes share one card) or "
                         "cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the parameters over every process")
    ap.add_argument("--hubert-weights", default="",
                    help="also run the HuBERT-encoder payload from these "
                         "weights (an .npz of save_weights)")
    ap.add_argument("--evaluate", action="store_true",
                    help="also run Trainer.evaluate on this process's rows")
    ap.add_argument("--dropout", action="store_true",
                    help="also run the payload with dropout and "
                         "classifier-free null rows")
    ap.add_argument("--beat", action="store_true",
                    help="the payloads at BEAT's full width: the lockstep "
                         "at a global batch of 256, the test-set stream")
    ap.add_argument("--testset-dir", default="",
                    help="also stream the test-set shard, writing here")
    ap.add_argument("--testset-clips", type=int, default=0,
                    help="stream only the first clips of the test split")
    ap.add_argument("--ckpt-dir", default="",
                    help="save the lockstep state here after the steps")
    args = ap.parse_args(argv)

    import torch

    from diffsheg_tpu_torch.device import (init_distributed,
                                           shutdown_distributed)
    from diffsheg_tpu_torch.parallel import collectives as col
    dev = resolve_device(args.device)
    os.environ.update(RANK=str(args.process_id),
                      WORLD_SIZE=str(args.num_processes),
                      LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(args.port))
    torch.set_num_threads(1)
    if dev.type == "cuda":
        # full f32 products: the parent holds f32 bands
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # gloo: CPU processes, or processes that share one card
    dev = init_distributed(dev, backend="gloo", timeout_s=args.timeout)
    try:
        result = {"process_id": col.process_index(),
                  "processes": col.process_count()}
        result.update(check_collectives(dev))
        result.update(check_loader_partition())
        n = args.num_processes if args.fsdp else 1
        if args.beat:
            cfg, batch, frames = beat_payload()
            lock = dict(cfg=cfg, global_batch=batch, frames=frames)
        else:
            lock = dict(cfg=tiny_config(fsdp=n))
        with kernel_launches() as launches:
            result.update(compute_lockstep(device=dev,
                                           ckpt_dir=args.ckpt_dir,
                                           fsdp=args.fsdp, **lock))
        result["launches"] = launches
        if args.hubert_weights:
            hub = compute_lockstep(tiny_config(hubert=True, fsdp=n),
                                   weights=load_weights(args.hubert_weights),
                                   device=dev, fsdp=args.fsdp)
            result["hubert"] = hub
        if args.evaluate:
            result["evaluate"] = check_evaluate(dev, args.fsdp)
        if args.dropout:
            result["dropout"] = compute_lockstep(
                tiny_config(fsdp=n, dropout=True), device=dev,
                fsdp=args.fsdp)
        if args.testset_dir:
            with kernel_launches() as launches:
                result.update(check_testset_shard(
                    args.testset_dir, args.testset_clips, dev,
                    full_width=args.beat))
            result["testset_launches"] = launches
    finally:
        shutdown_distributed()
    print("MP_RESULT " + json.dumps(result), flush=True)
    return 0


# -- parent harness ---------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_workers(num_processes: int, timeout: float = 300.0,
                  extra: Optional[List[str]] = None) -> List[Dict]:
    """Spawn the workers (``extra``: more worker flags), wait for them at
    most ``timeout`` seconds, and collect their result dicts in rank
    order; kills them all if one fails or the time runs out."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(v, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "diffsheg_tpu_torch.parallel.mp_lockstep",
         "--port", str(port), "--num-processes", str(num_processes),
         "--process-id", str(pid), "--timeout", str(timeout)]
        + list(extra or []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=REPO_ROOT, text=True) for pid in range(num_processes)]
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    "multi-process lockstep worker timed out") from None
            for line in out.splitlines():
                if line.startswith("MP_RESULT "):
                    results.append(json.loads(line[len("MP_RESULT "):]))
                    break
            else:
                raise RuntimeError(
                    f"worker rc={p.returncode} produced no result.\n"
                    f"stdout:\n{out[-2000:]}\nstderr:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def check_workers(workers: List[Dict], num_processes: int) -> None:
    """Every collectives / loader check passed on every worker."""
    assert [w["process_id"] for w in workers] == list(range(num_processes))
    for w in workers:
        assert w["processes"] == num_processes, w
        for key in ("metric_ok", "gather_ok", "ragged_ok", "nanmean_ok",
                    "tensor_ok", "loader_ok"):
            assert w[key] == 1.0, (key, w)


def check_lockstep(results: List[Dict], reference: Dict[str, float],
                   rtol: float = 2e-5, atol: float = 1e-6) -> None:
    """The ranks agree bit for bit, and match ``reference`` (one
    process) at rtol / atol."""
    for key, want in reference.items():
        got = [r[key] for r in results]
        assert max(got) == min(got), (key, got)
        np.testing.assert_allclose(
            got[0], want, rtol=rtol, atol=atol,
            err_msg=f"{key}: multi-process != single-process")


def verify_testset(workers: List[Dict], num_processes: int,
                   single_dir: str, clips: int = 0,
                   device: DeviceLike = None,
                   full_width: bool = False) -> Dict:
    """The multi-process ``generate_testset`` against one process here
    (the workers' ``clips``, ``device`` and width): every clip written
    once by its striding rank, the reduced metrics replicated and equal to
    one process's, each clip's output the same.  Returns the one-process
    result."""
    n_clips = clips or TestsetSynthClips.N_CLIPS
    all_files = sorted(f for w in workers for f in w["testset_files"])
    want = sorted(f"clip_{i:05d}_rank{i % num_processes}.npy"
                  for i in range(n_clips))
    assert all_files == want, (all_files, want)
    for key in ("mse", "pck", "beat_align", "fgd", "clips"):
        got = [w["testset_metrics"][key] for w in workers]
        assert max(got) == min(got), (key, got)

    single = check_testset_shard(single_dir, clips, device, full_width)
    sm, wm = single["testset_metrics"], workers[0]["testset_metrics"]
    assert wm["clips"] == sm["clips"] == float(n_clips), (wm, sm)
    for key in ("mse", "pck", "fgd"):
        np.testing.assert_allclose(
            wm[key], sm[key], rtol=1e-4,
            err_msg=f"testset {key}: multi-process != single-process")
    # only clips 0-2 carry audio (rank1's shard is a mix): agreement here
    # proves the reduction weights by audio-clip count
    np.testing.assert_allclose(wm["beat_align"], sm["beat_align"],
                               rtol=1e-4, err_msg="testset beat_align")
    for base, s in single["testset_sums"].items():
        ws = [w["testset_sums"][base] for w in workers
              if base in w["testset_sums"]]
        assert len(ws) == 1, (base, ws)
        np.testing.assert_allclose(ws[0], s, rtol=1e-5,
                                   err_msg=f"testset clip {base}")
    return single


if __name__ == "__main__":
    sys.exit(worker_main())

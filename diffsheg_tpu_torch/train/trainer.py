"""Training driver: epochs, logging, periodic evaluation, checkpoints.

Counterpart of ``diffsheg_tpu/train/trainer.py``, on the card unless the
caller asks for the CPU, in one process or in several, one card each
(``torchrun``; ``device.py::init_distributed`` joins their group):

  - each epoch runs the step of ``train/step.py`` over a
    ``data/loader.py::ShardedBatchLoader`` (each process its block of
    every global batch); the velocity and x0 terms join the loss from
    epoch ``train.vel_loss_start``;
  - ``mesh.data_parallel`` x ``mesh.fsdp_parallel`` must equal the number
    of processes (``parallel/mesh.py``); with ``fsdp`` above 1 the
    parameters are sharded, otherwise the step averages the gradients;
  - with ``train.on_device_frontend`` the batches carry the cache's raw
    window audio (int16) and the speech frontend (``audio/frontend.py``)
    computes mel and HuBERT on the card before the step and before the
    evaluation's generator;
  - the loss terms (global means) go to ``<workdir>/metrics.jsonl`` every
    ``log_every`` steps (``utils/logging.py``);
  - checkpoints (``train/checkpoint.py``) every epoch (latest, 3 kept),
    every ``save_every_epochs`` (tagged), and on the best FGD / MSE / PCK;
  - every ``eval_every_epochs`` the window generator samples the val
    split (DDIM, the plain program) and scores MSE, PCK, PCK@2 and
    diversity (``eval/metrics.py``), and with an FGD feature net
    (``eval/fgd_net.py``, e.g. the reference's ``ae_300.bin`` through
    ``compat/fgd_ckpt.py``) FGD between the generated and the real
    windows' latents; without one FGD is NaN.  Across processes each
    scores its rows and the metrics are reduced, so every process holds
    the same numbers.

Process 0 writes ``config.json``, the metrics and the checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.config import Config
from diffsheg_tpu_torch.data.loader import ShardedBatchLoader
from diffsheg_tpu_torch.device import (DeviceLike, init_distributed,
                                       resolve_device)
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise, NoiseSource
from diffsheg_tpu_torch.diffusion.schedule import (get_named_beta_schedule,
                                                   make_schedule)
from diffsheg_tpu_torch.models.factory import build_denoiser, random_init_
from diffsheg_tpu_torch.parallel import collectives as col
from diffsheg_tpu_torch.parallel.mesh import (is_fsdp, make_mesh, mesh_shape,
                                              shard_batch)
from diffsheg_tpu_torch.train.checkpoint import CheckpointManager
from diffsheg_tpu_torch.train.step import (TrainState, create_train_state,
                                           make_train_step,
                                           reset_learning_rate, step_seeds)
from diffsheg_tpu_torch.utils.logging import MetricLogger


@dataclasses.dataclass
class EvalResult:
    fgd: float = float("nan")
    mse: float = float("nan")
    # PCK at threshold 0.5 (the reference's, in normalized units) and at
    # 2.0, which still moves while a young model's pck@0.5 sits at its
    # floor-imposed ceiling
    pck: float = float("nan")
    pck2: float = float("nan")
    diversity: float = float("nan")

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def check_trainable(cfg: Config) -> None:
    """Raise when ``mesh.data_parallel`` x ``mesh.fsdp_parallel`` does not
    lay out this run's processes (JAX's mesh-size error)."""
    mesh_shape(cfg.mesh)


class GlobalRowsNoise(GeneratorNoise):
    """``GeneratorNoise`` whose every draw is made for the global batch
    and cut to this process's rows (``collectives.global_rows``), so N
    processes draw what one process draws; one process draws exactly as
    ``GeneratorNoise``."""

    def _draw(self, shape, device):
        first, total = col.global_rows(shape[0])
        full = torch.randn((total,) + tuple(shape[1:]), generator=self.gen,
                           device=device)
        return full[first:first + shape[0]]

    def initial(self, window, shape, device):
        return self._draw(shape, device)

    def step(self, window, step, kind, shape, device):
        return self._draw(shape, device)


class _SilentLogger:
    """The logger of a process other than 0: it writes nothing."""

    def log_metrics(self, step, metrics) -> None:
        pass

    def log_text(self, msg) -> None:
        pass


class Trainer:
    """Owns the train state, its steps, the checkpoint manager and the
    epoch loop.  The model starts from the Flax initialisation's
    distributions (zero output projections) seeded by ``train.seed``, the
    same in every process.  ``fgd_net``: the frozen FGD feature net the
    evaluation embeds with (moved to the trainer's device);
    ``hubert_model``: the frozen HuBERT of the speech frontend (without
    one, seeded random weights of ``hubert_config``'s layout, default
    HuBERT-large)."""

    def __init__(self, cfg: Config, workdir: str,
                 logger: Optional[MetricLogger] = None,
                 device: DeviceLike = None, fgd_net=None,
                 hubert_model=None, hubert_config=None):
        self.device = init_distributed(resolve_device(device))
        _, fsdp = mesh_shape(cfg.mesh)
        self.cfg = cfg
        self.workdir = workdir
        self.rank0 = col.process_index() == 0
        if cfg.train.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        if logger is None:
            logger = (MetricLogger(workdir, name=cfg.name) if self.rank0
                      else _SilentLogger())
        self.logger = logger
        model = random_init_(build_denoiser(cfg.model), cfg.train.seed,
                             perturb=0.0)
        self.schedule = make_schedule(get_named_beta_schedule(
            cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
        mesh = make_mesh(cfg.mesh, self.device.type) if fsdp > 1 else None
        self.state: TrainState = create_train_state(cfg, model, self.device,
                                                    mesh=mesh)
        self._frontend = None
        if cfg.train.on_device_frontend:
            from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
            self._frontend = make_speech_frontend(cfg, hubert_model,
                                                  self.device, hubert_config)
        # two step variants: the epoch-gated velocity / x0 terms
        self._step_full = make_train_step(cfg, self.schedule,
                                          vel_loss_active=True)
        self._step_eps = make_train_step(cfg, self.schedule,
                                         vel_loss_active=False)
        self.ckpt = CheckpointManager(f"{workdir}/ckpt")
        self.epoch = 0
        self.total_it = 0
        self._generator = None  # built at the first evaluation
        self.fgd_net = (None if fgd_net is None
                        else fgd_net.to(self.device).eval())
        if self.rank0:
            os.makedirs(workdir, exist_ok=True)
            with open(os.path.join(workdir, "config.json"), "w") as f:
                f.write(cfg.to_json())

    # -- checkpoint --------------------------------------------------------
    def try_resume(self) -> bool:
        """Resume from the newest checkpoint; False when there is none."""
        restored = self.ckpt.restore_latest(self.state)
        if restored is None:
            return False
        _, meta = restored
        self.epoch = int(meta.get("epoch", 0))
        self.total_it = int(meta.get("total_it", 0))
        if self.cfg.train.reset_lr:
            reset_learning_rate(self.state.optimizer, self.cfg.train.lr)
            self.logger.log_text(f"reset_lr: optimizer lr forced to "
                                 f"{self.cfg.train.lr}")
        self.logger.log_text(f"resumed at epoch {self.epoch} "
                             f"(it {self.total_it})")
        return True

    def _meta(self) -> Dict:
        return {"epoch": self.epoch, "total_it": self.total_it,
                "config": self.cfg.to_json()}

    # -- core loops --------------------------------------------------------
    def _on_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return shard_batch(batch, self.device)

    def train_epoch(self, loader: ShardedBatchLoader) -> Dict[str, float]:
        cfg = self.cfg.train
        vel_on = cfg.vel_loss_start < 0 or self.epoch >= cfg.vel_loss_start
        step_fn = self._step_full if vel_on else self._step_eps
        loader.set_epoch(self.epoch)
        sums: Dict[str, float] = {}
        count = 0
        t0 = time.time()
        for batch in loader:
            batch = self._on_device(self._to_model_batch(batch))
            if self._frontend is not None:
                batch = self._frontend(batch)
            self.state, terms = step_fn(self.state, batch)
            self.total_it += 1
            count += 1
            if cfg.debug and count >= 1:  # smoke mode: one batch
                break
            if self.total_it % cfg.log_every == 0:
                vals = {k: float(v) for k, v in terms._asdict().items()}
                for k, v in vals.items():
                    sums[k] = sums.get(k, 0.0) + v
                self.logger.log_metrics(
                    step=self.total_it,
                    metrics={**vals, "epoch": self.epoch,
                             "it_per_s": count / (time.time() - t0)})
        self.epoch += 1
        n = max(1, count // max(1, cfg.log_every))
        return {k: v / n for k, v in sums.items()}

    def _to_model_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        """Dataset dict -> the step's batch {motion, mel, pid, hubert?,
        sem?, exp_cond?, word?, emo?}."""
        mode = self.cfg.model.branch_mode
        if mode == "expression_only" and "facial" in batch:
            motion = batch["facial"]
        elif mode in ("gesture_only", "exp_condition_gesture") \
                and "pose_axis_angle" in batch:
            motion = batch["pose_axis_angle"]
        else:
            motion = batch["motion"]
        out = {"motion": motion}
        on_device_fe = self.cfg.train.on_device_frontend
        if on_device_fe:
            if "audio" not in batch:
                raise ValueError(
                    "train.on_device_frontend requires the cache's raw "
                    "'audio' field in batches (BeatDataset(..., "
                    "include_audio=True); the cache builder stores it by "
                    "default, data/beat.py)")
            # the int16 transport halves the bytes to the card; the source
            # PCM was int16, so this rounds below its own resolution
            out["wave16"] = np.clip(
                np.asarray(batch["audio"], np.float32) * 32768.0,
                -32768, 32767).astype(np.int16)
        else:
            out["mel"] = batch["mel"]
        if mode == "exp_condition_gesture":
            out["exp_cond"] = batch["facial"]
        if "pid" in batch:
            out["pid"] = batch["pid"]
        elif "speaker" in batch:
            out["pid"] = batch["speaker"]
        else:
            S = self.cfg.model.style_dim
            ids = batch["id"].reshape(-1).astype(np.int32)
            out["pid"] = np.eye(S, dtype=np.float32)[ids % S]
        if on_device_fe:
            pass    # the frontend computes mel and HuBERT from wave16
        elif "hubert" in batch:
            out["hubert"] = batch["hubert"]
        elif self.cfg.model.add_hubert:
            # no cached features: zero conditioning keeps the shapes — but
            # warn once, because the model then learns to ignore its
            # speech pathway
            if not getattr(self, "_warned_zero_hubert", False):
                self._warned_zero_hubert = True
                self.logger.log_text(
                    "WARNING: model.add_hubert is on but the dataset "
                    "provides no 'hubert' features; training with ZERO "
                    "speech conditioning. Provide --hubert-cache or set "
                    "model.add_hubert=false.")
            B, T = batch["motion"].shape[:2]
            out["hubert"] = np.zeros((B, T, self.cfg.model.hubert_dim),
                                     dtype=np.float32)
        if "sem" in batch:
            out["sem"] = batch["sem"]
        # text / emotion labels; -1 sentinels clamp to 0 in the model
        B, T = out["motion"].shape[:2]
        if self.cfg.model.add_text_cond:
            out["word"] = np.asarray(
                batch.get("word", np.zeros((B, T))), dtype=np.int32)
        if self.cfg.model.add_emo_cond:
            out["emo"] = np.asarray(
                batch.get("emo", np.zeros((B, T))), dtype=np.int32)
        return out

    # -- eval --------------------------------------------------------------
    def _get_generator(self):
        """The window generator on the current weights: built once, then
        reloaded (its copy of the model and its fast-path weights) at
        every evaluation."""
        from diffsheg_tpu_torch.sampling.generator import WindowGenerator
        model = self.state.model
        if is_fsdp(model):
            # the generator samples with whole weights: gather them (a
            # collective) into an unsharded copy
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, get_model_state_dict)
            full = get_model_state_dict(
                model, options=StateDictOptions(full_state_dict=True))
            model = build_denoiser(self.cfg.model).to(self.device)
            model.load_state_dict(full)
        if self._generator is None:
            self._generator = WindowGenerator(self.cfg, model,
                                              device=self.device)
        else:
            self._generator.load_weights(model)
        return self._generator

    def evaluate(self, loader: ShardedBatchLoader, seed: int = 0,
                 max_batches: int = 0,
                 noise: Optional[Callable[[int], NoiseSource]] = None
                 ) -> EvalResult:
        """DDIM sampling of each val batch and MSE / PCK / PCK@2 /
        diversity against the targets; FGD with the trainer's
        ``fgd_net``.  Batch i draws its noise from ``noise(i)``, by default
        a ``GlobalRowsNoise`` seeded from ``seed`` and i: each process
        takes its rows of the global batch's draws, so the result does not
        depend on the number of processes.  Across processes the metrics
        are reduced (the FGD latents gathered), so every process returns
        the same result."""
        from diffsheg_tpu_torch.eval.metrics import diversity as div_fn
        from diffsheg_tpu_torch.eval.metrics import (frechet_from_activations,
                                                     mse_pck_channels)

        gen = self._get_generator()
        n_proc = col.process_count()
        mses, pcks, pck2s = [], [], []
        # streaming diversity: score each disjoint 50-sample group as it
        # fills instead of keeping every generated batch
        div_carry, carry_n = [], 0
        div_total, div_groups = 0.0, 0
        gen_lat, real_lat = [], []
        for bi, batch in enumerate(loader):
            if max_batches and bi >= max_batches:
                break
            mb = self._on_device(self._to_model_batch(batch))
            if self._frontend is not None:
                # mel (+ HuBERT) from the raw window audio, as in the step
                mb = self._frontend(mb)
            draws = (GlobalRowsNoise(step_seeds(seed, bi)[0], self.device)
                     if noise is None else noise(bi))
            out = gen.generate(mb["mel"], mb["pid"], draws,
                               hubert=mb.get("hubert"))
            out_np = out.float().cpu().numpy()
            tgt = mb["motion"].cpu().numpy()
            m, p = mse_pck_channels(out_np, tgt)
            mses.append(m)
            pcks.append(p)
            pck2s.append(mse_pck_channels(out_np, tgt, pck_threshold=2.0)[1])
            div_carry.append(out_np)
            carry_n += len(out_np)
            while carry_n >= 50:
                pool = np.concatenate(div_carry)
                div_total += div_fn(pool[:50], batch=50)
                div_groups += 1
                rest = pool[50:]
                div_carry = [rest] if len(rest) else []
                carry_n = len(rest)
            if self.fgd_net is not None:
                with torch.no_grad():
                    gen_lat.append(self.fgd_net(out.float()).cpu().numpy())
                    real_lat.append(self.fgd_net(mb["motion"]).cpu().numpy())
        # diversity over 50-sample groups of the pooled outputs, whatever
        # the loader's batch size
        if div_groups:
            div_val = div_total / div_groups
        elif div_carry:  # fewer than 50 samples in all: one smaller group
            div_val = div_fn(np.concatenate(div_carry), batch=50)
        else:
            div_val = float("nan")
        res = EvalResult(
            mse=float(np.mean(mses)) if mses else float("nan"),
            pck=float(np.mean(pcks)) if pcks else float("nan"),
            pck2=float(np.mean(pck2s)) if pck2s else float("nan"),
            diversity=div_val)
        if n_proc > 1:
            # every process scored an equal share of each batch
            means = col.all_reduce_nanmean_metrics(
                {"mse": res.mse, "pck": res.pck, "pck2": res.pck2},
                weight=float(len(mses)))
            means.update(col.all_reduce_nanmean_metrics(
                {"diversity": div_val}, weight=float(max(div_groups, 1))))
            res = EvalResult(**means)
            if self.fgd_net is not None:
                gen_lat = [col.gather_arrays(np.concatenate(gen_lat))]
                real_lat = [col.gather_arrays(np.concatenate(real_lat))]
        if gen_lat:
            res.fgd = frechet_from_activations(np.concatenate(gen_lat),
                                               np.concatenate(real_lat))
        self.logger.log_metrics(step=self.total_it,
                                metrics={f"val_{k}": v
                                         for k, v in res.as_dict().items()})
        return res

    # -- top-level fit -----------------------------------------------------
    def fit(self, train_loader: ShardedBatchLoader,
            val_loader: Optional[ShardedBatchLoader] = None,
            num_epochs: Optional[int] = None) -> None:
        cfg = self.cfg.train
        num_epochs = num_epochs or cfg.num_epochs
        while self.epoch < num_epochs:
            losses = self.train_epoch(train_loader)
            self.logger.log_text(
                f"epoch {self.epoch}/{num_epochs} " +
                " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
            self.ckpt.save_latest(self.epoch, self.state, self._meta())
            if cfg.save_every_epochs and \
                    self.epoch % cfg.save_every_epochs == 0:
                self.ckpt.save_tagged(f"epoch_{self.epoch:04d}", self.state,
                                      self._meta())
            if (val_loader is not None and cfg.eval_every_epochs
                    and self.epoch % cfg.eval_every_epochs == 0):
                res = self.evaluate(val_loader, seed=cfg.seed + 1 + self.epoch)
                if np.isfinite(res.fgd):
                    self.ckpt.update_best("fgd", res.fgd, self.state,
                                          self._meta())
                if np.isfinite(res.mse):
                    self.ckpt.update_best("mse", res.mse, self.state,
                                          self._meta())
                if np.isfinite(res.pck):
                    self.ckpt.update_best("pck", res.pck, self.state,
                                          self._meta(), lower_is_better=False)

"""Typed configuration for diffsheg_tpu_torch.

The port's own copy of ``diffsheg_tpu/config.py``: the same frozen
dataclasses, field names, defaults and presets, so a configuration reads
the same in both packages and a ``config.json`` the JAX trainer wrote
loads here (``DiffusionConfig.scan_unroll``, the unroll factor of JAX's
compiled sampler loop, is carried and has no effect: the port's sampler
loops on the host).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser architecture: latent 512, 8 layers, 8 heads, ffn 1024,
    mel 128 -> audio latent 256, HuBERT 1024 -> 128 conv encoder.
    ``branch_mode`` picks the joint UniDiffuser or a single branch;
    ``model_base`` the per-layer condition concat ('transformer_encoder')
    or cross-attention ('transformer_decoder'); ``learned_variance`` the
    2C output head."""

    pose_dim: int = 141
    expression_dim: int = 51
    latent_dim: int = 512
    num_layers: int = 8
    num_heads: int = 8
    ff_size: int = 1024
    audio_dim: int = 128
    aud_latent_dim: int = 256
    style_dim: int = 30
    max_seq_len: int = 600
    pe_type: str = "pe_sinu"   # {'learnable','ppe_sinu','pe_sinu','pe_sinu_repeat'}
    dropout: float = 0.0
    cond_projection: str = "mlp_includeX"
    cond_residual: bool = True
    add_hubert: bool = True
    encode_hubert: bool = True
    hubert_dim: int = 1024
    hubert_latent_dim: int = 128
    speech_encoder: str = "conv"   # {'conv','linear','raw'}
    add_text_cond: bool = False
    add_emo_cond: bool = False
    word_f: int = 128
    emotion_f: int = 8
    word_vocab: int = 2048
    num_emotions: int = 8
    classifier_free: bool = False
    null_cond_prob: float = 0.2
    cond_scale: float = 1.0
    branch_mode: str = "joint"
    expr_id_off: bool = False
    no_style: bool = False
    remove_audio: bool = False
    remove_style: bool = False
    use_single_style: bool = False
    model_base: str = "transformer_encoder"
    learned_variance: bool = False
    remat: bool = False
    scan_layers: bool = False
    compute_dtype: str = "float32"

    @property
    def motion_dim(self) -> int:
        return self.pose_dim + self.expression_dim

    @property
    def time_embed_dim(self) -> int:
        return self.latent_dim * 4

    @property
    def uses_cfg_at_inference(self) -> bool:
        return self.classifier_free and self.cond_scale != 1.0


@dataclass(frozen=True)
class DiffusionConfig:
    """Forward/reverse process."""

    num_steps: int = 1000
    beta_schedule: str = "linear"        # {'linear','cosine'}
    mean_type: str = "epsilon"           # {'epsilon','start_x','previous_x'}
    # {'fixed_small','fixed_large','learned','learned_range'}; the learned
    # two need model.learned_variance=True
    var_type: str = "fixed_small"
    respacing: str = "ddim25"
    sampler: str = "ddim"                # {'ddim','ancestral'}
    clip_denoised: bool = False
    jump_length: int = 3
    jump_n_sample: int = 5
    no_resample: bool = False
    # JAX's lax.scan unroll factor; carried with no effect
    scan_unroll: int = 1
    # 'auto'/'jnp': the streamlined eta=0 DDIM+RePaint step composition
    fused_step: str = "auto"
    # 'auto'/'on': the per-layer kernel (ops/fused_layer.py::fused_layer);
    # 'chain': the whole-branch kernel (fused_branch)
    fused_layer: str = "auto"
    level_cache: bool = True
    quantize: str = "none"


@dataclass(frozen=True)
class StreamConfig:
    """Arbitrary-length windowed-outpainting generation."""

    overlap_len: int = 4
    # custom-audio generation (cli/generate.py): mel + HuBERT + sampler in
    # one pipeline call; False: staged, each stage timed (the reference's
    # per-stage RTF)
    single_dispatch: bool = True
    add_blend: bool = True
    fix_very_first: bool = False
    no_repaint: bool = False
    same_overlap_noisy: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset-dependent constants."""

    dataset_name: str = "beat"
    fps: int = 15
    n_poses: int = 34
    stride: int = 10
    audio_sr: int = 16000
    mel_sr: int = 18000
    mel_hop: int = 1200
    n_mels: int = 128
    speaker_dim: int = 30
    data_root: str = "data/BEAT"
    cache_name: str = "beat_4english_15_141"
    remove_hand: bool = False
    audio_feat: str = "mel"
    n_mfcc: int = 64


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation: Adam at ``lr`` after a global-norm clip at
    ``grad_clip``; the loss ``eps_weight * eps MSE + vel_weight * velocity
    MSE + x0_weight * Huber(x0)`` (the last two from epoch
    ``vel_loss_start``; ``use_sem_weighting`` scales the x0 term by the
    semantic score + 1), plus the VLB term for ``loss_type`` 'kl' /
    'rescaled_kl' or a learned variance head."""

    batch_size: int = 2500
    num_epochs: int = 1000
    lr: float = 2e-4
    grad_clip: float = 0.5
    eps_weight: float = 1000.0
    vel_weight: float = 1.0
    x0_weight: float = 100.0
    huber_beta: float = 0.1
    loss_type: str = "mse"     # {'mse','rescaled_mse','kl','rescaled_kl'}
    vel_loss_start: int = -1
    use_sem_weighting: bool = True
    log_every: int = 50
    save_every_epochs: int = 20
    eval_every_epochs: int = 40
    seed: int = 0
    checkpoints_dir: str = "checkpoints"
    timestep_sampler: str = "uniform"  # {'uniform','loss-second-moment'}
    # mel + HuBERT inside the step from the cache's raw audio (JAX only)
    on_device_frontend: bool = False
    debug_nans: bool = False   # torch.autograd anomaly detection
    debug: bool = False        # one batch an epoch
    reset_lr: bool = False     # on resume, force the optimizer lr to ``lr``


@dataclass(frozen=True)
class MeshConfig:
    """Process layout (the JAX package's mesh, one process a card):
    ``data_parallel`` x ``fsdp_parallel`` must equal the number of
    processes, ``data_parallel=-1`` taking the rest; with ``fsdp_parallel``
    above 1 the parameters are sharded (``parallel/mesh.py``)."""

    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    data_parallel: int = -1    # -1 = all devices
    fsdp_parallel: int = 1


@dataclass(frozen=True)
class Config:
    """Top-level config."""

    name: str = "beat_diffsheg_tpu"
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            name=raw.get("name", "unnamed"),
            model=ModelConfig(**raw.get("model", {})),
            diffusion=DiffusionConfig(**raw.get("diffusion", {})),
            stream=StreamConfig(**raw.get("stream", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
        )


def check_variance_coupling(cfg: Config) -> None:
    """A learned-variance head and a learned ``var_type`` come as a pair:
    the sampler splits the 2C output exactly when ``var_type`` is learned,
    and the model emits 2C channels exactly when ``model.learned_variance``.
    Raises a ValueError for either without the other."""
    learned = cfg.diffusion.var_type in ("learned", "learned_range")
    if cfg.model.learned_variance and not learned:
        raise ValueError(
            "model.learned_variance=True needs diffusion.var_type="
            "'learned' or 'learned_range' (got "
            f"{cfg.diffusion.var_type!r}) — the 2C output must be split")
    if learned and not cfg.model.learned_variance:
        raise ValueError(
            f"diffusion.var_type={cfg.diffusion.var_type!r} needs "
            "model.learned_variance=True — the model must emit a variance "
            "head")


def resolve(cfg: Config) -> Config:
    """The cross-field constants the reference sets in code: without the
    hands (``data.remove_hand``) the pose shrinks (BEAT 141 -> 33, SHOW
    129 -> 39), and on SHOW ``data.audio_feat`` picks the audio width
    (mel ``n_mels``, mfcc ``n_mfcc``, raw 1).  Only widths still at their
    preset defaults are rewritten, so an explicit override wins.  Checks
    the variance coupling first (:func:`check_variance_coupling`)."""
    check_variance_coupling(cfg)
    model = cfg.model
    if cfg.data.remove_hand:
        is_beat = cfg.data.dataset_name == "beat"
        full, no_hand = (141, 33) if is_beat else (129, 39)
        if model.pose_dim == full:
            model = dataclasses.replace(model, pose_dim=no_hand)
    feat_dim = {"mel": cfg.data.n_mels, "mfcc": cfg.data.n_mfcc,
                "raw": 1}.get(cfg.data.audio_feat)
    if (feat_dim is not None and cfg.data.dataset_name != "beat"
            and model.audio_dim == 128 and model.audio_dim != feat_dim):
        model = dataclasses.replace(model, audio_dim=feat_dim)
    return cfg.replace(model=model) if model is not cfg.model else cfg


def beat_config(**overrides) -> Config:
    """BEAT preset: 141-d gesture + 51-d face @ 15 fps, 34-frame windows."""
    cfg = Config(
        name="beat_diffsheg_tpu",
        model=ModelConfig(pose_dim=141, expression_dim=51, style_dim=30),
        data=DataConfig(dataset_name="beat", fps=15, n_poses=34, stride=10,
                        speaker_dim=30, mel_sr=18000, mel_hop=1200),
        stream=StreamConfig(overlap_len=4),
        train=TrainConfig(batch_size=2500, num_epochs=1000),
    )
    return cfg.replace(**overrides) if overrides else cfg


def show_config(**overrides) -> Config:
    """SHOW/TalkSHOW preset: 129-d pose + 103-d face @ 30 fps, 88-frame
    windows, classifier-free guidance."""
    cfg = Config(
        name="talkshow_diffsheg_tpu",
        model=ModelConfig(pose_dim=129, expression_dim=103, style_dim=4,
                          classifier_free=True, cond_scale=1.15),
        data=DataConfig(dataset_name="talkshow", fps=30, n_poses=88,
                        stride=10, speaker_dim=4, mel_sr=18000, mel_hop=600,
                        data_root="data/SHOW", cache_name="talkshow_cache"),
        stream=StreamConfig(overlap_len=10),
        train=TrainConfig(batch_size=950, num_epochs=4000,
                          use_sem_weighting=False),
    )
    return cfg.replace(**overrides) if overrides else cfg

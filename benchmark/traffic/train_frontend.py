"""Training steps with the speech frontend inside them
(``train.on_device_frontend``): each step's windows go to the card as
16 kHz int16 audio, and the step computes their mel spectrogram and the
frozen speech encoder's features (``audio/frontend.py::
make_speech_frontend``) before the loss, gradients, clip and Adam
(``make_train_step``), as ``train/trainer.py`` composes the two.

The mix file gives the ``pool`` of synthetic windows made on the card at
set-up (pose and face motion, a speaker, a semantic score, and one
synthetic clip of speech a window, made as ``stream.py::synth_audio``
makes a clip), the ``batch`` each step draws from it by index, the
program's settings, ``check_steps`` and ``trace_steps``.  The timesteps and
noise are drawn as ``train.py`` draws them.  The encoder is the one the
configuration's ``hubert`` group describes (WavLM-Large in
``beat-wavlm``), on the benchmark's seeded weights.

``correct`` compares the first check step's encoder features with the
plain reference's (``reference/wavlm.py``), the worst window's relative
RMS, and the three steps' loss, first gradient and change leaf gaps
(``train.py::compare``) with the reference step fed the reference's mel
and features.
"""

from __future__ import annotations

import math
import sys

import torch

from benchmark import program, weights
from benchmark.flops import speech_encoder as enc_flops
from benchmark.reference import train as ref_train
from benchmark.reference import wavlm as ref_wavlm
from benchmark.reference.denoiser import UniDiffuser as RefUniDiffuser
from benchmark.traffic import train

AUDIO_SR = 16000


def window_samples(config):
    """16 kHz samples of one window (BEAT: 34 frames at 15 fps, 36266)."""
    d = config["data"]
    return int(d["n_poses"] / d["fps"] * d["audio_sr"])


def synth_windows(gen, n, samples, device, block=500):
    """``n`` clips of ``samples`` at 16 kHz as int16 (n, samples), each
    made as ``stream.py::synth_audio`` makes a clip (six partials under a
    syllable-rate envelope plus a little noise) at half its amplitude, so
    that no sample clips."""
    out = torch.empty((n, samples), dtype=torch.int16, device=device)
    t = torch.arange(samples, device=device) / AUDIO_SR
    for i in range(0, n, block):
        m = min(block, n - i)
        f = 80.0 + 900.0 * torch.rand((m, 6, 1), generator=gen, device=device)
        a = 0.05 + 0.2 * torch.rand((m, 6, 1), generator=gen, device=device)
        ph = 2 * math.pi * torch.rand((m, 7, 1), generator=gen, device=device)
        rate = 2.0 + 4.0 * torch.rand((m, 1), generator=gen, device=device)
        tone = (a * torch.sin(2 * math.pi * f * t + ph[:, :6])).sum(1)
        env = 0.5 + 0.5 * torch.sin(2 * math.pi * rate * t + ph[:, 6])
        noise = 0.02 * torch.randn((m, samples), generator=gen, device=device)
        wave = 0.5 * (tone * env + noise)
        out[i:i + m] = (wave * 32768).round().clamp(-32768, 32767).short()
    return out


def make_pool(config, n, seed, device):
    m = config["model"]
    T = config["data"]["n_poses"]
    g = weights.generator(seed, "pool", device)
    style = torch.randint(m["style_dim"], (n,), generator=g, device=device)
    return {
        "motion": torch.randn((n, T, m["pose_dim"] + m["expression_dim"]),
                              generator=g, device=device),
        "pid": torch.nn.functional.one_hot(style, m["style_dim"]).float(),
        "sem": torch.rand((n, T), generator=g, device=device),
        "wave16": synth_windows(weights.generator(seed, "audio", device), n,
                                window_samples(config), device),
    }


def encoder_state(config, seed, device):
    """The encoder's seeded weights: the rule of ``weights.py``, then the
    relative-position embedding scaled by sqrt(heads) to N(0, 1), so that
    the gated bias moves the logits by O(1) (the configuration's
    ``assumed``)."""
    h = config["hubert"]
    state = weights.make_state(weights.build(ref_wavlm.WavLM, h), seed,
                               "wavlm", device)
    for name in state:
        if name.endswith("rel_attn_embed.weight"):
            state[name] = state[name] * h["num_heads"] ** 0.5
    return state


def encoder_counts():
    """The port's encoder counters: windows and chunks of the training
    frontend, attention calls by kind."""
    from diffsheg_tpu_torch.audio.frontend import encoder_counts as c
    from diffsheg_tpu_torch.models.hubert import attention_calls as a
    return {**c, **{f"attention.{k}": v for k, v in a.items()}}


class Generator(train.Generator):
    def __init__(self, cell, mix, config, seed, device, tracer):
        super().__init__(cell, mix, config, seed, device, tracer)
        self.counts0 = None

    # -- set-up ------------------------------------------------------------
    def encoder(self):
        """The program's encoder on the seed's weights."""
        conf = self.config
        hcfg = program.hubert_config(conf, conf["model"]["compute_dtype"])
        return program.port_hubert(
            hcfg, encoder_state(conf, self.seed, self.device), self.device)

    def setup(self):
        from diffsheg_tpu_torch.audio.frontend import make_speech_frontend
        from diffsheg_tpu_torch.diffusion.schedule import (
            get_named_beta_schedule, make_schedule)
        from diffsheg_tpu_torch.train.step import (create_train_state,
                                                   make_train_step)
        program.precise(True)
        conf = self.config
        cfg = program.port_config(conf)
        dev = self.device
        self.frontend = make_speech_frontend(cfg, self.encoder(), dev)
        self.pool = make_pool(conf, self.mix["pool"], self.seed, dev)
        model = program.port_denoiser(
            cfg, program.denoiser_state(conf, self.seed, dev), dev)
        self.state = create_train_state(cfg, model, dev)
        sched = make_schedule(get_named_beta_schedule(
            cfg.diffusion.beta_schedule, cfg.diffusion.num_steps))
        self.step = make_train_step(cfg, sched, inject_randoms=True)
        named = dict(self.state.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        self.losses, self.k = [], 0
        for k in range(self.n_check):
            batch = self._step()
            self.losses.append(float(self.terms.total))
            if k == 0:
                self.features = batch["hubert"].cpu()
                opt = self.state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                self.first_grad = {
                    n: float(opt.state[p]["exp_avg"].norm() / (1 - b1))
                    for n, p in named.items()}
        self.change = {n: float((p.detach() - start[n]).norm())
                       for n, p in named.items()}
        del start
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        if self.tracer.active and self.counts0 is None:
            self.counts0 = encoder_counts()
        batch, t, noise = self.draw(self.k)
        with self.tracer.span("frontend"):
            batch = self.frontend(batch)
        with self.tracer.span("step"):
            self.state, self.terms = self.step(self.state, batch, t, noise)
        self.k += 1
        return batch

    def _facts(self, steps, launches):
        h = self.config["hubert"]
        enc = self.batch_size * enc_flops.window_ops(
            h, window_samples(self.config))
        facts = super()._facts(steps, launches)
        now = encoder_counts()
        counts = {k: (v - (self.counts0 or {}).get(k, 0)) / steps
                  for k, v in now.items()}
        print("counters a traced step: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(counts.items())),
            file=sys.stderr)
        facts.update(
            ops_per_item=facts["ops_per_item"] + enc,
            ops_per_item_is="3 x the denoiser's forward + the encoder's "
                            "forward once, a step",
            encoder_ops_per_step=enc, counters_per_step=counts)
        return facts

    def free(self):
        self.frontend = None
        super().free()

    # -- the check -------------------------------------------------------------
    def reference(self, tf32=False):
        """(losses, first-gradient leaf norms, change leaf norms) of the
        reference steps over the first ``check_steps`` steps, fed the
        reference frontend's mel and features; the first step's features
        are kept in ``self.ref_features``."""
        program.precise(not tf32)
        cfg, dev = self.config, self.device
        enc = weights.build(ref_wavlm.WavLM, cfg["hubert"],
                            state=encoder_state(cfg, self.seed, dev),
                            device=dev).eval()
        ref = weights.build(RefUniDiffuser, cfg["model"],
                            state=program.denoiser_state(cfg, self.seed, dev),
                            device=dev)
        names, params = zip(*ref.named_parameters())
        start = [p.detach().clone() for p in params]
        opt = ref_train.Adam(list(params), cfg["train"]["lr"])
        tab = ref_train.Tables(cfg["diffusion"]["num_steps"], dev)
        T = cfg["data"]["n_poses"]
        losses, first = [], None
        for k in range(self.n_check):
            batch, t, noise = self.draw(k)
            mel, feats = ref_wavlm.frontend(enc, batch.pop("wave16"), T,
                                            cfg["data"])
            if k == 0:
                self.ref_features = feats.cpu()
            batch.update(mel=mel, hubert=feats)
            loss, grads = ref_train.train_step(
                ref, opt, tab, cfg["train"], batch, t, noise,
                remat=cfg["model"].get("remat", False))
            losses.append(loss)
            if k == 0:
                first = {n: float(g.norm()) for n, g in zip(names, grads)}
        change = {n: float((p.detach() - s).norm())
                  for n, p, s in zip(names, params, start)}
        program.precise(True)
        return losses, first, change

    def check(self):
        losses, first, change = self.reference()
        out = {"encoder_window_rel_rms": {
            "value": ref_wavlm.window_rel_rms(self.features,
                                              self.ref_features),
            "limit": self.cell["limits"]["encoder_window_rel_rms"]}}
        out.update(train.compare(self.cell["limits"], self.losses,
                                 self.first_grad, self.change, losses,
                                 first, change))
        return out

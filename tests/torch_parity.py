"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs: weights are made once in JAX (Flax init,
then every leaf perturbed with seeded numpy noise so no zero-initialised
projection hides a sub-layer) and carried into the port with
``diffsheg_tpu_torch.compat.from_jax``; sampler noise is replayed from the
JAX key chain into a ``TableNoise``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffsheg_tpu import config as jconfig
from diffsheg_tpu_torch import config as tconfig

# The parity tests run tiny shapes, often in several pytest workers at
# once: intra-op threads gain nothing there, and every op's thread barrier
# waits out the time slices of threads that the other workers displaced.
torch.set_num_threads(1)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()) / np.sqrt((b ** 2).mean()))


TINY_MODEL = dict(latent_dim=64, num_layers=2, num_heads=4, ff_size=128,
                  hubert_dim=48, hubert_latent_dim=32)


def config_pair(preset: str = "beat", model=None, diffusion=None,
                stream=None, data=None, train=None):
    """The same configuration in both packages: a preset with overrides.
    Unless ``diffusion`` says otherwise, both run the streamlined step
    composition (``fused_step='jnp'``)."""
    pair = []
    for mod in (jconfig, tconfig):
        cfg = getattr(mod, f"{preset}_config")()
        over = dict(model=dict(TINY_MODEL, **(model or {})),
                    diffusion=dict({"fused_step": "jnp"}, **(diffusion or {})),
                    stream=stream or {}, data=data or {}, train=train or {})
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                             for k, v in over.items()})
        pair.append(cfg)
    return tuple(pair)


def perturb(tree, seed: int, scale: float = 0.1):
    """Add ``scale * N(0, 1)`` to every leaf (variances kept positive)."""
    rng = np.random.RandomState(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        n = (scale * rng.randn(*a.shape)).astype(np.float32)
        return a + (np.abs(n) if name == "var" else n)

    return walk(tree)


def jax_denoiser(jcfg, seed: int = 0):
    """Perturbed variables (numpy tree) of the JAX model of any
    ``branch_mode`` (``models/factory.py::init_denoiser``)."""
    from diffsheg_tpu.models.factory import init_denoiser
    _, variables = init_denoiser(jcfg.model, jcfg.data.n_poses,
                                 jax.random.PRNGKey(seed))
    variables = jax.tree.map(np.asarray, dict(variables))
    return {k: perturb(v, seed + 100) for k, v in variables.items()}


def torch_denoiser(tcfg, variables):
    from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
    from diffsheg_tpu_torch.models.factory import build_denoiser
    return load_flax_tree(build_denoiser(tcfg.model), variables)


def jax_window_noise(key, B, T, C, program, repaint: bool,
                     model_noise: bool = False, sampler: str = "ddim"):
    """Replay one window's draws: ``rng, k = split(key)``; x_T =
    normal(k); per step ``key, k_model, k_gt, k_undo = split(key, 4)``
    (the DDIM noise ``normal(k_model)`` only with ``model_noise``, for
    eta > 0).  ``sampler='ancestral'`` replays the ancestral chain: per
    step ``key, k_gt, k_trans, k_undo = split(key, 4)``, the GT noise on
    every denoise step under RePaint, the transition noise on every
    denoise step."""
    rng, k = jax.random.split(key)
    initial = np.asarray(jax.random.normal(k, (B, T, C)))
    steps = {}
    key = rng
    for s, den in enumerate(np.asarray(program.denoise).tolist()):
        if sampler == "ancestral":
            key, k_gt, k_trans, k_undo = jax.random.split(key, 4)
            if den:
                if repaint:
                    steps[(s, "gt")] = np.asarray(
                        jax.random.normal(k_gt, (B, T, C)))
                steps[(s, "trans")] = np.asarray(
                    jax.random.normal(k_trans, (B, T, C)))
            else:
                steps[(s, "undo")] = np.asarray(
                    jax.random.normal(k_undo, (B, T, C)))
            continue
        key, k_model, k_gt, k_undo = jax.random.split(key, 4)
        if den and model_noise:
            steps[(s, "model")] = np.asarray(
                jax.random.normal(k_model, (B, T, C)))
        if den and repaint:
            steps[(s, "gt")] = np.asarray(jax.random.normal(k_gt, (B, T, C)))
        elif not den:
            steps[(s, "undo")] = np.asarray(jax.random.normal(k_undo, (B, T, C)))
    return initial, steps


def stream_noise(rng, n_windows, B, T, C, plain, harmonize,
                 first_repaint: bool = False, sampler: str = "ddim"):
    """The TableNoise of a stream: window keys chained off ``rng`` as the
    JAX streamer, pipeline and live session do; window 0 runs the plain
    program, or with ``first_repaint`` (``stream.fix_very_first``) the
    harmonize program."""
    from diffsheg_tpu_torch.diffusion.sampler import TableNoise
    initial, steps = {}, {}
    for w in range(n_windows):
        rng, k = jax.random.split(rng)
        repaint = w > 0 or first_repaint
        prog = harmonize if repaint else plain
        initial[w], st = jax_window_noise(k, B, T, C, prog, repaint,
                                          sampler=sampler)
        steps.update({(w, s, kind): v for (s, kind), v in st.items()})
    return TableNoise(initial, steps)


def jnp_f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def beat_template_text(frames: int = 3, seed: int = 0) -> str:
    """A 228-channel BEAT skeleton: a chain of every joint, a root with
    translation, ZXY rotations, an end site, ``frames`` random frames."""
    from diffsheg_tpu_torch.geometry.joints import BEAT_JOINT_ORDER
    rng = np.random.RandomState(seed)
    lines = ["HIERARCHY"]
    for d, name in enumerate(BEAT_JOINT_ORDER):
        pad = "  " * d
        off = " ".join("%.4f" % v for v in rng.randn(3))
        lines += [f"{pad}{'ROOT' if d == 0 else 'JOINT'} {name}", f"{pad}{{",
                  f"{pad}  OFFSET {off}",
                  f"{pad}  CHANNELS 6 Xposition Yposition Zposition "
                  "Zrotation Xrotation Yrotation" if d == 0 else
                  f"{pad}  CHANNELS 3 Zrotation Xrotation Yrotation"]
    nj = len(BEAT_JOINT_ORDER)
    lines += ["  " * nj + "End Site", "  " * nj + "{",
              "  " * nj + "  OFFSET 0 0.1 0", "  " * nj + "}"]
    lines += ["  " * (d - 1) + "}" for d in range(nj, 0, -1)]
    lines += ["MOTION", f"Frames: {frames}", "Frame Time: 0.06666667"]
    lines += [" ".join("%.5f" % v for v in rng.uniform(-60, 60, 228))
              for _ in range(frames)]
    return "\n".join(lines) + "\n"


def write_beat_split(root, clips, seed: int = 0, fps: int = 15,
                     sr: int = 16000):
    """A synthetic raw BEAT split under ``root`` (``bvh_rot`` euler-degree
    rows, ``wave16k`` audio, ``facial52`` JSON, ``sem`` TSV, optional
    ``word`` / ``emo`` labels).  ``clips``: {clip id: dict(secs=,
    pose_secs=, const=, labels=)} — ``pose_secs`` clamps the pose frames
    (the whole-second clamp), ``const`` makes every pose value equal (the
    filter's case), ``labels`` writes word / emo arrays."""
    import os
    from diffsheg_tpu_torch.geometry.face import write_face_json
    rng = np.random.RandomState(seed)
    root = str(root)
    for sub in ("bvh_rot", "wave16k", "facial52", "sem", "word", "emo"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for cid, spec in clips.items():
        secs = spec.get("secs", 6)
        T = int(spec.get("pose_secs", secs) * fps)
        pose = rng.randn(T, 141) * 25
        if spec.get("const") is not None:
            pose[:] = spec["const"]
        np.savetxt(f"{root}/bvh_rot/{cid}.bvh", pose, fmt="%.6f")
        np.save(f"{root}/wave16k/{cid}.npy",
                (rng.randn(secs * sr) * 0.05).astype(np.float32))
        write_face_json(rng.rand(secs * fps, 51),
                        f"{root}/facial52/{cid}.json", fps=fps)
        with open(f"{root}/sem/{cid}.txt", "w") as f:
            f.write("w\t0.5\t2.0\t1.5\t0.8\thi\n"
                    "bad\tx\ty\tz\tq\n"
                    "w\t31.0\t33.0\t2.0\t0.4\tthere\n"
                    "w\t2.5\t4.0\t1.5\t0.3\tyou\n")
        if spec.get("labels"):
            np.save(f"{root}/word/{cid}.npy", rng.randint(0, 2048, T))
            np.save(f"{root}/emo/{cid}.npy", rng.randint(0, 8, T))
    return root


def write_show_split(root, lengths, seed: int = 0, fps: int = 30,
                     sr: int = 16000):
    """A synthetic SHOW split: one ``.npz`` sequence a length (frames),
    speakers 20, 21, ... (the raw TalkSHOW ids)."""
    import os
    rng = np.random.RandomState(seed)
    os.makedirs(str(root), exist_ok=True)
    for i, T in enumerate(lengths):
        np.savez(os.path.join(str(root), f"seq{i}.npz"),
                 pose=rng.randn(T, 165).astype(np.float32),
                 expression=rng.randn(T, 100).astype(np.float32),
                 audio=(rng.randn(int(T / fps * sr)) * 0.1).astype(
                     np.float32),
                 speaker=np.asarray(20 + i))
    return str(root)


def mel_close(a, b, tol: float = 2e-5) -> float:
    """max |a - b| over max |b|, asserted within ``tol`` (the mel band of
    tests/test_torch_mel.py)."""
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)
                       ).max() / np.abs(np.asarray(b, np.float64)).max())
    assert err <= tol, err
    return err


def reference_fgd_state_dict(T, C, seed=0, base=300):
    """A seeded HalfEmbeddingNet state dict under the reference's names
    (with the decoder's and fc_logvar's keys, which FGD drops) for
    ``T``-frame windows of ``C`` channels."""
    from diffsheg_tpu_torch.eval.fgd_net import FgdNetConfig
    g = torch.Generator().manual_seed(seed)

    def t(*shape, pos=False):
        x = torch.randn(*shape, generator=g) * 0.1
        return x.abs() + 0.5 if pos else x

    sd = {}

    def lin(name, i, o):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(o, i), t(o)

    def bn(name, n):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(n) + 1, t(n)
        sd[f"{name}.running_mean"] = t(n)
        sd[f"{name}.running_var"] = t(n, pos=True)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    e = "pose_encoder"
    for i, (ci, co, k) in enumerate([(C, base, 3), (base, 2 * base, 3),
                                     (2 * base, 2 * base, 4)]):
        sd[f"{e}.net.{i}.0.weight"] = t(co, ci, k)
        sd[f"{e}.net.{i}.0.bias"] = t(co)
        bn(f"{e}.net.{i}.1", co)
    sd[f"{e}.net.3.weight"] = t(base, 2 * base, 3)
    sd[f"{e}.net.3.bias"] = t(base)
    flat = base * FgdNetConfig(n_frames=T, pose_dim=C).conv_out_frames
    if T >= 64:
        lin(f"{e}.out_net.0", flat, base * 12)
        bn(f"{e}.out_net.1", base * 12)
        lin(f"{e}.out_net.2", base * 12, base * 4)
        bn(f"{e}.out_net.3", base * 4)
        lin(f"{e}.out_net.5", base * 4, base * 2)
        bn(f"{e}.out_net.6", base * 2)
        lin(f"{e}.out_net.8", base * 2, base)
    else:
        lin(f"{e}.out_net.0", flat, base * 4)
        bn(f"{e}.out_net.1", base * 4)
        lin(f"{e}.out_net.3", base * 4, base * 2)
        bn(f"{e}.out_net.4", base * 2)
        lin(f"{e}.out_net.6", base * 2, base)
    lin(f"{e}.fc_mu", base, base)
    lin(f"{e}.fc_logvar", base, base)
    lin("decoder.out", base, C)
    return sd

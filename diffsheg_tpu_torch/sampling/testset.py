"""Test-set streaming generation (arbitrary-length clips).

Counterpart of ``diffsheg_tpu/sampling/testset.py``, the reference's
``test_arbitrary_len`` mode (reference trainers/ddpm_beat_trainer.py:
849-1121): every whole clip of the test split goes through windowed
outpainting (``sampling/streamer.py``'s host window loop) conditioned on
its own audio features; each clip's output is saved and scored against
its ground truth — MSE / PCK, beat alignment on clips with audio, SRGR on
clips with the semantic annotation, and FGD over the clips' whole windows
with a feature net.

Clip i draws its noise from ``noise(i)``: by default a ``GeneratorNoise``
seeded from ``(seed, i)``, so a clip's output does not depend on which
clips ran before it, nor on how many processes share the split (the JAX
package keys clip i by ``fold_in(rng, i)``).  Across processes, process p
streams clips p, p + N, ... and tags its files ``_rank{p}`` (the
reference's per-rank result shards, ddpm_beat_trainer.py:825); the
metrics are then reduced so that every process returns the one-process
numbers: MSE / PCK weighted by clips, beat alignment by the clips with
audio, SRGR by the annotated clips, clips and fps summed, and FGD over the
gathered latents of every process (``parallel/collectives.py``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diffsheg_tpu_torch.config import Config
from diffsheg_tpu_torch.device import (DeviceLike, init_distributed,
                                       resolve_device)
from diffsheg_tpu_torch.diffusion.sampler import GeneratorNoise, NoiseSource


def generate_testset(
    cfg: Config,
    model: torch.nn.Module,
    dataset,                      # BeatDataset / ShowDataset over a test cache
    out_dir: str,
    seed: int = 0,
    noise: Optional[Callable[[int], NoiseSource]] = None,
    fgd_net=None,
    max_clips: int = 0,
    output_gt: bool = False,
    exporter=None,
    srgr_avg_weight: float | None = None,
    log=print,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Stream every test clip through ``model`` on ``device`` (default:
    the GPU; raises without one); returns the metrics.

    ``output_gt`` skips the sampler and writes the ground truth instead,
    into an ``_GT``-suffixed directory (reference --output_gt).
    ``exporter`` (``sampling/export.py::BeatMotionExporter``) writes the
    de-normalized npy, the template BVH and the face JSON of each clip;
    without it the normalized output is saved as npy.  ``fgd_net``
    (``eval/fgd_net.py``) adds FGD over every clip's whole windows.
    """
    from diffsheg_tpu_torch.audio.onsets import audio_onset_times
    from diffsheg_tpu_torch.eval.metrics import (beat_alignment,
                                                 frechet_from_activations,
                                                 mse_pck_channels, srgr)
    from diffsheg_tpu_torch.sampling.generator import WindowGenerator
    from diffsheg_tpu_torch.sampling.streamer import StreamingGenerator
    from diffsheg_tpu_torch.train.step import step_seeds

    from diffsheg_tpu_torch.parallel import collectives as col

    device = init_distributed(resolve_device(device))
    if noise is None:
        def noise(i):
            return GeneratorNoise(step_seeds(seed, i)[0], device)
    if output_gt:
        out_dir = out_dir.rstrip("/") + "_GT"
    os.makedirs(out_dir, exist_ok=True)
    gen = StreamingGenerator(WindowGenerator(cfg, model, device=device))
    if fgd_net is not None:
        fgd_net = fgd_net.to(device).eval()
    mcfg = cfg.model

    mses, pcks, aligns, srgrs = [], [], [], []
    gen_lat, real_lat = [], []
    total_frames = 0
    t_start = time.perf_counter()
    n = len(dataset)
    if max_clips:
        n = min(n, max_clips)
    pcount, pidx = col.process_count(), col.process_index()
    rank_sfx = f"_rank{pidx}" if pcount > 1 else ""
    for i in range(pidx, n, pcount):
        s = dataset[i]
        mel = torch.from_numpy(np.array(s["mel"], np.float32))[None]
        gt = np.asarray(s["motion"], dtype=np.float32)
        T = min(mel.shape[1], gt.shape[0])
        mel = mel[:, :T]
        if "hubert" in s:
            hubert = torch.from_numpy(np.array(s["hubert"], np.float32)
                                      )[None, :T]
        elif mcfg.add_hubert:
            hubert = torch.zeros((1, T, mcfg.hubert_dim))
        else:
            hubert = None
        sid = int(np.asarray(s.get("id", [0])).reshape(-1)[0])
        pid = torch.nn.functional.one_hot(torch.tensor([sid]),
                                          mcfg.style_dim).float()

        if output_gt:
            out = gt[:T]
        else:
            out = gen.generate(mel, pid, noise(i), hubert=hubert
                               )[0].float().cpu().numpy()
        if exporter is not None:
            exporter.export(out, out_dir, f"clip_{i:05d}{rank_sfx}")
        else:
            np.save(os.path.join(out_dir, f"clip_{i:05d}{rank_sfx}.npy"),
                    out)
        total_frames += T

        C = out.shape[-1]
        m, p = mse_pck_channels(out[None, :T], gt[None, :T])
        mses.append(m)
        pcks.append(p)
        if "audio" in s:
            beats = audio_onset_times(np.asarray(s["audio"], np.float32),
                                      cfg.data.audio_sr, device=device)
            aligns.append(beat_alignment(out[:T, :mcfg.pose_dim], beats,
                                         cfg.data.fps))
        # SRGR on clips with the BEAT semantic annotation, over the
        # gesture block; srgr_avg_weight 0.165 is the BEAT harness's
        # normalizer, None the clip's own mean weight
        if "sem" in s and mcfg.pose_dim % 3 == 0 and not output_gt:
            sem = np.asarray(s["sem"], dtype=np.float32).reshape(-1)[:T]
            srgrs.append(srgr(out[:T, :mcfg.pose_dim],
                              gt[:T, :mcfg.pose_dim], sem,
                              avg_weight=srgr_avg_weight))
        if fgd_net is not None:
            W = cfg.data.n_poses
            nwin = T // W
            if nwin:
                with torch.no_grad():
                    for wins, lat in ((out, gen_lat), (gt, real_lat)):
                        x = torch.as_tensor(wins[:nwin * W].reshape(
                            nwin, W, C)).to(device)
                        lat.append(fgd_net(x).cpu().numpy())
        log(f"[test-stream] clip {i}: {T} frames "
            f"mse={m:.4f} pck={p:.4f}")

    wall = time.perf_counter() - t_start
    metrics = {
        "mse": float(np.mean(mses)) if mses else float("nan"),
        "pck": float(np.mean(pcks)) if pcks else float("nan"),
        "beat_align": float(np.mean(aligns)) if aligns else float("nan"),
        "srgr": float(np.mean(srgrs)) if srgrs else float("nan"),
        # which normalizer the srgr number used
        "srgr_norm": (srgr_avg_weight if srgr_avg_weight is not None
                      else "self"),
        "fps": total_frames / max(wall, 1e-9),
        "clips": float(len(mses)),
    }
    if pcount > 1:
        # a process with no clips (n < N) or no audio contributes nothing
        # to a metric it did not measure (the nanmean form)
        metrics.update(col.all_reduce_nanmean_metrics(
            {m: metrics[m] for m in ("mse", "pck")}, weight=metrics["clips"]))
        metrics.update(col.all_reduce_nanmean_metrics(
            {"beat_align": metrics["beat_align"]}, weight=float(len(aligns))))
        metrics.update(col.all_reduce_nanmean_metrics(
            {"srgr": metrics["srgr"]}, weight=float(len(srgrs))))
        # processes stream at once: the global rate is the sum of theirs
        sums = col.gather_arrays(np.asarray(
            [[metrics["clips"], metrics["fps"]]], dtype=np.float64)).sum(0)
        metrics["clips"], metrics["fps"] = float(sums[0]), float(sums[1])
        if fgd_net is not None:
            # a process whose clips held no full window sends 0 rows
            if gen_lat:
                lat, rlat = np.concatenate(gen_lat), np.concatenate(real_lat)
            else:
                with torch.no_grad():
                    width = fgd_net(torch.zeros(
                        (1, cfg.data.n_poses, mcfg.motion_dim),
                        device=device)).shape[-1]
                lat = rlat = np.zeros((0, width), np.float32)
            gen_lat = [col.gather_arrays_ragged(lat)]
            real_lat = [col.gather_arrays_ragged(rlat)]
    if gen_lat and sum(a.shape[0] for a in gen_lat) >= 2:
        metrics["fgd"] = frechet_from_activations(
            np.concatenate(gen_lat), np.concatenate(real_lat))
    return metrics

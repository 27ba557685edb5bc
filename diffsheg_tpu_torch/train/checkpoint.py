"""Checkpoints: the JAX package's policy in the port's own format.

Counterpart of ``diffsheg_tpu/train/checkpoint.py``, with its directory
names: under the root, ``latest/<step>/`` keeps the newest ``max_keep``
steps (each with a ``latest_<step>.meta.json`` sidecar, pruned with it),
``<tag>/`` holds an immutable snapshot (``epoch_NNNN``, ``<metric>_best``)
beside ``<tag>.meta.json``, and ``best_metrics.json`` the best value of
each metric.  A checkpoint is one ``state.pt``: ``torch.save`` of the
train state's tensors (model state dict, optimizer state dict, step,
sampler history), loaded with ``weights_only=True``; the free-form
metadata (epoch, config JSON) lives in the JSON sidecars.  The JAX
package writes Orbax directories instead, which this module refuses by
name.

Across processes, process 0 writes and every process reads.  A model
sharded by ``fully_shard`` is gathered into the full state dict first
(``torch.distributed.checkpoint.state_dict``, the optimizer's keyed by
parameter index as ``Optimizer.state_dict`` keys it), so a checkpoint is
the same file whatever the layout and a run resumes at another world
size.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _is_orbax(path: str) -> bool:
    """An Orbax checkpoint directory: one of its metadata files, and no
    ``state.pt``."""
    return (not os.path.exists(os.path.join(path, STATE_FILE))
            and any(os.path.exists(os.path.join(path, n)) for n in
                    ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")))


def _refuse_orbax(path: str) -> None:
    raise ValueError(
        f"{path}: an Orbax checkpoint, which is the JAX package's format; "
        "the port reads its own checkpoints (state.pt). Export the JAX "
        "weights as a reference .tar (python -m diffsheg_tpu.cli "
        "export-ckpt) and pass the .tar")


def _full_options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions
    return StateDictOptions(full_state_dict=True, **kw)


def _rekey_optimizer(osd: Dict, model, to_index: bool) -> Dict:
    """A full optimizer state dict keyed by parameter name <-> by index in
    ``model.parameters()`` order."""
    if not osd:             # a process that gathers nothing
        return osd
    names = [n for n, _ in model.named_parameters()]
    key = ({n: i for i, n in enumerate(names)} if to_index
           else dict(enumerate(names)))
    return {"state": {key[k]: v for k, v in osd["state"].items()},
            "param_groups": [dict(g, params=[key[k] for k in g["params"]])
                             for g in osd["param_groups"]]}


def state_dict(state) -> Dict:
    """A ``train.step.TrainState`` as a dict of tensors and plain values;
    under ``fully_shard`` a collective that gathers it (into process 0's
    CPU memory; the others get empty dicts)."""
    from diffsheg_tpu_torch.parallel.mesh import is_fsdp
    model, opt, t = state.model, state.optimizer, state.t_state
    if is_fsdp(model):
        from torch.distributed.checkpoint.state_dict import (
            get_model_state_dict, get_optimizer_state_dict)
        opts = _full_options(cpu_offload=True)
        msd = get_model_state_dict(model, options=opts)
        osd = _rekey_optimizer(get_optimizer_state_dict(model, opt,
                                                        options=opts),
                               model, to_index=True)
    else:
        msd, osd = model.state_dict(), opt.state_dict()
    return {"step": state.step, "model": msd, "optimizer": osd,
            "t_state": None if t is None else {"history": t.history,
                                               "counts": t.counts}}


def load_state_dict(state, payload: Dict):
    """Fill ``state`` (built by ``create_train_state`` for the same
    config, sharded or not) from :func:`state_dict`'s dict; returns
    ``state``."""
    from diffsheg_tpu_torch.diffusion.timestep_sampler import LossAwareState
    from diffsheg_tpu_torch.parallel.mesh import is_fsdp
    if is_fsdp(state.model):
        from torch.distributed.checkpoint.state_dict import (
            set_model_state_dict, set_optimizer_state_dict)
        set_model_state_dict(state.model, payload["model"],
                             options=_full_options())
        set_optimizer_state_dict(
            state.model, state.optimizer,
            _rekey_optimizer(payload["optimizer"], state.model,
                             to_index=False), options=_full_options())
    else:
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    t = payload["t_state"]
    if (t is None) != (state.t_state is None):
        raise ValueError("checkpoint and config disagree on "
                         "train.timestep_sampler")
    if t is not None:
        dev = state.t_state.history.device
        state.t_state = LossAwareState(t["history"].to(dev),
                                       t["counts"].to(dev))
    return state


def read_state_file(path: str) -> Dict:
    """The payload of one checkpoint directory, its tensors on the CPU
    (``load_state_dict`` moves them to the model's device; Adam keeps its
    step counts on the CPU)."""
    if _is_orbax(path):
        _refuse_orbax(path)
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


class CheckpointManager:
    """latest / periodic / best-metric checkpoint policy."""

    def __init__(self, root: str, max_keep: int = 3):
        from diffsheg_tpu_torch.parallel.collectives import process_index
        self.root = os.path.abspath(root)
        self.max_keep = max_keep
        self.writer = process_index() == 0
        if self.writer:
            os.makedirs(self.root, exist_ok=True)
        self._latest = os.path.join(self.root, "latest")
        self._best: Dict[str, float] = self._load_best_table()

    # -- metadata ----------------------------------------------------------
    def _best_path(self) -> str:
        return os.path.join(self.root, "best_metrics.json")

    def _load_best_table(self) -> Dict[str, float]:
        if os.path.exists(self._best_path()):
            with open(self._best_path()) as f:
                return json.load(f)
        return {}

    def _save_best_table(self) -> None:
        if not self.writer:
            return
        with open(self._best_path(), "w") as f:
            json.dump(self._best, f, indent=2)

    @property
    def best_metrics(self) -> Dict[str, float]:
        return dict(self._best)

    def _write_meta(self, name: str, meta: Optional[Dict]) -> None:
        if not self.writer:
            return
        with open(os.path.join(self.root, f"{name}.meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=2)

    def _read_meta(self, name: str) -> Dict:
        path = os.path.join(self.root, f"{name}.meta.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    # -- save/restore ------------------------------------------------------
    def _write(self, path: str, state) -> None:
        """Write through a temporary file, so a crash leaves the old
        checkpoint or the new one, never half of one.  Every process
        calls it (gathering a sharded state is a collective); process 0
        writes, and the others wait until the file is there."""
        from diffsheg_tpu_torch.parallel.collectives import barrier
        payload = state_dict(state)
        if self.writer:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, STATE_FILE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, STATE_FILE))
        barrier("checkpoint_written")

    def all_steps(self):
        """The kept steps of ``latest``, oldest first; an Orbax directory
        among them raises."""
        if not os.path.isdir(self._latest):
            return []
        steps = []
        for name in os.listdir(self._latest):
            path = os.path.join(self._latest, name)
            if not (name.isdigit() and os.path.isdir(path)):
                continue
            if _is_orbax(path):
                _refuse_orbax(path)
            if os.path.exists(os.path.join(path, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save_latest(self, step: int, state,
                    meta: Optional[Dict] = None) -> None:
        self._write(os.path.join(self._latest, str(step)), state)
        self._write_meta(f"latest_{step}", meta)
        if not self.writer:
            return
        kept = set(self.all_steps()[-self.max_keep:])
        for s in self.all_steps():
            if s not in kept:
                shutil.rmtree(os.path.join(self._latest, str(s)))
        for p in glob.glob(os.path.join(self.root, "latest_*.meta.json")):
            s = os.path.basename(p)[len("latest_"):-len(".meta.json")]
            if s.isdigit() and int(s) not in kept:
                os.remove(p)

    def restore_latest(self, state) -> Optional[Tuple[object, Dict]]:
        """Fill ``state`` from the newest checkpoint; returns (state, meta)
        or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        payload = read_state_file(os.path.join(self._latest, str(step)))
        return load_state_dict(state, payload), self._read_meta(
            f"latest_{step}")

    def save_tagged(self, tag: str, state,
                    meta: Optional[Dict] = None) -> None:
        """Snapshot (periodic epoch or best metric)."""
        self._write(os.path.join(self.root, tag), state)
        self._write_meta(tag, meta)

    def restore_tagged(self, tag: str, state) -> Tuple[object, Dict]:
        payload = read_state_file(os.path.join(self.root, tag))
        return load_state_dict(state, payload), self._read_meta(tag)

    def update_best(self, metric: str, value: float, state,
                    meta: Optional[Dict] = None,
                    lower_is_better: bool = True) -> bool:
        """Snapshot iff ``value`` improves on the stored best."""
        prev = self._best.get(metric)
        improved = (prev is None or
                    (value < prev if lower_is_better else value > prev))
        if improved:
            self._best[metric] = float(value)
            self._save_best_table()
            self.save_tagged(f"{metric}_best", state, meta)
        return improved


def load_model_weights(root: str, model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model`` with the weights (and BatchNorm statistics) of the
    newest ``latest`` checkpoint under a training checkpoint directory
    ``root`` (a trainer's ``<workdir>/ckpt``); returns the model."""
    step = CheckpointManager(root).latest_step()
    if step is None:
        raise ValueError(f"no checkpoint under {root}")
    payload = read_state_file(os.path.join(root, "latest", str(step)))
    model.load_state_dict(payload["model"])
    return model

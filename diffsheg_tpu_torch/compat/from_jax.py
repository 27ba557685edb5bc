"""Carry weights across from a JAX/Flax variables tree.

The port's modules use the Flax parameter names, so a tree of nested dicts
of numpy arrays (``{"params": ..., "batch_stats": ...}``, e.g. from
``jax.tree.map(np.asarray, variables)``) fills them by walking both in
step:

  - ``Dense`` kernels are (in, out) and become ``nn.Linear`` weights
    (out, in);
  - ``Conv`` kernels are (k, in / groups, out) and become ``nn.Conv1d``
    weights (out, in / groups, k);
  - ``LayerNorm`` / ``BatchNorm`` scale and bias become weight and bias,
    and BatchNorm ``batch_stats`` mean / var the running statistics;
  - ``Embed`` tables (``embedding``) become ``nn.Embedding`` weights;
  - both layer layouts load: unrolled ``layer_i`` subtrees and the
    ``scan_layers`` form, one ``layers/layer`` subtree whose leaves carry
    a leading layer axis.

The FGD feature net (``eval/fgd_net.py``) carries Flax's names too, so
JAX's ``FgdFeatureNet`` variables load into it the same way.

Every parameter and buffer of the module must be filled exactly once, and
every leaf of the tree must land somewhere; anything else raises.
:func:`export_flax_tree` is the inverse: a module's weights as such a tree.
:func:`load_flax_train_state` carries a whole JAX ``TrainState`` (weights,
optimizer moments, learning rate, step, sampler history) into the port's,
so that a run started in JAX continues in the port.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from diffsheg_tpu_torch.models.denoiser import BatchNorm

Tree = Dict[str, Any]


def _set(t: torch.Tensor, value, filled: set, name: str) -> None:
    value = torch.tensor(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"{name}: tree shape {tuple(value.shape)} != "
                         f"module shape {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(value.to(t.dtype))
    filled.add(id(t))


def _fill(mod: nn.Module, p: Tree, bs: Optional[Tree], filled: set,
          path: str) -> None:
    bs = bs or {}
    if isinstance(mod, nn.Linear):
        _set(mod.weight, np.asarray(p["kernel"]).T, filled, path + "/kernel")
        if "bias" in p:
            _set(mod.bias, p["bias"], filled, path + "/bias")
        return
    if isinstance(mod, nn.Conv1d):
        _set(mod.weight, np.asarray(p["kernel"]).transpose(2, 1, 0), filled,
             path + "/kernel")
        if "bias" in p:
            _set(mod.bias, p["bias"], filled, path + "/bias")
        return
    if isinstance(mod, nn.Embedding):
        _set(mod.weight, p["embedding"], filled, path + "/embedding")
        return
    if isinstance(mod, (nn.LayerNorm, BatchNorm)):
        _set(mod.weight, p["scale"], filled, path + "/scale")
        _set(mod.bias, p["bias"], filled, path + "/bias")
        if isinstance(mod, BatchNorm):
            _set(mod.running_mean, bs["mean"], filled, path + "/mean")
            _set(mod.running_var, bs["var"], filled, path + "/var")
        return
    for key, sub in p.items():
        where = f"{path}/{key}"
        if key == "layers" and isinstance(sub, dict) and set(sub) == {"layer"}:
            # scan_layers layout: slice the leading layer axis back out
            stacked, st = sub["layer"], bs.get("layers", {}).get("layer")
            n = len(np.asarray(_first_leaf(stacked)))
            for i in range(n):
                _fill(getattr(mod, f"layer_{i}"), _index(stacked, i),
                      None if st is None else _index(st, i), filled,
                      f"{where}[{i}]")
            continue
        if not hasattr(mod, key):
            raise KeyError(f"{where}: no such attribute on "
                           f"{type(mod).__name__}")
        target = getattr(mod, key)
        if isinstance(target, nn.Module):
            _fill(target, sub, bs.get(key), filled, where)
        else:
            _set(target, sub, filled, where)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_flax_tree(module: nn.Module, variables: Tree) -> nn.Module:
    """Fill ``module`` from ``{"params": ..., "batch_stats": ...}``;
    returns the module."""
    filled: set = set()
    _fill(module, variables["params"], variables.get("batch_stats"), filled,
          "")
    missing = [n for n, t in list(module.named_parameters())
               + list(module.named_buffers()) if id(t) not in filled]
    if missing:
        raise KeyError(f"not in the tree: {missing}")
    return module


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def export_flax_tree(module: nn.Module) -> Tree:
    """The inverse of :func:`load_flax_tree`: ``module`` ->
    ``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays under
    the Flax names (unrolled ``layer_i`` layout)."""
    params: Tree = {}
    stats: Tree = {}
    if isinstance(module, nn.Linear):
        params["kernel"] = _np(module.weight).T
        if module.bias is not None:
            params["bias"] = _np(module.bias)
    elif isinstance(module, nn.Conv1d):
        params["kernel"] = _np(module.weight).transpose(2, 1, 0)
        if module.bias is not None:
            params["bias"] = _np(module.bias)
    elif isinstance(module, nn.Embedding):
        params["embedding"] = _np(module.weight)
    elif isinstance(module, (nn.LayerNorm, BatchNorm)):
        params["scale"] = _np(module.weight)
        params["bias"] = _np(module.bias)
        if isinstance(module, BatchNorm):
            stats["mean"] = _np(module.running_mean)
            stats["var"] = _np(module.running_var)
    else:
        for name, p in module.named_parameters(recurse=False):
            params[name] = _np(p)
        for name, child in module.named_children():
            sub = export_flax_tree(child)
            params[name] = sub["params"]
            if sub["batch_stats"]:
                stats[name] = sub["batch_stats"]
    return {"params": params, "batch_stats": stats}


def load_flax_train_state(state, jax_state):
    """Fill the port's ``train.step.TrainState`` ``state`` (from
    ``create_train_state`` for the same config) from a JAX ``TrainState``
    as numpy (``jax.tree.map(np.asarray, state)``): params and
    ``batch_stats`` into the model; the optax ``(clip, inject_hyperparams
    (adam))`` state's ``mu`` / ``nu`` / ``count`` into Adam's moments and
    step counts, laid out as the weights (each leaf through the same
    transposes), and its ``learning_rate`` into the optimizer; the step;
    and the loss-aware sampler's history.  Returns ``state``."""
    from diffsheg_tpu_torch.diffusion.timestep_sampler import LossAwareState
    model, opt = state.model, state.optimizer
    stats = jax_state.batch_stats or {}
    load_flax_tree(model, {"params": jax_state.params, "batch_stats": stats})
    inject = jax_state.opt_state[1]
    adam = inject.inner_state[0]
    moments = {}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        scratch = load_flax_tree(copy.deepcopy(model),
                                 {"params": tree, "batch_stats": stats})
        moments[key] = dict(scratch.named_parameters())
    count = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    for name, p in model.named_parameters():
        opt.state[p] = {"step": count.clone(),
                        **{k: m[name].detach().clone().to(p.device)
                           for k, m in moments.items()}}
    lr = float(np.asarray(inject.hyperparams["learning_rate"]))
    for group in opt.param_groups:
        group["lr"] = lr
    state.step = int(np.asarray(jax_state.step))
    t_state = jax_state.t_state
    if state.t_state is not None and hasattr(t_state, "history"):
        dev = state.t_state.history.device
        state.t_state = LossAwareState(
            torch.tensor(np.asarray(t_state.history, np.float32), device=dev),
            torch.tensor(np.asarray(t_state.counts, np.int32), device=dev))
    return state

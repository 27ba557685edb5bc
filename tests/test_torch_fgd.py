"""The FGD feature net and its checkpoint converter
(``diffsheg_tpu_torch/eval/{fgd_net,fgd}.py``,
``compat/fgd_ckpt.py``) against the JAX package's: latents of shared
weights at 34 and 88 frames within f32 rel-RMS 1e-5, the converted
reference state dict equal leaf for leaf, FGD through both
calculators."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsheg_tpu.compat import fgd_ckpt as jckpt
from diffsheg_tpu.eval import fgd as jfgd
from diffsheg_tpu.eval.fgd_net import FgdNetConfig as JConfig
from diffsheg_tpu.eval.fgd_net import init_fgd_net as jinit
from diffsheg_tpu_torch.compat import fgd_ckpt as tckpt
from diffsheg_tpu_torch.compat.from_jax import load_flax_tree
from diffsheg_tpu_torch.eval import fgd as tfgd
from diffsheg_tpu_torch.eval.fgd_net import (FgdFeatureNet, FgdNetConfig,
                                             init_fgd_net)
from torch_parity import perturb, reference_fgd_state_dict, rel_rms

SHAPES = [(34, 192), (88, 232)]
# a narrow latent keeps the 88-frame head small here (300 on the card)
BASE = 64


def jax_variables(T, C, seed=0):
    _, v = jinit(JConfig(n_frames=T, pose_dim=C, feature_length=BASE),
                 jax.random.PRNGKey(seed))
    v = jax.tree.map(np.asarray, dict(v))
    return {k: perturb(x, seed + 1) for k, x in v.items()}


def jax_latents(T, C, variables, x):
    model, _ = jinit(JConfig(n_frames=T, pose_dim=C, feature_length=BASE))
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, variables),
                                  jnp.asarray(x)))


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("T,C", SHAPES)
def test_feature_net_matches_flax(T, C):
    variables = jax_variables(T, C)
    x = np.random.RandomState(2).randn(6, T, C).astype(np.float32)
    want = jax_latents(T, C, variables, x)
    net = load_flax_tree(FgdFeatureNet(FgdNetConfig(
        n_frames=T, pose_dim=C, feature_length=BASE)), variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, BASE)
    assert rel_rms(got, want) <= 1e-5
    # the 34-frame head has no fc0; the long one has it
    assert hasattr(net.pose_encoder, "fc0") == (T >= 64)


@pytest.mark.parametrize("T,C", SHAPES)
def test_convert_state_dict_matches_jax(T, C, tmp_path):
    sd = reference_fgd_state_dict(T, C, seed=T, base=BASE)
    jcfg = JConfig(n_frames=T, pose_dim=C, feature_length=BASE)
    tcfg = FgdNetConfig(n_frames=T, pose_dim=C, feature_length=BASE)
    want = flat_leaves(jckpt.convert_fgd_state_dict(sd, jcfg))
    wrapped = {"model_state": {f"module.{k}": v for k, v in sd.items()}}
    for src in (sd, wrapped):
        got = flat_leaves(tckpt.convert_fgd_state_dict(src, tcfg))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(tckpt.normalize_fgd_state_dict(wrapped)) == sorted(sd)
    # from a file holding the options Namespace, as the reference saves it
    path = str(tmp_path / "ae_300.bin")
    torch.save({"args": argparse.Namespace(vae_length=BASE), "epoch": 300,
                "model_state": sd}, path)
    net = tckpt.load_torch_fgd_checkpoint(path, tcfg, device="cpu")
    x = np.random.RandomState(3).randn(4, T, C).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    jvars = jckpt.convert_fgd_state_dict(sd, jcfg)
    assert rel_rms(got, jax_latents(T, C, jvars, x)) <= 1e-5


def test_fgd_calculator_and_positions_match_jax():
    T, C = 34, 192
    variables = jax_variables(T, C, seed=4)
    jcalc = jfgd.FgdCalculator(JConfig(feature_length=BASE),
                               jax.tree.map(jnp.asarray, variables))
    net = load_flax_tree(FgdFeatureNet(FgdNetConfig(feature_length=BASE)),
                         variables).eval()
    tcalc = tfgd.FgdCalculator(FgdNetConfig(feature_length=BASE), net)
    rng = np.random.RandomState(5)
    for _ in range(2):
        g = rng.randn(8, T, C).astype(np.float32)
        r = (rng.randn(8, T, C) * 1.3 + 0.2).astype(np.float32)
        jcalc.update(g, r)
        tcalc.update(g, r)
    want, got = jcalc.compute(), tcalc.compute()
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want)
    tcalc.reset()
    assert tcalc._gen == [] and tcalc._real == []
    a, b = rng.randn(50, 12), rng.randn(60, 12) + 0.3
    assert abs(tfgd.fgd_from_positions(a, b)
               - jfgd.fgd_from_positions(a, b)) <= 1e-12
    # a seeded random net when none is given, on the requested device
    c = tfgd.FgdCalculator(FgdNetConfig(n_frames=88, pose_dim=232,
                                        feature_length=BASE), seed=1,
                           device="cpu")
    assert c.embed(np.zeros((2, 88, 232))).shape == (2, BASE)
    n1, n2 = (init_fgd_net(FgdNetConfig(feature_length=BASE), seed=s,
                           device="cpu")
              for s in (1, 1))
    assert all(torch.equal(a, b) for a, b in zip(n1.state_dict().values(),
                                                  n2.state_dict().values()))

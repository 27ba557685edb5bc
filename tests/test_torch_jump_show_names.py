"""Public names of JAX modules that the port carries since its examples
slice, each against the JAX package on the CPU:

- ``diffusion/jump.py::generic_jump_schedule`` and
  ``jump_schedule_paper``: the walks equal JAX's list for list;
- ``data/show.py::reassemble_smplx``: equal bit for bit;
- ``models/hubert.py::hubert_large_config``: equal to the default
  ``HubertConfig``, field for field with JAX's;
- ``models/attention.py::linear_attention_core``: within 1e-6 rel-RMS in
  f32;
- ``ops/step_math.py::ddim_repaint_step``: the dispatcher, on CPU tensors
  its plain version, equal to JAX's reference within 1e-6 absolute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread)
from torch_parity import rel_rms  # noqa: E402

WALKS = [
    dict(t_T=15),
    dict(t_T=15, jump_length=1, jump_n_sample=2),
    dict(t_T=25, jump_length=3, jump_n_sample=3),
    dict(t_T=30, n_sample=2),
    dict(t_T=40, jump_length=10, jump_n_sample=2, jump2_length=3,
         jump2_n_sample=2),
    dict(t_T=40, jump_length=10, jump_n_sample=2, jump2_length=5,
         jump2_n_sample=2, jump3_length=2, jump3_n_sample=3),
    dict(t_T=60, n_sample=2, jump_length=10, jump_n_sample=3,
         start_resampling=30),
    dict(t_T=250, jump_length=10, jump_n_sample=10),
]


@pytest.mark.parametrize("kw", WALKS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_generic_jump_schedule_equals_jax(kw):
    from diffsheg_tpu.diffusion.jump import generic_jump_schedule as j_walk
    from diffsheg_tpu_torch.diffusion.jump import (
        generic_jump_schedule as p_walk, jump_schedule)
    ours = p_walk(**kw)
    assert ours == j_walk(**kw)
    if set(kw) <= {"t_T", "jump_length", "jump_n_sample"}:
        # at its other defaults the general walk is the plain jump walk
        assert ours == jump_schedule(kw["t_T"], kw.get("jump_length", 1),
                                     kw.get("jump_n_sample", 1))


def test_jump_schedule_paper_equals_jax():
    from diffsheg_tpu.diffusion.jump import jump_schedule_paper as j_paper
    from diffsheg_tpu_torch.diffusion.jump import (jump_schedule_paper,
                                                   make_step_program)
    walk = jump_schedule_paper()
    assert walk == j_paper()
    assert walk[0] == 249 and walk[-1] == -1
    # the harmonize program of the ancestral sampler
    prog = make_step_program(walk)
    assert prog.num_model_calls == 250 + 24 * 9 * 10


@pytest.mark.parametrize("lead", [(), (7,), (2, 5)])
@pytest.mark.parametrize("template", [False, True])
def test_reassemble_smplx_equals_jax(lead, template):
    from diffsheg_tpu.data.show import reassemble_smplx as j_fn
    from diffsheg_tpu_torch.data import reassemble_smplx as p_fn
    from diffsheg_tpu_torch.data.show import (combine_expression,
                                              extract_gesture)
    rs = np.random.RandomState(len(lead) + 3 * template)
    ges = rs.randn(*lead, 129).astype(np.float32)
    exp = rs.randn(*lead, 103).astype(np.float32)
    tmpl = rs.randn(165).astype(np.float32) if template else None
    ours = p_fn(ges, exp, tmpl)
    theirs = j_fn(ges, exp, tmpl)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    # the inverse of the carpentry
    assert np.array_equal(extract_gesture(ours), ges)
    assert np.array_equal(combine_expression(ours, exp[..., 3:]), exp)


def test_hubert_large_config_equals_jax():
    from diffsheg_tpu.models.hubert import hubert_large_config as j_cfg
    from diffsheg_tpu_torch.models.hubert import (HubertConfig,
                                                  hubert_large_config)
    assert hubert_large_config() == HubertConfig()
    ours = dataclasses.asdict(hubert_large_config())
    # the port's own fields (WavLM's relative-position bias) are off
    assert ours.pop("rel_pos_buckets") == 0
    assert ours == dataclasses.asdict(j_cfg())


@pytest.mark.parametrize("shape", [(2, 34, 8, 64), (3, 12, 4, 8),
                                   (1, 88, 8, 64), (4, 34, 8, 16)])
def test_linear_attention_core_equals_jax(shape):
    import jax
    from diffsheg_tpu.models.attention import linear_attention_core as j_core
    from diffsheg_tpu_torch.models.attention import linear_attention_core
    rs = np.random.RandomState(sum(shape))
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    q = np.exp(q) / np.exp(q).sum(-1, keepdims=True)     # over hd
    k = np.exp(k) / np.exp(k).sum(1, keepdims=True)      # over T
    v[:, -shape[1] // 8:] = 0.0                          # masked frames
    with jax.default_matmul_precision("highest"):
        theirs = j_core(*(jnp.asarray(a) for a in (q, k, v)))
    ours = linear_attention_core(*(torch.tensor(a) for a in (q, k, v)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    assert rel_rms(ours.numpy(), np.asarray(theirs)) <= 1e-6


@pytest.mark.parametrize("use_fused", [None, True, False])
@pytest.mark.parametrize("gt", [False, True])
def test_ddim_repaint_step_dispatch_equals_jax(gt, use_fused):
    from diffsheg_tpu.ops.step_math import ddim_repaint_step_reference as j_ref
    from diffsheg_tpu_torch.ops.step_math import (ddim_repaint_step,
                                                  fused_ddim_repaint_step)
    rs = np.random.RandomState(5 + gt)
    B, T, C, ov = 2, 12, 8, 4
    x, eps, g, gn = (rs.randn(B, T, C).astype(np.float32) for _ in range(4))
    tail = rs.randn(B, ov, C).astype(np.float32)
    # a low-noise DDIM-25 level: the blend is on
    scal = (np.float32(0.995), np.float32(1.0025), np.float32(0.0707),
            np.float32(1.0))
    args = (g, gn, tail) if gt else (None, None, None)
    theirs = np.asarray(j_ref(
        jnp.asarray(x), jnp.asarray(eps), jnp.asarray(np.array(scal)),
        *(None if a is None else jnp.asarray(a) for a in args), ov, True))
    before = fused_ddim_repaint_step.launches
    ours = ddim_repaint_step(
        torch.tensor(x), torch.tensor(eps), scal,
        *(None if a is None else torch.tensor(a) for a in args), ov, True,
        use_fused=use_fused)
    # CPU tensors never launch the kernel, whatever use_fused says
    assert fused_ddim_repaint_step.launches == before
    assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-6

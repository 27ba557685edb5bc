"""The speech encoder's dense layers (``models/hubert.py``) on the route to
split TF32 (``ops/products.py``: ``Dense``, ``takes_tf32x3``), on the CPU.

The kernel runs only on the card (``chip_smoke.py``'s speech cases count
its launches there); here:

- every product layer of ``HubertModel`` is a ``Dense`` under the
  HuBERT-large, WavLM-Large and wav2vec2-base layouts, with
  ``nn.Linear``'s parameter names and state-dict keys;
- the route in the encoder: a training frontend's chunk of 64 BEAT
  windows (7232 rows) takes its 145 products (24 layers x q, k, v, out,
  fc1, fc2, and the feature projection) and refuses WavLM's gate (64 -> 8
  on 16 heads' rows), a tail chunk of 4 windows and bf16; counted on a
  meta-device forward of the full-size encoder, so nothing is computed
  (the rule at each of these shapes: ``test_torch_tf32x3.py``'s
  ``test_route_rule``);
- a 2-layer WavLM at small widths with every f32 product sent through
  the split (``gemm_tf32x3_reference``, the kernel's plain version):
  rel-RMS to an f64 forward of the benchmark's reference under 1e-5
  (observed 8.2e-7, the same as ``F.linear``'s); the control, plain TF32
  (one product of operands rounded to TF32), reads ~5e-4 and fails it;
- on the CPU the encoder's output is ``nn.Linear``'s bit for bit.
"""

import dataclasses

import pytest
import torch
from torch import nn

from torch_parity import rel_rms
from test_torch_wavlm import SMALL, small_input, small_pair

from benchmark import program
from diffsheg_tpu_torch.audio.frontend import HUBERT_CHUNK
from diffsheg_tpu_torch.models import hubert
from diffsheg_tpu_torch.models.hubert import (HubertConfig, HubertModel,
                                              speech_encoder_config)
from diffsheg_tpu_torch.ops import products
from diffsheg_tpu_torch.ops.products import Dense, takes_tf32x3

LAYOUTS = ("hubert-large", "wavlm-large", "wav2vec2-base")
PRODUCT_LAYERS = {"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2",
                  "feat_proj", "gru_rel_pos_linear"}
# one BEAT window: 34 frames at 15 fps of 16 kHz speech, 113 encoder frames
WINDOW_SAMPLES = 36266
TOL = 1e-5


def on_meta(cfg: HubertConfig) -> HubertModel:
    with torch.device("meta"):
        return HubertModel(cfg).eval()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_product_layer_is_dense(layout):
    cfg = speech_encoder_config(layout)
    linear = {name: m for name, m in on_meta(cfg).named_modules()
              if isinstance(m, nn.Linear)}
    assert all(type(m) is Dense for m in linear.values())
    assert {name.rsplit(".", 1)[-1] for name in linear} == (
        PRODUCT_LAYERS if cfg.rel_pos_buckets
        else PRODUCT_LAYERS - {"gru_rel_pos_linear"})
    per_layer = 7 if cfg.rel_pos_buckets else 6
    assert len(linear) == cfg.num_layers * per_layer + 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_parameter_names_are_nn_linears(layout, monkeypatch):
    cfg = speech_encoder_config(layout)
    routed = on_meta(cfg)
    monkeypatch.setattr(hubert, "Dense", nn.Linear)
    plain = on_meta(cfg)
    assert not any(isinstance(m, Dense) for m in plain.modules())
    sd_r, sd_p = routed.state_dict(), plain.state_dict()
    assert list(sd_r) == list(sd_p)
    assert all(sd_r[k].shape == sd_p[k].shape for k in sd_r)


@pytest.mark.parametrize("layout,windows,dtype,taken", [
    ("wavlm-large", HUBERT_CHUNK, torch.float32, 145),
    ("hubert-large", HUBERT_CHUNK, torch.float32, 145),
    ("wavlm-large", 4, torch.float32, 0),
    ("wavlm-large", HUBERT_CHUNK, torch.bfloat16, 0),
])
def test_a_frontend_chunk_takes_its_products(layout, windows, dtype, taken,
                                             monkeypatch):
    cfg = speech_encoder_config(layout)
    seen = []

    def rule(device_type, dt, rows, n_in, n_out):
        # the decision the card would make; F.linear runs on the meta device
        seen.append(((rows, n_in, n_out),
                     takes_tf32x3("cuda", dt, rows, n_in, n_out)))
        return False

    monkeypatch.setattr(products, "takes_tf32x3", rule)
    model = on_meta(cfg).to(dtype)
    with torch.no_grad():
        out = model(torch.empty((windows, WINDOW_SAMPLES), device="meta"))
    rows = windows * 113
    assert out.shape == (windows, 113, cfg.hidden_size)
    shapes = [s for s, took in seen if took]
    assert len(shapes) == taken
    assert all(s[0] == rows for s in shapes)
    gates = [took for (_, n_in, n_out), took in seen
             if (n_in, n_out) == (64, 8)]
    assert gates == ([False] * cfg.num_layers if cfg.rel_pos_buckets else [])
    assert len(seen) == cfg.num_layers * (7 if cfg.rel_pos_buckets else 6) + 1


def _worst(out, ref):
    """rel-RMS of small_input's two rows, the padded one's valid frames."""
    return max(rel_rms(out[0].numpy(), ref[0].numpy()),
               rel_rms(out[1, :600].numpy(), ref[1, :600].numpy()))


def _plain_tf32(a, b, layout, bias=None):
    """The control: one product of operands rounded to TF32 (nt only)."""
    out = products.split_tf32(a)[0] @ products.split_tf32(b)[0].t()
    return out if bias is None else out + bias


@pytest.mark.parametrize("product,bound", [
    ("split", lambda err: err <= TOL),
    ("plain_tf32", lambda err: err > 10 * TOL),
])
def test_split_products_keep_the_encoder_f32_grade(product, bound,
                                                   monkeypatch):
    ref, port = small_pair()
    x, mask = small_input()
    with torch.no_grad():
        ref64 = ref.double()(x.double(), mask)
    calls = []
    gemm = (products.gemm_tf32x3_reference if product == "split"
            else _plain_tf32)

    def counted(*args, **kw):
        calls.append(args[2])
        return gemm(*args, **kw)

    # every f32 product takes the route, the CPU's through the plain version
    monkeypatch.setattr(products, "takes_tf32x3",
                        lambda device_type, dtype, *shape:
                        dtype == torch.float32)
    monkeypatch.setattr(products, "gemm_tf32x3_reference", counted)
    with torch.no_grad():
        out = port(x, mask)
    assert calls == ["nt"] * (SMALL["num_layers"] * 7 + 1)
    assert bound(_worst(out, ref64))


@pytest.mark.parametrize("layout", [
    dict(),
    dict(rel_pos_buckets=0, conv_bias=True),
    dict(rel_pos_buckets=0, conv_norm="group_first", stable_layer_norm=False),
], ids=["wavlm", "hubert-large", "wav2vec2-base"])
def test_on_the_cpu_the_encoder_is_nn_linears_bit_for_bit(layout,
                                                          monkeypatch):
    cfg = dataclasses.replace(
        program.hubert_config({"hubert": SMALL}, "float32"), **layout)
    torch.manual_seed(0)
    routed = HubertModel(cfg).eval()
    monkeypatch.setattr(hubert, "Dense", nn.Linear)
    plain = HubertModel(cfg).eval()
    plain.load_state_dict(routed.state_dict())
    x, mask = small_input(T=120, valid=90)
    with torch.no_grad():
        assert torch.equal(routed(x, mask), plain(x, mask))

"""What the benchmark makes from the seed: weights and noise repeat for
a seed and differ between seeds; the noise answers by (window, step)."""

import pytest
import torch

from benchmark import program, weights
from benchmark.harness import Loader
from benchmark.traffic.stream import SlotNoise


def test_weights_repeat_for_a_seed_and_follow_the_rule():
    config = Loader().config("beat")
    config["model"].update(latent_dim=16, num_layers=1, num_heads=2,
                           ff_size=32, hubert_dim=16)
    a = program.denoiser_state(config, 5, "cpu")
    b = program.denoiser_state(config, 5, "cpu")
    c = program.denoiser_state(config, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder_exp.out.weight"],
                           c["encoder_exp.out.weight"])
    # zero-initialised output projections and unit norms, perturbed
    w = a["encoder_exp.layer_0.ffn.linear2.weight"]
    assert 0 < w.abs().max() < 0.2
    g = a["encoder_exp.layer_0.sa_block.norm.weight"]
    assert (g - 1).abs().max() < 0.2 and not torch.equal(g, torch.ones_like(g))
    assert (a["encoder_exp.hubert_encoder.bn.running_var"] > 0).all()


def test_slot_noise_by_window_and_step():
    n = SlotNoise(123, windows=3, slots=5, shape=(1, 4, 2), device="cpu")
    again = SlotNoise(123, windows=3, slots=5, shape=(1, 4, 2), device="cpu")
    assert torch.equal(n.initial(2, (1, 4, 2), "cpu"),
                       again.initial(2, (1, 4, 2), "cpu"))
    assert torch.equal(n.step(1, 3, "gt", (1, 4, 2), "cpu"), n.buf[1 * 5 + 4])
    assert torch.equal(n.step(1, 3, "undo", (1, 4, 2), "cpu"), n.buf[9])
    with pytest.raises(ValueError):
        n.step(0, 4, "gt", (1, 4, 2), "cpu")       # past the window's slots
    with pytest.raises(ValueError):
        n.step(0, 0, "model", (1, 4, 2), "cpu")    # eta is 0: never drawn
    with pytest.raises(ValueError):
        n.initial(0, (2, 4, 2), "cpu")


def test_sub_seeds_take_large_seeds():
    assert weights.sub_seed(2 ** 31 + 5, "a") != weights.sub_seed(2 ** 31 + 6, "a")
    assert 0 <= weights.sub_seed(2 ** 40, "noise:3") < 2 ** 63

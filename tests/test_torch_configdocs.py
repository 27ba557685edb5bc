"""The port's configuration reference (``docs/torch_config.md``,
``diffsheg_tpu_torch/utils/configdocs.py``): current, covering every
field, and the same tables as the JAX package's row for row."""

import dataclasses
import os

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _generate():
    from diffsheg_tpu_torch.utils.configdocs import generate
    return generate()


def test_config_reference_is_current():
    with open(os.path.join(DOCS, "torch_config.md")) as f:
        on_disk = f.read()
    assert on_disk == _generate(), (
        "docs/torch_config.md is stale — regenerate with "
        "`python -m diffsheg_tpu_torch.utils.configdocs > "
        "docs/torch_config.md`")


def test_config_reference_covers_every_field():
    from diffsheg_tpu_torch.config import Config, beat_config
    text, cfg = _generate(), beat_config()
    for sec in dataclasses.fields(Config):
        sub = getattr(cfg, sec.name)
        if not dataclasses.is_dataclass(sub):
            continue
        for f in dataclasses.fields(type(sub)):
            assert f"| `{f.name}` |" in text, f"{sec.name}.{f.name} undocumented"


def test_tables_equal_the_jax_reference_row_for_row():
    """Every ``| field | type | BEAT | SHOW |`` row and every section
    heading equals JAX's; only the prose (module names, section
    docstrings) differs."""
    from diffsheg_tpu.utils.configdocs import generate as jax_generate

    def rows(text, prefix):
        return [ln for ln in text.splitlines() if ln.startswith(prefix)]

    ours, ref = _generate(), jax_generate()
    assert rows(ours, "|") == rows(ref, "|")
    # 99 section fields; the 100th, ``name``, is a top-level scalar
    assert len(rows(ours, "| `")) == 99
    assert "## `name` — str" in rows(ours, "## ")
    assert rows(ours, "## ") == rows(ref, "## ")
    assert "diffsheg_tpu_torch/config.py" in ours
    assert "diffsheg_tpu/config.py" not in ours

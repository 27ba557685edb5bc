"""Generate the port's configuration reference (docs/torch_config.md) from
its config dataclasses.

The port's own copy of ``diffsheg_tpu/utils/configdocs.py``, introspecting
``diffsheg_tpu_torch/config.py``: every section dataclass's fields, their
types, the BEAT and SHOW preset defaults, and the section docstring.  The
tables equal the JAX package's row for row (``tests/test_torch_configdocs
.py``), and the committed file equals :func:`generate`'s output.

Regenerate with::

    python -m diffsheg_tpu_torch.utils.configdocs > docs/torch_config.md
"""

from __future__ import annotations

import dataclasses

from diffsheg_tpu_torch.config import Config, beat_config, show_config


def _fmt(v) -> str:
    if isinstance(v, str):
        return f"`'{v}'`"
    return f"`{v}`"


def _type_name(f: dataclasses.Field) -> str:
    t = f.type
    return t if isinstance(t, str) else getattr(t, "__name__", str(t))


def generate() -> str:
    beat, show = beat_config(), show_config()
    lines = [
        "# Configuration reference of the PyTorch port",
        "",
        "<!-- GENERATED by diffsheg_tpu_torch/utils/configdocs.py — do not "
        "edit by hand; run `python -m diffsheg_tpu_torch.utils.configdocs "
        "> docs/torch_config.md` -->",
        "",
        "Every behavioural knob of `diffsheg_tpu_torch` is a field of a "
        "frozen dataclass (`diffsheg_tpu_torch/config.py`, the same fields, "
        "types and presets as the JAX package's, [config.md](config.md)); "
        "`beat_config()` / `show_config()` build the two shipped presets "
        "and any field is reachable from the CLI as "
        "`--set section.field=value`.",
        "",
    ]
    for sec_field in dataclasses.fields(Config):
        sub = getattr(beat, sec_field.name, None)
        if not dataclasses.is_dataclass(sub):
            lines += [f"## `{sec_field.name}` — {_type_name(sec_field)}",
                      "", f"Top-level scalar, default {_fmt(sub)}.", ""]
            continue
        cls = type(sub)
        doc = (cls.__doc__ or "").strip().split("\n\n")[0]
        doc = " ".join(line.strip() for line in doc.splitlines())
        lines += [f"## `{sec_field.name}` — {cls.__name__}", "", doc, ""]
        lines += ["| field | type | BEAT preset | SHOW preset |",
                  "|---|---|---|---|"]
        show_sub = getattr(show, sec_field.name)
        for f in dataclasses.fields(cls):
            bval, sval = getattr(sub, f.name), getattr(show_sub, f.name)
            sdisp = _fmt(sval) if sval != bval else "〃"
            lines.append(
                f"| `{f.name}` | {_type_name(f)} | {_fmt(bval)} | {sdisp} |")
        lines.append("")
    lines += [
        "## Derived / cross-field resolution",
        "",
        "`config.resolve()` applies the cross-field constants the "
        "reference injects in code (runner.py:124-225): "
        "`data.remove_hand` shrinks `model.pose_dim` (BEAT 141→33, SHOW "
        "129→39) and `data.audio_feat` selects `model.audio_dim` for SHOW "
        "(mfcc 64 / mel 128 / raw 1); explicit `--set` overrides win.  "
        "`config.check_variance_coupling()` rejects mismatched "
        "`model.learned_variance` / `diffusion.var_type` pairs before "
        "the sampler or the step is built.",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    print(generate(), end="")

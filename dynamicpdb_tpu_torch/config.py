"""Layered configuration (dataclasses + YAML + dotted CLI overrides).

Port of ``dynamicpdb_tpu/config.py``: the same dataclasses, field names and
defaults, so every ``configs/*.yaml`` file and every ``a.b.c=value``
override means the same thing to both packages. YAML files are read by ``parse_yaml``,
a reader of the subset the config files use (nested mappings of plain
scalars and flow lists), which resolves scalars as PyYAML's ``safe_load``
does, so the package needs no YAML library.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any

from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Config


@dataclass(frozen=True)
class FilteringConfig:
    max_len: int = 256


@dataclass(frozen=True)
class DataConfig:
    csv_path: str = ""
    val_csv_path: str = ""
    test_csv_path: str = ""
    frame_time: int = 2  # window length F
    frame_sample_step: int = 1
    keep_first: int | None = 100000
    fix_sample_start: int | None = 100000
    min_t: float = 0.01
    num_t: int = 10  # reverse steps
    dynamics: bool = True
    sample_mode: str = "time_batch"
    cluster_path: str = ""
    filtering: FilteringConfig = field(default_factory=FilteringConfig)


@dataclass(frozen=True)
class EmbedConfig:
    index_embed_size: int = 32
    aatype_embed_size: int = 32
    embed_self_conditioning: bool = False
    use_aatype_embedding: bool = False
    num_bins: int = 22
    min_bin: float = 1e-5
    max_bin: float = 20.0


@dataclass(frozen=True)
class IPAConfig:
    c_s: int = 256
    c_z: int = 128
    c_hidden: int = 256
    no_heads: int = 8
    no_qk_points: int = 8
    no_v_points: int = 12
    num_blocks: int = 4
    coordinate_scaling: float = 1.0
    temporal: bool = False
    temporal_position_max_len: int = 40
    # Mirrored so that YAML files and overrides written for the JAX package
    # load unchanged. They select nothing in the port: the IPA attention of
    # a CUDA tensor always runs the hand-written kernel
    # (ops/ipa_attention.py), and a CPU tensor its plain version.
    use_pallas_attention: bool | str = False
    pallas_min_n: int = 8192
    pallas_interpret: bool = False


@dataclass(frozen=True)
class ModelConfig:
    node_embed_size: int = 256
    edge_embed_size: int = 128
    node_repr_dim: int = 256
    edge_repr_dim: int = 128
    dropout: float = 0.0
    # "float32" | "bfloat16": compute dtype of the projections, embedders,
    # ConvNet and angle head; logits, softmax, geometry and block outputs
    # stay float32
    compute_dtype: str = "float32"
    remat: bool = False
    cfg_drop_rate: float = 0.0
    cfg_gamma: float = 2.0
    embed: EmbedConfig = field(default_factory=EmbedConfig)
    ipa: IPAConfig = field(default_factory=IPAConfig)


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "dfold_tpu"
    seed: int = 0
    batch_size: int = 8
    grad_accum: int = 1
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    lr_decay_steps: int = 1000000
    grad_clip_norm: float | None = None
    num_epoch: int = 500000
    log_freq: int = 32
    ckpt_freq: int = 400
    ckpt_dir: str = "ckpt"
    eval_dir: str = "eval_outputs"
    warm_start: str | None = None
    trans_loss_weight: float = 100.0
    rot_loss_weight: float = 7.0
    torsion_loss_weight: float = 1.0
    rot_loss_t_threshold: float = 0.0
    separate_rot_loss: bool = False
    bb_atom_loss_weight: float = 1.0
    bb_atom_loss_t_filter: float = 0.25
    dist_mat_loss_weight: float = 1.0
    dist_mat_loss_t_filter: float = 0.25
    aux_loss_weight: float = 0.25
    cond_noise_trans: float = 0.0
    cond_noise_rot_deg: float = 0.0
    unroll_steps: int = 1
    noise_scale: float = 1.0
    num_loader_workers: int = 2
    mesh_shape: tuple = ()
    mesh_axes: tuple = ("data",)
    bf16: bool = False
    opt_state_dtype: str | None = None
    ema_decay: float | None = None
    amsgrad_formulation: str = "optax"
    zero_opt_state: bool = True


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    diffuser: SE3Config = field(default_factory=SE3Config)
    model: ModelConfig = field(default_factory=ModelConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)


# ---------------------------------------------------------------------------
# overrides / YAML
# ---------------------------------------------------------------------------
def _coerce(value: str, current: Any, allows_str: bool = True) -> Any:
    if value.lower() in ("null", "none"):
        return None
    if value.lower() == "auto":
        # only tri-state fields (declared `bool | str`) accept 'auto'; on a
        # pure-bool field a truthy string would silently enable the feature
        if isinstance(current, bool) and not allows_str:
            raise ValueError(
                "'auto' is not valid for a boolean-only field; use true/false"
            )
        return "auto"
    if isinstance(current, bool) or (
        isinstance(current, str) and current.lower() in (
            "auto", "true", "false", "1", "0", "yes", "no", "on", "off"
        )
    ):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        return value
    if current is None:
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        return value
    if isinstance(current, int) and not isinstance(current, bool):
        return int(float(value))
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        if not value.strip("()[] "):
            return ()
        return tuple(
            _coerce(v.strip(), current[0] if current else "0")
            for v in value.strip("()[]").split(",")
        )
    return value


def _replace_path(obj: Any, path: list[str], value: Any) -> Any:
    name = path[0]
    if not hasattr(obj, name):
        raise KeyError(f"No config field '{name}' on {type(obj).__name__}")
    current = getattr(obj, name)
    if len(path) == 1:
        declared = ""
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                if f.name == name:
                    declared = str(f.type)
                    break
        allows_str = "str" in declared
        new = (
            _coerce(value, current, allows_str=allows_str)
            if isinstance(value, str) else value
        )
        return dataclasses.replace(obj, **{name: new})
    return dataclasses.replace(
        obj, **{name: _replace_path(current, path[1:], value)}
    )


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``section.field=value`` overrides (Hydra-style CLI syntax)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like a.b=c, got: {ov}")
        key, value = ov.split("=", 1)
        cfg = _replace_path(cfg, key.split("."), value)
    return cfg


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict):
            # nested dataclass types are declared as strings under
            # `from __future__ import annotations`: take the default's type
            default = (
                f.default_factory() if f.default_factory is not dataclasses.MISSING
                else f.default
            )
            kwargs[f.name] = _from_dict(type(default), v)
        else:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


# PyYAML's (YAML 1.1) implicit scalar types, without the sexagesimal forms
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$")
_YAML_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _yaml_scalar(text: str) -> Any:
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_yaml_scalar(v) for v in inner.split(",")] if inner else []
    if _YAML_NULL.match(t):
        return None
    if _YAML_BOOL.match(t):
        return t.lower() in ("yes", "true", "on")
    if _YAML_INT.match(t):
        v = t.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _YAML_FLOAT.match(t):
        v = t.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v.startswith("-") else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    return t


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    """A YAML document of nested block mappings whose leaves are plain or
    quoted scalars or flow lists of scalars, as a dict. Anything outside
    that subset raises ValueError."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for n, raw_line in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw_line).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"YAML line {n}: tab indentation")
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        key, sep, value = body.partition(":")
        if (body.startswith(("- ", "{", "[", "?")) or body == "-"
                or value.strip().startswith(("&", "*", "!", "|", ">", "{"))):
            raise ValueError(f"YAML line {n}: unsupported syntax: {body!r}")
        if not sep or (value and not value.startswith(" ")):
            raise ValueError(f"YAML line {n}: expected 'key: value': {body!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key = _yaml_scalar(key)
        if value.strip():
            parent[key] = _yaml_scalar(value)
        else:  # a mapping if indented lines follow, else null
            child: dict = {}
            stack.append((indent, child))
            parent[key] = child
    _empty_to_none(root)
    return root


def _empty_to_none(d: dict):
    """``key:`` with nothing under it is null, as in YAML."""
    for k, v in d.items():
        if isinstance(v, dict):
            if v:
                _empty_to_none(v)
            else:
                d[k] = None


def load_yaml(path: str, overrides: list[str] | None = None) -> Config:
    with open(path) as f:
        raw = parse_yaml(f.read())
    cfg = _from_dict(Config, raw)
    return apply_overrides(cfg, overrides or [])


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)

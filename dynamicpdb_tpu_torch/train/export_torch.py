"""Export the port's weights as a REFERENCE-format torch checkpoint.

Port of ``dynamicpdb_tpu/train/export_torch.py``, the inverse of
``train/import_torch.py``: a model trained with the port is written as the
torch pickle the reference's evaluator reads, ``{'model': state_dict,
'conf', 'optimizer', 'epoch', 'step'}``, loadable by its strict
``load_state_dict`` after the 'module.' strip.

The port's parameters already use the reference layout, so no mapping is
needed. A strict load needs every key the reference network registers,
its dead parameters included (modules whose outputs it computes and then
overwrites): ``embedding_layer.node_ln`` / ``edge_ln`` and the two
``*_timestep_proj`` MLPs are written as torch-default LayerNorm values
(weight 1, bias 0) and zero MLPs, so the file is deterministic and the
dead weights inert (``_dead_embedder_entries``, as the JAX module writes
them). A parameter the reference network cannot hold, the aatype
embedding of ``embed.use_aatype_embedding``, makes a strict export raise;
``strict=False`` (the CLI's ``--no-strict``) drops it with a warning.

    python -m dynamicpdb_tpu_torch.train.export_torch \\
        --ckpt runs/x/step_1000.ckpt --out dfold_ref.pth [--no-strict] \\
        [model.key=value ...]
"""
from __future__ import annotations

import dataclasses
import logging
import types

import numpy as np
import torch

from dynamicpdb_tpu_torch.config import ModelConfig

log = logging.getLogger(__name__)


def _dead_embedder_entries(model_cfg: ModelConfig) -> dict[str, np.ndarray]:
    """State-dict entries for the reference embedder's dead parameters:
    time_embed_size = node_embed_size; each *_timestep_proj is
    Linear(time, out//2) -> SiLU -> Linear(out//2, out)."""
    ns, es = model_cfg.node_embed_size, model_cfg.edge_embed_size
    out: dict[str, np.ndarray] = {}

    def mlp(prefix: str, d_in: int, d_out: int):
        out[f"{prefix}.0.weight"] = np.zeros((d_out // 2, d_in), np.float32)
        out[f"{prefix}.0.bias"] = np.zeros((d_out // 2,), np.float32)
        out[f"{prefix}.2.weight"] = np.zeros((d_out, d_out // 2), np.float32)
        out[f"{prefix}.2.bias"] = np.zeros((d_out,), np.float32)

    mlp("embedding_layer.node_timestep_proj", ns, ns)
    out["embedding_layer.node_ln.weight"] = np.ones((ns,), np.float32)
    out["embedding_layer.node_ln.bias"] = np.zeros((ns,), np.float32)
    mlp("embedding_layer.edge_timestep_proj", ns, es)
    out["embedding_layer.edge_ln.weight"] = np.ones((es,), np.float32)
    out["embedding_layer.edge_ln.bias"] = np.zeros((es,), np.float32)
    return out


def reference_shapes(model_cfg: ModelConfig) -> dict[str, tuple]:
    """The live keys of the reference network at ``model_cfg`` and their
    shapes: the port's network without the aatype embedding, built on the
    meta device."""
    from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork

    ref_cfg = dataclasses.replace(model_cfg, embed=dataclasses.replace(
        model_cfg.embed, use_aatype_embedding=False))
    with torch.device("meta"):
        net = DFoldScoreNetwork(ref_cfg, device="meta")
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def reference_state_dict_from_port(state_dict: dict, model_cfg: ModelConfig,
                                   *, strict: bool = True
                                   ) -> dict[str, np.ndarray]:
    """The port's state dict as the reference FullScoreNetwork's (numpy
    float32 values; callers wrap them in tensors). ``strict`` raises on a
    parameter the reference architecture cannot represent; otherwise it is
    dropped with a warning."""
    want = reference_shapes(model_cfg)
    sd = _dead_embedder_entries(model_cfg)
    for key, shape in want.items():
        if key not in state_dict:
            raise KeyError(
                f"param '{key}' not in the state dict: the model config used "
                f"for export (num_blocks={model_cfg.ipa.num_blocks}, "
                f"c_s={model_cfg.ipa.c_s}, c_z={model_cfg.ipa.c_z}) does not "
                "match the trained architecture; pass model.* overrides")
        value = state_dict[key].detach().to("cpu", torch.float32).numpy()
        if value.shape != shape:
            raise ValueError(f"param '{key}' has shape {value.shape}, the "
                             f"model config gives {shape}; pass model.* "
                             "overrides")
        sd[key] = value
    unmapped = sorted(set(state_dict) - set(want))
    if unmapped:
        msg = ("parameters not representable in the reference architecture: "
               + ", ".join(unmapped))
        if strict:
            raise ValueError(msg)
        log.warning("%s (dropped, strict=False)", msg)
    return sd


def reference_model_conf(model_cfg: ModelConfig):
    """A pickleable ``conf`` whose ``.model`` matches the reference's Hydra
    model tree, so the evaluator's ``OmegaConf.merge(conf.model,
    ckpt.conf.model)`` reconstructs the exported architecture."""
    e, i = model_cfg.embed, model_cfg.ipa
    model = {
        "node_embed_size": model_cfg.node_embed_size,
        "edge_embed_size": model_cfg.edge_embed_size,
        "dropout": model_cfg.dropout,
        "cfg_drop_rate": model_cfg.cfg_drop_rate,
        "cfg_gamma": model_cfg.cfg_gamma,
        "embed": {
            "index_embed_size": e.index_embed_size,
            "aatype_embed_size": e.aatype_embed_size,
            "embed_self_conditioning": e.embed_self_conditioning,
            "num_bins": e.num_bins,
            "min_bin": e.min_bin,
            "max_bin": e.max_bin,
            "DFOLDv2_embedder": True,
        },
        "ipa": {
            "c_s": i.c_s,
            "c_z": i.c_z,
            "c_hidden": i.c_hidden,
            "no_heads": i.no_heads,
            "no_qk_points": i.no_qk_points,
            "no_v_points": i.no_v_points,
            "num_blocks": i.num_blocks,
            "coordinate_scaling": i.coordinate_scaling,
            "temporal": i.temporal,
        },
    }
    return types.SimpleNamespace(model=model)


def export_reference_checkpoint(path: str, state_dict: dict,
                                model_cfg: ModelConfig, *, epoch: int = 0,
                                step: int = 0, strict: bool = True) -> None:
    """Write a reference-format torch checkpoint file. 'optimizer' is None:
    the reference's warm start ignores it, and the port's AMSGrad state is
    not in torch.optim's format."""
    sd = reference_state_dict_from_port(state_dict, model_cfg, strict=strict)
    payload = {
        "model": {k: torch.tensor(v) for k, v in sd.items()},
        "conf": reference_model_conf(model_cfg),
        "optimizer": None,
        "epoch": epoch,
        "step": step,
    }
    torch.save(payload, path)
    n = sum(v.size for v in sd.values())
    log.info("exported reference checkpoint %s: %.1fM params (step %d)",
             path, n / 1e6, step)
    # the reference evaluator merges ONLY conf.model from the checkpoint;
    # its diffuser.r3.coordinate_scaling stays at the eval config's value
    log.warning(
        "reference eval config must set diffuser.r3.coordinate_scaling=%s "
        "to match the exported model.ipa.coordinate_scaling: the "
        "evaluator merges only conf.model from the checkpoint "
        "(see docs/MIGRATION.md)", model_cfg.ipa.coordinate_scaling,
    )


def main(argv=None) -> str:
    """CLI: a ``train_cli`` checkpoint -> reference torch checkpoint. The
    model config is the checkpoint's saved one; ``model.*`` overrides win.
    Returns the path written."""
    import argparse

    from dynamicpdb_tpu_torch import config as config_lib
    from dynamicpdb_tpu_torch.eval_cli import _model_overrides
    from dynamicpdb_tpu_torch.train import checkpoint as ckpt_lib

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--ckpt", required=True,
                        help="a train_cli checkpoint (or a bare state dict)")
    parser.add_argument("--out", required=True, help="torch .pth/.pkl path")
    parser.add_argument("--no-strict", action="store_true",
                        help="drop (with a warning) params the reference "
                        "architecture cannot represent instead of erroring")
    parser.add_argument("overrides", nargs="*", metavar="model.key=value")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    payload = ckpt_lib.load(args.ckpt)
    if isinstance(payload.get("model"), dict):
        state_dict, saved = payload["model"], payload.get("config")
    else:  # a bare state dict
        state_dict, saved, payload = payload, None, {}
    cfg = config_lib.Config()
    if saved:
        cfg = config_lib.apply_overrides(
            cfg, _model_overrides(saved.get("model", {})))
    else:
        log.warning(
            "checkpoint has no config snapshot; assuming the default "
            "ModelConfig: pass model.* overrides if dims differ (a mismatch "
            "raises on the first param that differs)")
    cfg = config_lib.apply_overrides(cfg, args.overrides)
    export_reference_checkpoint(
        args.out, state_dict, cfg.model,
        epoch=int(payload.get("epoch", 0)), step=int(payload.get("step", 0)),
        strict=not args.no_strict)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()

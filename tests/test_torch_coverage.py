"""Every module of the JAX package has its port module, and every public
name of it a counterpart.

  * For each ``.py`` module of ``dynamicpdb_tpu/`` outside ``ops/pallas/``
    (the TPU kernels, whose CUDA counterparts live in
    ``dynamicpdb_tpu_torch/csrc/`` and ``ops/``), the port has a module at
    the same path.
  * Each public top-level ``def`` / ``class`` name there is defined at the
    top level of the port module, or is listed in ``NOT_DEFINED`` below
    with its counterpart (a renamed function or class, which must exist)
    or none, and a one-line reason. A name with no counterpart is named in
    the port module's docstring (literally or by a ``*`` pattern), which
    says why.

Names are read with ``ast``; no JAX module is imported."""
import ast
import fnmatch
import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "dynamicpdb_tpu")
PORT_PKG = os.path.join(ROOT, "dynamicpdb_tpu_torch")
JAX_MODULES = sorted(
    os.path.relpath(p, JAX_PKG)
    for p in glob.glob(os.path.join(JAX_PKG, "**", "*.py"), recursive=True)
    if not os.path.relpath(p, JAX_PKG).startswith(os.path.join("ops",
                                                               "pallas")))

PYTREE = "flax-free parameter pytree: the port module's own parameters"
CONVERTER = ("converter from the reference torch module to a pytree: the "
             "port module loads the reference state dict as it is")
SHARDING = ("places a pytree with a NamedSharding; torch has no such "
            "placement (ParamLayout and the sampler split by rank)")
# (JAX module, name) -> (port counterpart "module:name" or None, reason)
NOT_DEFINED = {
    ("models/ipa.py", "dense_ipa_attention"): (
        "ops/ipa_attention.py:ipa_attention_plain",
        "the attention core without a kernel is the plain version the CPU "
        "runs"),
    ("models/layers.py", "GlobalStatNorm"): (
        "models/layers.py:global_stat_norm",
        "a flax module without parameters is a function in torch"),
    ("models/omegafold/core.py", "GAUParams"): (None, PYTREE),
    ("models/omegafold/core.py", "gated_attention_unit"): (
        "models/omegafold/core.py:GatedAttentionUnit",
        "the pytree's function is the module's forward"),
    ("models/omegafold/embedders.py", "EdgeEmbedderParams"): (None, PYTREE),
    ("models/omegafold/embedders.py", "RecycleEmbedderParams"): (
        None, PYTREE),
    ("models/omegafold/embedders.py", "edge_embedder"): (
        "models/omegafold/embedders.py:EdgeEmbedder",
        "the pytree's function is the module's forward"),
    ("models/omegafold/embedders.py", "recycle_embedder"): (
        "models/omegafold/embedders.py:RecycleEmbedder",
        "the pytree's function is the module's forward"),
    ("models/omegafold/embedders.py", "edge_embedder_from_torch"): (
        None, CONVERTER),
    ("models/omegafold/embedders.py", "recycle_embedder_from_torch"): (
        None, CONVERTER),
    **{("models/omegafold/geoformer.py", n): (None, PYTREE) for n in (
        "AttnParams", "AttnWEdgeBiasParams", "GeoFormerBlockParams",
        "GeoFormerParams", "GeomAttnParams", "Node2EdgeParams",
        "TransitionParams")},
    **{("models/omegafold/geoformer.py", n): (None, CONVERTER) for n in (
        "attn_params_from_torch", "block_params_from_torch",
        "geoformer_params_from_torch", "geom_params_from_torch",
        "node2edge_params_from_torch", "transition_params_from_torch")},
    ("models/omegafold/geoformer.py", "geoformer"): (
        "models/omegafold/geoformer.py:GeoFormer",
        "the pytree's function is the module's forward"),
    ("models/omegafold/model.py", "OmegaFoldParams"): (None, PYTREE),
    ("models/omegafold/model.py", "params_from_torch"): (None, CONVERTER),
    ("models/omegafold/model.py", "params_from_state_dict"): (
        "models/omegafold/model.py:omegafold_from_state_dict",
        "a state dict becomes the module, not a pytree"),
    ("models/omegafold/model.py", "omegafold_embed_scan"): (
        "models/omegafold/model.py:omegafold_embed",
        "the cycles under lax.scan; the port keeps the best cycle on the "
        "device without a scan"),
    ("models/omegafold/plm.py", "PLMParams"): (None, PYTREE),
    ("models/omegafold/plm.py", "params_from_torch"): (None, CONVERTER),
    ("models/omegafold/plm.py", "omega_plm"): (
        "models/omegafold/plm.py:OmegaPLM",
        "the pytree's function is the module's forward"),
    **{("models/omegafold/structure.py", n): (None, PYTREE) for n in (
        "ConfidenceParams", "CycleParams", "DecodeIPAParams", "LinearParams",
        "StructureParams", "TorsionHeadParams")},
    **{("models/omegafold/structure.py", n): (None, CONVERTER) for n in (
        "confidence_params_from_torch", "decode_ipa_from_torch",
        "linear_from_torch", "structure_params_from_torch")},
    **{("models/omegafold/structure.py", fn): (
        f"models/omegafold/structure.py:{cls}",
        "the pytree's function is the module's forward") for fn, cls in (
        ("decode_ipa", "DecodeIPA"), ("structure_cycle", "StructureCycle"),
        ("structure_module", "StructureModule"),
        ("torsion_head", "TorsionAngleHead"),
        ("confidence_head", "ConfidenceHead"))},
    **{("parallel/mesh.py", n): (None, SHARDING) for n in (
        "batch_sharding", "replicated", "shard_batch")},
    **{("parallel/sharding.py", n): (None, SHARDING) for n in (
        "opt_state_shardings", "shard_params", "tree_shardings")},
    ("parallel/sp.py", "shard"): (
        None, "a sharding constraint for XLA's partitioner: each rank holds "
        "its rows itself"),
    ("preprocess/extract_embeddings.py", "resolve_dtype_flash"): (
        None, "picks the Pallas kernel by backend; the CUDA kernels always "
        "run on the card"),
    ("train/export_torch.py", "reference_state_dict_from_flax"): (
        "train/export_torch.py:reference_state_dict_from_port",
        "it maps the port's state dict, not a flax tree"),
    ("train/import_torch.py", "flax_from_reference_state_dict"): (
        None, "maps onto flax's tree; the port's parameters have the "
        "reference keys"),
    ("train/optim.py", "AmsgradState"): (
        None, "optax state: the torch optimizer's state dict holds it"),
    ("train/optim.py", "EmaState"): (
        None, "optax state: the torch optimizer's state dict holds it"),
    ("train/optim.py", "amsgrad"): (
        "train/optim.py:AMSGrad", "the optax chain is one torch optimizer"),
    ("train/optim.py", "scale_by_amsgrad"): (
        "train/optim.py:AMSGrad", "the optax transform is the optimizer's "
        "step"),
    ("train/optim.py", "track_ema"): (
        "train/optim.py:AMSGrad", "the optimizer keeps the EMA in its state "
        "(experiment.ema_decay)"),
    ("train/optim.py", "ema_params"): (
        "train/optim.py:ema_state_dict", "the EMA weights as a state dict"),
    ("utils/platform.py", "honor_cpu_request"): (
        None, "sets JAX's platform; torch takes its device per call"),
    ("utils/platform.py", "raise_cpu_collective_timeouts"): (
        None, "sets XLA's CPU collective timeouts; a torch process group "
        "takes its timeout where it is made"),
}


def _tree(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def public_defs(path: str) -> list[str]:
    return [n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def defined_names(path: str) -> set[str]:
    """Top-level functions, classes and assigned names of a module."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def docstring_mentions(path: str, name: str) -> bool:
    doc = ast.get_docstring(_tree(path)) or ""
    tokens = re.findall(r"``([^`]+)``", doc)
    return any(fnmatch.fnmatchcase(name, t) for t in tokens)


def test_the_jax_modules_are_found():
    assert len(JAX_MODULES) > 60
    assert "models/score_network.py" in JAX_MODULES
    assert not any(m.startswith("ops/pallas") for m in JAX_MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_module_has_a_port_module(module):
    port = os.path.join(PORT_PKG, module)
    assert os.path.exists(port), f"no port module {module}"
    missing = [n for n in public_defs(os.path.join(JAX_PKG, module))
               if n not in defined_names(port)
               and (module, n) not in NOT_DEFINED]
    assert not missing, (module, missing)


def test_every_listed_name_is_a_jax_name_with_a_reason():
    for (module, name), (counterpart, reason) in NOT_DEFINED.items():
        jax_path = os.path.join(JAX_PKG, module)
        port_path = os.path.join(PORT_PKG, module)
        assert name in public_defs(jax_path), (module, name)
        assert name not in defined_names(port_path), (
            f"{module}:{name} is defined in the port: drop its entry")
        assert reason and "\n" not in reason, (module, name)
        if counterpart is None:
            assert docstring_mentions(port_path, name), (
                f"{module}'s port docstring does not say why {name} has no "
                "counterpart")
        else:
            where, new = counterpart.split(":")
            assert new in defined_names(os.path.join(PORT_PKG, where)), \
                counterpart

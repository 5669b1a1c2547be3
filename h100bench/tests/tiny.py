"""A tiny configuration and traffic of the extraction cell, for the CPU
tests: the release files with every width cut, and a few short inputs."""
from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def omegafold_cfg():
    """Every dimension of the release model, narrow, c = 8 for both
    attentions (the port's own tests' tiny configuration)."""
    from h100bench.reference.models.omegafold.model import (
        OmegaFoldConfig,
        StructConfig,
    )
    from h100bench.reference.models.omegafold.plm import PLMConfig

    return OmegaFoldConfig(
        plm=PLMConfig(node=32, num_layers=3, proj_dim=48, attn_dim=16),
        node_dim=24, edge_dim=16, geo_num_blocks=2, attn_c=8, attn_n_head=2,
        transition_multiplier=2, opm_dim=10, geom_c=8, geom_head=2,
        struct=StructConfig(node_dim=20, edge_dim=16, num_cycle=2,
                            num_transition=2, num_head=2, num_point_qk=4,
                            num_point_v=4, num_scalar_qk=6, num_scalar_v=6,
                            num_channel=20, num_residual_block=2,
                            hidden_dim=18, num_bins=10))


def extract_traffic() -> dict:
    t = copy.deepcopy(load("traffic", "extract-n256-c10"))
    t.update(length=12, distinct=3)
    return t


def extract_config() -> dict:
    c = copy.deepcopy(load("configs", "omegafold-release"))
    c.update(num_cycles=2, num_pseudo_msa=3)
    return c


def program_omegafold(seed, device):
    """The port's OmegaFold at ``omegafold_cfg`` with the seed's weights."""
    from dynamicpdb_tpu_torch.models.omegafold.model import (
        omegafold_from_state_dict,
    )
    from h100bench import weights
    from h100bench.reference import steps

    return omegafold_from_state_dict(weights.omegafold_weights(
        steps.omegafold_shapes(omegafold_cfg()), seed, device), device=device)


def reference_omegafold(seed, device):
    from h100bench.reference import steps

    return steps.omegafold_model(seed, device, omegafold_cfg())

"""The PyTorch port stands alone: no import of jax, flax or the JAX package
anywhere in it or in chip_smoke.py, its own byte-identical copy of the chem
tables, and a config module that reads every YAML file as the JAX one does."""
import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest
import torch

from dynamicpdb_tpu import config as jax_config
from dynamicpdb_tpu_torch import config as port_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    glob.glob(os.path.join(ROOT, "dynamicpdb_tpu_torch", "**", "*.py"),
              recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "flax", "dynamicpdb_tpu")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def test_serving_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.serve_cli, dynamicpdb_tpu_torch.weights\n"
        "import dynamicpdb_tpu_torch.data.synthetic\n"
        "import dynamicpdb_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dynamicpdb_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_chem_tables_copy_is_byte_identical():
    a = open(os.path.join(ROOT, "dynamicpdb_tpu", "chem", "tables.npz"), "rb")
    b = open(os.path.join(ROOT, "dynamicpdb_tpu_torch", "chem", "tables.npz"),
             "rb")
    with a, b:
        assert a.read() == b.read()


OVERRIDES = [
    "model.ipa.num_blocks=2", "model.compute_dtype=bfloat16",
    "data.num_t=7", "diffuser.so3.cache_dir=null",
    "model.ipa.use_pallas_attention=auto", "experiment.mesh_shape=(2,4)",
    "experiment.grad_clip_norm=1.0", "diffuser.r3.coordinate_scaling=0.1",
]


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
    ids=os.path.basename)
def test_yaml_configs_load_identically(path):
    mine = port_config.load_yaml(path, OVERRIDES)
    ref = jax_config.load_yaml(path, OVERRIDES)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_auto_rejected_on_bool_field():
    with pytest.raises(ValueError, match="auto"):
        port_config.apply_overrides(port_config.Config(),
                                    ["data.dynamics=auto"])

"""The PyTorch port stands alone: no import of jax, flax, optax, pandas,
tensorboard, yaml or the JAX package anywhere in it or in chip_smoke.py
(the card's machine is not promised any of them), its own byte-identical copy of the chem
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
FORBIDDEN = ("jax", "flax", "optax", "pandas", "tensorboard", "yaml",
             "dynamicpdb_tpu")


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


def test_sequence_parallel_modules_load_without_jax():
    """parallel/sp.py and the modules that call it, imported alone."""
    assert os.path.join(ROOT, "dynamicpdb_tpu_torch", "parallel",
                        "sp.py") in PORT_FILES
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.parallel.sp\n"
        "import dynamicpdb_tpu_torch.tools.sp_run\n"
        "import dynamicpdb_tpu_torch.tools.dp_step\n"
        "import dynamicpdb_tpu_torch.train_cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dynamicpdb_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_training_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.train_cli\n"
        "import dynamicpdb_tpu_torch.train.experiment\n"
        "import dynamicpdb_tpu_torch.data.dataset\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib',)!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_extraction_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.preprocess.extract_embeddings\n"
        "import dynamicpdb_tpu_torch.ops.geom_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib',)!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_eval_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.eval_cli\n"
        "import dynamicpdb_tpu_torch.sampling.evaluate\n"
        "import dynamicpdb_tpu_torch.analysis.decomposition\n"
        "import dynamicpdb_tpu_torch.analysis.interactive\n"
        "import dynamicpdb_tpu_torch.analysis.pdb_io\n"
        "import dynamicpdb_tpu_torch.preprocess.dcd\n"
        "import dynamicpdb_tpu_torch.train.import_torch\n"
        "import dynamicpdb_tpu_torch.train.experiment\n"
        "import dynamicpdb_tpu_torch.sampling.reverse\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib',)!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_fold_sampling_and_data_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.fold_cli\n"
        "import dynamicpdb_tpu_torch.data.prefetch\n"
        "import dynamicpdb_tpu_torch.data.realistic\n"
        "import dynamicpdb_tpu_torch.preprocess.mmcif\n"
        "import dynamicpdb_tpu_torch.sampling.picard\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib',)!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_parallel_modules_load_without_jax():
    code = (
        "import sys\n"
        "import dynamicpdb_tpu_torch.parallel.mesh\n"
        "import dynamicpdb_tpu_torch.parallel.sharding\n"
        "import dynamicpdb_tpu_torch.train_cli\n"
        "import dynamicpdb_tpu_torch.train.experiment\n"
        "import dynamicpdb_tpu_torch.tools.dp_step\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib',)!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("module", [
    "analysis.contact_order", "analysis.plotting", "analysis.structure_checks",
    "analysis.violations", "preprocess.energies", "preprocess.pack",
    "preprocess.pbc", "train.export_torch", "utils.compile_cache",
    "tools.ingest_release"])
def test_last_slice_modules_load_without_jax(module):
    """Each module of the last slice, imported alone and then driven as far
    as its import reaches (the violation tables, the export's reference
    shapes), with nothing of JAX or the JAX package loaded."""
    code = (
        "import sys\n"
        f"import dynamicpdb_tpu_torch.{module} as m\n"
        "from dynamicpdb_tpu_torch.analysis import violations\n"
        "violations._tables()\n"
        "from dynamicpdb_tpu_torch.train import export_torch\n"
        "from dynamicpdb_tpu_torch.config import ModelConfig\n"
        "export_torch.reference_shapes(ModelConfig())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('jaxlib', 'matplotlib')!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("name", ["tables.npz", "omegafold_tables.npz"])
def test_chem_tables_copy_is_byte_identical(name):
    a = open(os.path.join(ROOT, "dynamicpdb_tpu", "chem", name), "rb")
    b = open(os.path.join(ROOT, "dynamicpdb_tpu_torch", "chem", name), "rb")
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


@pytest.mark.parametrize("text", [
    "a:\n  b: 1e-4\n  c: 0.0001\n  d: [2, 4]\n  e: 'x # y'\n",
    "f: off\ng:\nh: 010\ni: -3  # comment\nj: .5\nk: \"quoted\"\n",
    "# only a comment\nx:\n  y:\n    z: null\n  w: ~\n",
])
def test_yaml_reader_matches_pyyaml(text):
    import yaml

    assert port_config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: &x 1\n", "a: |\n  t\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="unsupported"):
        port_config.parse_yaml(text)


def test_auto_rejected_on_bool_field():
    with pytest.raises(ValueError, match="auto"):
        port_config.apply_overrides(port_config.Config(),
                                    ["data.dynamics=auto"])

"""train_cli under a launcher, on the CPU: ``python -m torch.distributed.run
--standalone --nproc_per_node 2 -m dynamicpdb_tpu_torch.train_cli --device
cpu`` (gloo) at half the batch a rank must write the checkpoint one process
writes at the full batch: with ZeRO on and off, and on a ('slice', 'data')
mesh given through experiment.mesh_shape / mesh_axes. A 2-rank ZeRO
checkpoint resumes in one process and continues to where one process
would have been. With --eval-every, rank 0 evaluates while the other waits.

Tolerances as in tests/test_torch_parallel.py (the bar of
test_five_train_steps_match_jax on the parameters; the moments to 1e-3 of
each one's largest magnitude, floored at 1e-6 of the model's largest, as
test_torch_train holds gradients): the two ranks' gradient sums are added
in another order than one process's windows.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from dynamicpdb_tpu_torch import train_cli
from dynamicpdb_tpu_torch.config import load_yaml
from dynamicpdb_tpu_torch.train import checkpoint as pckpt
from dynamicpdb_tpu_torch.train.experiment import Trainer
from tests.test_torch_parallel import assert_params_close, launch, manifest  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny.yaml")
LR = 1e-4  # its learning rate


def cli_args(csv: str, run_dir, *extra: str) -> list[str]:
    """Flags first, then the overrides (``extra`` may hold both)."""
    flags = [e for i, e in enumerate(extra) if e.startswith("--") or (
        i and extra[i - 1] in ("--max-steps", "--eval-every", "--backend"))]
    extra = [e for e in extra if e not in flags]
    return ["--config", TINY, *flags,
            "--pad-to", "12", "--device", "cpu", f"data.csv_path={csv}",
            "data.filtering.max_len=12", "experiment.log_freq=1",
            "diffuser.so3.cache_dir=" + os.path.join(ROOT, ".cache", "igso3"),
            f"experiment.ckpt_dir={run_dir / 'ckpt'}",
            f"experiment.eval_dir={run_dir / 'eval'}", *extra]


def one_process(csv: str, run_dir, *extra: str) -> dict:
    """train_cli in this process at the global batch (4); its checkpoint."""
    exp = train_cli.main(cli_args(csv, run_dir, "experiment.batch_size=4",
                                  *extra))
    return pckpt.load(str(run_dir / "ckpt" / f"step_{exp.step}.ckpt"))


def assert_checkpoints_close(got: dict, want: dict, steps: int):
    assert (got["step"], got["epoch"]) == (want["step"], want["epoch"])
    assert torch.equal(got["rng"], want["rng"])  # the generators in lock step
    start = Trainer(load_yaml(TINY), device="cpu").model.state_dict()
    assert_params_close(got["model"], want["model"], start, LR, steps)
    sg, sw = got["optimizer"]["state"], want["optimizer"]["state"]
    assert sg.keys() == sw.keys()
    assert (got["optimizer"]["param_groups"][0]["count"]
            == want["optimizer"]["param_groups"][0]["count"] == steps)
    # a moment of a gradient that is rounding noise (linear_b's bias,
    # which the softmax cancels) is noise too: floor each tensor's scale at
    # 1e-6 of the model's largest of that moment, as test_torch_train's
    # gradients are floored
    keys = {k for st in sw.values() for k in st}
    floor = {k: 1e-6 * max(float(st[k].abs().max()) for st in sw.values()
                           if k in st) for k in keys}
    for i in sw:
        for k, w in sw[i].items():
            g = sg[i][k]
            assert g.shape == w.shape, (i, k)  # gathered whole
            scale = max(float(w.abs().max()), floor[k] * 1e3)
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=0, atol=1e-3 * scale,
                                       err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def reference(manifest, tmp_path_factory):  # noqa: F811
    """One process's 3-step checkpoint for a given optimizer setting."""
    cache = {}

    def get(*options: str) -> dict:
        if options not in cache:
            cache[options] = one_process(
                manifest, tmp_path_factory.mktemp("one"), "--max-steps", "3",
                *options)
        return cache[options]

    return get


EMA_CLIP = ("experiment.ema_decay=0.9", "experiment.grad_clip_norm=50.0")
MESHES = {
    "zero": ((), ["experiment.zero_opt_state=true"]),
    "no-zero": ((), ["experiment.zero_opt_state=false"]),
    # the backend named, as chip_smoke.py names it for ranks sharing a card
    "hybrid": ((), ["--backend", "gloo", "experiment.mesh_shape=(2,1)",
                    "experiment.mesh_axes=(slice,data)"]),
    # the EMA is sharded with the moments; clipping reads the whole norm
    "zero-ema-clip": (EMA_CLIP, ["experiment.zero_opt_state=true"]),
}


@pytest.mark.parametrize("case", list(MESHES))
def test_two_ranks_write_the_one_process_checkpoint(manifest, reference,  # noqa: F811
                                                    tmp_path, case):
    options, mesh = MESHES[case]
    proc = launch(2, "dynamicpdb_tpu_torch.train_cli", cli_args(
        manifest, tmp_path, "--max-steps", "3", "experiment.batch_size=2",
        *options, *mesh))
    assert "global_batch=4 (2 a rank)" in proc.stderr
    got = pckpt.load(str(tmp_path / "ckpt" / "step_3.ckpt"))
    assert_checkpoints_close(got, reference(*options), 3)
    if options:
        st = got["optimizer"]["state"]
        assert all("ema" in v for v in st.values())
    # rank 0 alone writes the metrics: one line a step
    with open(tmp_path / "eval" / "logs" / "metrics.jsonl") as f:
        records = f.readlines()
    assert len(records) == 3


def test_a_two_rank_zero_checkpoint_resumes_in_one_process(manifest,  # noqa: F811
                                                           tmp_path):
    """Two ranks train epoch 0 (3 steps) with ZeRO; one process resumes
    from their checkpoint for 2 more steps and lands where 5 steps in one
    process land."""
    launch(2, "dynamicpdb_tpu_torch.train_cli", cli_args(
        manifest, tmp_path / "dp", "experiment.batch_size=2",
        "experiment.num_epoch=1"))
    saved = pckpt.load(str(tmp_path / "dp" / "ckpt" / "step_3.ckpt"))
    assert (saved["step"], saved["epoch"]) == (3, 1)
    resumed = one_process(manifest, tmp_path / "dp", "--resume",
                          "--max-steps", "5")
    straight = one_process(manifest, tmp_path / "one", "--max-steps", "5")
    assert_checkpoints_close(resumed, straight, 5)


def test_two_ranks_evaluate_on_rank_0(manifest, tmp_path):  # noqa: F811
    """--eval-every under a launcher: rank 0 evaluates, the other rank
    waits for its metrics, and one eval record and best.ckpt are written."""
    launch(2, "dynamicpdb_tpu_torch.train_cli", cli_args(
        manifest, tmp_path, "--eval-every", "1", "experiment.batch_size=2",
        "experiment.num_epoch=1"))
    with open(tmp_path / "eval" / "logs" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "eval/ave_rot" in r]
    assert len(evals) == 1 and len(records) == 4  # 3 steps, 1 eval
    for k in train_cli.EVAL_METRICS:
        assert math.isfinite(evals[0][f"eval/{k}"])
    best = pckpt.load(str(tmp_path / "ckpt" / "best.ckpt"))
    assert (best["step"], best["epoch"]) == (3, 1)

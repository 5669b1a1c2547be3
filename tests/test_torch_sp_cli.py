"""train_cli with sequence parallelism, on the CPU: two gloo ranks on a
('data', 'seq') = (1, 2) mesh split each window's residues (pad_to 11,
which 2 does not divide) and must write the checkpoint one process writes
at the same global batch; with --eval-every, rank 0 and the other rank of
its 'seq' group evaluate together and log what one process logs.

Tolerances: the checkpoint to tests/test_torch_parallel_cli.py's bar (the
ranks add their rows' gradient shares in another order than one process
sums them). The eval metrics run on unchanged weights (learning rate 0), so
the two runs sample from the same model with the same noise: 1e-5 relative,
the float32 sums of a rank's rows against one process's.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from dynamicpdb_tpu_torch import train_cli
from dynamicpdb_tpu_torch.train import checkpoint as pckpt
from tests.test_torch_parallel import launch, manifest  # noqa: F401
from tests.test_torch_parallel_cli import assert_checkpoints_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny.yaml")
SEQ_MESH = ("experiment.mesh_shape=(1,2)", "experiment.mesh_axes=(data,seq)")


def cli_args(csv: str, run_dir, *extra: str) -> list[str]:
    """Flags first, then the overrides; windows padded to 11 residues."""
    flags = [e for i, e in enumerate(extra) if e.startswith("--") or (
        i and extra[i - 1] in ("--max-steps", "--eval-every"))]
    extra = [e for e in extra if e not in flags]
    return ["--config", TINY, *flags,
            "--pad-to", "11", "--device", "cpu", f"data.csv_path={csv}",
            "data.filtering.max_len=11", "experiment.log_freq=1",
            "model.remat=true", "experiment.batch_size=4",
            "diffuser.so3.cache_dir=" + os.path.join(ROOT, ".cache", "igso3"),
            f"experiment.ckpt_dir={run_dir / 'ckpt'}",
            f"experiment.eval_dir={run_dir / 'eval'}", *extra]


def metrics(run_dir) -> list[dict]:
    with open(run_dir / "eval" / "logs" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_two_seq_ranks_write_the_one_process_checkpoint(manifest,  # noqa: F811
                                                        tmp_path):
    proc = launch(2, "dynamicpdb_tpu_torch.train_cli", cli_args(
        manifest, tmp_path / "sp", "--max-steps", "3", *SEQ_MESH))
    # the 'seq' axis is no batch axis: the ranks share their rows
    assert "global_batch=4 (4 a rank)" in proc.stderr
    got = pckpt.load(str(tmp_path / "sp" / "ckpt" / "step_3.ckpt"))
    exp = train_cli.main(cli_args(manifest, tmp_path / "one",
                                  "--max-steps", "3"))
    want = pckpt.load(str(tmp_path / "one" / "ckpt" / f"step_{exp.step}.ckpt"))
    assert_checkpoints_close(got, want, 3)
    # rank 0 alone writes the metrics, the losses one process logs
    got_m, want_m = metrics(tmp_path / "sp"), metrics(tmp_path / "one")
    assert len(got_m) == len(want_m) == 3
    np.testing.assert_allclose([r["total_loss"] for r in got_m],
                               [r["total_loss"] for r in want_m], rtol=1e-4)


def test_seq_group_of_rank_0_evaluates(manifest, tmp_path):  # noqa: F811
    """One epoch (3 steps) then --eval-every 1, at learning rate 0."""
    opts = ("--eval-every", "1", "experiment.num_epoch=1",
            "experiment.learning_rate=0.0")
    launch(2, "dynamicpdb_tpu_torch.train_cli", cli_args(
        manifest, tmp_path / "sp", *opts, *SEQ_MESH))
    train_cli.main(cli_args(manifest, tmp_path / "one", *opts))
    got = [r for r in metrics(tmp_path / "sp") if "eval/ave_rot" in r]
    want = [r for r in metrics(tmp_path / "one") if "eval/ave_rot" in r]
    assert len(got) == len(want) == 1
    for k in train_cli.EVAL_METRICS:
        assert math.isfinite(got[0][f"eval/{k}"])
        np.testing.assert_allclose(got[0][f"eval/{k}"], want[0][f"eval/{k}"],
                                   rtol=1e-5, err_msg=k)
    best = pckpt.load(str(tmp_path / "sp" / "ckpt" / "best.ckpt"))
    assert (best["step"], best["epoch"]) == (3, 1)

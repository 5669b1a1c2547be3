"""The port's host -> device prefetcher (data/prefetch.py) on CPU tensors,
and the training loop that runs through it.

The JAX package's four prefetcher cases (tests/test_data.py): batches in
order, errors re-raised in the consumer, close() unblocks and joins the
worker, and the end-of-iteration sentinel survives a full buffer. Then
against the plain iterator: the same batches in the same order (bit for
bit: placement on the CPU copies nothing), and ``Experiment.train``
through the prefetcher gives the losses of the same steps fed plainly
(bit for bit: the same batches and the same noise draws), and leaves no
worker thread alive when ``max_steps`` stops it mid-epoch or a step
raises."""
import itertools
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dynamicpdb_tpu_torch import config as pcfg
from dynamicpdb_tpu_torch.data import dataset as pdata
from dynamicpdb_tpu_torch.data.prefetch import (
    THREAD_NAME,
    DevicePrefetcher,
    prefetch_to_device,
)
from dynamicpdb_tpu_torch.data.synthetic import make_trajectory_npz
from dynamicpdb_tpu_torch.train.experiment import Experiment, Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "igso3")
JOIN_TIMEOUT = 10.0


def _workers_alive():
    return [t for t in threading.enumerate()
            if t.name == THREAD_NAME and t.is_alive()]


def _settle(timeout=JOIN_TIMEOUT):
    """Wait for the workers of earlier tests, which end just after their
    sentinel, to exit."""
    deadline = time.time() + timeout
    while _workers_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not _workers_alive()


def _wait_gone(pf, timeout=JOIN_TIMEOUT):
    deadline = time.time() + timeout
    while pf._thread.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    return not pf._thread.is_alive()


def test_device_prefetcher():
    src = ({"x": np.full((2, 2), i, np.float32)} for i in range(5))
    out = list(prefetch_to_device(src, buffer_size=2, device="cpu"))
    assert len(out) == 5
    assert isinstance(out[0]["x"], torch.Tensor)
    assert out[0]["x"].device.type == "cpu" and not out[0]["x"].is_pinned()
    np.testing.assert_allclose(out[3]["x"].numpy(), 3.0)


def test_device_prefetcher_propagates_errors():
    def bad():
        yield {"x": np.ones(2, np.float32)}
        raise RuntimeError("loader exploded")

    it = iter(prefetch_to_device(bad(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(it)


def test_device_prefetcher_close_unblocks_worker():
    """Abandoning the iterator mid-epoch must not leave the worker blocked
    in its put holding device batches."""
    src = ({"x": np.full((4,), i)} for i in itertools.count())  # infinite
    pf = prefetch_to_device(src, buffer_size=2, device="cpu")
    it = iter(pf)
    next(it)  # consume one; the worker now blocks on a full queue
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()  # the buffered batches were released

    # context-manager form + early break
    with prefetch_to_device(
            ({"x": np.full((4,), i)} for i in itertools.count()),
            buffer_size=2, device="cpu") as pf2:
        for i, _ in enumerate(pf2):
            if i == 1:
                break
    assert _wait_gone(pf2)


def test_device_prefetcher_sentinel_survives_full_buffer():
    """A producer that fills the buffer and finishes before the consumer
    takes its first batch must still deliver the end-of-iteration
    sentinel."""
    src = iter([np.zeros(3), np.ones(3)])
    pf = prefetch_to_device(src, buffer_size=1, place=lambda x: x)
    time.sleep(0.5)  # the producer fills the 1-slot buffer and ends
    out = []
    t = threading.Thread(target=lambda: out.extend(list(pf)), daemon=True)
    t.start()
    t.join(timeout=JOIN_TIMEOUT)
    assert not t.is_alive(), "consumer deadlocked waiting for the sentinel"
    assert len(out) == 2
    pf.close()


def test_prefetcher_keeps_order_under_fast_thread_switches():
    """200 batches through a 2-slot buffer with the interpreter switching
    threads as often as it can, and a consumer slower than the producer
    half the time: every batch arrives once, in order."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        src = ({"i": np.array([i]), "name": f"b{i}"} for i in range(200))
        got = []
        for i, b in enumerate(DevicePrefetcher(src, device="cpu")):
            if i % 2:
                time.sleep(1e-4)
            got.append((int(b["i"][0]), b["name"]))
    finally:
        sys.setswitchinterval(old)
    assert got == [(i, f"b{i}") for i in range(200)]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefetch")
    rows = []
    for i, n in enumerate((8, 10, 12)):
        path = str(d / f"p{i}.npz")
        make_trajectory_npz(path, n_res=n, n_frames=6, seed=i)
        rows.append(f"p{i},{path},{n}")
    csv = d / "train.csv"
    csv.write_text("name,atlas_npz,seq_len\n" + "\n".join(rows) + "\n")
    return str(csv)


def _cfg(csv):
    return pcfg.load_yaml(os.path.join(ROOT, "configs", "tiny.yaml"), [
        f"data.csv_path={csv}", "data.filtering.max_len=12",
        "model.node_repr_dim=256", "model.edge_repr_dim=128",
        "experiment.batch_size=2", "experiment.log_freq=1",
        f"diffuser.so3.cache_dir={CACHE}"])


def _batches(cfg):
    ds = pdata.TrajectoryDataset(cfg.data, split="train", pad_to=12)
    sampler = pdata.make_sampler(ds, cfg.data,
                                 batch_size=cfg.experiment.batch_size,
                                 seed=cfg.experiment.seed)
    return lambda epoch: pdata.batch_iterator(ds, sampler, epoch)


def test_prefetched_batches_equal_the_plain_iterator(manifest):
    cfg = _cfg(manifest)
    batches = _batches(cfg)
    for epoch in (0, 1):
        plain = list(batches(epoch))
        with prefetch_to_device(batches(epoch), device="cpu") as pf:
            got = list(pf)
        assert len(got) == len(plain) > 1
        for g, p in zip(got, plain):
            assert sorted(g) == sorted(p)
            for k in p:
                assert torch.equal(g[k], torch.as_tensor(p[k])), k


def test_train_losses_equal_the_plainly_fed_steps(manifest):
    """Experiment.train (prefetched) against Trainer.train_step on the
    plain iterator's batches, from the same seed: equal losses, step for
    step, over an epoch boundary."""
    cfg = _cfg(manifest)
    batches = _batches(cfg)
    exp = Experiment(cfg, batches, device="cpu")
    steps = len(list(batches(0))) + 1  # one step into epoch 1
    exp.train(max_steps=steps)
    assert exp.step == steps and exp.epoch == 1

    plain = Trainer(cfg, device="cpu")
    want = []
    for epoch in (0, 1):
        for raw in batches(epoch):
            if len(want) < steps:
                want.append(plain.train_step(raw))
    got = exp.step_metrics
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == w[k], (g["step"], k)
        assert g["data_seconds"] >= 0 and g["seconds"] > 0
    for a, b in zip(exp.trainer.model.parameters(),
                    plain.model.parameters()):
        assert torch.equal(a, b)


def test_train_stopped_mid_epoch_leaves_no_worker(manifest):
    cfg = _cfg(manifest)
    _settle()
    exp = Experiment(cfg, _batches(cfg), device="cpu")
    exp.train(max_steps=1)  # the first epoch has more batches
    assert exp.step == 1 and exp.epoch == 0
    assert not _workers_alive()


def test_train_step_error_closes_the_prefetcher(manifest):
    cfg = _cfg(manifest)
    _settle()
    exp = Experiment(cfg, _batches(cfg), device="cpu")

    def boom(raw_batch):
        raise RuntimeError("step exploded")

    exp.trainer.train_step = boom
    with pytest.raises(RuntimeError, match="step exploded"):
        exp.train(max_steps=3)
    assert not _workers_alive()


def test_trainer_to_device_passes_device_tensors_through():
    cfg = pcfg.load_yaml(os.path.join(ROOT, "configs", "tiny.yaml"), [
        f"diffuser.so3.cache_dir={CACHE}"])
    t = Trainer(cfg, device="cpu")
    batch = {k: torch.zeros(2, 3) for k in
             ("atom37", "atom37_mask", "aatype", "residue_index", "force",
              "vel", "node_repr", "edge_repr")}
    out = t.to_device(batch)
    assert all(out[k] is batch[k] for k in batch)


@pytest.mark.cuda
def test_cuda_prefetcher_delivers_the_host_batches():
    """On the card: every batch equals its host original after a step's
    worth of work on the compute stream, and the side stream's copies are
    ordered before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    host = [{"x": rng.normal(size=(64, 256, 128)).astype(np.float32),
             "i": np.array([i])} for i in range(6)]
    got = []
    for b in prefetch_to_device(iter(host), device="cuda"):
        assert b["x"].is_cuda
        y = b["x"]
        for _ in range(20):  # keep the compute stream busy
            y = y * 1.0
        got.append({"x": y.cpu().numpy(), "i": b["i"].cpu().numpy()})
    assert len(got) == len(host)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g["x"], h["x"])
        np.testing.assert_array_equal(g["i"], h["i"])

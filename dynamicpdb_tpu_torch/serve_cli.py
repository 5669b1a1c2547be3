"""Trajectory-extension serving endpoint.

Port of ``dynamicpdb_tpu/serve_cli.py``: a long-lived process that loads the
model once and answers HTTP requests with rollouts, with the same API:

    python -m dynamicpdb_tpu_torch.serve_cli --ckpt weights.pt \
        [--port 8765] [--pad-to 256] [--device cuda] [--config c.yaml] \
        [--ema] [overrides...]

  GET  /healthz             -> {"status": "ok", device, step, pad_to}
  POST /rollout?n_steps=64[&num_t=10&noise_scale=0.1&fast_x0=0&seed=0]
       body: an .npz with the raw window keys (RAW_KEYS)
       -> an .npz with atom_traj [n_steps,N,37,3] and rigid_traj
       [n_steps,N,7], residue axis un-padded back to the request's N.

``--ckpt`` is a training checkpoint of ``train_cli`` or a ``torch.save``d
state dict of ``DFoldScoreNetwork`` (``weights.state_dict_from_jax`` makes
one from JAX params); with ``--ema`` the EMA weights of a training
checkpoint's optimizer state are served instead. Requests are
padded to ``--pad-to`` residues; the device work of one request at a time
runs behind a lock, while the threaded HTTP layer keeps health checks
answering. Logs go to stderr.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dynamicpdb_tpu_torch import config as config_lib
from dynamicpdb_tpu_torch.data.dataset import pad_window
from dynamicpdb_tpu_torch.data.featurize import eval_init_window, featurize_window
from dynamicpdb_tpu_torch.diffusion.se3_diffuser import SE3Diffuser
from dynamicpdb_tpu_torch.models.score_network import DFoldScoreNetwork
from dynamicpdb_tpu_torch.sampling.reverse import rollout
from dynamicpdb_tpu_torch.train.checkpoint import model_state_dict, restore
from dynamicpdb_tpu_torch.train.optim import ema_state_dict, make_optimizer
from dynamicpdb_tpu_torch.utils.platform import resolve_device

log = logging.getLogger("serve")

RAW_KEYS = ("atom37", "atom37_mask", "aatype", "residue_index",
            "force", "vel", "node_repr", "edge_repr")


class RolloutService:
    """Model + diffuser on one device; HTTP-free, so tests drive it directly."""

    def __init__(self, model: DFoldScoreNetwork, diffuser: SE3Diffuser,
                 pad_to: int, step: int = -1):
        self.model = model.eval()
        self.diffuser = diffuser
        self.pad_to = pad_to
        self.step = step
        self.device = next(model.parameters()).device
        self._lock = threading.Lock()

    def health(self) -> dict:
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {
            "status": "ok",
            "device": f"{self.device} ({name})",
            "step": self.step,
            "pad_to": self.pad_to,
        }

    def extend(self, raw: dict, *, n_steps: int, num_t: int = 10,
               noise_scale: float = 0.1, fast_x0: bool = False,
               seed: int = 0) -> dict:
        """Raw window dict -> {atom_traj, rigid_traj} numpy arrays."""
        missing = [k for k in RAW_KEYS if k not in raw]
        if missing:
            raise ValueError(f"window is missing keys: {missing}")
        if not 1 <= n_steps <= 100_000:
            raise ValueError(f"n_steps out of range: {n_steps}")
        if num_t < 1:
            raise ValueError(f"num_t out of range: {num_t}")
        n = int(raw["aatype"].shape[0])
        padded = pad_window({k: raw[k] for k in RAW_KEYS}, self.pad_to)
        with self._lock, torch.inference_mode():  # one device: single flight
            window = {k: torch.as_tensor(v, device=self.device)
                      for k, v in padded.items()}
            g = torch.Generator(device=self.device).manual_seed(seed)
            feats = eval_init_window(featurize_window(window), self.diffuser,
                                     generator=g)
            atom_traj, rigid_traj = rollout(
                self.model, self.diffuser, feats, n_steps=n_steps,
                num_t=num_t, noise_scale=noise_scale, fast_x0=fast_x0,
                generator=g,
            )
            return {
                "atom_traj": atom_traj[:, :n].cpu().numpy(),
                "rigid_traj": rigid_traj[:, :n].cpu().numpy(),
            }


def make_handler(service: RolloutService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # through logging, not raw stderr
            log.info("%s " + fmt, self.client_address[0], *a)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                return self._json(200, service.health())
            return self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/rollout":
                return self._json(404, {"error": f"unknown path {url.path}"})
            q = parse_qs(url.query)

            def arg(name, cast, default):
                return cast(q[name][0]) if name in q else default

            try:
                n_steps = arg("n_steps", int, None)
                if n_steps is None:
                    raise ValueError("n_steps query parameter is required")
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    raw = {k: z[k] for k in z.files}
                out = service.extend(
                    raw,
                    n_steps=n_steps,
                    num_t=arg("num_t", int, 10),
                    noise_scale=arg("noise_scale", float, 0.1),
                    fast_x0=bool(arg("fast_x0", int, 0)),
                    seed=arg("seed", int, 0),
                )
            except (ValueError, KeyError) as e:
                return self._json(400, {"error": str(e)})
            buf = io.BytesIO()
            np.savez(buf, **out)
            payload = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler


def make_server(service: RolloutService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(service))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="train_cli checkpoint, or a torch.save'd "
                             "DFoldScoreNetwork state dict")
    parser.add_argument("--config", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--pad-to", type=int, default=None,
                        help="fixed residue count every request pads to "
                             "(default: data.filtering.max_len)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ema", action="store_true",
                        help="serve the EMA weights from the checkpoint's "
                             "optimizer state (trained with "
                             "experiment.ema_decay)")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def service_from_args(args: argparse.Namespace) -> RolloutService:
    """Load the config and weights named by ``args`` onto ``args.device``."""
    cfg = (
        config_lib.load_yaml(args.config, args.overrides)
        if args.config
        else config_lib.apply_overrides(config_lib.Config(), args.overrides)
    )
    device = resolve_device(args.device)
    model = DFoldScoreNetwork(cfg.model, device=device)
    if args.ema:
        optimizer = make_optimizer(model.parameters(), cfg.experiment)
        payload = restore(args.ckpt, model, optimizer)
        if payload.get("optimizer") is None:
            raise SystemExit("--ema: the checkpoint has no optimizer state")
        model.load_state_dict(ema_state_dict(optimizer, model))
        step = payload["step"]
        log.info("serving the EMA weights of %s", args.ckpt)
    else:
        state, step = model_state_dict(args.ckpt, map_location=device)
        model.load_state_dict(state, strict=True)
    diffuser = SE3Diffuser(cfg.diffuser, device=device)
    return RolloutService(model, diffuser,
                          args.pad_to or cfg.data.filtering.max_len, step=step)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    service = service_from_args(args)
    server = make_server(service, args.host, args.port)
    log.info("serving %s on http://%s:%d  pad_to=%d device=%s", args.ckpt,
             *server.server_address, service.pad_to, service.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

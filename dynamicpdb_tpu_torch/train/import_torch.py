"""Load trained REFERENCE checkpoints (torch pickles) into the port's model.

Port of ``load_reference_checkpoint`` from
``dynamicpdb_tpu/train/import_torch.py``. The reference saves a
torch-pickled dict {'model': state_dict, 'conf': an OmegaConf object,
'optimizer', 'epoch', 'step'}, its state dict keys carry DDP's 'module.'
prefix, and it holds the dead ``embedding_layer.*`` parameters whose
outputs the reference computes and overwrites
(``dynamicpdb_tpu/train/export_torch.py:51-74``). The port's parameters
already use the reference layout, so a reference state dict loads
strictly once the prefix is stripped and the dead entries are dropped;
no mapping like the JAX package's flax conversion is needed.

The JAX module's ``flax_from_reference_state_dict`` maps onto flax's
parameter tree; the port's parameters already have the reference keys.
"""
from __future__ import annotations

import io
import logging
import pickle

import torch

log = logging.getLogger(__name__)

DEAD_PREFIX = "embedding_layer."


class _Stub:
    """Accepts any pickled state; stands in for unimportable classes."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            log.debug("stubbing unpicklable %s.%s", module, name)
            return type(name, (_Stub,), {})


class _PickleModule:
    Unpickler = _TolerantUnpickler
    load = staticmethod(lambda f, **kw: _TolerantUnpickler(f).load())
    loads = staticmethod(
        lambda b, **kw: _TolerantUnpickler(io.BytesIO(b)).load())


def load_reference_checkpoint(path: str) -> dict:
    """``torch.load`` of a reference checkpoint, with every class that does
    not import here (OmegaConf's, say) replaced by a stub and every tensor
    mapped to the CPU. Unpickling runs code from the file: load only
    checkpoints you trust. Returns the raw payload dict."""
    return torch.load(path, map_location="cpu", pickle_module=_PickleModule,
                      weights_only=False)


def state_dict_from_reference(sd: dict) -> dict:
    """A reference state dict in the port's keys: 'module.' stripped, the
    dead ``embedding_layer.*`` entries dropped."""
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if not key.startswith(DEAD_PREFIX):
            out[key] = value
    return out


def import_reference_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """Load a reference checkpoint's weights into ``model`` (strict).
    Returns the payload's conf, epoch and step."""
    payload = load_reference_checkpoint(path)
    model.load_state_dict(state_dict_from_reference(payload["model"]),
                          strict=True)
    extras = {k: payload.get(k) for k in ("conf", "epoch", "step")}
    n = sum(p.numel() for p in model.parameters())
    log.info("imported reference checkpoint %s: %.1fM params (step %s)",
             path, n / 1e6, extras.get("step"))
    return extras

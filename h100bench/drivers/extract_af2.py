"""AlphaFold2 embedding extraction from an MSA:
``preprocess.extract_embeddings.extract_alphafold_embeddings`` (which runs
``alphafold_embed``), closed loop, one alignment after another until its
reprs reach the host.

Set-up builds AlphaFold2 ``model_5`` on the card with the seed's weights
(``alphafold_from_state_dict`` on tensors drawn on the card) and the
traffic's distinct alignments (``inputs_alphafold``); one alignment warms
every shape (all have the traffic's length and depth). A unit is one
alignment, named ``s<unit>``, which seeds its recycles' draws; its work is
its residues.

Every unit keeps each recycle's outputs on the card as the recycle ends
(``alphafold_embed``'s ``on_recycle``, rebound: references, no copy and
no sync), until the unit ends. The checked unit is drawn from the seed
before the window, among its first ``check_within`` units (which unit
to keep has to be known while it runs: keeping every unit's would grow
the card's memory with the window); its outputs alone outlive it. After
the window they reach the host, and the reference holds every recycle
of it, the last one's reprs and pLDDT as the npz path fetched them,
against its own pass from the same recycled inputs
(``steps_alphafold.recycle_gaps``).
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
from torch.profiler import record_function

from h100bench import harness, inputs_alphafold, traffic as gen


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 model_factory=None):
        from dynamicpdb_tpu_torch.models.alphafold.model import (
            alphafold_from_state_dict,
        )
        from dynamicpdb_tpu_torch.preprocess import extract_embeddings
        from h100bench.reference import steps_alphafold as ref

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self._entry = extract_embeddings
        data = dict(num_recycle=config["num_recycle"],
                    max_msa_clusters=config["max_msa_clusters"],
                    max_extra_msa=config["max_extra_msa"],
                    masked_msa_replace_fraction=config[
                        "masked_msa_replace_fraction"])
        if model_factory is None:  # model_5
            self.model = alphafold_from_state_dict(
                ref.alphafold_weights(seed, self.device), device=self.device,
                **data)
        else:
            self.model = model_factory(seed, self.device, data)
        self.alignments = inputs_alphafold.alignments(traffic, seed)
        rows = traffic["msa_rows"]
        self.counters = {
            "n_res": traffic["length"],
            "msa_clusters": min(config["max_msa_clusters"], rows),
            "extra_rows": min(config["max_extra_msa"],
                              max(rows - config["max_msa_clusters"], 0))}
        # the warm-up is unit 0; the window's units count from 1
        self.checked = 1 + int(np.random.default_rng(gen.sub_seed(
            seed, 4)).integers(0, traffic["check_within"]))
        self.captured = None  # (recycles' outputs on the card, arrays, pLDDT)
        self.done = 0
        self._sequence()  # warm-up

    @contextlib.contextmanager
    def _holding(self, recycles: list):
        """The program's ``alphafold_embed`` with each recycle's outputs
        appended to ``recycles`` as it ends, left on the card."""
        entry = self._entry
        real = entry.alphafold_embed

        def embed(model, inputs, on_recycle=None):
            return real(model, inputs,
                        on_recycle=lambda i, out: recycles.append(out))

        entry.alphafold_embed = embed
        try:
            yield
        finally:
            entry.alphafold_embed = real

    def _sequence(self) -> float:
        i = self.done
        lines = self.alignments[i % len(self.alignments)]
        recycles: list = []
        with self._holding(recycles), record_function("bench.sequence"):
            (_, arrays, stats), = self._entry.extract_alphafold_embeddings(
                [(f"s{i}", lines)], self.model)
        if i == self.checked:
            self.captured = (recycles, arrays, stats["plddt"])
        self.done += 1
        return float(stats["n_res"])

    def unit(self) -> float:
        return self._sequence()

    def reset_counters(self) -> None:
        """The per-layer metrics read the program's own spans: nothing is
        counted by the harness."""

    @contextlib.contextmanager
    def traced(self):
        yield

    def check(self, reference_model=None) -> dict:
        """The reference passes every recycle of the checked unit from the
        program's recycled outputs, with the same weights, a3m lines and
        name; its last recycle is held to the npz's arrays."""
        from h100bench.reference import steps_alphafold as ref

        if self.captured is None:
            raise RuntimeError(f"the window ended before unit "
                               f"{self.checked}, the checked one")
        recycles, arrays, plddt = self.captured
        recycles = [ref.host_outputs(o) for o in recycles]
        self.captured = None
        last = dict(recycles[-1], msa_first_row=torch.as_tensor(
            arrays["node_repr"]), pair=torch.as_tensor(arrays["edge_repr"]),
            single=torch.as_tensor(arrays["single_repr"]),
            plddt=torch.as_tensor(plddt))
        outputs = recycles[:-1] + [last]
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        model = (reference_model or ref.alphafold_model)(self.seed,
                                                         self.device)
        i = self.checked
        want, flops = harness.count_flops(lambda: ref.recycles_on(
            model, f"s{i}", self.alignments[i % len(self.alignments)],
            outputs))
        self.counters["flops_per_unit"] = flops
        gaps = ref.recycle_gaps(outputs, want)
        print(f"extract detail: alignment {i}, {gaps}; mean pLDDT "
              f"{float(np.mean(plddt))}, the reference's "
              f"{float(want[-1]['plddt'].mean())}", file=sys.stderr)
        lim = self.traffic["limits"]
        return {k: harness.check(v, lim[k]) for k, v in gaps.items()
                if k in lim}

"""Embedding extraction: ``preprocess.extract_embeddings.extract_embeddings``
(which runs ``omegafold_embed``), closed loop, one sequence after another
until its reprs reach the host.

Set-up builds the release OmegaFold on the card with the seed's weights
(``omegafold_from_state_dict`` on tensors drawn on the card) and the
traffic's distinct sequences; one sequence warms every shape (all have the
traffic's length). A unit is one sequence; its work is its residues. After
the window the reference re-extracts a sample of the finished sequences,
drawn from the seed: the node and edge reprs are compared, and the cycle
they were kept from is held to the reference's most confident one.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
from torch.profiler import record_function

from h100bench import costs, harness, inputs, traffic as gen, weights as bench_weights


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 model_factory=None):
        from dynamicpdb_tpu_torch.models.omegafold.model import (
            omegafold_from_state_dict,
        )
        from dynamicpdb_tpu_torch.preprocess.extract_embeddings import (
            extract_embeddings,
        )
        from h100bench.reference import steps as ref

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self._extract = extract_embeddings
        if model_factory is None:  # the release model
            weights = bench_weights.omegafold_weights(
                ref.omegafold_shapes(), seed, self.device)
            self.model = omegafold_from_state_dict(weights, device=self.device)
        else:
            self.model = model_factory(seed, self.device)
        self.sequences = inputs.sequences(traffic, seed)
        self.counters = {}
        self.done = 0
        # (sequence index, node_repr, edge_repr, confidences, cycle)
        self.served = []
        self._sequence(keep=False)  # warm-up

    def _sequence(self, keep: bool = True) -> float:
        i = self.done
        seq = self.sequences[i % len(self.sequences)]
        with record_function("bench.sequence"):
            (_, arrays, stats), = self._extract(
                [f">s{i}\n", seq + "\n"], self.model,
                num_cycles=self.config["num_cycles"],
                num_pseudo_msa=self.config["num_pseudo_msa"])
        if keep:
            self.served.append((i, arrays["node_repr"], arrays["edge_repr"],
                                stats["confidences"], stats["cycle"]))
        self.done += 1
        return float(stats["n_res"])

    def unit(self) -> float:
        return self._sequence()

    def reset_counters(self) -> None:
        for calls in self.counters["op_bounds"].values():
            calls.clear()

    @contextlib.contextmanager
    def traced(self):
        """The GeoFormer's two gated attentions in ``bench.op.geom``
        ranges, each call with its least time."""
        from dynamicpdb_tpu_torch.models.omegafold import geoformer

        calls: list = []
        self.counters["op_bounds"] = {"bench.op.geom": calls}
        dtype = self.config["compute_dtype"]

        def geom_cost(args, kwargs, out):
            x, qg_w = args[0], args[1]
            B, R, L, d = x.shape
            H, c = qg_w.shape[2], kwargs["c"]
            return costs.bound_s(
                costs.gated_attention_cost(B, R, H, L, L, d, c),
                costs.tensor_bytes(*args[:6], out), dtype)

        def node_cost(args, kwargs, out):
            x, qg_w, bias = args[0], args[1], args[5]
            M, L, d = x.shape
            H, c, Lq = qg_w.shape[2], kwargs["c"], bias.shape[-2]
            return costs.bound_s(
                costs.gated_attention_cost(M, 1, H, Lq, L, d, c),
                costs.tensor_bytes(*args[:7], out), dtype)

        with harness.rebound(geoformer, "fused_gated_geom_attention_t",
                             "bench.op.geom", calls, geom_cost), \
                harness.rebound(geoformer, "fused_gated_node_attention",
                                "bench.op.geom", calls, node_cost):
            yield

    def sample(self) -> list:
        n = self.traffic["check_sequences"]
        order = np.random.default_rng(gen.sub_seed(self.seed, 4)).permutation(
            len(self.served))
        return [self.served[j] for j in order[:n]]

    def check(self, reference_model=None) -> dict:
        """The reference extracts the sampled sequences from the same
        weights and sequences (``steps.omegafold_gaps`` says what is
        compared)."""
        from h100bench.reference import steps as ref

        picked = self.sample()
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        model = (reference_model or ref.omegafold_model)(self.seed,
                                                         self.device)
        worst: dict[str, float] = {}
        for k, (i, node, edge, confs, cycle) in enumerate(picked):
            def extract(i=i):
                return ref.omegafold_sequence(
                    model, f"s{i}", self.sequences[i % len(self.sequences)],
                    num_cycles=self.config["num_cycles"],
                    num_pseudo_msa=self.config["num_pseudo_msa"])
            if k == 0:
                want, flops = harness.count_flops(extract)
                self.counters["flops_per_unit"] = flops
            else:
                want = extract()
            gaps = ref.omegafold_gaps(node, edge, confs, cycle, want)
            print(f"extract detail: sequence {i}, cycle {cycle} (the "
                  f"reference's {want['cycle']}), {gaps}; confidences "
                  f"{list(confs)}, the reference's {want['confidences']}; "
                  f"cycle_choice_gap of wrong choices "
                  f"{ref.wrong_choice_gaps(want)}", file=sys.stderr)
            for name, v in gaps.items():
                worst[name] = max(worst.get(name, 0.0), v)
        lim = self.traffic["limits"]
        return {k: harness.check(v, lim[k]) for k, v in worst.items()
                if k in lim}

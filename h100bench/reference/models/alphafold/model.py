"""A plain reference of AlphaFold2 ``model_5`` extraction, in float32 torch:
the benchmark's frozen copy of ``dynamicpdb_tpu_torch/models/alphafold/
reference.py``.

The model from the published algorithms (Jumper et al., Nature 596:583,
2021, Supplementary Information, Algorithms 2-32), written for the
comparison that holds the port's extraction to it: it imports only torch
and numpy. Every module is ``nn.Linear`` and ``nn.LayerNorm`` with their
affines as they are (no folding), every attention is materialised, in
blocks of rows so that it fits a card at 512 clusters and 1,024 extra
rows. ``float32_exact`` turns TF32 off for matmuls and cuDNN. The
per-recycle features are made from the same NumPy draws as the port's
(``draws``), from this file's own a3m parser.

Departures from the paper, each exact or of no consequence to what
extraction reads:

* No mask is formed: one sequence has no padding, and every MSA, extra-MSA
  and pair mask of AlphaFold2 is then all ones. The outer product mean
  divides by the number of rows + 1e-3, as AlphaFold2 does with an all-ones
  mask. An alignment of no more rows than the clusters has no extra rows,
  and the extra-MSA stack is skipped (AlphaFold2 would pad it with masked
  rows).
* Dropout is off (inference).
* The side-chain torsions (the angle resnet) and the distogram,
  masked-MSA and experimentally-resolved heads are not computed:
  extraction reads none of them. The recycled pseudo-beta positions are
  Cβ in the backbone frame (CA for glycine and X), which needs no torsion.
* The IPA's output concatenates the points per head and point as (x, y,
  z) triples (AlphaFold2: all x, then all y, then all z) and takes the
  norm without its 1e-8: a permutation of the output projection's inputs
  with random weights, and a rounding-level change.
* A profile draw of the masked MSA takes the token of a uniformly drawn
  row of the whole alignment: AlphaFold2's categorical draw from the
  column's profile, in integers.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch
from torch import nn

RESTYPES = "ARNDCQEGHILKMFPSTWYV"
ALIASES = {"B": "D", "Z": "E", "U": "C"}
UNK, GAP, MASK_TOKEN, NUM_TOKENS = 20, 21, 22, 23
GLY = RESTYPES.index("G")

# Cβ in the backbone frame per residue type (AlphaFold2's
# residue_constants.rigid_group_atom_positions, group 0); X has none
CB_LITERATURE = [
    (-0.529, -0.774, -1.205), (-0.524, -0.778, -1.209),
    (-0.531, -0.787, -1.200), (-0.526, -0.778, -1.208),
    (-0.519, -0.773, -1.212), (-0.525, -0.779, -1.207),
    (-0.526, -0.781, -1.207), (0.0, 0.0, 0.0),
    (-0.525, -0.778, -1.208), (-0.536, -0.793, -1.213),
    (-0.522, -0.773, -1.214), (-0.524, -0.778, -1.208),
    (-0.523, -0.776, -1.210), (-0.525, -0.776, -1.212),
    (-0.546, -0.611, -1.293), (-0.518, -0.777, -1.211),
    (-0.516, -0.793, -1.215), (-0.523, -0.776, -1.212),
    (-0.522, -0.776, -1.213), (-0.533, -0.795, -1.213),
    (0.0, 0.0, 0.0)]


def float32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Config:
    """``model_5``'s widths, depths and data settings; any may be given."""

    msa_dim = 256
    pair_dim = 128
    single_dim = 384
    extra_msa_dim = 64
    evoformer_blocks = 48
    extra_msa_blocks = 4
    msa_heads = 8
    msa_head_dim = 32
    extra_msa_head_dim = 8
    pair_heads = 4
    pair_head_dim = 32
    transition_factor = 4
    opm_dim = 32
    max_relative_feature = 32
    prev_pos_bins = 15
    prev_pos_min = 3.25
    prev_pos_max = 20.75
    ipa_heads = 12
    ipa_scalar = 16
    ipa_points_qk = 4
    ipa_points_v = 8
    structure_layers = 8
    structure_transition = 3
    plddt_hidden = 128
    plddt_bins = 50
    num_recycle = 3
    max_msa_clusters = 512
    max_extra_msa = 1024
    replace_fraction = 0.15

    def __init__(self, **kw):
        for k, v in kw.items():
            if not hasattr(Config, k):
                raise AttributeError(k)
            setattr(self, k, v)


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------
def token(ch: str) -> int:
    ch = ALIASES.get(ch, ch)
    if ch == "-":
        return GAP
    return RESTYPES.index(ch) if ch in RESTYPES else UNK


def parse_a3m(lines):
    """(name, tokens [N, L] int64, deletions [N, L] float32): lowercase
    letters are insertions, counted against the next aligned column;
    equal aligned rows after the first are dropped."""
    name, rows, cur = None, [], None
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if cur is not None:
                rows.append(cur)
            elif name is None:
                words = line[1:].split()
                name = words[0] if words else ""
            cur = ""
        else:
            cur += line
    rows.append(cur)
    seen, tokens, deletions = set(), [], []
    for row in rows:
        toks, dels, run = [], [], 0
        for ch in row:
            if ch.islower():
                run += 1
            else:
                toks.append(token(ch))
                dels.append(run)
                run = 0
        key = tuple(toks)
        if key in seen:
            continue
        seen.add(key)
        tokens.append(toks)
        deletions.append(dels)
    return (name or "", np.array(tokens, np.int64),
            np.array(deletions, np.float32))


def draws(name: str, recycle: int, n_seq: int, n_res: int, cfg: Config):
    """One recycle's random choices, from the NumPy generator seeded with
    [crc32(name), recycle], in the order the port draws them."""
    rng = np.random.default_rng([zlib.crc32(name.encode("utf-8")), recycle])
    order = np.concatenate([[0], 1 + rng.permutation(n_seq - 1)])
    n_sel = min(cfg.max_msa_clusters, n_seq)
    shape = (n_sel, n_res)
    replaced = rng.random(shape) < cfg.replace_fraction
    kind = rng.random(shape)
    residue = rng.integers(0, 20, shape)
    row = rng.integers(0, n_seq, shape)
    crop = rng.permutation(n_seq - n_sel)[:cfg.max_extra_msa]
    return order[:n_sel], order[n_sel:], replaced, kind, residue, row, crop


def recycle_features(name, tokens, deletions, recycle: int, cfg: Config,
                     device):
    """msa_feat [clusters, L, 49] and extra_msa_feat [extra, L, 25] of one
    recycle: sample_msa, make_masked_msa, nearest_neighbor_clusters,
    summarize_clusters, crop_extra_msa, make_msa_feat."""
    n_seq, L = tokens.shape
    sel, extra, replaced, kind, residue, row, crop = draws(
        name, recycle, n_seq, L, cfg)
    msa = tokens[sel].copy()
    profile_tok = tokens[row, np.arange(L)[None, :]]
    repl = np.where(kind < 0.1, residue, np.where(
        kind < 0.2, profile_tok, np.where(kind < 0.3, msa, MASK_TOKEN)))
    msa = np.where(replaced, repl, msa)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    msa_hot = nn.functional.one_hot(t(msa), NUM_TOKENS).float()
    msa_del = t(deletions[sel])
    if len(extra):
        ex_hot = nn.functional.one_hot(t(tokens[extra]), NUM_TOKENS).float()
        ex_del = t(deletions[extra])
        weights = torch.tensor([1.0] * 21 + [0.0, 0.0], device=device)
        agreement = torch.einsum("elt,slt->es", ex_hot, msa_hot * weights)
        assign = torch.argmax(agreement, dim=1)
        onehot_assign = nn.functional.one_hot(assign, len(sel)).float()
        counts = (1.0 + 1e-6) + torch.einsum("es,el->sl", onehot_assign,
                                             torch.ones_like(ex_del))
        profile = (msa_hot + torch.einsum("es,elt->slt", onehot_assign,
                                          ex_hot)) / counts[..., None]
        del_mean = (msa_del + torch.einsum("es,el->sl", onehot_assign,
                                           ex_del)) / counts
        ex_hot, ex_del = ex_hot[t(crop)], ex_del[t(crop)]
    else:
        profile = msa_hot / (1.0 + 1e-6)
        del_mean = msa_del / (1.0 + 1e-6)
        ex_hot = torch.zeros(0, L, NUM_TOKENS, device=device)
        ex_del = torch.zeros(0, L, device=device)

    def dv(d):
        return torch.atan(d / 3.0) * (2.0 / math.pi)

    msa_feat = torch.cat([msa_hot, msa_del.clamp(0, 1)[..., None],
                          dv(msa_del)[..., None], profile,
                          dv(del_mean)[..., None]], -1)
    extra_feat = torch.cat([ex_hot, ex_del.clamp(0, 1)[..., None],
                            dv(ex_del)[..., None]], -1)
    return msa_feat, extra_feat


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------
def blocked(fn, n: int, block: int, dim: int = 0):
    """torch.cat of fn(slice) over blocks of ``block`` along ``dim``."""
    return torch.cat([fn(slice(i, min(i + block, n)))
                      for i in range(0, n, block)], dim)


def attend(q, k, v, bias, g):
    """softmax(q k^T / sqrt(c) + bias) v, gated: q, k, v, g [..., N, H, c]
    over the second-to-last but one axis, bias broadcastable to [..., H,
    Nq, Nk]."""
    c = q.shape[-1]
    logits = torch.einsum("...qhc,...khc->...hqk", q, k) / math.sqrt(c) + bias
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khc->...qhc", w, v) * torch.sigmoid(g)


class GatedAttention(nn.Module):
    """Gated multi-head attention over the second-to-last axis of its
    input, optionally with a bias from the pair tensor (Algorithms 7, 8,
    13, 14)."""

    def __init__(self, c_in, heads, c, pair_bias: int | None = None):
        super().__init__()
        self.heads, self.c = heads, c
        if pair_bias:
            self.layer_norm_m = nn.LayerNorm(c_in)
            self.layer_norm_z = nn.LayerNorm(pair_bias)
            self.linear_z = nn.Linear(pair_bias, heads, bias=False)
        else:
            self.layer_norm = nn.LayerNorm(c_in)
        self.linear_q = nn.Linear(c_in, heads * c, bias=False)
        self.linear_k = nn.Linear(c_in, heads * c, bias=False)
        self.linear_v = nn.Linear(c_in, heads * c, bias=False)
        self.linear_g = nn.Linear(c_in, heads * c)
        self.linear_o = nn.Linear(heads * c, c_in)

    def forward(self, x, bias=None, block: int = 64):
        """x [B, N, c_in]: row b attends over its N entries; bias [H, N, N]
        shared by the rows. ``block`` rows at a time."""
        norm = getattr(self, "layer_norm_m", None) or self.layer_norm
        x = norm(x)
        H, c = self.heads, self.c

        def rows(s):
            xs = x[s]
            sh = xs.shape[:-1] + (H, c)
            out = attend(self.linear_q(xs).view(sh), self.linear_k(xs).view(sh),
                         self.linear_v(xs).view(sh),
                         0.0 if bias is None else bias,
                         self.linear_g(xs).view(sh))
            return self.linear_o(out.reshape(xs.shape[:-1] + (H * c,)))

        return blocked(rows, x.shape[0], block)

    def pair_bias(self, z):
        return self.linear_z(self.layer_norm_z(z)).permute(2, 0, 1)


class GlobalColumnAttention(nn.Module):
    """Algorithm 19 on m [M, L, c]: per column, one query (the mean row's),
    keys and values one head wide."""

    def __init__(self, c_in, heads, c):
        super().__init__()
        self.heads, self.c = heads, c
        self.layer_norm = nn.LayerNorm(c_in)
        self.linear_q = nn.Linear(c_in, heads * c, bias=False)
        self.linear_k = nn.Linear(c_in, c, bias=False)
        self.linear_v = nn.Linear(c_in, c, bias=False)
        self.linear_g = nn.Linear(c_in, heads * c)
        self.linear_o = nn.Linear(heads * c, c_in)

    def forward(self, m):
        x = self.layer_norm(m)
        H, c = self.heads, self.c
        q = self.linear_q(x.mean(0)).view(-1, H, c) / math.sqrt(c)  # [L, H, c]
        k, v = self.linear_k(x), self.linear_v(x)  # [M, L, c]
        w = torch.softmax(torch.einsum("lhc,mlc->lhm", q, k), dim=-1)
        avg = torch.einsum("lhm,mlc->lhc", w, v)
        g = torch.sigmoid(self.linear_g(x)).view(*x.shape[:2], H, c)
        return self.linear_o((g * avg).reshape(*x.shape[:2], H * c))


class Transition(nn.Module):
    """Algorithms 9 and 15."""

    def __init__(self, c, factor):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c)
        self.linear_1 = nn.Linear(c, factor * c)
        self.linear_2 = nn.Linear(factor * c, c)

    def forward(self, x):
        return self.linear_2(torch.relu(self.linear_1(self.layer_norm(x))))


class OuterProductMean(nn.Module):
    """Algorithm 10."""

    def __init__(self, c_m, c, c_z):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_m)
        self.linear_a = nn.Linear(c_m, c)
        self.linear_b = nn.Linear(c_m, c)
        self.linear_out = nn.Linear(c * c, c_z)

    def forward(self, m, block: int = 32):
        x = self.layer_norm(m)
        a, b = self.linear_a(x), self.linear_b(x)

        def rows(s):
            o = torch.einsum("sic,sje->ijce", a[:, s], b)
            return self.linear_out(o.reshape(o.shape[0], o.shape[1], -1))

        return blocked(rows, a.shape[1], block) / (m.shape[0] + 1e-3)


class TriangleMultiplication(nn.Module):
    """Algorithms 11 (outgoing) and 12 (incoming)."""

    def __init__(self, c_z, outgoing: bool):
        super().__init__()
        self.outgoing = outgoing
        self.layer_norm_in = nn.LayerNorm(c_z)
        for n in ("a_p", "a_g", "b_p", "b_g", "g"):
            setattr(self, f"linear_{n}", nn.Linear(c_z, c_z))
        self.layer_norm_out = nn.LayerNorm(c_z)
        self.linear_z = nn.Linear(c_z, c_z)

    def forward(self, z):
        x = self.layer_norm_in(z)
        a = torch.sigmoid(self.linear_a_g(x)) * self.linear_a_p(x)
        b = torch.sigmoid(self.linear_b_g(x)) * self.linear_b_p(x)
        eq = "ikc,jkc->ijc" if self.outgoing else "kic,kjc->ijc"
        u = self.linear_z(self.layer_norm_out(torch.einsum(eq, a, b)))
        return torch.sigmoid(self.linear_g(x)) * u


class TriangleAttention(nn.Module):
    """Algorithms 13 (starting node) and 14 (ending node, on z^T)."""

    def __init__(self, c_z, heads, c, starting: bool):
        super().__init__()
        self.starting = starting
        self.heads, self.c = heads, c
        self.layer_norm = nn.LayerNorm(c_z)
        self.linear_z = nn.Linear(c_z, heads, bias=False)
        self.linear_q = nn.Linear(c_z, heads * c, bias=False)
        self.linear_k = nn.Linear(c_z, heads * c, bias=False)
        self.linear_v = nn.Linear(c_z, heads * c, bias=False)
        self.linear_g = nn.Linear(c_z, heads * c)
        self.linear_o = nn.Linear(heads * c, c_z)

    def forward(self, z, block: int = 64):
        if not self.starting:
            z = z.transpose(0, 1)
        x = self.layer_norm(z)
        bias = self.linear_z(x).permute(2, 0, 1)  # [H, j, k]
        H, c = self.heads, self.c

        def rows(s):
            xs = x[s]
            sh = xs.shape[:-1] + (H, c)
            out = attend(self.linear_q(xs).view(sh), self.linear_k(xs).view(sh),
                         self.linear_v(xs).view(sh), bias,
                         self.linear_g(xs).view(sh))
            return self.linear_o(out.reshape(xs.shape[:-1] + (H * c,)))

        out = blocked(rows, x.shape[0], block)
        return out if self.starting else out.transpose(0, 1)


class EvoformerBlock(nn.Module):
    """Algorithm 6 (18 for the extra-MSA stack: global column attention)."""

    def __init__(self, cfg: Config, extra: bool):
        super().__init__()
        c_m = cfg.extra_msa_dim if extra else cfg.msa_dim
        c = cfg.extra_msa_head_dim if extra else cfg.msa_head_dim
        z = cfg.pair_dim
        self.msa_row_attention = GatedAttention(c_m, cfg.msa_heads, c,
                                                pair_bias=z)
        if extra:
            self.msa_column_global_attention = GlobalColumnAttention(
                c_m, cfg.msa_heads, c)
        else:
            self.msa_column_attention = GatedAttention(c_m, cfg.msa_heads, c)
        self.msa_transition = Transition(c_m, cfg.transition_factor)
        self.outer_product_mean = OuterProductMean(c_m, cfg.opm_dim, z)
        self.triangle_multiplication_outgoing = TriangleMultiplication(z, True)
        self.triangle_multiplication_incoming = TriangleMultiplication(z, False)
        self.triangle_attention_starting = TriangleAttention(
            z, cfg.pair_heads, cfg.pair_head_dim, True)
        self.triangle_attention_ending = TriangleAttention(
            z, cfg.pair_heads, cfg.pair_head_dim, False)
        self.pair_transition = Transition(z, cfg.transition_factor)

    def forward(self, m, z):
        row = self.msa_row_attention
        m = m + row(m, row.pair_bias(z))
        if hasattr(self, "msa_column_global_attention"):
            m = m + self.msa_column_global_attention(m)
        else:
            m = m + self.msa_column_attention(
                m.transpose(0, 1)).transpose(0, 1)
        m = m + self.msa_transition(m)
        z = z + self.outer_product_mean(m)
        z = z + self.triangle_multiplication_outgoing(z)
        z = z + self.triangle_multiplication_incoming(z)
        z = z + self.triangle_attention_starting(z)
        z = z + self.triangle_attention_ending(z)
        return m, z + self.pair_transition(z)


class Stack(nn.Module):
    def __init__(self, cfg: Config, n: int, extra: bool):
        super().__init__()
        self.blocks = nn.ModuleList(EvoformerBlock(cfg, extra)
                                    for _ in range(n))
        if not extra:
            self.linear_single = nn.Linear(cfg.msa_dim, cfg.single_dim)


def quaternion_rotation(v):
    """The rotation of the quaternion (1, b, c, d), normalised."""
    q = torch.cat([torch.ones_like(v[..., :1]), v], -1)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    a, b, c, d = q.unbind(-1)
    return torch.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d,
    ], -1).view(v.shape[:-1] + (3, 3))


class InvariantPointAttention(nn.Module):
    """Algorithm 22 (no mask: one sequence)."""

    def __init__(self, cfg: Config):
        super().__init__()
        s, H = cfg.single_dim, cfg.ipa_heads
        self.H, self.c = H, cfg.ipa_scalar
        self.pq, self.pv = cfg.ipa_points_qk, cfg.ipa_points_v
        self.q_scalar = nn.Linear(s, H * self.c)
        self.k_scalar = nn.Linear(s, H * self.c)
        self.v_scalar = nn.Linear(s, H * self.c)
        self.q_point = nn.Linear(s, H * self.pq * 3)
        self.k_point = nn.Linear(s, H * self.pq * 3)
        self.v_point = nn.Linear(s, H * self.pv * 3)
        self.trainable_point_weights = nn.Parameter(torch.zeros(H))
        self.bias_2d = nn.Linear(cfg.pair_dim, H)
        self.output_projection = nn.Linear(
            H * (self.c + 4 * self.pv + cfg.pair_dim), s)

    def forward(self, s, z, rots, trans):
        L, H = s.shape[0], self.H
        w_l = math.sqrt(1.0 / 3.0)
        w_c = math.sqrt(2.0 / (9.0 * self.pq))
        q, k, v = (lin(s).view(L, H, -1) for lin in
                   (self.q_scalar, self.k_scalar, self.v_scalar))

        def points(lin):
            local = lin(s).view(L, H, -1, 3)
            return torch.einsum("lij,lhpj->lhpi", rots, local) + trans[:, None, None]

        qp, kp, vp = points(self.q_point), points(self.k_point), points(self.v_point)
        gamma = nn.functional.softplus(self.trainable_point_weights)
        d2 = ((qp[:, None] - kp[None]) ** 2).sum((-1, -2))  # [i, j, H]
        logits = w_l * (torch.einsum("ihc,jhc->ijh", q, k) / math.sqrt(self.c)
                        + self.bias_2d(z) - gamma * w_c / 2 * d2)
        a = torch.softmax(logits, dim=1)  # over j
        o = torch.einsum("ijh,jhc->ihc", a, v)
        op = torch.einsum("ijh,jhpc->ihpc", a, vp)
        op = torch.einsum("lji,lhpj->lhpi", rots, op - trans[:, None, None])
        o_pair = torch.einsum("ijh,ijc->ihc", a, z)
        feat = torch.cat([o.reshape(L, -1), op.reshape(L, -1),
                          torch.linalg.norm(op, dim=-1).reshape(L, -1),
                          o_pair.reshape(L, -1)], -1)
        return self.output_projection(feat)


class FoldIteration(nn.Module):
    """Algorithm 20's loop body: IPA, transition, backbone update (23)."""

    def __init__(self, cfg: Config):
        super().__init__()
        s = cfg.single_dim
        self.ipa = InvariantPointAttention(cfg)
        self.input_norm = nn.LayerNorm(s)
        self.transition = nn.ModuleList(nn.Linear(s, s) for _ in
                                        range(cfg.structure_transition))
        self.update_norm = nn.LayerNorm(s)
        self.affine_update = nn.Linear(s, 6)

    def forward(self, s, z, rots, trans):
        s = self.input_norm(s + self.ipa(s, z, rots, trans))
        x = s
        for i, lin in enumerate(self.transition):
            x = lin(x)
            if i < len(self.transition) - 1:
                x = torch.relu(x)
        s = self.update_norm(s + x)
        u = self.affine_update(s)
        return (s, rots @ quaternion_rotation(u[..., :3]),
                trans + torch.einsum("lij,lj->li", rots, u[..., 3:]))


class StructureModule(nn.Module):
    """Algorithm 20: 8 iterations of one shared fold iteration, frames in
    nanometres, positions returned in Angstrom."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.layers = cfg.structure_layers
        self.node_norm = nn.LayerNorm(cfg.single_dim)
        self.edge_norm = nn.LayerNorm(cfg.pair_dim)
        self.init_proj = nn.Linear(cfg.single_dim, cfg.single_dim)
        self.cycle = FoldIteration(cfg)

    def forward(self, single, pair):
        s = self.init_proj(self.node_norm(single))
        z = self.edge_norm(pair)
        L = s.shape[0]
        rots = torch.eye(3, device=s.device).expand(L, 3, 3)
        trans = torch.zeros(L, 3, device=s.device)
        for _ in range(self.layers):
            s, rots, trans = self.cycle(s, z, rots, trans)
        return s, rots, trans * 10.0


class PLDDTHead(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.single_dim)
        self.linear_1 = nn.Linear(cfg.single_dim, cfg.plddt_hidden)
        self.linear_2 = nn.Linear(cfg.plddt_hidden, cfg.plddt_hidden)
        self.linear_3 = nn.Linear(cfg.plddt_hidden, cfg.plddt_bins)

    def forward(self, s):
        x = torch.relu(self.linear_1(self.layer_norm(s)))
        logits = self.linear_3(torch.relu(self.linear_2(x)))
        n = logits.shape[-1]
        centres = (torch.arange(n, device=s.device, dtype=torch.float32)
                   + 0.5) / n
        return torch.softmax(logits, -1) @ centres  # in [0, 1]


class AlphaFold(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        m, z = cfg.msa_dim, cfg.pair_dim
        self.input_embedder = nn.Module()
        ie = self.input_embedder
        ie.linear_tf_m = nn.Linear(22, m)
        ie.linear_msa_m = nn.Linear(49, m)
        ie.linear_tf_z_i = nn.Linear(22, z)
        ie.linear_tf_z_j = nn.Linear(22, z)
        ie.linear_relpos = nn.Linear(2 * cfg.max_relative_feature + 1, z)
        self.recycling_embedder = nn.Module()
        re_ = self.recycling_embedder
        re_.linear = nn.Linear(cfg.prev_pos_bins, z)
        re_.layer_norm_m = nn.LayerNorm(m)
        re_.layer_norm_z = nn.LayerNorm(z)
        self.extra_msa_embedder = nn.Module()
        self.extra_msa_embedder.linear = nn.Linear(25, cfg.extra_msa_dim)
        self.extra_msa_stack = Stack(cfg, cfg.extra_msa_blocks, extra=True)
        self.evoformer = Stack(cfg, cfg.evoformer_blocks, extra=False)
        self.structure_module = StructureModule(cfg)
        self.plddt_head = PLDDTHead(cfg)

    def recycle(self, aatype, msa_feat, extra_feat, prev):
        """One pass (Algorithm 2's loop body)."""
        cfg, ie = self.cfg, self.input_embedder
        L = aatype.shape[0]
        tf = torch.cat([torch.zeros(L, 1, device=aatype.device),
                        nn.functional.one_hot(aatype, 21).float()], -1)
        m = ie.linear_tf_m(tf)[None] + ie.linear_msa_m(msa_feat)
        z = ie.linear_tf_z_i(tf)[:, None] + ie.linear_tf_z_j(tf)[None]
        re_ = self.recycling_embedder
        lower = torch.linspace(cfg.prev_pos_min, cfg.prev_pos_max,
                               cfg.prev_pos_bins, device=aatype.device) ** 2
        upper = torch.cat([lower[1:], lower.new_tensor([1e8])])
        pb = prev["pseudo_beta"]
        d2 = ((pb[:, None] - pb[None]) ** 2).sum(-1, keepdim=True)
        z = z + re_.linear(((d2 > lower) & (d2 < upper)).float())
        m = torch.cat([m[:1] + re_.layer_norm_m(prev["msa_first_row"]), m[1:]])
        z = z + re_.layer_norm_z(prev["pair"])
        idx = torch.arange(L, device=aatype.device)
        k = cfg.max_relative_feature
        rel = torch.clamp(idx[:, None] - idx[None, :] + k, 0, 2 * k)
        z = z + ie.linear_relpos(nn.functional.one_hot(rel, 2 * k + 1).float())
        if extra_feat.shape[0]:
            e = self.extra_msa_embedder.linear(extra_feat)
            for blk in self.extra_msa_stack.blocks:
                e, z = blk(e, z)
        for blk in self.evoformer.blocks:
            m, z = blk(m, z)
        single = self.evoformer.linear_single(m[0])
        s, rots, trans = self.structure_module(single, z)
        lit = torch.tensor(CB_LITERATURE, device=s.device)[aatype]
        pb = torch.einsum("lij,lj->li", rots, lit) + trans
        return {"msa_first_row": m[0], "pair": z, "single": single,
                "plddt": self.plddt_head(s), "pseudo_beta": pb}


@torch.no_grad()
def extract(model: AlphaFold, a3m_lines, name: str | None = None,
            on_recycle=None) -> dict:
    """The extraction of one alignment: every recycle, from zeros. Returns
    the last recycle's node_repr, edge_repr, single_repr (numpy), its
    pLDDT and mean pLDDT (``confidence``)."""
    cfg = model.cfg
    dev = model.evoformer.linear_single.weight.device
    parsed, tokens, deletions = parse_a3m(a3m_lines)
    name = parsed if name is None else name
    L = tokens.shape[1]
    aatype = torch.as_tensor(tokens[0], device=dev)
    prev = {"msa_first_row": torch.zeros(L, cfg.msa_dim, device=dev),
            "pair": torch.zeros(L, L, cfg.pair_dim, device=dev),
            "pseudo_beta": torch.zeros(L, 3, device=dev)}
    for r in range(cfg.num_recycle + 1):
        msa_feat, extra_feat = recycle_features(name, tokens, deletions, r,
                                                cfg, dev)
        prev = model.recycle(aatype, msa_feat, extra_feat, prev)
        if on_recycle is not None:
            on_recycle(r, prev)
    plddt = prev["plddt"].cpu().numpy()
    return {"node_repr": prev["msa_first_row"].cpu().numpy(),
            "edge_repr": prev["pair"].cpu().numpy(),
            "single_repr": prev["single"].cpu().numpy(),
            "plddt": plddt, "confidence": float(plddt.mean())}


def alphafold_model(state_dict, cfg: Config = Config(), device="cpu"
                    ) -> AlphaFold:
    """The reference with ``state_dict``'s weights (float32, strict)."""
    with torch.device("meta"):
        model = AlphaFold(cfg)
    model.load_state_dict({k: torch.as_tensor(v, device=device).float()
                           for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model.eval()

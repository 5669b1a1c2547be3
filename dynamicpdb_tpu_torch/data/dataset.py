"""Trajectory dataset: CSV manifest -> windowed raw training examples.

Port of ``dynamicpdb_tpu/data/dataset.py`` (numpy and the standard library
only; the manifest is read with ``csv``, not pandas):

  * ``TrajectoryDataset`` reads the manifest (columns: name, seqres,
    atlas_npz, embed_path, force_path, vel_path, pdb_path, seq_len), keeps
    the rows with ``seq_len <= data.filtering.max_len`` in file order, and
    draws one F-frame window at stride k per call (a random start over
    frames[:keep_first] when training, ``fix_sample_start`` otherwise),
    optionally zero-padded to ``pad_to`` residues;
  * ``EpochSampler`` / ``make_sampler`` lay out an epoch's indices in the
    four sample modes (time_batch, length_batch, cluster_time_batch,
    cluster_length_batch), ``read_clusters``/``assign_clusters`` parse the
    cluster file;
  * ``batch_iterator`` stacks ``[B, ...]`` numpy batches (under host
    striding, each host's rows of the one-host batches: see there);
  * ``eval_windows`` yields one deterministic window per protein;
  * ``StaticPdbDataset`` serves single structures (``.npz`` chains from
    ``preprocess/mmcif.process_mmcif_dir``, ``.cif``/``.cif.gz``, ``.pdb``)
    as windows of F identical frames.

The same seeds give the same windows and indices as the JAX package on one
host (on several, the JAX package draws each host's windows from a
generator of its own; here the hosts share one, see ``batch_iterator``). The
single-bundle npz of ``data/synthetic.make_trajectory_npz`` is accepted as
well as the reference layout (trajectory npz + force/vel pickles +
embedding npz).
"""
from __future__ import annotations

import csv
import logging
import os
import pickle
import zipfile
from dataclasses import dataclass

import numpy as np

from dynamicpdb_tpu_torch.config import DataConfig

log = logging.getLogger(__name__)


def _load_force_vel(path: str, suffix: str) -> np.ndarray:
    """Reference quirk preserved: force uses '_Ca.pkl', velocity '_ca.pkl'."""
    with open(path.replace(".pkl", suffix), "rb") as f:
        return pickle.load(f)


def pad_window(raw: dict, pad_to: int) -> dict:
    """Zero-pad the residue axis to pad_to (masks keep semantics)."""
    n = raw["aatype"].shape[0]
    if n == pad_to:
        return raw
    if n > pad_to:
        raise ValueError(
            f"window has {n} residues > pad_to={pad_to}; raise pad_to or "
            f"filter by seq_len (data.filtering.max_len)"
        )
    p = pad_to - n

    def pad(x, axes):
        widths = [(0, 0)] * x.ndim
        for ax in axes:
            widths[ax] = (0, p)
        return np.pad(x, widths)

    out = dict(raw)
    out["atom37"] = pad(raw["atom37"], [1])
    out["atom37_mask"] = pad(raw["atom37_mask"], [0])
    out["aatype"] = pad(raw["aatype"], [0])
    out["residue_index"] = pad(raw["residue_index"], [0])
    out["force"] = pad(raw["force"], [1])
    out["vel"] = pad(raw["vel"], [1])
    out["node_repr"] = pad(raw["node_repr"], [0])
    out["edge_repr"] = pad(raw["edge_repr"], [0, 1])
    return out


def npz_array_shape(path: str, key: str) -> tuple:
    """The shape of array ``key`` in the npz at ``path``, read from the
    array's header alone."""
    with zipfile.ZipFile(path) as zf, zf.open(f"{key}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)[0]


class TrajectoryDataset:
    """Index-addressable set of proteins; ``get_window`` draws one window."""

    def __init__(self, cfg: DataConfig, *, split: str = "train",
                 pad_to: int | None = None):
        self.cfg = cfg
        self.split = split
        self.pad_to = pad_to
        self._bundle_cache: dict[str, dict] = {}
        self._n_frames: dict[str, int] = {}
        csv_path = {
            "train": cfg.csv_path,
            "val": cfg.val_csv_path or cfg.csv_path,
            "test": cfg.test_csv_path or cfg.val_csv_path or cfg.csv_path,
        }[split]
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            self.columns = list(reader.fieldnames or [])
            rows = list(reader)
        if "seq_len" in self.columns:
            rows = [r for r in rows
                    if int(float(r["seq_len"])) <= cfg.filtering.max_len]
        self.rows = rows
        log.info("%s dataset: %d proteins from %s", split, len(rows), csv_path)

    def __len__(self):
        return len(self.rows)

    def column(self, name: str) -> list[str]:
        return [r[name] for r in self.rows]

    # -- window extraction ----------------------------------------------------
    def _select_window(self, n_frames: int, rng: np.random.Generator):
        F, k = self.cfg.frame_time, self.cfg.frame_sample_step
        if n_frames < F * k:
            raise ValueError(
                f"trajectory too short: {n_frames} frames for window "
                f"F={F} stride={k}"
            )
        if self.split == "train":
            limit = min(n_frames, self.cfg.keep_first or n_frames)
            hi = limit - F * k + 1
            if hi < 1:
                raise ValueError(
                    f"trajectory too short: keep_first="
                    f"{self.cfg.keep_first} frames for window F={F} "
                    f"stride={k}"
                )
            start = int(rng.integers(0, hi))
        else:
            start = self.cfg.fix_sample_start or 0
            if start + F * k > n_frames:
                start = max(0, n_frames - F * k)
        return slice(start, start + F * k, k)

    def _load_bundle(self, path: str):
        """A trajectory bundle, with the two most recently used kept
        decompressed (a time_batch batch draws the same protein B times)."""
        cache = self._bundle_cache
        if path not in cache:
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))
            with np.load(path, allow_pickle=True) as z:
                cache[path] = {k: z[k] for k in z.files}
        else:
            cache[path] = cache.pop(path)  # mark most recently used
        return cache[path]

    def n_frames(self, idx: int) -> int:
        """The frame count of row ``idx``'s trajectory, kept per bundle: from
        the bundle when it is loaded, else from the header of its
        ``all_atom_positions`` array, without decompressing any array."""
        path = self.rows[idx]["atlas_npz"]
        if path not in self._n_frames:
            if path in self._bundle_cache:
                shape = self._bundle_cache[path]["all_atom_positions"].shape
            else:
                shape = npz_array_shape(path, "all_atom_positions")
            self._n_frames[path] = int(shape[0])
        return self._n_frames[path]

    def select_window(self, idx: int, rng: np.random.Generator) -> slice:
        """The frames ``get_window(idx, rng)`` takes, drawn as it draws
        them; loads no bundle."""
        return self._select_window(self.n_frames(idx), rng)

    def get_window(self, idx: int, rng: np.random.Generator) -> dict:
        row = self.rows[idx]
        bundle = self._load_bundle(row["atlas_npz"])
        positions = bundle["all_atom_positions"]
        sel = self.select_window(idx, rng)

        if "force" in bundle:
            force, vel = bundle["force"], bundle["vel"]
        else:
            force = _load_force_vel(row["force_path"], "_Ca.pkl")
            vel = _load_force_vel(row["vel_path"], "_ca.pkl")

        if "node_repr" in bundle:
            node_repr, edge_repr = bundle["node_repr"], bundle["edge_repr"]
        else:
            embed = np.load(row["embed_path"])
            node_repr, edge_repr = embed["node_repr"], embed["edge_repr"]

        aatype = bundle["aatype"]
        if aatype.ndim == 2:  # one-hot (reference layout)
            aatype = np.argmax(aatype, axis=-1)

        mask = np.asarray(bundle["all_atom_mask"], np.float32)
        atom37 = np.asarray(positions[sel], np.float32) * mask[None, ..., None]

        raw = {
            "name": str(row.get("name", f"idx{idx}")),
            "atom37": atom37,
            "atom37_mask": mask,
            "aatype": np.asarray(aatype, np.int32),
            "residue_index": np.asarray(bundle["residue_index"], np.int32),
            "force": np.asarray(force[sel], np.float32),
            "vel": np.asarray(vel[sel], np.float32),
            "node_repr": np.asarray(node_repr, np.float32),
            "edge_repr": np.asarray(edge_repr, np.float32),
        }
        if self.pad_to:
            name = raw.pop("name")
            raw = pad_window(raw, self.pad_to)
            raw["name"] = name
        return raw


def read_clusters(path: str) -> dict[str, int]:
    """The reference's cluster file: line i defines cluster i; entries are
    space-separated chain ids like ``1abc_A``; the PDB id is the part
    before '_', uppercased."""
    pdb_to_cluster: dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            for chain in line.split(" "):
                pdb = chain.split("_")[0]
                if pdb.strip():
                    pdb_to_cluster[pdb.strip().upper()] = i
    return pdb_to_cluster


def assign_clusters(names, pdb_to_cluster: dict[str, int]) -> np.ndarray:
    """Cluster id per dataset row: names are uppercased and stripped of any
    '.'-suffix; a name absent from the cluster file becomes a new singleton
    cluster."""
    table = dict(pdb_to_cluster)
    max_cluster = max(table.values(), default=-1)
    out = []
    for name in names:
        key = str(name).upper().split(".")[0]
        if key not in table:
            max_cluster += 1
            table[key] = max_cluster
        out.append(table[key])
    return np.asarray(out, np.int64)


@dataclass
class EpochSampler:
    """Epoch-seeded deterministic index stream with host striding, in the
    reference's four sample modes:

    * time_batch (default): each batch = batch_size copies of ONE protein;
    * length_batch: batch_size proteins drawn with replacement from one
      seq-length group, groups in ascending length;
    * cluster_time_batch / cluster_length_batch: first ONE epoch-random
      representative per sequence cluster, then the time/length layout over
      the representatives.

    Length modes need ``lengths`` (per-row seq_len), cluster modes
    ``clusters`` (per-row cluster id); ``make_sampler`` wires both."""

    n_items: int
    batch_size: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    shuffle: bool = True
    sample_mode: str = "time_batch"
    lengths: np.ndarray | None = None
    clusters: np.ndarray | None = None

    def __post_init__(self):
        if self.num_hosts > 1 and self.batch_size % self.num_hosts:
            raise ValueError(
                f"batch_size={self.batch_size} must divide evenly over "
                f"num_hosts={self.num_hosts}"
            )
        modes = ("time_batch", "length_batch",
                 "cluster_time_batch", "cluster_length_batch")
        if self.sample_mode not in modes:
            raise ValueError(
                f"invalid sample_mode {self.sample_mode!r}; one of {modes}"
            )
        if "length" in self.sample_mode and self.lengths is None:
            raise ValueError(f"{self.sample_mode} needs per-row lengths")
        if self.sample_mode.startswith("cluster") and self.clusters is None:
            raise ValueError(f"{self.sample_mode} needs per-row clusters")

    @property
    def local_batch_size(self) -> int:
        """Rows each host consumes per batch."""
        return self.batch_size // self.num_hosts

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This host's rows of ``global_indices``: every num_hosts-th."""
        return self.global_indices(epoch)[self.host_index :: self.num_hosts]

    def global_indices(self, epoch: int) -> np.ndarray:
        """Every host's rows of the epoch in order, padded to a multiple of
        num_hosts; global batch i is rows [i B, (i + 1) B)."""
        rng = np.random.default_rng(self.seed + epoch)
        if self.sample_mode.startswith("cluster"):
            clusters = np.asarray(self.clusters)[: self.n_items]
            pool = np.asarray([
                int(rng.choice(np.flatnonzero(clusters == c)))
                for c in np.unique(clusters)
            ])
        else:
            pool = np.arange(self.n_items)

        if self.sample_mode.endswith("length_batch"):
            lengths = np.asarray(self.lengths)[pool]
            idx = np.concatenate([
                rng.choice(pool[lengths == length], size=self.batch_size,
                           replace=True)
                for length in np.unique(lengths)
            ])
        else:
            if self.shuffle and self.sample_mode == "time_batch":
                pool = rng.permutation(pool)
            idx = np.repeat(pool, self.batch_size)
        total = int(np.ceil(len(idx) / self.num_hosts)) * self.num_hosts
        if total > len(idx):
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx


def make_sampler(dataset: TrajectoryDataset, cfg: DataConfig, *,
                 batch_size: int, seed: int = 0, num_hosts: int = 1,
                 host_index: int = 0) -> EpochSampler:
    """The epoch sampler for cfg.sample_mode, with per-row lengths (the
    manifest's seq_len column) and cluster ids (cfg.cluster_path)."""
    lengths = clusters = None
    if "length" in cfg.sample_mode:
        if "seq_len" not in dataset.columns:
            raise ValueError(
                f"{cfg.sample_mode} needs a seq_len column in the manifest"
            )
        lengths = np.asarray([int(float(v)) for v in dataset.column("seq_len")])
    if cfg.sample_mode.startswith("cluster"):
        if not cfg.cluster_path:
            raise ValueError(f"{cfg.sample_mode} needs data.cluster_path")
        clusters = assign_clusters(dataset.column("name"),
                                   read_clusters(cfg.cluster_path))
    return EpochSampler(
        n_items=len(dataset), batch_size=batch_size, seed=seed,
        num_hosts=num_hosts, host_index=host_index,
        sample_mode=cfg.sample_mode, lengths=lengths, clusters=clusters,
    )


def batch_iterator(dataset: TrajectoryDataset, sampler: EpochSampler,
                   epoch: int, *, drop_names: bool = True):
    """Yield stacked [local B, ...] numpy batches for one epoch: host h of
    H takes rows h, h + H, ... of each global batch (``epoch_indices``).
    Every host walks every row with one window generator, seeded from
    (seed, epoch), drawing the frames of the rows it does not take
    (``select_window``, which reads a bundle's frame count, not its
    arrays), so the hosts' batches together are the one-host batches at the
    same global batch size, window for window, and a host loads only the
    bundles of its own rows."""
    idx = sampler.global_indices(epoch)
    rng = np.random.default_rng(np.random.SeedSequence([sampler.seed, epoch, 0]))
    B, H, h = sampler.batch_size, sampler.num_hosts, sampler.host_index
    for i in range(0, len(idx) - B + 1, B):
        windows = []
        for k, j in enumerate(idx[i : i + B]):
            if k % H == h:
                windows.append(dataset.get_window(int(j), rng))
            else:
                dataset.select_window(int(j), rng)
        if drop_names:
            for w in windows:
                w.pop("name", None)
        yield {k: np.stack([w[k] for w in windows]) for k in windows[0]}


def eval_windows(dataset: TrajectoryDataset):
    """One deterministic window per protein for evaluation (window i drawn
    with ``np.random.default_rng(i)``)."""
    for i in range(len(dataset)):
        yield dataset.get_window(i, np.random.default_rng(i))


class StaticPdbDataset:
    """Windows over single structures (no MD trajectory): each item holds
    ``frame_time`` copies of the structure, zero force and velocity, and
    zero embeddings or those of ``embed_paths`` (one npz per structure),
    zero-padded to ``pad_to`` residues when given. Inputs: ``.npz`` chains
    (atom37, atom37_mask, aatype, residue_index), ``.cif``/``.cif.gz``
    (the first chain) or ``.pdb`` (the first model)."""

    def __init__(self, pdb_paths: list, *, frame_time: int = 2,
                 pad_to: int | None = None, embed_paths: list | None = None):
        self.pdb_paths = list(pdb_paths)
        self.frame_time = frame_time
        self.pad_to = pad_to
        self.embed_paths = embed_paths

    def __len__(self):
        return len(self.pdb_paths)

    def get_window(self, idx: int, rng=None) -> dict:
        path = self.pdb_paths[idx]
        if path.endswith(".npz"):
            with np.load(path) as z:
                atom37 = np.asarray(z["atom37"], np.float32)
                mask = np.asarray(z["atom37_mask"], np.float32)
                aatype = np.asarray(z["aatype"], np.int32)
                residue_index = np.asarray(z["residue_index"], np.int32)
        elif path.endswith(".cif") or path.endswith(".cif.gz"):
            from dynamicpdb_tpu_torch.preprocess.mmcif import parse_mmcif

            ch = next(iter(parse_mmcif(path).chains.values()))
            atom37, mask = ch.atom37, ch.atom37_mask
            aatype, residue_index = ch.aatype, ch.residue_index
        else:
            from dynamicpdb_tpu_torch.analysis.pdb_io import read_pdb

            atom37, mask, aatype, residue_index = read_pdb(path)
        n = len(aatype)
        F = self.frame_time
        if self.embed_paths is not None:
            with np.load(self.embed_paths[idx]) as z:
                node_repr = np.asarray(z["node_repr"], np.float32)
                edge_repr = np.asarray(z["edge_repr"], np.float32)
        else:
            node_repr = np.zeros((n, 256), np.float32)
            edge_repr = np.zeros((n, n, 128), np.float32)
        raw = {
            "name": os.path.splitext(os.path.basename(path))[0],
            "atom37": np.repeat(atom37[None], F, axis=0),
            "atom37_mask": mask,
            "aatype": aatype,
            "residue_index": residue_index,
            "force": np.zeros((F, n, 3), np.float32),
            "vel": np.zeros((F, n, 3), np.float32),
            "node_repr": node_repr,
            "edge_repr": edge_repr,
        }
        if self.pad_to:
            name = raw.pop("name")
            raw = pad_window(raw, self.pad_to)
            raw["name"] = name
        return raw

"""GNN zoo of the port: GatedGCN, EGNN, MACE (reduced-order equivariant)
and GraphCast, all message passing on one edge-list substrate, plus the
per-destination edge softmax.

Counterpart of the reference's ``repro/models/gnn.py``, function for
function and with the same parameter names.  The substrate op is the
masked scatter-sum :func:`_agg` (``index_add`` here, ``segment_sum``
there); ``edge_softmax`` is the only caller of the ``segment_softmax``
CUDA kernel, and none of the four architectures calls it.

Batch format: one flat :class:`GraphBatch` — batched small graphs are
disjoint unions with ``graph_ids``; sampled subgraphs are padded flat
graphs with masks.

Parameters are an ``nn.Module`` tree read like the reference's dict
(``params["embed_n"]``, ``lp["phi_e"]["w0"]``).  The reference stacks
the layers' leaves on a leading axis and scans over them; here
``params["layers"]`` is an ``nn.ModuleList`` with one entry a layer and
the scan is a Python loop.  ``convert.gnn_params_from_numpy`` /
``gnn_params_to_numpy`` carry a tree across.

On a mesh (``launch.steps.build_cell(..., mesh=)``) the graph's node and
edge rows lie over every mesh dimension and the parameters are
replicated, as DTensors; :func:`train_loss` then runs each rank on its
own rows through :class:`RowShards`, which writes out the gathers and
scatter-sums that GSPMD makes of the reference's ``h[senders]`` and
``segment_sum`` under those specs.

MACE keeps the reference's Cartesian-irrep form (l=0 scalars, l=1
vectors, l=2 traceless symmetric tensors, exact E(3)-equivariant
couplings); see the reference module's docstring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops as kops


class GraphBatch(NamedTuple):
    node_feat: torch.Tensor  # (N, F)
    edge_feat: Optional[torch.Tensor]  # (E, Fe) or None
    senders: torch.Tensor  # (E,) int
    receivers: torch.Tensor  # (E,) int
    node_mask: torch.Tensor  # (N,) bool
    edge_mask: torch.Tensor  # (E,) bool
    positions: Optional[torch.Tensor]  # (N, 3) for EGNN / MACE
    graph_ids: torch.Tensor  # (N,) int — disjoint-union membership
    n_graphs: int


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # gatedgcn | egnn | mace | graphcast
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    d_edge_in: int = 0
    # mace
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    # graphcast
    n_mlp_layers: int = 1
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


class Params(nn.Module):
    """Named parameters and sub-groups, read like the reference's dict:
    ``p["w0"]``, ``p["layers"]``.  Tensors become ``nn.Parameter``s,
    modules (a sub-group, the ``nn.ModuleList`` of layers) submodules."""

    def __init__(self, **items):
        super().__init__()
        for key, value in items.items():
            if isinstance(value, nn.Module):
                self.add_module(key, value)
            else:
                self.register_parameter(key, nn.Parameter(value))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]


# ---------------------------------------------------------------------- #
# shared pieces
# ---------------------------------------------------------------------- #


class _Init:
    """The reference's initializers over one ``torch.Generator``: draws
    are made in float32 on the generator's device, in call order, then
    cast to the config's dtype and moved to ``device``.  Same
    distributions as the reference, not the same draws."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device) * scale
        return x.to(self.device, self.dtype)

    def lin(self, i: int, o: int) -> torch.Tensor:
        return self.normal((i, o), 1.0 / math.sqrt(i))

    def mlp(self, dims) -> Params:
        w = {f"w{i}": self.lin(dims[i], dims[i + 1])
             for i in range(len(dims) - 1)}
        b = {f"b{i}": torch.zeros(dims[i + 1], dtype=self.dtype,
                                  device=self.device)
             for i in range(len(dims) - 1)}
        return Params(**w, **b)


def _mlp(p, x, n, act=F.silu, final_act=False):
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _ln(x, eps=1e-6):
    """Population-variance normalisation, no affine (the reference's)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Gather indices as the reference's ``h[ids]`` reads them: negative
    ids count from the end, then every id is clamped into [0, n)."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _agg(messages: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
         edge_mask: torch.Tensor, rows=None) -> torch.Tensor:
    """Masked scatter-sum of edge messages to destination nodes — the one
    substrate op every model shares.  As ``segment_sum`` does, ids
    outside [0, n_nodes) are dropped: they land in a spare row.  With
    ``rows`` (a :class:`RowShards`) the messages are this rank's edges',
    ``n_nodes`` the global count, and the whole-size partial sum is
    reduce-scattered to this rank's rows."""
    mask = edge_mask.reshape((-1,) + (1,) * (messages.ndim - 1))
    m = torch.where(mask, messages, 0.0)
    r = receivers.long()
    r = torch.where((r >= 0) & (r < n_nodes), r, n_nodes)
    out = messages.new_zeros((n_nodes + 1,) + messages.shape[1:])
    out = out.index_add(0, r, m)[:n_nodes]
    return out if rows is None else rows.summed(out)


class RowShards:
    """Node and edge rows split over every dimension of a device mesh
    (the reference's ``gnn_batch_specs``: row ``i`` of N on the rank
    ``i // (N / ranks)`` in row-major mesh order), seen from one rank's
    local rows.  Each rank computes the messages of its own edges; the
    collectives run over the mesh's flattened group (one call each, where
    a redistribute over the mesh's dimensions makes one a dimension), as
    DTensor redistributes, so autograd carries them:

    * :meth:`whole` all-gathers node rows (before ``h[senders]``); its
      backward reduce-scatters the partial gradients each rank's edges
      made;
    * :meth:`summed` reduce-scatters a whole-size partial scatter-sum to
      this rank's rows; its backward all-gathers;
    * :meth:`total` all-reduces a partial sum (the loss's squared error
      and mask count);
    * :meth:`replicated` is a replicated parameter as it is, its gradient
      (a part on each rank) all-reduced.

    ``n`` is the global node count, which ``_ids`` and ``_agg`` index by."""

    def __init__(self, mesh, n_nodes: int):
        self.mesh = mesh._flatten() if mesh.ndim > 1 else mesh
        self.n = int(n_nodes)

    def _laid(self, t, placement):
        return DTensor.from_local(t, self.mesh, [placement], run_check=False)

    def whole(self, t):
        return self._laid(t, Shard(0)).redistribute(
            self.mesh, [Replicate()]).to_local(grad_placements=[Partial()])

    def summed(self, t):
        return self._laid(t, Partial()).redistribute(
            self.mesh, [Shard(0)]).to_local()

    def total(self, t):
        return self._laid(t, Partial()).redistribute(
            self.mesh, [Replicate()]).to_local()

    def replicated(self, t):
        return self._laid(t, Replicate()).to_local(grad_placements=[Partial()])

    @classmethod
    def of(cls, g: "GraphBatch") -> "RowShards":
        """The rows of ``g``, a batch of DTensors whose every row field
        lies over every mesh dimension (``launch.steps`` pads N and E to
        the mesh's size so that they do); raises otherwise."""
        mesh = g.node_feat.device_mesh
        for name, t in zip(g._fields, g):
            if t is None or name == "n_graphs":
                continue
            if not isinstance(t, DTensor) or t.device_mesh != mesh or any(
                    p != Shard(0) for p in t.placements):
                raise ValueError(f"GraphBatch.{name}: its rows must lie over "
                                 "every dimension of one mesh")
        return cls(mesh, g.node_feat.shape[0])

    def local_graph(self, g: "GraphBatch") -> "GraphBatch":
        return GraphBatch(*(t.to_local() if isinstance(t, DTensor) else t
                            for t in g))

    def local_params(self, params) -> "_LocalParams":
        return _LocalParams(params, self.replicated)


class _LocalParams:
    """A tree of DTensor parameters read as ``Params`` reads it, each
    leaf as ``take(its local tensor)`` (taken once, however often read)."""

    def __init__(self, module, take, memo=None):
        self.module, self.take = module, take
        self.memo = {} if memo is None else memo

    def __getitem__(self, key):
        v = self.module[key]
        if isinstance(v, nn.Module):
            return _LocalParams(v, self.take, self.memo)
        if id(v) not in self.memo:
            self.memo[id(v)] = self.take(v.to_local())
        return self.memo[id(v)]

    def __iter__(self):
        return (_LocalParams(m, self.take, self.memo) for m in self.module)


def _whole(h: torch.Tensor, rows) -> torch.Tensor:
    """Every node's rows: ``h`` as it is, or gathered from every rank."""
    return h if rows is None else rows.whole(h)


def _count(h: torch.Tensor, rows) -> int:
    """The global node count (``h``'s rows are this rank's on a mesh)."""
    return h.shape[0] if rows is None else rows.n


def edge_softmax(scores: torch.Tensor, receivers: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT-style): ``scores``
    (E, D) float32 or bfloat16, ``receivers`` (E,) int ids in
    ``[0, n_nodes)``; returns (E, D) in the scores' dtype.  On the card
    the normalize pass is the ``segment_softmax`` CUDA kernel."""
    return kops.segment_softmax(scores, receivers, n_nodes)


# ---------------------------------------------------------------------- #
# GatedGCN  [arXiv:2003.00982 benchmark config: 16L, d=70]
# ---------------------------------------------------------------------- #


def gatedgcn_init(cfg: GNNConfig, init: _Init) -> Params:
    d = cfg.d_hidden
    embed_n = init.lin(cfg.d_in, d)
    embed_e = init.lin(max(cfg.d_edge_in, 1), d)
    readout = init.lin(d, cfg.d_out)
    layers = nn.ModuleList(
        Params(**{k: init.lin(d, d) for k in "ABCUV"})
        for _ in range(cfg.n_layers))
    return Params(embed_n=embed_n, embed_e=embed_e, readout=readout,
                  layers=layers)


def gatedgcn_apply(cfg: GNNConfig, params, g: GraphBatch,
                   rows=None) -> torch.Tensor:
    h = g.node_feat.to(cfg.dtype) @ params["embed_n"]
    if g.edge_feat is not None:
        e = g.edge_feat.to(cfg.dtype) @ params["embed_e"]
    else:
        e = h.new_zeros((g.senders.shape[0], cfg.d_hidden))
    n = _count(h, rows)
    s, r = _ids(g.senders, n), _ids(g.receivers, n)
    for lp in params["layers"]:
        hw = _whole(h, rows)
        hs = hw[s]
        hr = hw[r]
        e_new = hr @ lp["A"] + hs @ lp["B"] + e @ lp["C"]
        e_new = e + F.silu(_ln(e_new))
        gate = torch.sigmoid(e_new)
        num = _agg(gate * (hs @ lp["V"]), g.receivers, n, g.edge_mask, rows)
        den = _agg(gate, g.receivers, n, g.edge_mask, rows)
        h_new = h @ lp["U"] + num / (den + 1e-6)
        h = h + F.silu(_ln(h_new))
        e = e_new
    return h @ params["readout"]


# ---------------------------------------------------------------------- #
# EGNN  [arXiv:2102.09844: 4L, d=64, E(n) equivariant]
# ---------------------------------------------------------------------- #


def egnn_init(cfg: GNNConfig, init: _Init) -> Params:
    d = cfg.d_hidden
    embed_n = init.lin(cfg.d_in, d)
    readout = init.lin(d, cfg.d_out)
    layers = nn.ModuleList(
        Params(phi_e=init.mlp([2 * d + 1, d, d]), phi_x=init.mlp([d, d, 1]),
               phi_h=init.mlp([2 * d, d, d]))
        for _ in range(cfg.n_layers))
    return Params(embed_n=embed_n, readout=readout, layers=layers)


def egnn_apply(cfg: GNNConfig, params, g: GraphBatch, rows=None):
    """Returns (node outputs (N, d_out), updated positions (N, 3))."""
    h = g.node_feat.to(cfg.dtype) @ params["embed_n"]
    x = g.positions.to(cfg.dtype)
    n = _count(h, rows)
    s, r = _ids(g.senders, n), _ids(g.receivers, n)
    for lp in params["layers"]:
        xw, hw = _whole(x, rows), _whole(h, rows)
        diff = xw[s] - xw[r]  # (E, 3)
        dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = _mlp(lp["phi_e"], torch.cat([hw[r], hw[s], dist2], -1), 2,
                 final_act=True)
        w = _mlp(lp["phi_x"], m, 2)  # (E, 1)
        # normalize by degree for stability (paper's C = 1/(n-1))
        x_agg = _agg(diff * w, g.receivers, n, g.edge_mask, rows)
        deg = _agg(torch.ones_like(w), g.receivers, n, g.edge_mask, rows)
        x = x + x_agg / (deg + 1.0)
        m_agg = _agg(m, g.receivers, n, g.edge_mask, rows)
        h = h + _mlp(lp["phi_h"], torch.cat([h, m_agg], -1), 2)
    return h @ params["readout"], x


# ---------------------------------------------------------------------- #
# MACE (reduced, Cartesian irreps)  [arXiv:2206.07697: 2L, d=128,
# l_max=2, correlation 3, n_rbf=8]
# ---------------------------------------------------------------------- #


def _bessel_basis(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    """(E, n) radial Bessel basis with smooth cutoff envelope."""
    r = torch.clamp(r, min=1e-4)
    k = torch.arange(1, n + 1, dtype=r.dtype, device=r.device) * math.pi / r_cut
    basis = math.sqrt(2.0 / r_cut) * torch.sin(k * r[:, None]) / r[:, None]
    x = torch.clamp(r / r_cut, 0, 1)
    env = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5  # C2-smooth polynomial cutoff
    return basis * env[:, None]


def _invariants(a0: torch.Tensor, a1: torch.Tensor,
                a2: torch.Tensor) -> torch.Tensor:
    """(N, 8, C) invariants of correlation orders 1-3 from the atomic
    basis A0 (N, C), A1 (N, C, 3), A2 (N, C, 3, 3), by exact Cartesian
    couplings.  The reference writes them as einsums; here they are
    broadcast products and sums, because an einsum over 3x3 blocks runs
    as batched GEMMs of N*C tiny matrices on the card."""
    # nu=1
    b1 = a0
    # nu=2: A0*A0, A1.A1, A2:A2
    b2a = a0 * a0
    b2b = (a1 * a1).sum(-1)
    b2c = (a2 * a2).sum((-2, -1))
    # nu=3: A0*A1.A1, A1.(A2@A1), A0*A2:A2, det-like tr(A2@A2@A2)
    a2a1 = (a2 * a1[:, :, None, :]).sum(-1)
    b3a = a0 * b2b
    b3b = (a1 * a2a1).sum(-1)
    b3c = a0 * b2c
    a2a2 = sum(a2[..., :, j, None] * a2[..., None, j, :] for j in range(3))
    b3d = (a2a2 * a2.transpose(-1, -2)).sum((-2, -1))
    return torch.stack([b1, b2a, b2b, b2c, b3a, b3b, b3c, b3d], 1)


def mace_init(cfg: GNNConfig, init: _Init) -> Params:
    c = cfg.d_hidden
    embed_n = init.lin(cfg.d_in, c)
    readout = init.mlp([c, c, cfg.d_out])
    # invariant scalar contributions per correlation order: nu=1 (A0),
    # nu=2 (3 couplings), nu=3 (4 couplings) => 8 scalar channel blocks
    layers = nn.ModuleList(
        Params(radial0=init.mlp([cfg.n_rbf, c]),
               radial1=init.mlp([cfg.n_rbf, c]),
               radial2=init.mlp([cfg.n_rbf, c]),
               wsrc=init.lin(c, c),
               path_w=init.normal((8, c), 0.3),
               update=init.mlp([8 * c, c, c]))
        for _ in range(cfg.n_layers))
    return Params(embed_n=embed_n, readout=readout, layers=layers)


def mace_apply(cfg: GNNConfig, params, g: GraphBatch,
               rows=None) -> torch.Tensor:
    """Higher-order equivariant message passing; returns (N, d_out)."""
    h = g.node_feat.to(cfg.dtype) @ params["embed_n"]  # (N, C)
    x = _whole(g.positions.to(cfg.dtype), rows)
    n_rows, c = h.shape  # this rank's rows on a mesh
    n = _count(h, rows)
    s, r = _ids(g.senders, n), _ids(g.receivers, n)
    eye3 = torch.eye(3, dtype=h.dtype, device=h.device)

    diff = x[s] - x[r]  # (E, 3)
    dist = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    rhat = diff / dist[:, None]
    rbf = _bessel_basis(dist, cfg.n_rbf, cfg.r_cut)  # (E, n_rbf)
    # Cartesian "spherical harmonics": Y1 = rhat, Y2 = rhat rhat^T - I/3
    y1 = rhat  # (E, 3)
    y2 = rhat[:, :, None] * rhat[:, None, :] - eye3 / 3.0  # (E, 3, 3)

    for lp in params["layers"]:
        hs = _whole(h @ lp["wsrc"], rows)[s]  # (E, C)
        r0 = _mlp(lp["radial0"], rbf, 1)  # (E, C)
        r1 = _mlp(lp["radial1"], rbf, 1)
        r2 = _mlp(lp["radial2"], rbf, 1)
        # atomic basis A (density trick): sum over neighbors
        a0 = _agg(r0 * hs, g.receivers, n, g.edge_mask, rows)  # (N, C)
        a1 = _agg((r1 * hs)[:, :, None] * y1[:, None, :], g.receivers, n,
                  g.edge_mask, rows)  # (N, C, 3)
        a2 = _agg((r2 * hs)[:, :, None, None] * y2[:, None, :, :],
                  g.receivers, n, g.edge_mask, rows)  # (N, C, 3, 3)

        feats = _invariants(a0, a1, a2)
        feats = feats * lp["path_w"][None]  # learnable path weights
        h = h + _mlp(lp["update"], feats.reshape(n_rows, 8 * c), 2)
    return _mlp(params["readout"], h, 2)


# ---------------------------------------------------------------------- #
# GraphCast-style encode-process-decode  [arXiv:2212.12794: 16L, d=512]
# ---------------------------------------------------------------------- #


def graphcast_init(cfg: GNNConfig, init: _Init) -> Params:
    d = cfg.d_hidden
    enc_n = init.mlp([cfg.d_in, d, d])
    enc_e = init.mlp([max(cfg.d_edge_in, 1), d, d])
    dec = init.mlp([d, d, cfg.d_out])
    layers = nn.ModuleList(
        Params(edge_mlp=init.mlp([3 * d, d, d]),
               node_mlp=init.mlp([2 * d, d, d]))
        for _ in range(cfg.n_layers))
    return Params(enc_n=enc_n, enc_e=enc_e, dec=dec, layers=layers)


def graphcast_apply(cfg: GNNConfig, params, g: GraphBatch,
                    rows=None) -> torch.Tensor:
    h = _mlp(params["enc_n"], g.node_feat.to(cfg.dtype), 2)
    if g.edge_feat is not None:
        e = _mlp(params["enc_e"], g.edge_feat.to(cfg.dtype), 2)
    else:
        e = h.new_zeros((g.senders.shape[0], cfg.d_hidden))
    n = _count(h, rows)
    s, r = _ids(g.senders, n), _ids(g.receivers, n)
    for lp in params["layers"]:
        hw = _whole(h, rows)
        e_in = torch.cat([e, hw[s], hw[r]], -1)
        e = e + _mlp(lp["edge_mlp"], e_in, 2)
        agg = _agg(e, g.receivers, n, g.edge_mask, rows)
        h = h + _mlp(lp["node_mlp"], torch.cat([h, agg], -1), 2)
    return _mlp(params["dec"], h, 2)


# ---------------------------------------------------------------------- #
# dispatch
# ---------------------------------------------------------------------- #

INIT = {"gatedgcn": gatedgcn_init, "egnn": egnn_init, "mace": mace_init,
        "graphcast": graphcast_init}


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device=None) -> Params:
    """Fresh parameters of ``cfg`` on the CUDA card unless ``device``
    names another, drawn from ``generator`` as the reference draws from
    its key: normal / sqrt(fan_in) weights, zero biases, MACE's path
    weights 0.3 * normal.  A CPU generator gives the same values on every
    device."""
    from ..core.index import resolve_device

    init = _Init(generator, resolve_device(device), cfg.dtype)
    return INIT[cfg.arch](cfg, init)


def apply(cfg: GNNConfig, params, g: GraphBatch, rows=None) -> torch.Tensor:
    """Node outputs (N, d_out); with ``rows`` (a :class:`RowShards`) the
    local graph's and local parameters' (``RowShards.local_graph`` /
    ``local_params``), this rank's rows."""
    if cfg.arch == "gatedgcn":
        return gatedgcn_apply(cfg, params, g, rows)
    if cfg.arch == "egnn":
        return egnn_apply(cfg, params, g, rows)[0]
    if cfg.arch == "mace":
        return mace_apply(cfg, params, g, rows)
    if cfg.arch == "graphcast":
        return graphcast_apply(cfg, params, g, rows)
    raise ValueError(cfg.arch)


def train_loss(cfg: GNNConfig, params, g: GraphBatch,
               targets: torch.Tensor):
    """Masked squared error over the real nodes: ``(loss float32,
    {"mse": loss})``, divided by ``max(sum(node_mask), 1)``.  On a mesh
    (``g``'s and ``targets``' rows DTensors over every dimension, the
    parameters replicated DTensors) each rank computes its own rows and
    the error's sum and the mask's count are all-reduced first: the loss
    is the whole graph's on every rank, a plain tensor, and each
    parameter's gradient the whole one, replicated."""
    rows = None
    if isinstance(g.node_feat, DTensor):
        rows = RowShards.of(g)
        params, g = rows.local_params(params), rows.local_graph(g)
        targets = targets.to_local()
    out = apply(cfg, params, g, rows)
    err = torch.where(g.node_mask[:, None], out - targets, 0.0)
    sq, count = torch.sum(err * err), g.node_mask.sum()
    if rows is not None:
        sq, count = rows.total(sq), rows.total(count)
    loss = sq / torch.clamp(count, min=1)
    return loss.to(torch.float32), {"mse": loss.detach()}

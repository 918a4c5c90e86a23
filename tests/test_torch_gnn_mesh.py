"""The GNN and engine cells of the port on a mesh, held against the
port's own unsharded steps, the in-process engine mesh and the reference.

* Each architecture's smoke config takes two ``gnn_step``s on an 8-rank
  (2, 2, 2) gloo mesh of CPU processes, its graph's node and edge rows
  over every axis (``launch.steps.gnn_laid_out``) and its parameters
  replicated: one seeded graph whose N and E are not multiples of 8,
  padded to them with masked rows, with masked edges and ids out of
  range.  Losses, grad norms, moments and updated leaves equal the
  unsharded port step's on the same padded graph within ``RTOL`` (and
  ``2 lr`` a step where AdamW's first step is ill conditioned, |g| <
  ``DETERMINED``: ``tests/test_torch_lm_train.py``), each rank's rows of
  the output equal the unsharded output's, and every rank's parameters
  are the same.  The reference's ``gnn_cell`` program, jitted under its
  own shardings on the (2, 2, 2) test mesh in a subprocess with 8 forced
  host devices from the same parameters (``convert``), gives the same
  losses within ``REF_TOL``.  EGNN again with every collective staged
  through host memory (``launch.mesh.HostStagedCollectives``): the same
  step, its staged bytes by kind those of the cell reckoned over a fake
  (2, 2, 2) group.
* ``distributed.MeshExchange`` (one shard a rank over the mesh's
  flattened group): each of its calls equals ``InProcessExchange``'s,
  also host-staged; ``build_64m``'s and ``query_s``'s cells built by
  ``build_cell(..., mesh=)`` at shrunk dimensions equal the in-process
  8-shard mesh bit for bit and a numpy join and ``isin`` filter, and an
  undersized bucket flags and retries in lockstep with it.
* A GNN and an engine smoke cell reckoned on a fake (2, 2, 2) group
  report 8 devices and collective bytes by kind equal to a count by hand
  from the shapes.

One spawn of 8 ranks runs every rank case; the ranks import no JAX (this
module imports it only inside tests)."""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import relational as R  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import (build_cell, engine_build_step,  # noqa: E402
                                      engine_query_step, gnn_laid_out,
                                      gnn_step)
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ((2, 2, 2), ("pod", "data", "model"))
WORLD = math.prod(MESH[0])
ARCHS = ("gatedgcn", "egnn", "mace", "graphcast")
N, E = 27, 70  # the graph's nodes and edges, not multiples of 8
PAD_N, PAD_E = 32, 72  # ... padded to the mesh's size, the padding masked
RTOL = 1e-5  # sharded vs unsharded port, max |diff| over max |value|
REF_TOL = 1e-4  # the port's sharded losses vs the reference's
DETERMINED = 1e-5
LR = 1e-3  # gnn_cell's
STEPS = 2
RANK_TIMEOUT_S = 240
# the engine cells, shrunk (tests/test_torch_engine_cells.py's dims)
N_PAIRS, N_IDS, N_SEQS = 2048, 2048, 16
N_CLASSES, LOOKUP = 256, 64
LANES = 3  # lanes a rank in the exchange cases
RETRIES, SKEW_OUT = 6, 8192  # the overflow retry: bucket doublings, out rows


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------- #
# inputs, made alike in every rank and in the test process
# ---------------------------------------------------------------------- #


def _graph(cfg, seed=0) -> dict:
    """One seeded graph of N nodes and E edges padded to PAD_N / PAD_E:
    some nodes and edges masked, a few ids out of range (negative, and
    past the padded N), the padding masked with ids 0; and targets."""
    rng = np.random.default_rng(seed)
    send = rng.integers(0, N, PAD_E).astype(np.int32)
    recv = rng.integers(0, N, PAD_E).astype(np.int32)
    send[:3], recv[3:6] = (-1, PAD_N + 2, -PAD_N - 5), (-2, PAD_N, 99)
    send[E:], recv[E:] = 0, 0
    node_mask = np.zeros(PAD_N, bool)
    node_mask[:N] = rng.random(N) < 0.85
    edge_mask = np.zeros(PAD_E, bool)
    edge_mask[:E] = rng.random(E) < 0.9
    feat = np.zeros((PAD_N, cfg.d_in), np.float32)
    feat[:N] = rng.normal(0, 1, (N, cfg.d_in))
    pos = np.zeros((PAD_N, 3), np.float32)
    pos[:N] = rng.normal(0, 1, (N, 3))
    efeat = None
    if cfg.d_edge_in:
        efeat = np.zeros((PAD_E, cfg.d_edge_in), np.float32)
        efeat[:E] = rng.normal(0, 1, (E, cfg.d_edge_in))
    targets = np.zeros((PAD_N, cfg.d_out), np.float32)
    targets[:N] = rng.normal(0, 1, (N, cfg.d_out))
    return dict(node_feat=feat, edge_feat=efeat, senders=send,
                receivers=recv, node_mask=node_mask, edge_mask=edge_mask,
                positions=pos, graph_ids=np.zeros(PAD_N, np.int32),
                n_graphs=1, targets=targets)


def _batch(arrays):
    fields = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in arrays.items() if k != "targets"}
    return G.GraphBatch(**fields), torch.from_numpy(arrays["targets"])


def _trees() -> dict:
    """Each architecture's seeded smoke parameters, as the reference's
    tree of host arrays."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = tconfigs.get_arch(arch).smoke
        out[arch] = convert.gnn_params_to_numpy(
            cfg, G.init_params(cfg, torch.Generator().manual_seed(i), "cpu"))
    return out


def _relation(rng, n):
    rows = np.stack([rng.integers(0, N_IDS, n), rng.integers(0, N_IDS, n),
                     rng.integers(0, N_SEQS, n)], 1).astype(np.int32)
    return np.unique(rows, axis=0)


def _engine_data():
    """Both sides of build_64m's join (a by v, b by m: what the cell's
    repartition does with them is the join's business), the lookups and
    I_c2p of query_s, and a skewed pair for the overflow retry, each laid
    out in WORLD shards of per * 2 rows."""
    rng = np.random.default_rng(5)
    per = N_PAIRS // WORLD
    a, b = _relation(rng, N_PAIRS), _relation(rng, N_PAIRS)
    ablk, an = D.shard_relation(a, WORLD, per * 2, key_col=0, grow=False)
    bblk, bn = D.shard_relation(b, WORLD, per * 2, key_col=1, grow=False)
    c2p = np.unique(np.stack([rng.integers(0, N_CLASSES, N_PAIRS),
                              rng.integers(0, N_IDS, N_PAIRS),
                              rng.integers(0, N_IDS, N_PAIRS)], 1)
                    .astype(np.int32), axis=0)
    cblk, cn = D.shard_relation(c2p, WORLD, per * 2, key_col=1, grow=False)
    looks = [np.sort(rng.choice(N_CLASSES, LOOKUP, replace=False))
             .astype(np.int32) for _ in range(2)]
    # skewed: one hot join key, so an 8-row bucket overflows
    sa = np.unique(np.stack([rng.integers(0, 64, 300), np.full(300, 7),
                             rng.integers(0, 4, 300)], 1).astype(np.int32),
                   axis=0)
    sb = np.unique(np.stack([np.full(40, 7), rng.integers(0, 64, 40),
                             rng.integers(0, 4, 40)], 1).astype(np.int32),
                   axis=0)
    sab, san = D.shard_relation(sa, WORLD, 512, key_col=0)
    sbb, sbn = D.shard_relation(sb, WORLD, 512, key_col=1)
    return {"a": a, "b": b, "build": (ablk, an, bblk, bn), "c2p": (cblk, cn),
            "looks": looks, "skewed": (sa, sb, sab, san, sbb, sbn)}


def _cols(blk, s=None):
    pick = slice(None) if s is None else slice(s, s + 1)
    return [torch.from_numpy(np.ascontiguousarray(blk[pick, :, j]))
            for j in range(blk.shape[2])]


def _engine_shape(name, **dims):
    spec = tconfigs.get_arch("cpqx-engine")
    return spec, dataclasses.replace(spec.shape(name),
                                     dims={**spec.shape(name).dims, **dims})


def _exchange_inputs():
    rng = np.random.default_rng(11)
    lanes = WORLD * LANES
    return {
        "a2a_i32": rng.integers(-2**31, 2**31 - 1,
                                (lanes, WORLD, 5)).astype(np.int32),
        "a2a_f32": rng.normal(0, 1, (lanes, WORLD, 3)).astype(np.float32),
        "gather_i8": rng.integers(-127, 128, (lanes, 2, 4)).astype(np.int8),
        "flags": rng.random(lanes) < 0.3,
    }


# ---------------------------------------------------------------------- #
# what each rank runs (no JAX)
# ---------------------------------------------------------------------- #


def _gnn_steps(arch, tree, arrays, mesh=None, outputs=True) -> dict:
    """``STEPS`` ``gnn_step``s of ``arch``'s smoke config on the padded
    graph from ``tree``: unsharded, or laid out on ``mesh``.  Returns the
    losses, grad norms, and after each step the parameters and both
    moments (a replicated leaf is whole on every rank), and with
    ``outputs`` the outputs (this rank's rows on a mesh) after the last."""
    cfg = tconfigs.get_arch(arch).smoke
    params = convert.gnn_params_from_numpy(cfg, tree, device="cpu")
    g, targets = _batch(arrays)
    if mesh is not None:
        g, targets = gnn_laid_out(g, targets, mesh)
        params = S.distribute_tree(params, S.gnn_param_specs(params, mesh),
                                   mesh)
    opt = adamw_init(dict(params.named_parameters()))
    step = gnn_step(cfg, lr=LR, device="cpu")

    def whole(t):
        return (t.to_local() if hasattr(t, "to_local") else t) \
            .detach().numpy().copy()

    rec = {"loss": [], "grad_norm": [], "params": [], "mu": [], "nu": []}
    for _ in range(STEPS):
        params, opt, m = step(params, opt, g, targets)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["params"].append({k: whole(v)
                              for k, v in params.named_parameters()})
        rec["mu"].append({k: whole(v) for k, v in opt.mu.items()})
        rec["nu"].append({k: whole(v) for k, v in opt.nu.items()})
    if not outputs:
        return rec
    with torch.no_grad():
        if mesh is None:
            rec["out"] = G.apply(cfg, params, g).numpy()
        else:
            rows = G.RowShards.of(g)
            rec["out"] = G.apply(cfg, rows.local_params(params),
                                 rows.local_graph(g), rows).numpy()
            rec["placements"] = all(
                all(p.is_replicate() for p in t.placements)
                for t in params.parameters())
    return rec


def _exchange_cases(ex, rank) -> dict:
    x = _exchange_inputs()
    mine = slice(rank * LANES, (rank + 1) * LANES)
    return {
        "axis_index": ex.axis_index(LANES, "cpu").numpy(),
        "a2a_i32": ex.all_to_all(torch.from_numpy(x["a2a_i32"][mine])).numpy(),
        "a2a_f32": ex.all_to_all(torch.from_numpy(x["a2a_f32"][mine])).numpy(),
        "gather_i8": ex.all_gather(
            torch.from_numpy(x["gather_i8"][mine])).numpy(),
        "any": ex.any_shard(torch.from_numpy(x["flags"][mine])).numpy(),
    }


def _engine_cases(rank, devmesh) -> dict:
    data = _engine_data()
    out = {}
    spec, build = _engine_shape("build_64m", n_pairs=N_PAIRS)
    ablk, an, bblk, bn = data["build"]
    cell = build_cell(spec, build, "cpu", mesh=devmesh, n_pairs=N_PAIRS)
    cols, counts, ovf = cell.fn(
        *_cols(ablk, rank), torch.from_numpy(an[rank:rank + 1]),
        *_cols(bblk, rank), torch.from_numpy(bn[rank:rank + 1]))
    out["build"] = ([c.numpy() for c in cols], counts.numpy(), ovf.numpy())
    out["build_args"] = [tuple(a.shape) for a in cell.args]
    spec, query = _engine_shape("query_s", n_pairs=N_PAIRS,
                                lookup_classes=LOOKUP)
    cblk, cn = data["c2p"]
    cell = build_cell(spec, query, "cpu", mesh=devmesh, n_pairs=N_PAIRS,
                      lookup_classes=LOOKUP)
    (pv, pu), pn = cell.fn(*map(torch.from_numpy, data["looks"]),
                           *_cols(cblk, rank),
                           torch.from_numpy(cn[rank:rank + 1]))
    out["query"] = (pv.numpy(), pu.numpy(), pn.numpy())
    # an undersized bucket: flagged, the flag reduced, retried in lockstep
    mesh = D.mesh_of_device_mesh(devmesh, "cpu")
    _, _, sab, san, sbb, sbn = data["skewed"]
    bucket, attempts = 8, []
    for _ in range(RETRIES):
        join = D.make_distributed_join(mesh, mesh.axis, WORLD, 3, 3,
                                       bucket_cap=bucket, out_cap=SKEW_OUT)
        cols, counts, ovf = join(_cols(sab, rank),
                                 torch.from_numpy(san[rank:rank + 1]),
                                 _cols(sbb, rank),
                                 torch.from_numpy(sbn[rank:rank + 1]))
        attempts.append(bool(ovf[0]))
        if not mesh.exchange.any_shard(ovf)[0]:
            break
        bucket *= 2
    out["skewed"] = (attempts, [c.numpy() for c in cols], counts.numpy())
    return out


def _rank(rank, world, trees, graphs):
    torch.set_num_threads(1)
    devmesh = M.make_test_mesh(*MESH, device="cpu")
    out = {"gnn": {arch: _gnn_steps(arch, trees[arch], graphs[arch], devmesh)
                   for arch in ARCHS}}
    with M.HostStagedCollectives("cpu") as staged:
        again = _gnn_steps("egnn", trees["egnn"], graphs["egnn"], devmesh,
                           outputs=False)
    out["staged"] = {"loss": again["loss"], "params": again["params"][-1],
                     "calls": staged.calls, "bytes": staged.bytes}
    ex = D.MeshExchange(devmesh)
    out["exchange"] = _exchange_cases(ex, rank)
    out["n_shards"], out["rank"] = ex.n_shards, ex.rank
    with M.HostStagedCollectives("cpu") as staged:
        out["exchange_staged"] = _exchange_cases(ex, rank)
    out["exchange_staged_calls"] = staged.calls
    out["engine"] = _engine_cases(rank, devmesh)
    if rank:  # the parameters' identity is all that is read of the others
        out["gnn"] = {a: {"loss": r["loss"], "params": r["params"],
                          "out": r["out"], "placements": r["placements"]}
                      for a, r in out["gnn"].items()}
    return out


# ---------------------------------------------------------------------- #
# the reference's gnn_cell program, in a subprocess
# ---------------------------------------------------------------------- #

_REFERENCE = """
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import ShapeSpec, get_arch
from repro.launch.steps import gnn_cell
from repro.models import gnn as G
from repro.train.optim import adamw_init

with open(sys.argv[1], "rb") as f:
    data = pickle.load(f)
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for arch, (tree, arrays) in data["archs"].items():
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    shape = ShapeSpec("toy", "full_graph", {"n_nodes": data["n"],
                      "n_edges": data["e"], "d_feat": spec.smoke.d_in})
    cell = gnn_cell(spec, shape, mesh)
    params = jax.tree.map(jnp.asarray, tree)
    opt = adamw_init(params)
    targets = jnp.asarray(arrays.pop("targets"))
    g = G.GraphBatch(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                        for k, v in arrays.items()})
    with compat.set_mesh(mesh):
        params, opt, g, targets = jax.device_put((params, opt, g, targets),
                                                 cell.in_shardings)
        step = jax.jit(cell.fn)
        losses = []
        for _ in range(2):
            params, opt, m = step(params, opt, g, targets)
            losses.append(float(m["loss"]))
    out[arch] = losses
print("LOSSES", json.dumps(out))
"""


def _start_reference(tmp, trees, graphs):
    path = os.path.join(tmp, "gnn_reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"n": N, "e": E, "archs": {
            a: (trees[a], dict(graphs[a])) for a in ARCHS}}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's results of one 8-rank spawn, and the reference's
    losses, run beside it."""
    trees = _trees()
    graphs = {a: _graph(tconfigs.get_arch(a).smoke) for a in ARCHS}
    reference = _start_reference(str(tmp_path_factory.mktemp("gnn_ref")),
                                 trees, graphs)
    try:
        ranks = run_ranks(_rank, WORLD, (trees, graphs),
                          timeout=RANK_TIMEOUT_S, init_timeout=120)
        out, err = reference.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        reference.kill()
    assert reference.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][-1]
    return {"ranks": ranks, "trees": trees, "graphs": graphs,
            "reference": json.loads(line.split(None, 1)[1])}


def _assert_steps_close(mine, ref):
    """Losses and grad norms to ``RTOL``; after each step both moments
    to ``RTOL`` and every leaf within ``2 lr`` a step; after the first,
    every leaf to ``RTOL`` of its largest value where |g| >=
    ``DETERMINED`` (``tests/test_torch_mesh_cells.py``'s rule)."""
    assert rel(mine["loss"], ref["loss"]) <= RTOL, (mine["loss"], ref["loss"])
    assert rel(mine["grad_norm"], ref["grad_norm"]) <= RTOL
    for i, (p, q, mu, mu_ref, nu, nu_ref) in enumerate(zip(
            mine["params"], ref["params"], mine["mu"], ref["mu"],
            mine["nu"], ref["nu"])):
        assert p.keys() == q.keys() == mu.keys() == nu.keys()
        for k in q:
            x, y = p[k].astype(np.float64), q[k].astype(np.float64)
            assert rel(mu[k], mu_ref[k]) <= RTOL, (i, k)
            assert rel(nu[k], nu_ref[k]) <= RTOL, (i, k)
            diff = np.abs(x - y)
            assert diff.max() <= 2 * LR * (i + 1), (i, k)
            if i == 0:
                sure = np.abs(mu_ref[k]) / 0.1 >= DETERMINED
                assert diff[sure].max(initial=0) <= RTOL * np.abs(y).max(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gnn_step_holds_to_the_unsharded_port(run, arch):
    ranks = run["ranks"]
    want = _gnn_steps(arch, run["trees"][arch], run["graphs"][arch])
    _assert_steps_close(ranks[0]["gnn"][arch], want)
    rows = PAD_N // WORLD
    for r, res in enumerate(ranks):
        mine = res["gnn"][arch]
        assert mine["placements"] and mine["loss"] == ranks[0]["gnn"][arch][
            "loss"]
        for step in range(STEPS):  # every rank's replica the same
            for k, v in ranks[0]["gnn"][arch]["params"][step].items():
                assert np.array_equal(mine["params"][step][k], v), (r, k)
        assert mine["out"].shape == (rows,) + want["out"].shape[1:]
        diff = np.abs(mine["out"] - want["out"][r * rows:(r + 1) * rows])
        assert diff.max() <= RTOL * np.abs(want["out"]).max(), r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gnn_losses_equal_the_references_program(run, arch):
    mine = run["ranks"][0]["gnn"][arch]["loss"]
    theirs = run["reference"][arch]
    assert rel(mine, theirs) <= REF_TOL, (mine, theirs)


def test_host_staged_gnn_step_stages_what_the_reckoning_counts(run):
    """EGNN's two steps through ``HostStagedCollectives("cpu")``: the same
    losses and parameters; a step's staged bytes by kind are the cell's
    reckoned over a fake (2, 2, 2) group on the meta device (the same
    padded graph, the same config)."""
    r0 = run["ranks"][0]
    staged = r0["staged"]
    assert staged["loss"] == r0["gnn"]["egnn"]["loss"]
    for k, v in r0["gnn"]["egnn"]["params"][-1].items():
        assert np.array_equal(staged["params"][k], v), k
    rec = _reckoned("egnn", {"n_nodes": PAD_N, "n_edges": PAD_E})
    assert {k: v // STEPS for k, v in staged["bytes"].items()} == \
        rec["collectives"]["bytes_by_kind"]
    assert {k: v // STEPS for k, v in staged["calls"].items()} == \
        rec["collectives"]["counts_by_kind"]


@pytest.mark.parametrize("staged", [False, True], ids=["gloo", "host_staged"])
def test_mesh_exchange_equals_the_in_process_exchange(run, staged):
    x = _exchange_inputs()
    inproc = D.InProcessExchange(WORLD)
    want = {
        "a2a_i32": inproc.all_to_all(torch.from_numpy(x["a2a_i32"])).numpy(),
        "a2a_f32": inproc.all_to_all(torch.from_numpy(x["a2a_f32"])).numpy(),
        "gather_i8": inproc.all_gather(
            torch.from_numpy(x["gather_i8"])).numpy(),
    }
    flags = inproc.any_shard(torch.from_numpy(x["flags"])).numpy()
    for rank, res in enumerate(run["ranks"]):
        got = res["exchange_staged" if staged else "exchange"]
        assert res["n_shards"] == WORLD and res["rank"] == rank
        assert (got["axis_index"] == rank).all()
        lanes = slice(rank * LANES, (rank + 1) * LANES)
        for k, w in want.items():
            assert got[k].dtype == w.dtype
            assert np.array_equal(got[k].view(np.uint8),
                                  w[lanes].view(np.uint8)), k
        assert got["any"].dtype == np.bool_
        assert np.array_equal(got["any"], flags)
    if staged:  # every call went through the host-staged route
        assert run["ranks"][0]["exchange_staged_calls"] == {
            "all-to-all": 2, "all-gather": 1, "all-reduce": 1}


def _rows(cols, counts, s=0) -> set:
    return {tuple(int(c[s, i]) for c in cols) for i in range(int(counts[s]))}


def _join_numpy(a, b) -> set:
    """(v, u, x, y) of a (v, m, x) ⋈ b (m, u, y)."""
    b = b[np.argsort(b[:, 0], kind="stable")]
    lo = np.searchsorted(b[:, 0], a[:, 1], "left")
    hi = np.searchsorted(b[:, 0], a[:, 1], "right")
    return {(int(a[i, 0]), int(b[j, 1]), int(a[i, 2]), int(b[j, 2]))
            for i in range(len(a)) for j in range(lo[i], hi[i])}


def test_engine_build_cell_on_the_mesh_equals_the_in_process_mesh(run):
    data = _engine_data()
    ablk, an, bblk, bn = data["build"]
    _, shape = _engine_shape("build_64m", n_pairs=N_PAIRS)
    wc, wn, wo = engine_build_step(None, shape, D.make_mesh(WORLD, device="cpu"))(
        *_cols(ablk), torch.from_numpy(an), *_cols(bblk), torch.from_numpy(bn))
    per = N_PAIRS // WORLD
    rows = set()
    for s, res in enumerate(run["ranks"]):
        gc, gn, go = res["engine"]["build"]
        assert res["engine"]["build_args"] == [(1, per)] * 3 + [(1,)] + \
            [(1, per)] * 3 + [(1,)]
        for g, w in zip(gc, wc):
            assert g.shape == (1, 4 * per)
            assert np.array_equal(g, w[s:s + 1].numpy())
        assert np.array_equal(gn, wn[s:s + 1].numpy())
        assert np.array_equal(go, wo[s:s + 1].numpy()) and not go.any()
        rows |= _rows(gc, gn)
    assert rows == _join_numpy(data["a"], data["b"])


def test_engine_query_cell_on_the_mesh_equals_the_in_process_mesh(run):
    data = _engine_data()
    cblk, cn = data["c2p"]
    _, shape = _engine_shape("query_s", n_pairs=N_PAIRS, lookup_classes=LOOKUP)
    (wv, wu), wn = engine_query_step(None, shape, D.make_mesh(
        WORLD, device="cpu"))(*map(torch.from_numpy, data["looks"]),
                              *_cols(cblk), torch.from_numpy(cn))
    both = np.intersect1d(*data["looks"])
    for s, res in enumerate(run["ranks"]):
        pv, pu, pn = res["engine"]["query"]
        for g, w in ((pv, wv), (pu, wu), (pn, wn)):
            assert np.array_equal(g, w[s:s + 1].numpy())
        mine = cblk[s, :cn[s]]
        keep = mine[np.isin(mine[:, 0], both)]
        assert int(pn[0]) == len(keep)
        assert np.array_equal(pv[0, :len(keep)], keep[:, 1])
        assert (pv[0, len(keep):] == R.SENTINEL).all()


def test_engine_bucket_overflow_retries_in_lockstep_with_the_in_process_mesh(
        run):
    sa, sb, sab, san, sbb, sbn = _engine_data()["skewed"]
    mesh, bucket, want = D.make_mesh(WORLD, device="cpu"), 8, []
    for _ in range(RETRIES):
        join = D.make_distributed_join(mesh, "engine", WORLD, 3, 3,
                                       bucket_cap=bucket, out_cap=SKEW_OUT)
        wc, wn, wo = join(_cols(sab), torch.from_numpy(san), _cols(sbb),
                          torch.from_numpy(sbn))
        want.append(wo.numpy())
        if not wo.any():
            break
        bucket *= 2
    assert len(want) > 1 and not want[-1].any(), want
    rows = set()
    for s, res in enumerate(run["ranks"]):
        attempts, gc, gn = res["engine"]["skewed"]
        assert attempts == [bool(w[s]) for w in want]
        for g, w in zip(gc, wc):
            assert np.array_equal(g, w[s:s + 1].numpy())
        rows |= _rows(gc, gn)
    assert rows == _join_numpy(sa, sb)


def _reckoned(arch, shape, **reduce) -> dict:
    """``arch``'s cell at ``shape`` (a shape's name, or the dims of a
    "toy" full graph for a GNN's smoke config), reckoned on the meta
    device over a fake (2, 2, 2) group."""
    from repro_torch.roofline.collect import analyze_step

    spec = tconfigs.get_arch(arch)
    if spec.family == "gnn":
        spec = dataclasses.replace(spec, config=spec.smoke)
        shape = tconfigs.ShapeSpec("toy", "full_graph",
                                   {**shape, "d_feat": spec.smoke.d_in})
    else:
        shape = spec.shape(shape)
    with M.reckoning_mesh(*MESH) as mesh:
        return analyze_step(build_cell(spec, shape, "meta", mesh=mesh,
                                       **reduce))


def test_a_gnn_cell_reckoned_on_a_fake_mesh_counts_its_collectives_by_hand():
    """GatedGCN's smoke cell at N = 27, E = 70 (padded to 32, 72 over 8
    devices).  A layer gathers h (N x d) once and reduce-scatters its two
    sums to a device's rows; the backward reduce-scatters h's gradient and
    all-gathers the two sums' (every layer's h feeds the output).  Every
    parameter's gradient is all-reduced, and so are the loss's squared
    error (float32) and mask count (int64)."""
    cfg = tconfigs.get_arch("gatedgcn").smoke
    rec = _reckoned("gatedgcn", {"n_nodes": N, "n_edges": E})
    d, layers, f32 = cfg.d_hidden, cfg.n_layers, 4
    whole, mine = PAD_N * d * f32, PAD_N // WORLD * d * f32
    params = G.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n_params = sum(p.numel() for p in params.parameters())
    coll = rec["collectives"]
    assert coll["bytes_by_kind"] == {
        "all-gather": 3 * layers * whole,
        "reduce-scatter": 3 * layers * mine,
        "all-reduce": n_params * f32 + 4 + 8}
    assert coll["counts_by_kind"] == {
        "all-gather": 3 * layers, "reduce-scatter": 3 * layers,
        "all-reduce": len(list(params.parameters())) + 2}
    assert rec["n_devices"] == WORLD
    assert rec["mesh_shape"] == dict(zip(MESH[1], MESH[0]))
    assert coll["bytes_by_axis"] == {"pod+data+model": coll["total_bytes"]}


def test_an_engine_cell_reckoned_on_a_fake_mesh_counts_its_all_to_alls():
    """build_64m at 2 048 pairs over 8 devices: each side's repartition
    sends three int32 columns of (8, bucket) and the (8,) bucket sizes,
    bucket = max(per // 8 * 4, 1024); query_s moves nothing."""
    per = N_PAIRS // WORLD
    bucket = max(per // WORLD * 4, 1024)
    rec = _reckoned("cpqx-engine", "build_64m", n_pairs=N_PAIRS)
    assert rec["n_devices"] == WORLD
    assert rec["collectives"]["bytes_by_kind"] == {
        "all-to-all": 2 * (3 * WORLD * bucket * 4 + WORLD * 4)}
    assert rec["collectives"]["counts_by_kind"] == {"all-to-all": 8}
    q = _reckoned("cpqx-engine", "query_s", n_pairs=N_PAIRS)
    assert q["collectives"]["total_bytes"] == 0 and q["n_devices"] == WORLD

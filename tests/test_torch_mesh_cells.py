"""The LM and BST cells of the port on a mesh (``launch.shardings``'
layouts as DTensors, ``launch.steps``' steps on them), held against the
port's own unsharded steps and the reference.

* gemma2-2b's smoke config on an 8-rank (2, 2, 2) gloo mesh of CPU
  processes takes two ``lm_train_step``s (and, on a (1, 1, 8) mesh at a
  q_chunk of 4, two more through context-parallel chunked attention): every parameter's placements
  are its spec's, the losses, grad norms and the updated leaves (gathered
  whole) equal the unsharded port step's within ``RTOL`` (and ``2 lr`` a
  step where AdamW's first step is ill conditioned, |g| < ``DETERMINED``:
  ``tests/test_torch_lm_train.py``), and on the reference's own program
  (``tests/test_distributed.py::test_sharded_lm_step_runs``: zero tokens,
  lr 1e-3, two steps) the losses equal the reference's, run in a
  subprocess with 8 forced host devices, within ``REF_TOL``.
* BST's smoke train step at 4 ranks ((2, 2) "data" x "model"), held the
  same way, and again with every collective staged through host memory
  (``launch.mesh.HostStagedCollectives``, the route a card's tensors
  take over gloo), its collectives counted.
* A smoke LM and BST cell reckoned at (2, 2, 2) over a fake process group
  (``launch.mesh.reckoning_mesh``, one process): ``n_devices`` 8, the
  collectives counted, and the per-device parameter and optimizer bytes
  equal a count by hand from the specs' local shapes.

The ranks import no JAX: this module imports it only inside tests."""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import recsys_stream as trs  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import (bst_batch_specs,  # noqa: E402
                                      bst_train_step, lm_train_step)
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_MESH = ((2, 2, 2), ("pod", "data", "model"))
BST_MESH = ((2, 2), ("data", "model"))
RTOL = 1e-5  # sharded vs unsharded port, max |diff| over max |value|
REF_TOL = 1e-4  # the port's sharded losses vs the reference's
DETERMINED = 1e-5
LR = 1e-3  # the reference program's
STEPS = 2
RANK_TIMEOUT_S = 240


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------- #
# what each rank runs (no JAX)
# ---------------------------------------------------------------------- #


def _whole(tree) -> dict:
    """{name: numpy} of a flat tree of DTensors, gathered (a collective:
    every rank calls it)."""
    return {k: v.full_tensor().detach().numpy().copy()
            for k, v in tree.items()}


def _placements_hold(params, specs, mesh) -> bool:
    return all(list(p.placements) == S.placements(S.spec_of(n, specs), mesh)
               for n, p in params.named_parameters())


def _lm_steps(tree, batches, mesh=None, arch="gemma2-2b", **changes):
    """Two ``lm_train_step``s of ``arch``'s smoke config on each batch
    (tokens, labels) from ``tree``: unsharded, or laid out on ``mesh``.
    Returns, per batch, the losses, grad norms and, after each step, the
    parameters and both moments (whole)."""
    cfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, **changes)
    out = []
    for toks, labels in batches:
        params = convert.lm_params_from_numpy(cfg, tree, device="cpu")
        step_cfg, held = cfg, True
        if mesh is not None:
            step_cfg, specs = S.lm_layout(cfg, mesh)
            params = S.distribute_tree(params, specs, mesh)
            held = _placements_hold(params, specs, mesh)
        opt = adamw_init(dict(params.named_parameters()))
        t, lab = torch.from_numpy(toks), torch.from_numpy(labels)
        if mesh is not None:
            t = S.distribute(t, S.lm_batch_spec(mesh), mesh)
            lab = S.distribute(lab, S.lm_batch_spec(mesh), mesh)
        step = lm_train_step(step_cfg, 1, lr=LR, device="cpu")
        rec = {"loss": [], "grad_norm": [], "params": [], "mu": [],
               "nu": [], "placements": held}
        for _ in range(STEPS):
            params, opt, m = step(params, opt, t, lab)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            named = dict(params.named_parameters())
            if mesh is None:
                rec["params"].append({k: v.detach().numpy().copy()
                                      for k, v in named.items()})
                rec["mu"].append({k: v.numpy().copy()
                                  for k, v in opt.mu.items()})
                rec["nu"].append({k: v.numpy().copy()
                                  for k, v in opt.nu.items()})
            else:
                rec["params"].append(_whole(named))
                rec["mu"].append(_whole(opt.mu))
                rec["nu"].append(_whole(opt.nu))
        out.append(rec)
    return out


# context parallelism (4 heads on an 8-way "model" axis), chunked: the
# K/V time split over "model", the softmax taken in parts
CP_MESH, CP_CHANGES = (1, 1, 8), {"q_chunk": 4}


def _lm_rank(rank, world, tree, batches, arch="gemma2-2b"):
    torch.set_num_threads(1)
    out = _lm_steps(tree, batches, M.make_test_mesh(*LM_MESH, device="cpu"),
                    arch)
    out += _lm_steps(tree, batches[:1],
                     M.make_test_mesh(CP_MESH, LM_MESH[1], device="cpu"),
                     arch, **CP_CHANGES)
    return out if rank == 0 else [
        {k: v for k, v in r.items() if k in ("loss", "placements")}
        for r in out]


def _bst_steps(tree, batches, mesh=None):
    """Two ``bst_train_step``s of BST's smoke config on each batch from
    ``tree``: unsharded, or laid out on ``mesh``."""
    cfg = tconfigs.get_arch("bst").smoke
    params = convert.bst_params_from_numpy(cfg, tree, device="cpu")
    held = True
    if mesh is not None:
        specs = S.bst_param_specs(cfg, mesh)
        params = S.distribute_tree(params, specs, mesh)
        held = _placements_hold(params, specs, mesh)
    opt = adamw_init(dict(params.named_parameters()))
    step = bst_train_step(cfg, lr=LR, device="cpu")
    rec = {"loss": [], "grad_norm": [], "params": [], "mu": [], "nu": [],
           "placements": held}
    for arrays in batches:
        batch = TR.BSTBatch(*map(torch.from_numpy, arrays))
        if mesh is not None:
            batch = S.distribute_tree(batch, bst_batch_specs(mesh), mesh)
        params, opt, m = step(params, opt, batch)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        named = dict(params.named_parameters())
        if mesh is None:
            rec["params"].append({k: v.detach().numpy().copy()
                                  for k, v in named.items()})
            rec["mu"].append({k: v.numpy().copy() for k, v in opt.mu.items()})
            rec["nu"].append({k: v.numpy().copy() for k, v in opt.nu.items()})
        else:
            rec["params"].append(_whole(named))
            rec["mu"].append(_whole(opt.mu))
            rec["nu"].append(_whole(opt.nu))
    return rec


def _bst_rank(rank, world, tree, batches):
    torch.set_num_threads(1)
    mesh = M.make_test_mesh(*BST_MESH, device="cpu")
    out = _bst_steps(tree, batches, mesh)
    # again with every collective staged through host memory, as on a card
    with M.HostStagedCollectives("cpu") as staged:
        again = _bst_steps(tree, batches, mesh)
    out["staged"] = {"loss": again["loss"], "params": again["params"],
                     "calls": staged.calls, "bytes": staged.bytes,
                     "staged_bytes": staged.staged_bytes}
    return out if rank == 0 else {k: out[k] for k in ("loss", "placements")}


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #


def _assert_steps_close(mine, ref):
    """Losses and grad norms to ``RTOL``; after each step both moments
    to ``RTOL`` and every leaf within ``2 lr`` a step; after the first,
    every leaf to ``RTOL`` of its largest value where |g| >=
    ``DETERMINED`` (the rule of ``tests/test_torch_lm_train.py``: AdamW's
    first step has slope lr / eps at g = 0; a later step's conditioning
    also depends on how its gradient cancels the earlier ones, so there
    the moments, which are sums of the gradients, carry the check)."""
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


_REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_arch
from repro.launch import shardings as S
from repro.models import transformer as T
from repro.train.optim import adamw_init, adamw_update

mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = get_arch("gemma2-2b").smoke
params = T.init_params(cfg, jax.random.PRNGKey(0))
pspecs = S.lm_param_specs(cfg, mesh)
shard = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                     is_leaf=lambda x: isinstance(x, P))
params = jax.device_put(params, shard)
opt = adamw_init(params)
toks = jnp.zeros((8, 16), jnp.int32)

def step(p, o, t):
    def lf(p):
        return T.train_loss(cfg, p, t, t)
    (loss, _), g = jax.value_and_grad(lf, has_aux=True)(p)
    np_, no, _ = adamw_update(g, o, p, 1e-3)
    return np_, no, loss

with compat.set_mesh(mesh):
    jstep = jax.jit(step)
    p2, o2, loss = jstep(params, opt, toks)
    p3, o3, loss2 = jstep(p2, o2, toks)
print("LOSSES", float(loss), float(loss2))
"""


def _start_reference():
    """The reference's sharded LM program in a subprocess with 8 forced
    host devices (started now, read by :func:`_reference_losses`)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _reference_losses(proc) -> list:
    out, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][-1]
    return [float(x) for x in line.split()[1:]]


def _lm_inputs():
    """The reference's initial gemma2-2b smoke parameters (its
    ``PRNGKey(0)`` draw, as numpy) and two batches: a token stream's,
    with masked labels, and the reference program's zeros."""
    import jax

    from repro import configs as jconfigs
    from repro.models import transformer as JT

    jcfg = jconfigs.get_arch("gemma2-2b").smoke
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    toks, labels = TokenStream(jcfg.vocab_size, 8, 16, 4).batch_at(2)
    labels = labels.copy()
    labels[0, :3] = -1  # masked positions
    zeros = np.zeros((8, 16), np.int32)
    return tree, [(toks, labels), (zeros, zeros)]


def test_sharded_lm_step_holds_to_the_port_and_the_reference():
    reference = _start_reference()
    try:
        tree, batches = _lm_inputs()
        ranks = run_ranks(_lm_rank, math.prod(LM_MESH[0]), (tree, batches),
                          timeout=RANK_TIMEOUT_S, init_timeout=120)
        theirs = _reference_losses(reference)
    finally:
        reference.kill()
    stream, zeros = _lm_steps(tree, batches)
    (cp,) = _lm_steps(tree, batches[:1], **CP_CHANGES)
    for b in range(len(batches) + 1):
        assert all(r[b]["placements"] for r in ranks)
        assert all(r[b]["loss"] == ranks[0][b]["loss"] for r in ranks)
    _assert_steps_close(ranks[0][0], stream)
    _assert_steps_close(ranks[0][2], cp)
    # on zero tokens the attention gradients are rounding noise (~1e-13):
    # the reference's program is held by its losses
    assert rel(ranks[0][1]["loss"], zeros["loss"]) <= RTOL
    assert rel(ranks[0][1]["loss"], theirs) <= REF_TOL, (
        ranks[0][1]["loss"], theirs)


def test_sharded_bst_step_holds_to_the_port():
    cfg = tconfigs.get_arch("bst").smoke
    tree = convert.bst_params_to_numpy(
        cfg, TR.init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    batches = [trs.batch_at(cfg, 64, k, seed=2) for k in range(STEPS)]
    ranks = run_ranks(_bst_rank, math.prod(BST_MESH[0]), (tree, batches),
                      timeout=RANK_TIMEOUT_S, init_timeout=120)
    assert all(r["placements"] for r in ranks)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    _assert_steps_close(ranks[0], _bst_steps(tree, batches))
    # the host-staged route: the same steps, its collectives counted
    staged = ranks[0]["staged"]
    assert rel(staged["loss"], ranks[0]["loss"]) <= RTOL
    for mine, theirs in zip(staged["params"], ranks[0]["params"]):
        for k in theirs:
            assert rel(mine[k], theirs[k]) <= RTOL, k
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(
        staged["calls"])
    assert staged["staged_bytes"] > sum(staged["bytes"].values()) > 0


def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        split = math.prod(sizes[a] for a in axes)
        assert dim % split == 0
        n *= dim // split
    return n * itemsize


@pytest.mark.parametrize("arch,shape", [("granite-moe-3b-a800m", "train_4k"),
                                        ("bst", "train_batch")])
def test_a_cell_reckoned_on_a_fake_mesh_counts_one_device(arch, shape):
    """A smoke cell reckoned at (2, 2, 2) over the fake group: the
    argument bytes are one device's (parameters, two float32 moments,
    the step counter, the batch's shard), counted by hand from the specs'
    local shapes; the collectives are counted."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.collect import analyze_step

    spec = tconfigs.get_arch(arch)
    smoke = dataclasses.replace(spec, config=spec.smoke)
    red = ({"global_batch": 8, "seq_len": 32} if spec.family == "lm"
           else {"batch": 64})
    sizes = dict(zip(LM_MESH[1], LM_MESH[0]))
    with M.reckoning_mesh(*LM_MESH) as mesh:
        cell = build_cell(smoke, spec.shape(shape), "meta", mesh=mesh, **red)
        rec = analyze_step(cell)
        params = cell.args[0]
        if spec.family == "lm":
            _, specs = S.lm_layout(spec.smoke, mesh)
            batch = 2 * _local_bytes((8, 32), S.lm_batch_spec(mesh), sizes, 4)
        else:
            specs = S.bst_param_specs(spec.smoke, mesh)
            bs = bst_batch_specs(mesh)
            f = spec.smoke.n_context_fields
            batch = sum(_local_bytes(s, sp, sizes, 4) for s, sp in zip(
                [(64, spec.smoke.seq_len)] * 2 + [(64 * f,)] * 2 + [(64,)],
                bs))
    want = sum(
        _local_bytes(p.shape, S.spec_of(n, specs), sizes, p.element_size())
        + 2 * _local_bytes(p.shape, S.spec_of(n, specs), sizes, 4)
        for n, p in params.named_parameters())
    assert rec["argument_size_in_bytes"] == want + 4 + batch
    assert rec["n_devices"] == 8
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and sum(coll["counts_by_kind"].values()) > 0
    assert set(coll["bytes_by_axis"]) <= {"pod", "data", "model"}
    assert rec["per_device_hbm_bytes"] >= rec["argument_size_in_bytes"]

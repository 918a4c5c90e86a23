"""The port's GNN substrate (``repro_torch.models.gnn``, its configs, the
parameter conversion, ``launch.steps.gnn_step`` and
``launch.gnn_features``) held against the JAX package on the CPU.

The same parameters cross over by ``convert.gnn_params_from_numpy``; the
same inputs are drawn with numpy from a seed.  Outputs, losses and
gradients agree within ``RTOL`` relative (``ATOL`` absolute for values
near zero) in float32: the two packages sum in other orders."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.data.graphs import gmark_citation as j_gmark  # noqa: E402
from repro.launch.steps import gnn_cell  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.train.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.data.graphs import gmark_citation as t_gmark  # noqa: E402
from repro_torch.launch import gnn_features  # noqa: E402
from repro_torch.launch.steps import gnn_step  # noqa: E402
from repro_torch.models import gnn as TG  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mace", "egnn", "gatedgcn", "graphcast"]
CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)


def _toy(d_in, d_e, n=20, e=60, seed=0):
    """numpy arrays of one toy graph (``tests/test_models.py``'s)."""
    rng = np.random.default_rng(seed)
    return dict(
        node_feat=rng.normal(0, 1, (n, d_in)).astype(np.float32),
        edge_feat=(rng.normal(0, 1, (e, max(d_e, 1))).astype(np.float32)
                   if d_e else None),
        senders=rng.integers(0, n, e).astype(np.int32),
        receivers=rng.integers(0, n, e).astype(np.int32),
        node_mask=np.ones(n, bool), edge_mask=np.ones(e, bool),
        positions=rng.normal(0, 1, (n, 3)).astype(np.float32),
        graph_ids=np.zeros(n, np.int32), n_graphs=1)


def _jax_graph(arrs):
    return JG.GraphBatch(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v) for k, v in arrs.items()})


def _port_graph(arrs):
    return TG.GraphBatch(**{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                                else v) for k, v in arrs.items()})


def _extend(arrs, n_extra, receiver, mask, seed=1):
    """``arrs`` with ``n_extra`` more edges into ``receiver`` carrying
    garbage features, their mask set to ``mask``."""
    rng = np.random.default_rng(seed)
    out = dict(arrs)
    out["senders"] = np.concatenate(
        [arrs["senders"], rng.integers(0, len(arrs["node_mask"]), n_extra)
         .astype(np.int32)])
    out["receivers"] = np.concatenate(
        [arrs["receivers"], np.full(n_extra, receiver, np.int32)])
    if arrs["edge_feat"] is not None:
        out["edge_feat"] = np.concatenate(
            [arrs["edge_feat"],
             99 * np.ones((n_extra, arrs["edge_feat"].shape[1]), np.float32)])
    out["edge_mask"] = np.concatenate([arrs["edge_mask"],
                                       np.full(n_extra, mask)])
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _port_grads(cfg, params, g, targets):
    named = dict(params.named_parameters())
    loss, aux = TG.train_loss(cfg, params, g, targets)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux, convert.gnn_params_to_numpy(cfg, dict(zip(named, grads)))


@pytest.fixture(scope="module")
def reference():
    """Per arch (smoke config): the JAX parameters as host arrays, the
    toy graph, targets, and the JAX output, loss and gradients."""
    out = {}
    for arch in ARCHS:
        cfg = jconfigs.get_arch(arch).smoke
        arrs = _toy(cfg.d_in, cfg.d_edge_in)
        targets = np.random.default_rng(7).normal(
            0, 1, (20, cfg.d_out)).astype(np.float32)
        params = JG.init_params(cfg, KEY)
        g = _jax_graph(arrs)
        lf = lambda p: JG.train_loss(cfg, p, g, jnp.asarray(targets))  # noqa: E731
        (loss, aux), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
        out[arch] = dict(cfg=cfg, arrs=arrs, targets=targets,
                         params=_np_tree(params), loss=float(loss),
                         mse=float(aux["mse"]),
                         out=np.asarray(jax.jit(lambda p: JG.apply(cfg, p, g))(params)),
                         grads=_np_tree(grads))
    return out


def _port(ref, arch):
    r = ref[arch]
    cfg = tconfigs.get_arch(arch).smoke
    return cfg, convert.gnn_params_from_numpy(cfg, r["params"], device=CPU), r


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_loss_and_grads_equal_the_reference(reference, arch):
    cfg, params, r = _port(reference, arch)
    g = _port_graph(r["arrs"])
    out = TG.apply(cfg, params, g)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), r["out"], rtol=RTOL,
                               atol=ATOL)
    loss, aux, grads = _port_grads(cfg, params, g, torch.from_numpy(r["targets"]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), r["loss"], rtol=RTOL)
    np.testing.assert_allclose(float(aux["mse"]), r["mse"], rtol=RTOL)
    _assert_trees_close(grads, r["grads"])


def test_egnn_positions_equal_the_reference(reference):
    cfg, params, r = _port(reference, "egnn")
    jcfg = jconfigs.get_arch("egnn").smoke
    jh, jx = JG.egnn_apply(jcfg, jax.tree.map(jnp.asarray, r["params"]),
                           _jax_graph(r["arrs"]))
    h, x = TG.egnn_apply(cfg, params, _port_graph(r["arrs"]))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(), (5,), (5, 3), (5, 3, 3)])
def test_agg_drops_masked_and_out_of_range_ids_as_segment_sum(shape):
    """Masked edges (even inf ones) and ids < 0 or >= N add nothing, as
    the reference's masked ``segment_sum``."""
    rng = np.random.default_rng(3)
    e, n = 40, 7
    msgs = rng.normal(0, 1, (e,) + shape).astype(np.float32)
    ids = rng.integers(-3, n + 4, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    msgs[~mask] = np.inf
    got = TG._agg(torch.from_numpy(msgs), torch.from_numpy(ids), n,
                  torch.from_numpy(mask)).numpy()
    want = np.asarray(JG._agg(jnp.asarray(msgs), jnp.asarray(ids), n,
                              jnp.asarray(mask)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_and_out_of_range_edges_do_not_contribute(reference, arch):
    """Masked garbage edges and unmasked edges into ids >= N change
    nothing, in the port as in the reference."""
    cfg, params, r = _port(reference, arch)
    jcfg = jconfigs.get_arch(arch).smoke
    jparams = jax.tree.map(jnp.asarray, r["params"])
    clean = TG.apply(cfg, params, _port_graph(r["arrs"])).detach().numpy()
    for extra in (_extend(r["arrs"], 8, 1, False),
                  _extend(r["arrs"], 8, 20, True),
                  _extend(r["arrs"], 8, 25, True)):
        got = TG.apply(cfg, params, _port_graph(extra)).detach().numpy()
        want = np.asarray(JG.apply(jcfg, jparams, _jax_graph(extra)))
        np.testing.assert_allclose(got, clean, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train(arch):
    """``TestGNNSmoke.test_forward_and_train`` on the port."""
    cfg = tconfigs.get_arch(arch).smoke
    g = _port_graph(_toy(cfg.d_in, cfg.d_edge_in))
    params = TG.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    out = TG.apply(cfg, params, g)
    assert out.shape == (20, cfg.d_out)
    assert torch.isfinite(out).all()
    _, _, grads = _port_grads(cfg, params, g, torch.zeros(20, cfg.d_out))
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(leaf).all()


def _rotation(th):
    return torch.tensor([[np.cos(th), -np.sin(th), 0],
                         [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                        dtype=torch.float32)


@pytest.mark.parametrize("arch", ["egnn", "mace"])
def test_e3_invariance(reference, arch):
    """``TestGNNSmoke.test_e3_invariance`` on the port, with the
    parameters that test draws (carried over)."""
    cfg, params, r = _port(reference, arch)
    g = _port_graph(r["arrs"])
    q = _rotation(0.7)
    with torch.no_grad():
        out1 = TG.apply(cfg, params, g)
        out2 = TG.apply(cfg, params,
                        g._replace(positions=g.positions @ q.T + 3.0))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-4)


def test_egnn_coordinate_equivariance(reference):
    """``TestGNNSmoke.test_egnn_coordinate_equivariance`` on the port,
    with the parameters that test draws (carried over)."""
    cfg, params, r = _port(reference, "egnn")
    g = _port_graph(r["arrs"])
    q = _rotation(1.1)
    with torch.no_grad():
        _, x1 = TG.egnn_apply(cfg, params, g)
        _, x2 = TG.egnn_apply(cfg, params,
                              g._replace(positions=g.positions @ q.T + 3.0))
    np.testing.assert_allclose((x1 @ q.T + 3.0).numpy(), x2.numpy(), atol=1e-4)


def test_mace_invariants_equal_the_einsum_forms():
    """The port's broadcast products and sums are the reference's einsums
    (checked in float64, where only the summation order differs)."""
    gen = torch.Generator().manual_seed(5)
    a0, a1, a2 = (torch.randn((11, 6) + (3,) * k, generator=gen,
                              dtype=torch.float64) for k in range(3))
    want = torch.stack([
        a0, a0 * a0, torch.einsum("nci,nci->nc", a1, a1),
        torch.einsum("ncij,ncij->nc", a2, a2),
        a0 * torch.einsum("nci,nci->nc", a1, a1),
        torch.einsum("nci,nci->nc", a1, torch.einsum("ncij,ncj->nci", a2, a1)),
        a0 * torch.einsum("ncij,ncij->nc", a2, a2),
        torch.einsum("ncij,ncjk,ncki->nc", a2, a2, a2)], 1)
    torch.testing.assert_close(TG._invariants(a0, a1, a2), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """At the published config: the port's parameters, mapped to the
    reference's layout, have its names, shapes and dtypes."""
    cfg = tconfigs.get_arch(arch).config
    want = jax.eval_shape(
        lambda k: JG.init_params(jconfigs.get_arch(arch).config, k), KEY)
    got = convert.gnn_params_to_numpy(
        cfg, TG.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    assert [(x.shape, x.dtype) for x in gl] == [(x.shape, x.dtype) for x in wl]


def test_init_params_draws_the_reference_distributions():
    """normal / sqrt(fan_in) weights, zero biases, 0.3 * normal path
    weights; a seeded CPU generator gives the same values twice."""
    cfg = tconfigs.get_arch("mace").config
    p = TG.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    q = TG.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    for (_, a), (_, b) in zip(p.named_parameters(), q.named_parameters()):
        assert torch.equal(a, b)
    lp = p["layers"][1]
    w = lp["update"]["w0"].detach()  # (8 * 128, 128)
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.02
    assert abs(float(lp["path_w"].detach().std()) / 0.3 - 1) < 0.1
    assert not lp["update"]["b0"].any() and not p["readout"]["b1"].any()
    assert abs(float(p["embed_n"].detach().mean())) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_bit_exact(reference, arch):
    cfg, params, r = _port(reference, arch)
    back = convert.gnn_params_to_numpy(cfg, params)
    bl, bdef = jax.tree.flatten(back)
    wl, wdef = jax.tree.flatten(r["params"])
    assert bdef == wdef
    for b, w in zip(bl, wl):
        assert b.dtype == w.dtype and np.array_equal(b, w)
    assert isinstance(params["layers"], torch.nn.ModuleList)
    assert len(params["layers"]) == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_step_equals_the_gnn_cell_step(reference, arch):
    """Two steps of ``gnn_step`` against the step that ``gnn_cell``
    lowers (its ``fn``, called on concrete arrays of a one-device mesh):
    parameters, moments, loss, ``grad_norm`` and ``clip_scale``."""
    from repro import compat

    r = reference[arch]
    jspec = dataclasses.replace(jconfigs.get_arch(arch),
                                config=jconfigs.get_arch(arch).smoke)
    shape = jconfigs.ShapeSpec("toy", "full_graph", {
        "n_nodes": 20, "n_edges": 60, "d_feat": r["cfg"].d_in})
    cell = gnn_cell(jspec, shape, compat.make_mesh((1,), ("data",)))
    jparams = jax.tree.map(jnp.asarray, r["params"])
    jopt = j_adamw_init(jparams)
    g = _jax_graph(r["arrs"])
    jstep = jax.jit(cell.fn)

    cfg, params, _ = _port(reference, arch)
    step = gnn_step(cfg, device=CPU)
    opt = adamw_init(dict(params.named_parameters()))
    tg = _port_graph(r["arrs"])
    targets = torch.from_numpy(r["targets"])
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt, g, jnp.asarray(r["targets"]))
        params, opt, m = step(params, opt, tg, targets)
        for key in ("loss", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, err_msg=key)
    _assert_trees_close(convert.gnn_params_to_numpy(cfg, params),
                        _np_tree(jparams))
    assert int(opt.step) == int(jopt.step) == 2
    for mine, theirs in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        _assert_trees_close(convert.gnn_params_to_numpy(cfg, mine),
                            _np_tree(theirs), atol=1e-6)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "gnn_with_cpq_features", ROOT / "examples" / "gnn_with_cpq_features.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cpq_class_features_equal_the_reference_bit_for_bit():
    example = _reference_example()
    jg, tg = j_gmark(300, avg_degree=5, seed=0), t_gmark(300, avg_degree=5, seed=0)
    want = example.cpq_class_features(jg, jindex.build(jg, 2))
    got = gnn_features.cpq_class_features(tg, tindex.build(tg, 2, device=CPU))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_gnn_features_main_trains_on_the_cpu(capsys):
    history = gnn_features.main(["--device", "cpu", "--steps", "30"])
    assert len(history) == 30 and np.isfinite(history).all()
    assert history[-1] < 0.5 * history[0]
    assert "device cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    mine, theirs = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    for field in ("config", "smoke"):
        assert dataclasses.asdict(getattr(mine, field)) == \
            dataclasses.asdict(getattr(theirs, field))
    assert mine.shapes == tuple(tconfigs.ShapeSpec(**dataclasses.asdict(s))
                                for s in theirs.shapes)
    assert (mine.arch_id, mine.family, mine.notes) == \
        (theirs.arch_id, theirs.family, theirs.notes)
    assert mine.shape("minibatch_lg").dims["pad_nodes"] == 169_984


def test_get_arch_names_the_roadmap_item_for_the_other_ids():
    """Every id of the reference resolves in the port but the engine's
    dry-run cell, which names its ROADMAP item."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        if arch == "cpqx-engine":
            with pytest.raises(NotImplementedError, match=r"item 14\(c\)"):
                tconfigs.get_arch(arch)
        else:
            assert tconfigs.get_arch(arch).arch_id == arch
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")

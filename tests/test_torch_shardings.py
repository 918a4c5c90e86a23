"""The port's production meshes and sharding rule table
(``repro_torch.launch.mesh``, ``repro_torch.launch.shardings``) held
against the reference's ``launch/mesh.py`` and ``launch/shardings.py``.

The spec tables are pure functions of a config and a mesh shape: every
spec of the port equals the reference's ``PartitionSpec`` entry for entry
(the reference called with a stand-in exposing ``axis_names`` and
``devices``, so no JAX device state is needed).  Then one 8-rank gloo run
lays gemma2-2b's and BST's smoke parameters out as DTensors on a (2, 2, 2)
``DeviceMesh``: each rank's local shard equals the global array sliced by
the reference's ``NamedSharding.devices_indices_map`` for the device at
the same mesh coordinate (the reference in a subprocess with 8 forced
host devices).  The ranks import no JAX: this module imports it only
inside tests."""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import recsys, transformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ("gemma2-2b", "minicpm-2b", "mistral-nemo-12b",
            "granite-moe-3b-a800m", "grok-1-314b")
MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "test": ((2, 2, 2), ("pod", "data", "model")),
    "one": ((1,), ("data",)),
}
# the fsdp choices of the reference's lm_cell, per mesh
FSDP = {"pod": ("data", None), "multi_pod": ("data", ("pod", "data"), None),
        "test": ("data", ("pod", "data"), None), "one": ("data",)}
RANKS = 8
RANK_TIMEOUT_S = 240


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _port_mesh(name):
    shape, axes = MESHES[name]
    return (axes, shape)


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts (and the optimizer state's fields)."""
    if hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _assert_specs_equal(mine, theirs):
    a, b = _flat(mine), _flat(theirs)
    assert sorted(a) == sorted(b)
    for path in a:
        assert a[path] == tuple(b[path]), (path, a[path], b[path])
        assert all(x is None or isinstance(x, (str, tuple)) for x in a[path])


def _both(fn_name, *args_mine, args_theirs=None, **kw):
    """The port's and the reference's result of one table function, or
    the exception type each raised."""
    from repro.launch import shardings as JS

    out = []
    for mod, args in ((S, args_mine), (JS, args_theirs or args_mine)):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except (KeyError, ValueError) as err:
            out.append(type(err))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("size", ["config", "smoke"])
def test_lm_specs_equal_the_reference(arch, size, mesh):
    from repro import configs as jconfigs
    from repro.launch import shardings as JS

    mine_cfg = getattr(tconfigs.get_arch(arch), size)
    ref_cfg = getattr(jconfigs.get_arch(arch), size)
    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    for fsdp in FSDP[mesh]:
        for embed_fsdp in (True, False):
            mine, theirs = _both("lm_param_specs", mine_cfg, pm,
                                 args_theirs=(ref_cfg, rm), fsdp=fsdp,
                                 embed_fsdp=embed_fsdp)
            if mesh == "one":  # no "model" axis: both refuse
                assert mine is theirs is KeyError
                continue
            _assert_specs_equal(mine, theirs)
            opt = S.lm_opt_specs(mine)
            ref_opt = JS.lm_opt_specs(theirs)
            assert opt.step == tuple(ref_opt.step) == ()
            _assert_specs_equal(opt.mu, ref_opt.mu)
            _assert_specs_equal(opt.nu, ref_opt.nu)
    assert S.lm_batch_spec(pm) == tuple(JS.lm_batch_spec(rm))
    mine, theirs = _both("lm_cache_specs", mine_cfg, pm,
                         args_theirs=(ref_cfg, rm))
    if mesh == "one":
        assert mine is theirs is KeyError
    else:
        _assert_specs_equal(mine, theirs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bst_and_gnn_specs_equal_the_reference(mesh):
    from repro import configs as jconfigs
    from repro.launch import shardings as JS

    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    for size in ("config", "smoke"):
        mine, theirs = _both("bst_param_specs",
                             getattr(tconfigs.get_arch("bst"), size), pm,
                             args_theirs=(getattr(jconfigs.get_arch("bst"),
                                                  size), rm))
        if mesh == "one":
            assert mine is theirs is KeyError
        else:
            _assert_specs_equal(mine, theirs)
    assert S.bst_batch_spec(pm) == tuple(JS.bst_batch_spec(rm))
    total = int(np.prod(MESHES[mesh][0]))
    for arch in tconfigs.GNN_ARCH_IDS:
        for shape in tconfigs.get_arch(arch).shapes:
            d = shape.dims
            sizes = [(d["n_nodes"], d["n_edges"])]
            if "pad_nodes" in d:
                sizes.append((d["pad_nodes"], d["pad_edges"]))
            if "batch" in d:
                sizes.append((d["n_nodes"] * d["batch"],
                              d["n_edges"] * d["batch"]))
            sizes += [(-(-n // total) * total, -(-e // total) * total)
                      for n, e in list(sizes)]
            for n, e in sizes:
                _assert_specs_equal(S.gnn_batch_specs(pm, n, e),
                                    JS.gnn_batch_specs(rm, n, e))
        cfg = tconfigs.get_arch(arch).smoke
        from repro_torch.models import gnn

        tree = convert.gnn_params_to_numpy(
            cfg, gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
        _assert_specs_equal(S.gnn_param_specs(tree, pm),
                            JS.gnn_param_specs(tree, rm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_helpers_equal_the_reference(mesh):
    from repro.launch import mesh as JM

    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    assert M.batch_axes(pm) == JM.batch_axes(rm)
    assert M.flat_axes(pm) == JM.flat_axes(rm)
    for a in MESHES[mesh][1]:
        assert M.axis_size(pm, a) == JM.axis_size(rm, a)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = (("pod", "data", "model"), (2, 2, 2))
    assert S.placements((None, None), m) == [Replicate()] * 3
    assert S.placements((), m) == [Replicate()] * 3
    assert S.placements((None, "data", "model"), m) == \
        [Replicate(), Shard(1), Shard(2)]
    assert S.placements(("model", "data"), m) == \
        [Replicate(), Shard(1), Shard(0)]
    # a tuple of axes on one dim, in mesh order (major to minor)
    assert S.placements((("pod", "data"), None), m) == \
        [Shard(0), Shard(0), Replicate()]
    assert S.placements((("pod", "data", "model"),), m) == [Shard(0)] * 3
    assert S.placements((("data",), "model"), m) == \
        [Replicate(), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="not in mesh order"):
        S.placements((("data", "pod"), None), m)
    with pytest.raises(ValueError, match="named twice"):
        S.placements(("data", ("pod", "data")), m)
    with pytest.raises(ValueError, match="no mesh axis"):
        S.placements(("expert",), m)


def test_meshes_need_a_group_of_their_size():
    with pytest.raises(RuntimeError, match="256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="8 ranks"):
        M.make_test_mesh(device="cpu")


# ---------------------------------------------------------------------- #
# 8 ranks: DTensor local shards vs the reference's device index map
# ---------------------------------------------------------------------- #


def _global_trees():
    """{arch: (port config, {path: float32 global array}, {path: spec})}
    of gemma2-2b's and BST's smoke parameters, from a seeded draw."""
    mesh = M.names_and_shape((MESHES["test"][1], MESHES["test"][0]))
    out = {}
    lm = tconfigs.get_arch("gemma2-2b").smoke
    tree = convert.lm_params_to_numpy(
        lm, transformer.init_params(lm, torch.Generator().manual_seed(0), "cpu"))
    out["gemma2-2b"] = (tree, S.lm_param_specs(lm, mesh))
    bst = tconfigs.get_arch("bst").smoke
    tree = convert.bst_params_to_numpy(
        bst, recsys.init_params(bst, torch.Generator().manual_seed(1), "cpu"))
    out["bst"] = (tree, S.bst_param_specs(bst, mesh))
    return {a: ({p: np.asarray(x).astype(np.float32)
                 for p, x in _flat(t).items()}, _flat(s))
            for a, (t, s) in out.items()}


def _rank_local_shards(rank, world):
    torch.set_num_threads(1)
    mesh = M.make_test_mesh(*MESHES["test"], device="cpu")
    out = {"coordinate": tuple(int(c) for c in mesh.get_coordinate())}
    for arch, (arrays, specs) in _global_trees().items():
        for path, x in arrays.items():
            d = S.distribute(torch.from_numpy(x), specs[path], mesh)
            out[(arch, path)] = d.to_local().numpy()
    return out


_REFERENCE = """
import json, sys
import numpy as np
from jax.sharding import NamedSharding
from repro import compat, configs
from repro.launch import shardings as S

shapes = json.loads(sys.argv[1])
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
specs = {{"gemma2-2b": S.lm_param_specs(configs.get_arch("gemma2-2b").smoke,
                                        mesh),
          "bst": S.bst_param_specs(configs.get_arch("bst").smoke, mesh)}}

def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {{}}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (k,)))
        return out
    return {{"/".join(prefix): tree}}

out = {{}}
for arch, leaves in shapes.items():
    spec = flat(specs[arch])
    for path, shape in leaves.items():
        index = NamedSharding(mesh, spec[path]).devices_indices_map(tuple(shape))
        for coord in np.ndindex(2, 2, 2):
            dev = mesh.devices[coord]
            out[f"{{arch}}|{{path}}|{{coord}}"] = [
                [s.start, s.stop] if isinstance(s, slice) else s
                for s in index[dev]]
json.dump(out, sys.stdout)
"""


def _reference_slices(shapes):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={RANKS}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _REFERENCE.format()), json.dumps(shapes)], capture_output=True,
        text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def test_dtensor_local_shards_equal_the_references_device_slices():
    trees = _global_trees()
    shapes = {a: {p: list(x.shape) for p, x in arrays.items()}
              for a, (arrays, _) in trees.items()}
    slices = _reference_slices(shapes)
    results = run_ranks(_rank_local_shards, RANKS, timeout=RANK_TIMEOUT_S,
                        init_timeout=120)
    coords = [r["coordinate"] for r in results]
    assert coords == [tuple(np.unravel_index(r, (2, 2, 2)))
                      for r in range(RANKS)]
    sharded = 0
    for r in results:
        for arch, (arrays, _) in trees.items():
            for path, x in arrays.items():
                sl = slices[f"{arch}|{path}|{r['coordinate']}"]
                want = x[tuple(slice(a, b) for a, b in sl)]
                got = r[(arch, path)]
                assert got.shape == want.shape, (arch, path, r["coordinate"])
                assert np.array_equal(got, want), (arch, path)
                sharded += got.size < x.size
    assert sharded > 0  # some leaves really are split

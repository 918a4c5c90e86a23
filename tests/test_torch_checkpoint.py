"""The port's async checkpoint writer: saves commit in the order they were
issued, ``LATEST`` only moves forward, and a writer's failure is raised to
the caller (``src/repro_torch/checkpoint/checkpoint.py``)."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.checkpoint import (committed_steps, latest_step,  # noqa: E402
                                    load_checkpoint_items, save_checkpoint,
                                    wait_for_writes)

# trials of back-to-back saves: an unordered writer (one thread a save, all
# sharing one LATEST.tmp) left LATEST behind in ~45 % of trials of three
TRIALS = 100
STEPS = (10, 20, 30, 40)


def _tree(step):
    return {"w": np.full(256, step, np.float32), "n": np.arange(step)}


def test_back_to_back_async_saves_commit_in_order(tmp_path):
    for trial in range(TRIALS):
        d = str(tmp_path / f"t{trial}")
        for s in STEPS:
            save_checkpoint(d, s, _tree(s), async_write=True)
        wait_for_writes()  # raises if any writer failed
        assert latest_step(d) == STEPS[-1], trial
        assert committed_steps(d) == list(STEPS), trial
        for s in STEPS:
            assert os.path.exists(os.path.join(d, f"step_{s:09d}",
                                               "manifest.json"))
        assert sorted(os.listdir(d)) == sorted(
            ["LATEST"] + [f"step_{s:09d}" for s in STEPS]), trial
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == str(STEPS[-1])
    items, _, step = load_checkpoint_items(str(tmp_path / "t0"))
    assert step == STEPS[-1] and np.array_equal(items["w"], _tree(step)["w"])


def test_sync_save_commits_after_pending_async_ones(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, s, _tree(s), async_write=True)
    save_checkpoint(d, 4, _tree(4))
    assert latest_step(d) == 4 and committed_steps(d) == [1, 2, 3, 4]


def test_latest_only_moves_forward(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 30, _tree(30))
    save_checkpoint(d, 20, _tree(20))
    assert latest_step(d) == 30 and committed_steps(d) == [20, 30]
    save_checkpoint(d, 40, _tree(40), async_write=True)
    save_checkpoint(d, 35, _tree(35), async_write=True)
    wait_for_writes()
    assert latest_step(d) == 40
    # a dangling pointer does not hold LATEST back
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("99")
    save_checkpoint(d, 41, _tree(41))
    assert latest_step(d) == 41


def test_failed_writer_reraises_from_wait_for_writes(tmp_path):
    d = str(tmp_path / "ok")
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where a checkpoint directory should be")
    save_checkpoint(d, 1, _tree(1), async_write=True)
    save_checkpoint(str(blocked), 2, _tree(2), async_write=True)
    save_checkpoint(d, 3, _tree(3), async_write=True)
    with pytest.raises(OSError):
        wait_for_writes()
    wait_for_writes()  # re-raised once, then cleared
    # the writers issued around the failed one committed
    assert committed_steps(d) == [1, 3] and latest_step(d) == 3


def test_failed_writer_reraises_from_the_next_save(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    save_checkpoint(str(blocked), 1, _tree(1), async_write=True)
    d = str(tmp_path / "next")
    # the next save waits for the writers before it and raises the stored
    # failure before it writes anything
    with pytest.raises(OSError):
        save_checkpoint(d, 2, _tree(2))
    assert committed_steps(d) == []
    save_checkpoint(d, 2, _tree(2), async_write=True)
    wait_for_writes()
    assert latest_step(d) == 2


def test_tree_walks_make_no_reference_cycle():
    """The tree helpers the optimizer runs every step: their leaves die
    with the last reference, without the cyclic collector."""
    import gc
    import weakref

    import torch
    from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                                   _unflatten)

    gc.disable()
    try:
        t = torch.ones(3)
        alive = weakref.ref(t)
        paths, leaves = _flatten_with_paths({"a": [t, (t, None)], "b": t})
        assert paths == ["['a']/[0]", "['a']/[1]/[0]", "['b']"]
        back = _unflatten({"a": [0, (0, None)], "b": 0}, leaves)
        assert back["a"][1][0] is t
        del t, leaves, back
        assert alive() is None
    finally:
        gc.enable()


def test_a_train_step_frees_its_gradients_on_return(monkeypatch):
    """A BST train step and an LM train step (smoke configs on the CPU):
    every gradient ``torch.autograd.grad`` returned is dead when the step
    returns, without the cyclic collector, so a step's gradients never
    survive into the next step's peak."""
    import dataclasses
    import gc
    import weakref

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell

    made = []
    real = torch.autograd.grad

    def grad(*args, **kwargs):
        out = real(*args, **kwargs)
        made.extend(weakref.ref(g) for g in out)
        return out

    monkeypatch.setattr(torch.autograd, "grad", grad)
    for arch, shape, cut in (("bst", "train_batch", dict(batch=64)),
                             ("gemma2-2b", "train_4k",
                              dict(global_batch=4, seq_len=32))):
        spec = get_arch(arch)
        smoke = dataclasses.replace(spec, config=spec.smoke)
        cell = build_cell(smoke, spec.shape(shape), device="cpu", **cut)
        cell.fn(*cell.args)  # a first call imports lazily (frames in cycles)
        gc.collect()
        gc.disable()
        try:
            for _ in range(2):
                made.clear()
                out = cell.fn(*cell.args)
                assert made and all(r() is None for r in made), arch
                del out
        finally:
            gc.enable()


# ---------------------------------------------------------------------- #
# restore onto any mesh (the reference's restore_sharded with shardings)
# ---------------------------------------------------------------------- #

RESTORE_MESHES = (((2, 2, 2), ("pod", "data", "model")),
                  ((4, 2), ("data", "model")))


def _restore_rank(rank, world, ckpt, shape, axes):
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import restore_sharded
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as S

    torch.set_num_threads(1)
    mesh = M.make_test_mesh(shape, axes, device="cpu")
    cfg = configs.get_arch("gemma2-2b").smoke
    specs = S.lm_param_specs(cfg, mesh)
    like = _lm_tree()
    got = restore_sharded(ckpt, 1, like, shardings=(specs, mesh))
    out = {}
    for path, leaf, spec in _walk_specs(got, specs):
        out[path] = (list(leaf.placements) == S.placements(spec, mesh),
                     leaf.full_tensor().numpy())
    return out


def _lm_tree():
    import torch

    from repro_torch import configs, convert
    from repro_torch.models import transformer

    cfg = configs.get_arch("gemma2-2b").smoke
    return convert.lm_params_to_numpy(
        cfg, transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu"))


def _walk_specs(tree, specs, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _walk_specs(tree[key], specs[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", tree[key], specs[key]


@pytest.fixture(scope="module")
def lm_save(tmp_path_factory):
    """One save of gemma2-2b's smoke tree (the reference's stacked
    layout)."""
    d = str(tmp_path_factory.mktemp("lm_save"))
    tree = _lm_tree()
    save_checkpoint(d, 1, tree)
    return d, tree


@pytest.mark.parametrize("shape,axes", RESTORE_MESHES)
def test_restore_sharded_onto_any_mesh(lm_save, shape, axes):
    """The one save restored onto an 8-rank gloo mesh of each shape:
    every leaf a DTensor placed by its spec, whole equal to the saved
    leaf."""
    from repro_torch.launch.ranks import run_ranks

    ckpt, tree = lm_save
    ranks = run_ranks(_restore_rank, 8, (ckpt, shape, axes),
                      timeout=240, init_timeout=120)
    flat = {p: leaf for p, leaf, _ in _walk_specs(tree, tree)}
    for got in ranks:
        assert got.keys() == flat.keys()
        for path, (placed, whole) in got.items():
            assert placed, path
            assert np.array_equal(whole, flat[path]), path

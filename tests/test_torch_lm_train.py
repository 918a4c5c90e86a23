"""The port's training half of the LM and recsys side
(``repro_torch.data.tokens``, ``launch.steps.lm_train_step`` and
``bst_train_step``, ``models.transformer``'s per-layer remat and the
``launch.train`` driver) held against the JAX package on the CPU.

Parameters cross over by ``convert.lm_params_from_numpy`` /
``bst_params_from_numpy``; tokens come from both packages' ``TokenStream``,
which must agree bit for bit.  Float32 values agree within ``RTOL``
relative (max |diff| over max |reference|, a leaf at a time): the two
packages sum in other orders.

Run as a script, the file prints the losses of a train step on one batch
fed again, in both packages, at a published config cut to a few layers
(:func:`refed_losses`; ROADMAP Queue 3, the cell's learning rate)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train.py \
        minicpm-2b --layers 2 --seq 256 [--vocab 8192] [--lr 3e-4]

An updated parameter is AdamW's first step, ``lr * g / (|g| + eps)`` plus
the decay: near ``g = 0`` the step's slope is ``lr / eps`` = 3e4, so a
gradient element of ~1e-9 whose rounding differs moves its parameter by
a good part of ``lr``.  The moments hold the gradients to ``RTOL``; the
new parameters are held to ``RTOL`` wherever the (clipped) gradient is at
least ``DETERMINED`` = 1e3 eps, where that slope is below ``lr * 1e-5``,
and every element to within one step's reach, ``2 lr``."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.data import recsys_stream as jrs  # noqa: E402
from repro.launch.steps import _lm_train_step, bst_cell  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import recsys_stream as trs  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.launch import train as TD  # noqa: E402
from repro_torch.launch.steps import (TRAIN_ACCUM, bst_train_step,  # noqa: E402
                                      lm_train_step)
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.train.optim import adamw_init  # noqa: E402

ARCHS = ["gemma2-2b", "minicpm-2b", "mistral-nemo-12b",
         "granite-moe-3b-a800m", "grok-1-314b"]
RTOL = 1e-4
BST_RTOL = 1e-5
KEY = jax.random.PRNGKey(0)
CPU = "cpu"
# (accum, global batch, seq_len, config changes): plain, accumulated, and
# the chunked attention path (sequences >= 2 * q_chunk)
LR = 3e-4  # lm_train_step's default, the reference's
DETERMINED = 1e-5  # |g| past which AdamW's first step is well conditioned
CASES = {"accum1": (1, 4, 16, {}), "accum2": (2, 4, 16, {}),
         "chunked": (2, 2, 64, {"q_chunk": 16})}


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_trees_close(mine, theirs, tol, what):
    a, b = jax.tree.flatten(mine), jax.tree.flatten(theirs)
    assert a[1] == b[1], what
    for i, (x, y) in enumerate(zip(a[0], b[0])):
        assert rel(x, y) <= tol, (what, i, rel(x, y))


def _assert_updated_close(new, ref, mu_ref, lr=LR):
    """New parameters after a first step against the reference's, leaf
    by leaf: ``RTOL`` relative where the gradient ``mu / (1 - b1)`` is at
    least ``DETERMINED``, ``2 lr`` everywhere (the module docstring)."""
    a, b, m = (jax.tree.flatten(t) for t in (new, ref, mu_ref))
    assert a[1] == b[1] == m[1]
    for i, (x, y, mu) in enumerate(zip(a[0], b[0], m[0])):
        x, y, mu = (np.asarray(v, np.float64) for v in (x, y, mu))
        sure = np.abs(mu) / 0.1 >= DETERMINED
        diff = np.abs(x - y)
        assert diff[sure].max(initial=0) <= RTOL * np.abs(y).max(), i
        assert diff.max() <= 2 * lr, i


# ---------------------------------------------------------------------- #
# the token stream
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("vocab", [256, 256_000])
def test_token_stream_is_the_reference_bit_for_bit(vocab):
    for seed, step in ((0, 0), (1, 7), (5, 123)):
        mine, theirs = TokenStream(vocab, 4, 24, seed), JStream(vocab, 4, 24, seed)
        for got, want in zip(mine.batch_at(step), theirs.batch_at(step)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        for shard in range(2):
            for got, want in zip(mine.shard_at(step, shard, 2),
                                 theirs.shard_at(step, shard, 2)):
                assert np.array_equal(got, want)


# ---------------------------------------------------------------------- #
# lm_train_step against the reference's _lm_train_step
# ---------------------------------------------------------------------- #


def _lm_pair(arch, **changes):
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, **changes)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, **changes)
    jp = JT.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                      device=CPU)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, gb, seq, seed=4):
    toks, labels = TokenStream(cfg.vocab_size, gb, seq, seed).batch_at(2)
    labels = labels.copy()
    labels[0, :3] = -1  # masked positions
    return toks, labels


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_equals_the_reference(arch, case):
    """One ``lm_train_step`` against the reference's jitted
    ``_lm_train_step``: loss, ``grad_norm``, ``clip_scale``, every new
    parameter and every mu / nu leaf."""
    accum, gb, seq, changes = CASES[case]
    jcfg, tcfg, jp, tp = _lm_pair(arch, **changes)
    toks, labels = _tokens(jcfg, gb, seq)
    jnew, jopt, jm = jax.jit(_lm_train_step(jcfg, accum))(
        jp, j_adamw_init(jp), jnp.asarray(toks), jnp.asarray(labels))
    named = dict(tp.named_parameters())
    tp, opt, m = lm_train_step(tcfg, accum, device=CPU)(
        tp, adamw_init(named), torch.from_numpy(toks), torch.from_numpy(labels))
    for key in ("loss", "grad_norm", "clip_scale"):
        assert rel(m[key], jm[key]) <= RTOL, key
    assert int(opt.step) == int(jopt.step) == 1
    for mine, theirs in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        _assert_trees_close(convert.lm_params_to_numpy(tcfg, mine),
                            jax.tree.map(np.asarray, theirs), RTOL, "moments")
    _assert_updated_close(convert.lm_params_to_numpy(tcfg, tp),
                          jax.tree.map(np.asarray, jnew),
                          jax.tree.map(np.asarray, jopt.mu))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """``cfg.remat`` recomputes each layer in the backward pass: on the
    CPU the step is bit for bit the one without it, chunked path
    included."""
    outs = []
    for remat in (True, False):
        _, tcfg, _, tp = _lm_pair(arch, remat=remat, q_chunk=16)
        toks, labels = _tokens(tcfg, 2, 64)
        tp, opt, m = lm_train_step(tcfg, 2, device=CPU)(
            tp, adamw_init(dict(tp.named_parameters())),
            torch.from_numpy(toks), torch.from_numpy(labels))
        outs.append([m["loss"], m["grad_norm"], *tp.parameters(),
                     *opt.mu.values(), *opt.nu.values()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_remat_keeps_one_activation_a_layer():
    """With remat the forward under autograd saves less than without it,
    and ``lm_train_step`` refuses inputs off its device."""
    saved = {}
    for remat in (True, False):
        _, tcfg, _, tp = _lm_pair("gemma2-2b", remat=remat, n_layers=4)
        toks, labels = _tokens(tcfg, 2, 32)
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            from repro_torch.models import transformer as TT

            TT.train_loss(tcfg, tp, torch.from_numpy(toks),
                          torch.from_numpy(labels))
        saved[remat] = sum(sizes)
    assert saved[True] < saved[False] / 2
    with pytest.raises(ValueError, match="the step runs on meta"):
        lm_train_step(tcfg, device="meta")(
            tp, adamw_init(dict(tp.named_parameters())),
            torch.from_numpy(toks), torch.from_numpy(labels))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_adamw_update_is_the_pure_one_bit_for_bit(monkeypatch, dtype):
    """``adamw_update(..., inplace=True)`` writes the pure update's values
    into the given moments and parameters, a slice at a time (slices of
    7 elements here, so leaves straddle them)."""
    from repro_torch.train import optim

    monkeypatch.setattr(optim, "INPLACE_CHUNK", 7)
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 6, generator=g).to(dtype),
              "b": {"c": torch.randn(17, generator=g).to(dtype)}}
    grads = optim.tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    state = optim.adamw_init(params)
    for _ in range(2):
        want_p, want_s, want_m = optim.adamw_update(grads, state, params, 1e-3)
        got_p, got_s, got_m = optim.adamw_update(
            grads, optim.tree_map(torch.clone, state),
            optim.tree_map(torch.clone, params), 1e-3, inplace=True)
        for a, b in zip(optim.tree_leaves((got_p, got_s, got_m)),
                        optim.tree_leaves((want_p, want_s, want_m))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        params, state = want_p, want_s


def refed_losses(cfg_name: str, arch: str, layers: int, seq: int,
                 vocab=None, lr: float = LR, steps: int = 4,
                 dtype: str = "bfloat16") -> dict:
    """Losses of ``steps`` train steps at ``lr`` on one sequence of
    ``TokenStream(vocab, 1, seq, seed=3).batch_at(0)`` fed again, from the
    reference's parameters at ``KEY``: the reference's ``_lm_train_step``
    body at ``lr`` and the port's ``lm_train_step``.  ``cfg_name`` picks
    the published ``config`` or the ``smoke`` one, cut to ``layers`` (and
    ``vocab``)."""
    import gc

    from repro.train.optim import adamw_update as j_adamw_update

    changes = {"n_layers": layers, "param_dtype": dtype}
    if vocab:
        changes["vocab_size"] = vocab
    jcfg = dataclasses.replace(getattr(jconfigs.get_arch(arch), cfg_name),
                               **changes)
    tcfg = dataclasses.replace(getattr(tconfigs.get_arch(arch), cfg_name),
                               **changes)
    toks, labels = TokenStream(jcfg.vocab_size, 1, seq, seed=3).batch_at(0)

    @jax.jit
    def jstep(params, opt, t, lab):
        (loss, _), grads = jax.value_and_grad(
            lambda p: JT.train_loss(jcfg, p, t, lab), has_aux=True)(params)
        params, opt, _ = j_adamw_update(grads, opt, params, lr=lr)
        return params, opt, loss

    jp = JT.init_params(jcfg, KEY)
    tree = jax.tree.map(np.asarray, jp)
    opt, out = j_adamw_init(jp), {"reference": [], "port": []}
    for _ in range(steps):
        jp, opt, loss = jstep(jp, opt, jnp.asarray(toks), jnp.asarray(labels))
        out["reference"].append(float(loss))
    del jp, opt
    gc.collect()
    tp = convert.lm_params_from_numpy(tcfg, tree, device=CPU)
    del tree
    opt = adamw_init(dict(tp.named_parameters()))
    step = lm_train_step(tcfg, 1, lr=lr, device=CPU)
    for _ in range(steps):
        tp, opt, m = step(tp, opt, torch.from_numpy(toks),
                          torch.from_numpy(labels))
        out["port"].append(float(m["loss"]))
    return out


@pytest.mark.parametrize("lr", [LR, 1e-5])
def test_refed_losses_follow_the_reference(lr):
    """Four steps on one batch fed again: the port's losses are the
    reference's, step by step (minicpm-2b's smoke config, float32)."""
    out = refed_losses("smoke", "minicpm-2b", 2, 32, lr=lr, dtype="float32")
    for mine, theirs in zip(out["port"], out["reference"]):
        assert abs(mine - theirs) <= RTOL * abs(theirs)


def test_train_accum_is_the_reference():
    from repro.launch.steps import TRAIN_ACCUM as J_ACCUM

    assert TRAIN_ACCUM == J_ACCUM


# ---------------------------------------------------------------------- #
# bst_train_step against bst_cell's train step
# ---------------------------------------------------------------------- #


def test_bst_train_step_equals_the_bst_cell_step():
    """Two ``bst_train_step``s against the step ``bst_cell`` lowers (its
    ``fn``, called on concrete arrays of a one-device mesh): loss,
    ``grad_norm``, ``clip_scale``, parameters and moments."""
    jspec = jconfigs.get_arch("bst")
    jcfg, tcfg = jspec.smoke, tconfigs.get_arch("bst").smoke
    cell = bst_cell(dataclasses.replace(jspec, config=jcfg),
                    jconfigs.ShapeSpec("toy", "train", {"batch": 64}),
                    compat.make_mesh((1, 1), ("data", "model")))
    jstep = jax.jit(cell.fn)
    jp = JR.init_params(jcfg, KEY)
    tp = convert.bst_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                       device=CPU)
    jopt, opt = j_adamw_init(jp), adamw_init(dict(tp.named_parameters()))
    step = bst_train_step(tcfg, device=CPU)
    for k in range(2):
        arrs = jrs.batch_at(jcfg, 64, k, seed=2)
        jp, jopt, jm = jstep(jp, jopt, JR.BSTBatch(*map(jnp.asarray, arrs)))
        tb = TR.BSTBatch(*map(torch.from_numpy, trs.batch_at(tcfg, 64, k, seed=2)))
        tp, opt, m = step(tp, opt, tb)
        for key in ("loss", "grad_norm", "clip_scale"):
            assert rel(m[key], jm[key]) <= BST_RTOL, (k, key)
    _assert_trees_close(convert.bst_params_to_numpy(tcfg, tp),
                        jax.tree.map(np.asarray, jp), BST_RTOL, "params")
    for mine, theirs in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        _assert_trees_close(convert.bst_params_to_numpy(tcfg, mine),
                            jax.tree.map(np.asarray, theirs), BST_RTOL,
                            "moments")
    with pytest.raises(ValueError, match="the step runs on meta"):
        bst_train_step(tcfg, device="meta")(tp, opt, tb)


# ---------------------------------------------------------------------- #
# the launch.train driver
# ---------------------------------------------------------------------- #


def test_train_driver_learns_and_resumes(tmp_path, capsys):
    """``tests/test_drivers.py::TestTrainDriver`` on the port's driver."""
    hist = TD.main(["--arch", "minicpm-2b", "--steps", "14", "--batch", "2",
                    "--seq", "32", "--ckpt-dir", str(tmp_path),
                    "--device", CPU])
    out = capsys.readouterr().out
    assert "[train] done" in out and "schedule=wsd" in out
    first = float(out.split("loss ")[-1].split(" ->")[0])
    last = float(out.split("-> ")[-1].split(" over")[0])
    assert last <= first and len(hist) == 14
    TD.main(["--arch", "minicpm-2b", "--steps", "6", "--batch", "2",
             "--seq", "32", "--ckpt-dir", str(tmp_path), "--resume",
             "--device", CPU])
    assert "[train] done" in capsys.readouterr().out
    TD.main(["--arch", "gemma2-2b", "--steps", "2", "--batch", "2", "--seq",
             "16", "--device", CPU])
    assert "schedule=cosine" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not an LM"):
        TD.main(["--arch", "bst", "--device", CPU])


def test_stacked_tree_is_the_reference_layout():
    jcfg, tcfg, jp, tp = _lm_pair("mistral-nemo-12b")
    tree = TD.stacked_tree(tp)
    _assert_trees_close(jax.tree.map(lambda t: t.numpy(), tree),
                        jax.tree.map(np.asarray, jp), 0.0, "stacked")
    view = TD.layer_view(tree)
    assert len(view["layers"]) == tcfg.n_layers
    assert torch.equal(view["layers"][1]["wq"], tp["layers"][1]["wq"])


def test_resume_from_a_reference_checkpoint_continues_its_losses(tmp_path):
    """The reference's loop trains minicpm-2b's smoke config for four
    steps, checkpointing every two; the port's driver resumes from the
    step-2 checkpoint and its steps 2-3 give the reference's losses."""
    from repro.checkpoint import wait_for_writes as j_wait

    jcfg = jconfigs.get_arch("minicpm-2b").smoke
    batch, seq, steps = 2, 32, 4
    stream = JStream(jcfg.vocab_size, batch, seq)

    def loss_fn(p, b):
        return JT.train_loss(jcfg, p, *b)

    tcfg = jloop.TrainConfig(steps=steps, peak_lr=3e-4,
                             warmup=max(steps // 10, 5), schedule="wsd",
                             ckpt_every=2, ckpt_dir=str(tmp_path))
    _, _, jhist = jloop.train(
        loss_fn, JT.init_params(jcfg, KEY),
        lambda s: tuple(map(jnp.asarray, stream.batch_at(s))), tcfg)
    j_wait()
    shutil.rmtree(tmp_path / "step_000000004")
    out = tmp_path / "hist.json"
    TD.main(["--arch", "minicpm-2b", "--steps", str(steps), "--batch",
             str(batch), "--seq", str(seq), "--ckpt-dir", str(tmp_path),
             "--resume", "--history-out", str(out), "--device", CPU])
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [2, 3]
    for mine, theirs in zip(hist, jhist[2:]):
        assert abs(mine["loss"] - theirs["loss"]) <= RTOL * abs(theirs["loss"])
        assert abs(mine["grad_norm"] - theirs["grad_norm"]) \
            <= RTOL * theirs["grad_norm"]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    a = ap.parse_args()
    for who, values in refed_losses("config", a.arch, a.layers, a.seq, a.vocab,
                                    a.lr, a.steps, a.dtype).items():
        print(f"{a.arch} at {a.layers} layers, seq {a.seq}, vocab "
              f"{a.vocab or 'published'}, {a.dtype}, lr {a.lr}: {who} "
              + ", ".join(f"{x:.4f}" for x in values))

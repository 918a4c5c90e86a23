"""The port's recsys side (``repro_torch.models.recsys``, ``configs.bst``,
``data.recsys_stream`` and the BST steps of ``launch.steps``) held against
the JAX package on the CPU.

Parameters cross over by ``convert.bst_params_from_numpy``; batches come
from both packages' ``recsys_stream.batch_at``, which must agree bit for
bit.  Float32 outputs agree within ``RTOL`` relative (max |diff| over max
|reference|)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import recsys_stream as jstream  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import recsys_stream as tstream  # noqa: E402
from repro_torch.launch.steps import bst_retrieval_step, bst_serve_step  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

RTOL = 1e-5
KEY = jax.random.PRNGKey(0)
CPU = "cpu"


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def bst():
    """(JAX config, port config, JAX params, port params) of the smoke
    config, the port's parameters carried over from JAX's."""
    jcfg, tcfg = jconfigs.get_arch("bst").smoke, tconfigs.get_arch("bst").smoke
    jp = JR.init_params(jcfg, KEY)
    tp = convert.bst_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                       device=CPU)
    tp.requires_grad_(False)
    return jcfg, tcfg, jp, tp


def _batches(jcfg, tcfg, b=64, step=3, seed=1):
    arrs = jstream.batch_at(jcfg, b, step, seed=seed)
    return (JR.BSTBatch(*map(jnp.asarray, arrs)),
            TR.BSTBatch(*map(torch.from_numpy, tstream.batch_at(tcfg, b, step,
                                                                seed=seed))))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batch_at_is_the_reference_bit_for_bit(seed):
    for cfg_name in ("smoke", "config"):
        jcfg = getattr(jconfigs.get_arch("bst"), cfg_name)
        tcfg = getattr(tconfigs.get_arch("bst"), cfg_name)
        b = 32 if cfg_name == "smoke" else 4
        for step in (0, 5):
            want = jstream.batch_at(jcfg, b, step, seed=seed)
            got = tstream.batch_at(tcfg, b, step, seed=seed)
            assert got._fields == want._fields
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_over_unsorted_segments(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    segs = rng.integers(0, 6, 40).astype(np.int32)  # unsorted; segment 5 empty
    segs[segs == 5] = 4
    segs[:2] = [6, -1]  # outside [0, 6): dropped, as segment_sum drops them
    want = JR.embedding_bag(*map(jnp.asarray, (table, ids, segs)), 6, mode)
    got = TR.embedding_bag(*map(torch.from_numpy, (table, ids, segs)), 6, mode)
    assert got.shape == (6, 8) and not got[5].any()
    assert rel(got, want) <= RTOL


def test_ln_is_the_population_variance_form():
    rng = np.random.default_rng(1)
    x = rng.normal(3, 2, (4, 5, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, 16).astype(np.float32)
    want = JR._ln(jnp.asarray(x), jnp.asarray(w))
    got = TR._ln(torch.from_numpy(x), torch.from_numpy(w))
    assert rel(got, want) <= RTOL


def test_forward_and_train_loss_equal_the_reference(bst):
    jcfg, tcfg, jp, tp = bst
    jb, tb = _batches(jcfg, tcfg)
    want = JR.forward(jcfg, jp, jb)
    got = TR.forward(tcfg, tp, tb)
    assert got.dtype == torch.float32 and got.shape == (64,)
    assert rel(got, want) <= RTOL
    jseq = JR.sequence_tower(jcfg, jp, jb.item_ids, jb.cat_ids)
    assert rel(TR.sequence_tower(tcfg, tp, tb.item_ids, tb.cat_ids), jseq) <= RTOL
    jl, jm = JR.train_loss(jcfg, jp, jb)
    tl, tm = TR.train_loss(tcfg, tp, tb)
    assert rel(tl, jl) <= RTOL and rel(tm["bce"], jm["bce"]) <= RTOL


@pytest.mark.parametrize("k", [5, 128])
def test_retrieval_scores_and_topk_with_ties(bst, k):
    """Scores, and the top k in the reference's order; candidates repeated
    in the list tie exactly, and ``lax.top_k`` takes the lower index
    first, as the port's stable sort does."""
    jcfg, tcfg, jp, tp = bst
    jb, tb = _batches(jcfg, tcfg, b=1, step=0)
    rng = np.random.default_rng(2)
    cand = rng.permutation(jcfg.n_items)[:300].astype(np.int32)
    cand = np.concatenate([cand, cand[::-1][:100]])  # 100 exact ties
    segs = np.zeros(8, np.int32)
    jargs = (jb.item_ids, jb.cat_ids, jb.ctx_ids, jnp.asarray(segs),
             jnp.asarray(cand))
    targs = (tb.item_ids, tb.cat_ids, tb.ctx_ids, torch.from_numpy(segs),
             torch.from_numpy(cand))
    want = JR.retrieval_scores(jcfg, jp, *jargs)
    got = TR.retrieval_scores(tcfg, tp, *targs)
    assert got.dtype == torch.float32 and rel(got, want) <= RTOL
    jv, ji = JR.retrieval_topk(jcfg, jp, *jargs, k=k)
    tv, ti = TR.retrieval_topk(tcfg, tp, *targs, k=k)
    assert rel(tv, jv) <= RTOL
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    # on the port's own scores, the order is lax.top_k's
    lv, li = jax.lax.top_k(jnp.asarray(got.numpy()), k)
    assert np.array_equal(ti.numpy(), cand[np.asarray(li)])


def test_published_tree_and_init_distributions():
    cfg, jcfg = tconfigs.get_arch("bst").config, jconfigs.get_arch("bst").config
    mine = TR.init_params(cfg, torch.Generator(), device="meta")
    want = jax.eval_shape(lambda k: JR.init_params(jcfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {tuple(p.key for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {}
    for name, p in mine.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] == "blocks":
            parts, shape = ["blocks"] + parts[2:], (cfg.n_blocks,) + shape
        got[tuple(parts)] = (shape, str(p.dtype).replace("torch.", ""))
    assert got == want
    small = dataclasses.replace(cfg, n_items=20_000, n_context=1000)
    p = TR.init_params(small, torch.Generator().manual_seed(0), device=CPU)
    p.requires_grad_(False)
    assert abs(float(p["item_emb"].std()) / 0.01 - 1) < 0.02
    w0 = p["mlp"]["w0"]
    assert abs(float(w0.std()) * np.sqrt(w0.shape[0]) - 1) < 0.02
    assert not p["mlp"]["b2"].any() and bool((p["blocks"][0]["ln1"] == 1).all())


def test_bst_params_round_trip_bit_exact(bst):
    jcfg, tcfg, jp, tp = bst
    tree = jax.tree.map(np.asarray, jp)
    back = convert.bst_params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(back)))
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    half = convert.bst_params_from_numpy(bf, convert.bst_params_to_numpy(
        tcfg, TR.init_params(bf, torch.Generator(), device=CPU)), device=CPU)
    again = convert.bst_params_from_numpy(
        bf, convert.bst_params_to_numpy(bf, half), device=CPU)
    assert all(p.dtype == torch.bfloat16 and torch.equal(p, q) for p, q in
               zip(half.parameters(), again.parameters()))


def test_bst_steps_equal_the_reference_and_refuse_other_devices(bst):
    """``bst_serve_step`` and ``bst_retrieval_step`` (k = 128) against
    ``bst_cell``'s ``serve`` and ``retrieval`` bodies, jitted."""
    jcfg, tcfg, jp, tp = bst
    jb, tb = _batches(jcfg, tcfg, b=48, step=1)
    want = jax.jit(lambda p, b: JR.forward(jcfg, p, b))(jp, jb)
    assert rel(bst_serve_step(tcfg, device=CPU)(tp, tb), want) <= RTOL
    cand = np.arange(jcfg.n_items, dtype=np.int32)
    segs = np.zeros(8, np.int32)
    jv, ji = jax.jit(lambda p, *a: JR.retrieval_topk(jcfg, p, *a, k=128))(
        jp, jb.item_ids[:1], jb.cat_ids[:1], jb.ctx_ids[:8], jnp.asarray(segs),
        jnp.asarray(cand))
    tv, ti = bst_retrieval_step(tcfg, device=CPU)(
        tp, tb.item_ids[:1], tb.cat_ids[:1], tb.ctx_ids[:8],
        torch.from_numpy(segs), torch.from_numpy(cand))
    assert tv.shape == (128,) and rel(tv, jv) <= RTOL
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError, match="the step runs on meta"):
        bst_serve_step(tcfg, device="meta")(tp, tb)
    with pytest.raises(ValueError, match="the step runs on meta"):
        bst_retrieval_step(tcfg, device="meta")(
            tp, tb.item_ids[:1], tb.cat_ids[:1], tb.ctx_ids[:8],
            torch.from_numpy(segs), torch.from_numpy(cand))

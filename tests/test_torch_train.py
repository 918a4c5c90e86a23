"""The port's train substrate (``repro_torch.train``: AdamW, the
schedules, the fault-tolerant loop) and its fanout sampler, held against
the JAX package on the CPU: the optimizer and schedules within 1e-6,
the sampler and the CSR generator bit for bit, and the loop tests of
``tests/test_substrate.py`` run on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import sampler as jsampler  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import schedules as jsched  # noqa: E402
from repro_torch.checkpoint import latest_step, wait_for_writes  # noqa: E402
from repro_torch.data import sampler as tsampler  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import schedules as tsched  # noqa: E402
from repro_torch.train.loop import (StragglerStats, TrainConfig,  # noqa: E402
                                    make_train_step, resume, train)

TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(0, 1, (4, 3))).astype(np.float32),
            "b": {"c": (scale * rng.normal(0, 1, 5)).astype(np.float32),
                  "d": (scale * rng.normal(0, 1, (2, 2))).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_equals_the_reference(clip_norm):
    """Five steps of ``adamw_update`` (clipping active at clip_norm 1,
    idle at 100): parameters, both moments, ``grad_norm``, ``clip_scale``
    and the step counter equal the reference's within 1e-6."""
    jp, tp = jax.tree.map(jnp.asarray, _tree(0)), _to_torch(_tree(0))
    jo, to = joptim.adamw_init(jp), toptim.adamw_init(tp)
    assert to.step.dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in toptim.tree_leaves(to.mu))
    for step in range(5):
        grads = _tree(10 + step, scale=3.0)
        lr = 0.05 if step % 2 else jnp.float32(0.02)
        jp, jo, jm = joptim.adamw_update(jax.tree.map(jnp.asarray, grads), jo,
                                         jp, lr, clip_norm=clip_norm)
        tp, to, tm = toptim.adamw_update(
            _to_torch(grads), to, tp,
            lr if isinstance(lr, float) else torch.tensor(float(lr)),
            clip_norm=clip_norm)
        for key in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=TOL, err_msg=key)
        assert (float(tm["clip_scale"]) < 1) == (clip_norm == 1.0)
        for mine, theirs in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
            for a, b in zip(jax.tree.leaves(_to_numpy(mine)),
                            jax.tree.leaves(_to_numpy(theirs))):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        assert int(to.step) == int(jo.step) == step + 1


def test_global_norm_and_clip_equal_the_reference():
    g = _tree(3, scale=1e6)
    np.testing.assert_allclose(
        float(toptim.global_norm(_to_torch(g))),
        float(joptim.global_norm(jax.tree.map(jnp.asarray, g))), rtol=TOL)
    params = {"w": torch.ones(4)}
    _, _, m = toptim.adamw_update({"w": torch.full((4,), 1e6)},
                                  toptim.adamw_init(params), params, lr=0.1)
    assert float(m["clip_scale"]) < 1e-5


def test_adamw_keeps_bfloat16_params_and_float32_moments():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    new, opt, _ = toptim.adamw_update({"w": torch.ones(3, dtype=torch.bfloat16)},
                                      toptim.adamw_init(p), p, lr=0.1)
    assert new["w"].dtype == torch.bfloat16 and opt.mu["w"].dtype == torch.float32


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = toptim.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt, _ = toptim.adamw_update(g, opt, params, lr=0.1,
                                             weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("kw", [dict(peak_lr=1.0, warmup=10, total=100),
                                dict(peak_lr=3e-4, warmup=0, total=37,
                                     floor_frac=0.05)])
def test_cosine_equals_the_reference_at_every_step(kw):
    for s in range(kw["total"] + 5):
        np.testing.assert_allclose(float(tsched.cosine(s, **kw)),
                                   float(jsched.cosine(s, **kw)),
                                   rtol=TOL, atol=1e-9, err_msg=str(s))


@pytest.mark.parametrize("kw", [dict(peak_lr=1.0, warmup=10, stable=70,
                                     decay=20),
                                dict(peak_lr=3e-4, warmup=3, stable=5, decay=1,
                                     floor_frac=0.1)])
def test_wsd_equals_the_reference_at_every_step(kw):
    total = kw["warmup"] + kw["stable"] + kw["decay"]
    for s in range(total + 5):
        np.testing.assert_allclose(float(tsched.wsd(s, **kw)),
                                   float(jsched.wsd(s, **kw)),
                                   rtol=TOL, atol=1e-9, err_msg=str(s))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_csr_and_sample_fanout_bit_identical(seed):
    n, deg = 500 + 37 * seed, 6 + seed
    mine, theirs = tsampler.random_csr(n, deg, seed), jsampler.random_csr(n, deg, seed)
    assert mine.n_nodes == theirs.n_nodes
    for a, b in ((mine.indptr, theirs.indptr), (mine.indices, theirs.indices)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeds = np.random.default_rng(seed).choice(n, 16, replace=False)
    fanout = (5, 3) if seed != 1 else (40, 2)  # 40 > most degrees: replace
    a = tsampler.sample_fanout(mine, seeds, fanout, seed=seed + 1)
    b = jsampler.sample_fanout(theirs, seeds, fanout, seed=seed + 1)
    assert a.seed_count == b.seed_count
    for x, y in zip(a[:-1], b[:-1]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_fanout_sampler_capacities_and_masks():
    g = tsampler.random_csr(1000, avg_degree=12, seed=0)
    sub = tsampler.sample_fanout(g, np.arange(8), (4, 3), seed=1)
    assert sub.node_ids.shape[0] == 8 + 32 + 96
    assert sub.senders.shape[0] == 32 + 96
    ok = sub.edge_mask
    assert (sub.node_ids[sub.senders[ok]] >= 0).all()
    assert (sub.node_ids[sub.receivers[ok]] >= 0).all()


# ---------------------------------------------------------------------- #
# the loop: tests/test_substrate.py's TestTrainLoop on the port
# ---------------------------------------------------------------------- #

W_TRUE = np.random.default_rng(0).normal(0, 1, (4, 1)).astype(np.float32)


def _loss_fn(p, batch):
    x, y = batch
    return torch.mean((x @ p["w"] - y) ** 2), {}


def _data_at(step):
    x = np.random.default_rng(step).normal(0, 1, (16, 4)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(x @ W_TRUE)


def _params():
    return {"w": torch.zeros((4, 1))}


def test_loss_decreases():
    tcfg = TrainConfig(steps=60, peak_lr=0.05, warmup=5)
    _, _, hist = train(_loss_fn, _params(), _data_at, tcfg)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.1


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_train_equals_the_reference_loop(schedule):
    """30 steps of the port's loop and the reference's on the same data:
    every step's loss, lr and grad norm, and the final weights."""
    tcfg = TrainConfig(steps=30, peak_lr=0.05, warmup=5, schedule=schedule)
    jcfg = jloop.TrainConfig(steps=30, peak_lr=0.05, warmup=5,
                             schedule=schedule)

    def jloss(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] - y) ** 2), {}

    p, _, hist = train(_loss_fn, _params(), _data_at, tcfg)
    jp, _, jhist = jloop.train(
        jloss, {"w": jnp.zeros((4, 1))},
        lambda s: tuple(jnp.asarray(t.numpy()) for t in _data_at(s)), jcfg)
    for mine, theirs in zip(hist, jhist):
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5,
                               atol=1e-7)


def test_resume_is_deterministic(tmp_path):
    """A run checkpointed every 10 steps, resumed from the directory's
    ``latest_step`` (a port checkpoint), ends where the straight run
    ends."""
    tcfg = TrainConfig(steps=30, peak_lr=0.05, warmup=5,
                       ckpt_dir=str(tmp_path), ckpt_every=10)
    p1, _, _ = train(_loss_fn, _params(), _data_at, tcfg)
    wait_for_writes()
    assert latest_step(str(tmp_path)) == 30
    # resume from step 20 (the newest once step 30 is dropped)
    import shutil

    shutil.rmtree(tmp_path / "step_000000030")
    (tmp_path / "LATEST").write_text("20")
    start, params, opt = resume(str(tmp_path), _params(), device="cpu")
    assert start == 20 and int(opt.step) == 20
    p2, _, h2 = train(_loss_fn, params, _data_at,
                      TrainConfig(steps=30, peak_lr=0.05, warmup=5),
                      start_step=start, opt_state=opt)
    assert [h["step"] for h in h2] == list(range(20, 30))
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5)
    assert resume(str(tmp_path / "empty"), _params(), device="cpu")[0] == 0


def test_nan_breaker():
    def loss_fn(p, batch):
        return torch.tensor(float("nan")) * torch.sum(p["w"]), {}

    tcfg = TrainConfig(steps=20, peak_lr=0.1, warmup=1, max_bad_steps=3)
    with pytest.raises(FloatingPointError):
        train(loss_fn, {"w": torch.ones(2)},
              lambda s: (torch.zeros(1), torch.zeros(1)), tcfg)


def test_a_non_finite_step_is_a_no_op_on_the_params():
    def loss_fn(p, batch):
        return batch * torch.sum(p["w"]), {}

    step = make_train_step(loss_fn, TrainConfig(steps=10, warmup=1))
    params = {"w": torch.ones(2)}
    opt = toptim.adamw_init(params)
    new, opt, m = step(params, opt, torch.tensor(float("inf")),
                       torch.tensor(3, dtype=torch.int32))
    assert not bool(m["finite"]) and torch.equal(new["w"], params["w"])
    new, _, m = step(params, opt, torch.tensor(1.0),
                     torch.tensor(4, dtype=torch.int32))
    assert bool(m["finite"]) and not torch.equal(new["w"], params["w"])


def test_straggler_detection():
    st = StragglerStats()
    for _ in range(10):
        st.observe(0.1, 3.0)
    assert st.observe(10.0, 3.0)  # 100x the EWMA
    assert st.n_stragglers == 1


def test_grad_accumulation_matches_large_batch():
    params = _params()
    x, y = _data_at(0)
    step1 = make_train_step(_loss_fn, TrainConfig(steps=10, accum=1))
    step2 = make_train_step(_loss_fn, TrainConfig(steps=10, accum=4))
    opt = toptim.adamw_init(params)
    p1, _, m1 = step1(params, opt, (x, y), torch.tensor(5, dtype=torch.int32))
    p2, _, m2 = step2(params, opt, (x.reshape(4, 4, 4), y.reshape(4, 4, 1)),
                      torch.tensor(5, dtype=torch.int32))
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)

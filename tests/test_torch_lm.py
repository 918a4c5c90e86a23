"""The port's LM side (``repro_torch.models.layers``, ``models.transformer``,
the five LM configs, ``launch.serve`` and the LM steps of
``launch.steps``) held against the JAX package on the CPU.

Parameters cross over by ``convert.lm_params_from_numpy``; inputs are drawn
with numpy from a seed.  In float32 every output agrees within ``RTOL``
relative (max |diff| over max |reference|): the two packages sum in other
orders.  In bfloat16 the tolerance is ``BF16_TOL``: every matmul output
and residual add rounds at 2^-8 relative, in an order each package picks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch.steps import lm_decode_step, lm_prefill_step  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["gemma2-2b", "minicpm-2b", "mistral-nemo-12b",
         "granite-moe-3b-a800m", "grok-1-314b"]
RTOL = 1e-4
BF16_TOL = 3e-2
KEY = jax.random.PRNGKey(0)
CPU = "cpu"


def rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(arch, **changes):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    smoke config, the port's parameters carried over from JAX's."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, **changes)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, **changes)
    jp = JT.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                      device=CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _pair(arch)
        return cache[arch]

    return get


# ---------------------------------------------------------------------- #
# layers.py, function by function
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("gemma_style", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(gemma_style, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 16)).astype(np.float32)
    w = rng.normal(0, 0.5, 16).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-6,
                       gemma_style)
    got = TL.rms_norm(t(x).to(getattr(torch, dtype)),
                      t(w).to(getattr(torch, dtype)), 1e-6, gemma_style)
    assert str(got.dtype) == f"torch.{dtype}"
    # float32: the rsqrt's last bit; bfloat16: one rounding of the output
    assert rel(got, np.asarray(want, np.float32)) <= (
        1e-6 if dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("head_dim,max_len,theta", [(16, 128, 1e4),
                                                     (128, 3000, 1e6)])
def test_rope_table_is_the_reference_bit_for_bit(head_dim, max_len, theta):
    cos, sin = TL.rope_table(head_dim, max_len, theta)
    jcos, jsin = JL.rope_table(head_dim, max_len, theta)
    assert cos.dtype == torch.float32 and cos.shape == (max_len, head_dim // 2)
    assert np.array_equal(cos.numpy(), np.asarray(jcos))
    assert np.array_equal(sin.numpy(), np.asarray(jsin))
    # built once per (head_dim, max_len, theta, device)
    assert TL.rope_table(head_dim, max_len, theta)[0] is cos


def test_apply_rope():
    rng = np.random.default_rng(1)
    cos, sin = TL.rope_table(16, 64, 1e4)
    jcos, jsin = JL.rope_table(16, 64, 1e4)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    for pos in (np.arange(5)[None], rng.integers(0, 64, (2, 5))):
        want = JL.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
        got = TL.apply_rope(t(x), cos, sin, t(pos))
        assert rel(got, want) <= 1e-6


def test_softcap_and_causal_mask():
    x = np.linspace(-200, 200, 41).astype(np.float32)
    assert rel(TL._softcap(t(x), 50.0), JL._softcap(jnp.asarray(x), 50.0)) <= 1e-6
    assert TL._softcap(t(x), None) is not None
    for args in ((6, 6, None, 0), (4, 10, 3, 6), (8, 8, 2, 0)):
        got = TL.causal_mask(*args[:2], window=args[2], q_offset=args[3])
        want = JL.causal_mask(*args[:2], window=args[2], q_offset=args[3])
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask_ndim", [2, 3])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_gqa_attention(mask_ndim, softcap):
    rng = np.random.default_rng(2)
    b, s, h, kv, d, tt = 2, 3, 4, 2, 8, 7
    q = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, tt, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, tt, kv, d)).astype(np.float32)
    mask = (rng.random((b, s, tt) if mask_ndim == 3 else (s, tt)) < 0.6)
    mask[..., 0] = True
    if mask_ndim == 3:
        mask[1, 2] = False  # a fully masked row: uniform, as in JAX
    want = JL.gqa_attention(*map(jnp.asarray, (q, k, v, mask)), scale=d ** -0.5,
                            softcap=softcap)
    got = TL.gqa_attention(*map(t, (q, k, v, mask)), scale=d ** -0.5,
                           softcap=softcap)
    assert rel(got, want) <= RTOL


@pytest.mark.parametrize("window", [3, 100])
def test_chunked_gqa_attention(window):
    rng = np.random.default_rng(3)
    b, s, h, kv, d, tt = 1, 12, 4, 2, 8, 16
    q = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, tt, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, tt, kv, d)).astype(np.float32)
    qpos, kpos = np.arange(s) + 2, np.arange(tt)
    want = JL.chunked_gqa_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), jnp.int32(window),
        scale=d ** -0.5, softcap=50.0, q_chunk=4)
    got = TL.chunked_gqa_attention(*map(t, (q, k, v, qpos, kpos)), window,
                                   scale=d ** -0.5, softcap=50.0, q_chunk=4)
    assert rel(got, want) <= RTOL
    # the same numbers as the full form over the (S, T) mask
    mask = TL.causal_mask(s, tt, window=window, q_offset=2)
    full = TL.gqa_attention(*map(t, (q, k, v)), mask, scale=d ** -0.5,
                            softcap=50.0)
    assert rel(got, full.numpy()) <= 1e-6


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_mlp(activation):
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.normal(0, 1, sh).astype(np.float32) for sh in
                     ((3, 4, 8), (8, 12), (8, 12), (12, 8)))
    want = JL.gated_mlp(*map(jnp.asarray, (x, wg, wu, wd)), activation)
    got = TL.gated_mlp(*map(t, (x, wg, wu, wd)), activation)
    assert rel(got, want) <= RTOL


def test_moe_capacity():
    for args in ((16, 2, 8, 1.25), (1, 8, 40, 1.25), (4096, 8, 40, 1.25),
                 (3, 1, 4, 0.1)):
        assert TL.moe_capacity(*args) == JL.moe_capacity(*args)


def test_topk_gates_ties_go_to_the_first_index():
    rng = np.random.default_rng(5)
    probs = np.concatenate([
        np.full((1, 3, 8), 1 / 8, np.float32),  # all tied
        np.repeat(np.array([[[0.3, 0.1, 0.3, 0.1, 0.05, 0.05, 0.05, 0.05]]],
                           np.float32), 3, 1),
        np.asarray(jax.nn.softmax(rng.normal(0, 1, (1, 3, 8)), -1), np.float32),
    ])
    for k in (1, 3, 8):
        gv, gi = JL._topk_gates(jnp.asarray(probs), k)
        tv, ti = TL._topk_gates(t(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(gi))
        assert np.array_equal(tv.numpy(), np.asarray(gv))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("case", ["ample", "drops", "uniform_router"])
def test_moe_ffn(case):
    rng = np.random.default_rng(6)
    g, s, d, e, k, f = 2, 16, 8, 4, 2, 12
    x = rng.normal(0, 1, (g, s, d)).astype(np.float32)
    rw = (np.zeros((d, e), np.float32) if case == "uniform_router"
          else rng.normal(0, 1, (d, e)).astype(np.float32))
    wg, wu = (rng.normal(0, 0.3, (e, d, f)).astype(np.float32) for _ in range(2))
    wd = rng.normal(0, 0.3, (e, f, d)).astype(np.float32)
    cap = {"ample": JL.moe_capacity(s, k, e, 8.0), "drops": 2,
           "uniform_router": 3}[case]
    act = "gelu" if case == "drops" else "silu"
    jy, jaux = JL.moe_ffn(*map(jnp.asarray, (x, rw, wg, wu, wd)),
                          JL.MoEDims(e, k, cap), act)
    ty, taux = TL.moe_ffn(*map(t, (x, rw, wg, wu, wd)), TL.MoEDims(e, k, cap),
                          act)
    assert rel(ty, jy) <= RTOL
    assert rel(taux["moe_aux_loss"], jaux["moe_aux_loss"]) <= 1e-6
    # which assignments are dropped is decided by the stable sort: equal
    assert float(taux["moe_dropped_frac"]) == float(jaux["moe_dropped_frac"])
    assert (float(jaux["moe_dropped_frac"]) > 0) == (case != "ample")


def test_normal_init_distribution_and_meta():
    gen = torch.Generator().manual_seed(0)
    w = TL.normal_init(gen, (400, 300), torch.float32, scale=2.0)
    assert abs(float(w.std()) - 2.0 / np.sqrt(400)) < 0.02 * 2.0 / np.sqrt(400)
    assert abs(float(w.mean())) < 3e-3
    v = TL.normal_init(gen, (4, 1000), torch.bfloat16)
    assert v.dtype == torch.bfloat16  # fan_in = shape[-2]: std 1/2
    assert abs(float(v.float().std()) - 0.5) < 0.02
    m = TL.normal_init(gen, (10 ** 6, 10 ** 6), torch.bfloat16, device="meta")
    assert m.device.type == "meta" and m.shape == (10 ** 6, 10 ** 6)


# ---------------------------------------------------------------------- #
# transformer.py per smoke config
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_loss_equal_the_reference(arch, pairs):
    jcfg, tcfg, jp, tp = pairs(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.where(rng.random((2, 12)) < 0.2, -1, np.roll(toks, -1, 1))
    jl, jaux = JT.forward(jcfg, jp, jnp.asarray(toks))
    jloss, jm = JT.train_loss(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels))
    with torch.no_grad():
        tl, taux = TT.forward(tcfg, tp, t(toks))
        tloss, tm = TT.train_loss(tcfg, tp, t(toks), t(labels))
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, tcfg.padded_vocab)
    assert rel(tl, jl) <= RTOL
    assert abs(float(taux) - float(jaux)) <= RTOL * max(abs(float(jaux)), 1.0)
    assert rel(tloss, jloss) <= RTOL and rel(tm["ce_loss"], jm["ce_loss"]) <= RTOL
    if tcfg.final_softcap:
        assert float(tl.abs().max()) <= tcfg.final_softcap + 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference(arch, pairs):
    jcfg, tcfg, jp, tp = pairs(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jc = JT.make_cache(jcfg, 2, 24)
    tc = TT.make_cache(tcfg, 2, 24)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :8]), jc)
    tl, tc2 = TT.prefill(tcfg, tp, t(toks[:, :8]), tc)
    assert tc2 is tc  # written in place
    assert rel(tl, jl) <= RTOL
    for k in "kv":
        assert rel(tc[k], jc[k]) <= RTOL
    for pos in (8, 9):
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos))
        tl, tc = TT.decode_step(tcfg, tp, tc, t(toks[:, pos:pos + 1]), pos)
        assert tl.shape == (2, tcfg.padded_vocab)
        assert rel(tl, jl) <= RTOL
        for k in "kv":
            assert rel(tc[k], jc[k]) <= RTOL


def test_bfloat16_forward_prefill_and_decode():
    """gemma2-2b's smoke config in bfloat16 (the reference's leaves are
    ``ml_dtypes`` arrays, carried over bit for bit)."""
    jcfg, tcfg, jp, tp = _pair("gemma2-2b", param_dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    assert np.array_equal(tp["embed"].view(torch.int16).numpy(),
                          np.asarray(jp["embed"]).view(np.int16))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jl, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tp, t(toks))
    assert rel(tl, jl) <= BF16_TOL
    jc, tc = JT.make_cache(jcfg, 2, 16), TT.make_cache(tcfg, 2, 16)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :8]), jc)
    tl, tc = TT.prefill(tcfg, tp, t(toks[:, :8]), tc)
    assert tc["k"].dtype == torch.bfloat16 and rel(tl, jl) <= BF16_TOL
    jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 8:]), jnp.int32(8))
    tl, tc = TT.decode_step(tcfg, tp, tc, t(toks[:, 8:]), 8)
    assert rel(tl, jl) <= BF16_TOL
    assert rel(tc["v"].float(), np.asarray(jc["v"], np.float32)) <= BF16_TOL


def test_chunked_prefill_equals_the_reference_and_the_unchunked_path():
    """gemma2-2b's smoke config with q_chunk 4: a prompt of 16 takes the
    chunked path (local window 16 of the smoke config cut to 5)."""
    jcfg, tcfg, jp, tp = _pair("gemma2-2b", q_chunk=4, window=5)
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks), JT.make_cache(jcfg, 2, 20))
    tl, tc = TT.prefill(tcfg, tp, t(toks), TT.make_cache(tcfg, 2, 20))
    assert rel(tl, jl) <= RTOL and rel(tc["k"], jc["k"]) <= RTOL
    flat = dataclasses.replace(tcfg, q_chunk=0)
    fl, fc = TT.prefill(flat, tp, t(toks), TT.make_cache(flat, 2, 20))
    assert rel(tl, fl.numpy()) <= RTOL and rel(tc["v"], fc["v"].numpy()) <= RTOL
    jf, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tf, _ = TT.forward(tcfg, tp, t(toks))
    assert rel(tf, jf) <= RTOL


# ---------------------------------------------------------------------- #
# serve.py
# ---------------------------------------------------------------------- #


def _recorded(server):
    """``server`` whose every step's logits are kept, as host arrays."""
    log = []
    step = server._step

    def rec(p, c, tok, pos):
        logits, c = step(p, c, tok, pos)
        log.append(np.asarray(logits.detach() if isinstance(logits, torch.Tensor)
                              else logits, np.float32))
        return logits, c

    server._step = rec
    return log


def _drive(server, reqs):
    pending = list(reqs)
    while pending or any(server.slot_req):
        while pending and server.admit(pending[0]):
            pending.pop(0)
        server.step_all()


@pytest.mark.parametrize("arch", ARCHS)
def test_server_equals_the_reference_server(arch, pairs):
    """Token streams, every step's logits and the step count equal the
    reference ``Server``'s; for minicpm-2b both leave out the residual
    scale (see the next test)."""
    jcfg, tcfg, jp, tp = pairs(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (5, 3, 6)]
    js = JS.Server(jcfg, jp, 2, 16)
    ts = TS.Server(tcfg, tp, 2, 16, device=CPU)
    jlog, tlog = _recorded(js), _recorded(ts)
    jr = [JS.Request(i, p, 5) for i, p in enumerate(prompts)]
    tr = [TS.Request(i, p, 5) for i, p in enumerate(prompts)]
    _drive(js, jr)
    _drive(ts, tr)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert all(r.done for r in tr) and ts.steps == js.steps == len(tlog)
    assert max(rel(a, b) for a, b in zip(tlog, jlog)) <= RTOL
    assert np.array_equal(ts.positions, js.positions)


def test_server_reproduces_the_references_residual_scale_omission(pairs):
    """The reference's step leaves out ``cfg.residual_scale`` (its
    ``serve.py`` step against ``transformer.py``'s ``_block``).  minicpm-2b
    is the one config that sets it: two slots at position 0 give logits
    3.9e-3 off ``decode_step``'s, in both packages; mistral-nemo-12b's
    are equal."""
    for arch, differs in (("minicpm-2b", True), ("mistral-nemo-12b", False)):
        jcfg, tcfg, jp, tp = pairs(arch)
        toks, pos = np.array([[3], [5]], np.int32), np.zeros(2, np.int32)
        served, _ = TS._decode_step_multi(tcfg, tp, TT.make_cache(tcfg, 2, 8),
                                          t(toks), t(pos))
        stepped, _ = TT.decode_step(tcfg, tp, TT.make_cache(tcfg, 2, 8),
                                    t(toks), 0)
        jserved, _ = JS._decode_step_multi(jcfg, jp, JT.make_cache(jcfg, 2, 8),
                                           jnp.asarray(toks), jnp.asarray(pos))
        gap = float((served - stepped).abs().max())
        assert rel(served, jserved) <= RTOL
        assert (gap > 1e-3) == differs, (arch, gap)


def test_serve_main_continuous_batching(capsys):
    """``tests/test_drivers.py::TestServeDriver``'s run and assertions."""
    server = TS.main(["--arch", "gemma2-2b", "--requests", "4", "--slots", "2",
                      "--max-new", "4", "--max-len", "32", "--device", CPU])
    out = capsys.readouterr().out
    assert "all 4 requests done" in out
    # more requests than slots => slots were reused
    assert "admitted request 3" in out
    assert server.steps == 8 * 4 + 4 * 2 and not any(server.slot_req)


# ---------------------------------------------------------------------- #
# configs, parameter trees, init, conversion, steps
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS + ["bst"])
def test_configs_equal_the_reference(arch):
    mine, theirs = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    for field in ("config", "smoke"):
        assert dataclasses.asdict(getattr(mine, field)) == \
            dataclasses.asdict(getattr(theirs, field))
    assert mine.shapes == tuple(tconfigs.ShapeSpec(**dataclasses.asdict(s))
                                for s in theirs.shapes)
    assert (mine.arch_id, mine.family, mine.notes) == \
        (theirs.arch_id, theirs.family, theirs.notes)


def _port_shapes(params, stacked, n):
    """{reference leaf path: (shape, dtype name)} of a port ``Params``
    module, ``stacked``'s entries' leaves stacked over ``n``."""
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] == stacked:
            parts, shape = [stacked] + parts[2:], (n,) + shape
        key = tuple(parts)
        entry = (shape, str(p.dtype).replace("torch.", ""))
        assert out.setdefault(key, entry) == entry, key
    return out


def _jax_shapes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_published_parameter_trees_equal_the_reference(arch):
    """Names, shapes and dtypes of the full configs' trees against
    ``jax.eval_shape(T.init_params)``; the port's tree on the meta device
    allocates nothing (grok-1 is 631 GB)."""
    cfg = tconfigs.get_arch(arch).config
    jcfg = jconfigs.get_arch(arch).config
    mine = TT.init_params(cfg, torch.Generator(), device="meta")
    want = _jax_shapes(jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                                      jax.ShapeDtypeStruct((2,), jnp.uint32)))
    assert _port_shapes(mine, "layers", cfg.n_layers) == want
    assert cfg.param_count() == jcfg.param_count()
    pad = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    n = sum(p.numel() for p in mine.parameters())
    assert n - pad * (1 if cfg.tie_embeddings else 2) == cfg.param_count()


def test_init_distributions():
    cfg = dataclasses.replace(tconfigs.get_arch("granite-moe-3b-a800m").smoke,
                              d_model=128, d_ff=96, n_layers=2)
    p = TT.init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    p.requires_grad_(False)
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    depth = 1 / np.sqrt(2 * cfg.n_layers)
    lp = p["layers"][1]
    for w, std in ((p["embed"], 1 / np.sqrt(cfg.padded_vocab)),
                   (lp["wq"], 1 / np.sqrt(d)), (lp["wo"], depth / np.sqrt(hd)),
                   (lp["router"], 1 / np.sqrt(d)), (lp["w_up"], 1 / np.sqrt(d)),
                   (lp["w_down"], depth / np.sqrt(cfg.d_ff))):
        assert abs(float(w.std()) / std - 1) < 0.05, (tuple(w.shape), std)
        assert abs(float(w.mean())) < 0.05 * std
    assert torch.equal(lp["attn_norm"], torch.ones(d))
    g = TT.init_params(tconfigs.get_arch("gemma2-2b").smoke,
                       torch.Generator().manual_seed(1), device=CPU)
    for name in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
        assert not g["layers"][0][name].any()  # gemma-style (1 + w): zeros
    assert not g["final_norm"].any()
    untied = TT.init_params(tconfigs.get_arch("mistral-nemo-12b").smoke,
                            torch.Generator(), device=CPU)
    assert untied["lm_head"].shape == (64, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip_bit_exact(dtype):
    jcfg = dataclasses.replace(jconfigs.get_arch("grok-1-314b").smoke,
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_arch("grok-1-314b").smoke,
                               param_dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, KEY))
    params = convert.lm_params_from_numpy(tcfg, tree, device=CPU)
    assert params["layers"][1]["w_gate"].dtype == getattr(torch, dtype)
    back = convert.lm_params_to_numpy(tcfg, params)
    raw = (lambda a: a.view(np.uint16)) if dtype == "bfloat16" else (lambda a: a)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(raw(a), b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(back)))
    again = convert.lm_params_from_numpy(tcfg, back, device=CPU)
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))
    with pytest.raises(ValueError, match="stacked over 3"):
        convert.lm_params_from_numpy(dataclasses.replace(tcfg, n_layers=3),
                                     tree, device=CPU)


def test_lm_steps_equal_the_reference_and_refuse_other_devices(pairs):
    """``lm_prefill_step`` / ``lm_decode_step`` against ``lm_cell``'s
    ``prefill`` and ``decode`` bodies, jitted."""
    jcfg, tcfg, jp, tp = pairs("granite-moe-3b-a800m")
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (3, 7))
    toks = toks.astype(np.int32)
    jl, jc = jax.jit(lambda p, x, c: JT.prefill(jcfg, p, x, c))(
        jp, jnp.asarray(toks[:, :6]), JT.make_cache(jcfg, 3, 12))
    tl, tc = lm_prefill_step(tcfg, device=CPU)(tp, t(toks[:, :6]),
                                               TT.make_cache(tcfg, 3, 12))
    assert rel(tl, jl) <= RTOL
    jl, jc = jax.jit(lambda p, c, x, pos: JT.decode_step(jcfg, p, c, x, pos))(
        jp, jc, jnp.asarray(toks[:, 6:]), jnp.int32(6))
    tl, tc = lm_decode_step(tcfg, device=CPU)(tp, tc, t(toks[:, 6:]), 6)
    assert rel(tl, jl) <= RTOL and rel(tc["k"], jc["k"]) <= RTOL
    with pytest.raises(ValueError, match="the step runs on meta"):
        lm_decode_step(tcfg, device="meta")(tp, tc, t(toks[:, 6:]), 6)
    with pytest.raises(ValueError, match="the step runs on meta"):
        lm_prefill_step(tcfg, device="meta")(tp, t(toks[:, :6]), tc)

"""The plain PyTorch versions of the port's four kernels
(``repro_torch.kernels.ref``, what ``ops`` runs for CPU tensors) held bit
for bit against the JAX package's ``kernels.ops`` (Pallas in interpret
mode on the CPU), lane by lane, on the reference kernel tests' shapes.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import expand_join, fingerprint, ops, ref, sorted_intersect  # noqa: E402
from repro_torch.kernels import segment_softmax  # noqa: E402
from repro_torch.models.gnn import edge_softmax  # noqa: E402

SENTINEL = 2**31 - 1
INT_MIN = -(2**31)


def _member_case(rng, n_hay, n_q):
    hay = np.sort(rng.choice(5 * n_hay, n_hay, replace=False)).astype(np.int32)
    count = int(rng.integers(0, n_hay + 1))
    queries = rng.integers(0, 5 * n_hay, n_q).astype(np.int32)
    queries[rng.random(n_q) < 0.05] = SENTINEL
    return hay, count, queries


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n_hay", [1, 7, 128, 1000])
@pytest.mark.parametrize("n_q", [1, 64, 1024, 1500])
def test_sorted_member_mask(lanes, n_hay, n_q):
    rng = np.random.default_rng(n_hay * 10_007 + n_q + lanes)
    cases = [_member_case(rng, n_hay, n_q) for _ in range(lanes)]
    hay = torch.from_numpy(np.stack([c[0] for c in cases]))
    count = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    queries = torch.from_numpy(np.stack([c[2] for c in cases]))
    got = ops.sorted_member_mask(hay, count, queries)
    assert got.dtype == torch.int32 and got.shape == (lanes, n_q)
    for b, (h, c, q) in enumerate(cases):
        exp = np.asarray(jops.sorted_member_mask(jnp.asarray(h), c, jnp.asarray(q)))
        np.testing.assert_array_equal(got[b].numpy(), exp)
        np.testing.assert_array_equal(
            got[b].numpy(), np.isin(q, h[:c]).astype(np.int32))


def test_sentinel_queries_never_match():
    hay = torch.tensor([[1, 5, 9, SENTINEL]], dtype=torch.int32)
    q = torch.tensor([[5, SENTINEL, 9, SENTINEL]], dtype=torch.int32)
    got = ops.sorted_member_mask(hay, torch.tensor([3], dtype=torch.int32), q)
    np.testing.assert_array_equal(got.numpy(), [[1, 0, 1, 0]])


def _join_case(rng, n_b_rows):
    n_a = int(rng.integers(1, 40))
    a = rng.integers(0, 6, (n_a, 2)).astype(np.int32)
    lo = np.searchsorted(n_b_rows[:, 0], a[:, 1], "left").astype(np.int32)
    hi = np.searchsorted(n_b_rows[:, 0], a[:, 1], "right").astype(np.int32)
    ends = np.cumsum(hi - lo).astype(np.int32)
    return ends, lo, a[:, 0].copy(), int(ends[-1])


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("seed", range(8))
def test_expand_join_gather(lanes, seed):
    """Random CSR joins against one shared, sorted build side."""
    rng = np.random.default_rng(seed)
    n_b = int(rng.integers(1, 40))
    b = rng.integers(0, 6, (n_b, 2)).astype(np.int32)
    b = b[np.lexsort((b[:, 1], b[:, 0]))]
    cases = [_join_case(rng, b) for _ in range(lanes)]
    n_a = max(len(c[0]) for c in cases)

    def pad(x, fill):  # lanes share one probe width; padding adds no rows
        return np.concatenate([x, np.full(n_a - len(x), fill, np.int32)])

    ends = np.stack([pad(c[0], c[0][-1]) for c in cases])
    lo = np.stack([pad(c[1], 0) for c in cases])
    pay = np.stack([pad(c[2], 0) for c in cases])
    total = np.array([c[3] for c in cases], np.int32)
    cap = max(8, 1 << max(0, int(total.max()) - 1).bit_length())
    got = ops.expand_join_gather(
        torch.from_numpy(ends), torch.from_numpy(lo), torch.from_numpy(pay),
        torch.from_numpy(b[:, 0].copy()), torch.from_numpy(b[:, 1].copy()),
        torch.from_numpy(total), cap)
    for lane in range(lanes):
        exp = jops.expand_join_gather(
            jnp.asarray(ends[lane]), jnp.asarray(lo[lane]), jnp.asarray(pay[lane]),
            jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]), int(total[lane]), cap)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g[lane].numpy(), np.asarray(e))


def _assert_same_fingerprint(cols, salt):
    got = ops.fingerprint_rows(tuple(torch.from_numpy(c) for c in cols), salt=salt)
    exp = jops.fingerprint_rows(tuple(jnp.asarray(c) for c in cols), salt=salt)
    for g, e in zip(got, exp):
        e = np.asarray(e)
        assert g.dtype == torch.int64 and e.dtype == np.uint32
        assert g.shape == e.shape
        # the port holds uint32 values in int64 lanes: compare the integers
        np.testing.assert_array_equal(g.numpy(), e.astype(np.int64))


@pytest.mark.parametrize("n_cols", [1, 2, 4])
@pytest.mark.parametrize("n", [16, 100, 2048, 4096])
def test_fingerprint_rows(n_cols, n):
    """The reference's ``TestFingerprint`` sweep."""
    rng = np.random.default_rng(n * 31 + n_cols)
    cols = [rng.integers(-5, 1000, n).astype(np.int32) for _ in range(n_cols)]
    _assert_same_fingerprint(cols, salt=3)


@pytest.mark.parametrize("salt", [0, 1, 77])
@pytest.mark.parametrize("n_cols", [1, 3, 5])
def test_fingerprint_rows_padding_values(salt, n_cols):
    """-1 (sequence padding), SENTINEL and INT_MIN reinterpret as uint32
    exactly as the reference's casts do."""
    rng = np.random.default_rng(salt * 7 + n_cols)
    n = 2048
    cols = []
    for _ in range(n_cols):
        c = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        roll = rng.random(n)
        c[roll < 0.1] = -1
        c[(roll >= 0.1) & (roll < 0.2)] = SENTINEL
        c[(roll >= 0.2) & (roll < 0.3)] = INT_MIN
        cols.append(c)
    _assert_same_fingerprint(cols, salt=salt)


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach a CUDA kernel, so no launch is counted."""
    before = (sorted_intersect.launches, expand_join.launches,
              fingerprint.launches)
    hay = torch.tensor([[1, 3, 5]], dtype=torch.int32)
    one = torch.tensor([3], dtype=torch.int32)
    ops.sorted_member_mask(hay, one, hay)
    ops.expand_join_gather(one[None], torch.zeros(1, 1, dtype=torch.int32),
                           one[None], hay[0], hay[0], one, 4)
    ops.fingerprint_rows((hay[0], hay[0]), salt=1)
    assert (sorted_intersect.launches, expand_join.launches,
            fingerprint.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA bindings raise on a CPU tensor instead of computing."""
    hay = torch.tensor([[1, 3, 5]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sorted_intersect.sorted_member_mask(hay, torch.tensor([3], dtype=torch.int32), hay)
    one = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        expand_join.expand_join_gather(one[None], one[None], one[None], one, one,
                                       one, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fingerprint.fingerprint_rows((one, one), salt=1)


@pytest.mark.parametrize("n_cols", [0, fingerprint.MAX_COLS + 1])
def test_fingerprint_wrapper_refuses_column_counts_it_cannot_take(n_cols):
    cols = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(n_cols))
    with pytest.raises(ValueError, match="columns"):
        fingerprint.fingerprint_rows(cols)



# ---- segment_softmax: float32 to 1e-6, bfloat16 to 2e-2 (the reference
# test's tolerances; the port sums in float32, the reference in bfloat16)

_SOFTMAX_DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
                   "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _assert_softmax_equals_jax(scores, seg, n, dtype):
    """The port's ``ops.segment_softmax`` and ``edge_softmax`` against the
    reference's ``kernels.ops.segment_softmax`` (Pallas in interpret mode
    where E divides by 512, its ``ref`` otherwise) on the same values."""
    t_dtype, j_dtype, tol = _SOFTMAX_DTYPES[dtype]
    j_scores = jnp.asarray(scores, j_dtype)
    exp = np.asarray(jops.segment_softmax(j_scores, jnp.asarray(seg), n),
                     np.float32)
    t_scores = torch.from_numpy(np.array(j_scores, np.float32)).to(t_dtype)
    for got in (ops.segment_softmax(t_scores, torch.from_numpy(seg), n),
                edge_softmax(t_scores, torch.from_numpy(seg), n)):
        assert got.dtype == t_dtype and got.shape == scores.shape
        np.testing.assert_allclose(got.float().numpy(), exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(_SOFTMAX_DTYPES))
@pytest.mark.parametrize("e,d,n", [(512, 1, 16), (1024, 8, 64), (2048, 4, 100)])
def test_segment_softmax(dtype, e, d, n):
    """The reference's ``TestSegmentSoftmax`` shapes."""
    rng = np.random.default_rng(e + d + n)
    scores = rng.normal(0, 3, (e, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    _assert_softmax_equals_jax(scores, seg, n, dtype)


def _softmax_case(name, rng):
    if name == "empty_segments":  # ids use only every third segment
        return rng.normal(0, 3, (512, 4)), np.sort(rng.integers(0, 20, 512)) * 3, 64
    if name == "out_of_range":  # negative and >= N ids, some clipped onto
        seg = rng.integers(-5, 40, 1024)  # the empty segments 0 and N-1
        seg[(seg == 0) | (seg == 31)] = 7
        return rng.normal(0, 3, (1024, 2)), seg, 32
    if name == "unsorted":
        return rng.normal(0, 3, (1024, 3)), rng.integers(0, 50, 1024), 50
    if name == "ragged":  # E not a multiple of 512: the reference's ref path
        return rng.normal(0, 3, (1000, 5)), rng.integers(0, 30, 1000), 30
    if name == "one_edge":
        return rng.normal(0, 3, (1, 1)), np.array([0]), 1
    raise ValueError(name)


@pytest.mark.parametrize("dtype", sorted(_SOFTMAX_DTYPES))
@pytest.mark.parametrize("case", ["empty_segments", "out_of_range", "unsorted",
                                  "ragged", "one_edge"])
def test_segment_softmax_edge_cases(dtype, case):
    scores, seg, n = _softmax_case(case, np.random.default_rng(11))
    _assert_softmax_equals_jax(scores.astype(np.float32), seg.astype(np.int32),
                               n, dtype)


def test_segment_tables_drop_out_of_range_ids():
    """``jax.ops.segment_sum``/``segment_max`` drop ids outside [0, N),
    negative ids included; the port's reductions do the same."""
    seg = np.array([-1, 0, 1, 5], np.int32)
    vals = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), 3)),
        [[2.0], [3.0], [0.0]])
    table = ref.segment_tables(torch.from_numpy(vals), torch.from_numpy(seg), 3)
    np.testing.assert_array_equal(table[..., 0].numpy(), [[2.0], [3.0], [0.0]])  # empty: 0
    np.testing.assert_array_equal(table[..., 1].numpy(), [[1.0], [1.0], [0.0]])  # exp(0)


def test_segment_softmax_cpu_takes_the_plain_version():
    before = segment_softmax.launches
    x = torch.zeros(4, 2)
    out = ops.segment_softmax(x, torch.tensor([0, 0, 1, 1]), 2)
    torch.testing.assert_close(out, torch.full((4, 2), 0.5))
    assert segment_softmax.launches == before


def test_segment_softmax_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 2)
    seg = torch.zeros(4, dtype=torch.int32)
    table = torch.zeros(1, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        segment_softmax.segment_normalize(x, seg, table)


def _bad_tables():
    """Tables the kernel cannot gather from, for (E, 2) scores, by name."""
    flat = torch.zeros(3 * 2 * 2 + 1)
    return {
        "two_dims": torch.zeros(3, 2),
        "three_slots": torch.zeros(3, 2, 3),
        "other_width": torch.zeros(3, 4, 2),
        "no_rows": torch.zeros(0, 2, 2),
        "float64": torch.zeros(3, 2, 2, dtype=torch.float64),
        "bfloat16": torch.zeros(3, 2, 2, dtype=torch.bfloat16),
        "transposed": torch.zeros(2, 3, 2).transpose(0, 1),
        "slots_apart": torch.zeros(2, 3, 2).permute(1, 2, 0).transpose(1, 2),
        "every_other_row": torch.zeros(6, 2, 2)[::2],
        "off_8_bytes": flat[1:].view(3, 2, 2),
    }


@pytest.mark.parametrize("name", sorted(_bad_tables()))
def test_segment_softmax_wrapper_refuses_bad_packed_tables(name):
    """A wrongly shaped, typed, strided or misaligned packed table raises
    before the device is looked at (the kernel reads one aligned float2 an
    entry); the message names the table."""
    table = _bad_tables()[name]
    x = torch.zeros(4, 2)
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="^table: "):
        segment_softmax.segment_normalize(x, seg, table)
    with pytest.raises(ValueError, match="^table: "):
        segment_softmax.check_table(table, 2)


def test_segment_softmax_packed_table_views_are_accepted():
    """A row slice of a packed table still starts on 8 bytes and passes."""
    table = torch.zeros(5, 3, 2)
    for t in (table, table[1:], table[2:4]):
        segment_softmax.check_table(t, 3)


def _jax_tables(scores, seg, n):
    """The reference's two separate (N, D) tables, in float32: the
    segment max (0 where empty) and the sum of exp(scores - max)."""
    x = jnp.asarray(scores, jnp.float32)
    s = jnp.asarray(seg)
    mx = jax.ops.segment_max(x, s, n)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
    den = jax.ops.segment_sum(jnp.exp(x - mx[jnp.clip(s, 0, n - 1)]), s, n)
    return np.asarray(mx), np.asarray(den)


@pytest.mark.parametrize("case", ["empty_segments", "out_of_range", "unsorted",
                                  "ragged", "one_edge"])
@pytest.mark.parametrize("d", [1, 4])
def test_packed_segment_table_equals_the_two_tables(case, d):
    """``ref.segment_tables`` fills one (N, D, 2) table: slot 0 equals the
    reference's segment max exactly, slot 1 its segment sum (float32
    sums, 1e-6), with empty segments 0 and out-of-range ids dropped."""
    scores, seg, n = _softmax_case(case, np.random.default_rng(23 + d))
    scores = np.ascontiguousarray(
        np.resize(scores, (scores.shape[0], d)), np.float32)
    seg = seg.astype(np.int32)
    table = ref.segment_tables(torch.from_numpy(scores), torch.from_numpy(seg), n)
    assert table.shape == (n, d, 2) and table.dtype == torch.float32
    assert table.is_contiguous() and table.data_ptr() % 8 == 0
    mx, den = _jax_tables(scores, seg, n)
    np.testing.assert_array_equal(table[..., 0].numpy(), mx)
    np.testing.assert_allclose(table[..., 1].numpy(), den, rtol=1e-6, atol=1e-6)
    if case == "empty_segments":
        assert (table[1::3] == 0).all() and (table[2::3] == 0).all()


@pytest.mark.parametrize("dtype", sorted(_SOFTMAX_DTYPES))
@pytest.mark.parametrize("e,d,n", [(512, 1, 16), (1024, 8, 64), (2048, 4, 100),
                                   (1000, 5, 30)])
def test_segment_normalize_on_packed_table_equals_jax(dtype, e, d, n):
    """The plain normalize pass reading the packed table against the
    reference's normalize formula on its own two tables, at the reference
    test's shapes and a ragged E."""
    t_dtype, j_dtype, tol = _SOFTMAX_DTYPES[dtype]
    rng = np.random.default_rng(e * 3 + d + n)
    scores = np.array(jnp.asarray(rng.normal(0, 3, (e, d)), j_dtype), np.float32)
    seg = rng.integers(-2, n + 2, e).astype(np.int32)
    x = torch.from_numpy(scores).to(t_dtype)
    table = ref.segment_tables(x, torch.from_numpy(seg), n)
    got = ref.segment_normalize(x, torch.from_numpy(seg), table)
    mx, den = _jax_tables(scores, seg, n)
    s = np.clip(seg, 0, n - 1)
    exp = np.exp(scores - mx[s]) / (den[s] + np.float32(1e-9))
    assert got.dtype == t_dtype and got.shape == (e, d)
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("n_hay,path,shared_bytes", [
    (0, "global", 0), (1, "global", 0), (7, "global", 0),
    (32, "global", 0),  # one 128-byte L1 line: searched in place
    (33, "shared", 132), (256, "shared", 1024), (1000, "shared", 4000),
    (4096, "shared", 16_384), (4097, "shared", 16_388),
    (6144, "shared", 24_576),  # the whole budget
    (6145, "global", 0), (12_288, "global", 0), (58_112, "global", 0),
    (100_000, "global", 0), (1 << 20, "global", 0)])
def test_sorted_member_mask_launch_plan(n_hay, path, shared_bytes):
    """A haystack that fits the budget is staged in 4 bytes an id of
    shared memory; a larger one, or one within a single 128-byte line, is
    searched in device memory by the same kernel."""
    assert sorted_intersect.launch_plan(n_hay) == (path, shared_bytes)
    assert shared_bytes <= sorted_intersect.SHARED_BUDGET == 24 * 1024

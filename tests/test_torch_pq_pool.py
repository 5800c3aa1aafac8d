"""The compressed sweep's coarse pool (ops/pq_sweep._pq_pool, the JAX
package's _pq_pool_impl) on the CPU: the kernel's plain twin
_pq_pool_plain against the JAX function at the pool level, before any
rerank; the PQ instance's element rule and its staged code windows
rendered in torch, and its Manhattan sum's order; the instance's shared
memory and launch shape; the wrapper's routing by device and metric.

Data: integer codebooks whose 256 centroids in a group are signed
permutations of 1 .. sub, so every decoded row has the same norm, and
integer queries (OPQ: a signed permutation).  Every score is then exact
in float32 in both packages, rows with equal products tie exactly (the
lower id first in both), and unequal cosines lie ~1e-4 apart, far past
either package's rsqrt: ids are held equal, distances at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_embedding_tpu.ops.pq_sweep import _pq_pool_impl as jax_pool
from pg_embedding_tpu_torch.ops import cuda_bruteforce as cb
from pg_embedding_tpu_torch.ops import pq_sweep
from pg_embedding_tpu_torch.ops.pq import pq_decode

N, B = 3000, 16
# rows past n_valid inside the last 128-row tile; a chunk that does not
# divide N
N_VALID, CHUNK = N - 37, 1024
METRICS = {"l2": 0, "cosine": 1, "manhattan": 2}
# (G, D): sub = 16, 8 and 6 (6 does not divide the kernel's 32-dim chunk)
GROUPS = {4: 64, 8: 64, 12: 72}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and test files running side by side do not oversubscribe the
    cores.  The count is restored for whatever runs next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def equal_norm_case(seed, groups, dims, n=N, b=B):
    """(codes u8[n, G], codebook f32[G, 256, sub], queries f32[b, D],
    signed permutation f32[D, D], tombstones bool[n]): each centroid a
    signed permutation of 1 .. sub, queries integers in [-4, 4]."""
    rng = np.random.default_rng(seed)
    sub = dims // groups
    base = np.arange(1, sub + 1, dtype=np.float32)
    book = np.stack([[rng.permutation(base) * rng.choice([-1, 1], sub)
                      for _ in range(256)] for _ in range(groups)])
    codes = rng.integers(0, 256, size=(n, groups)).astype(np.uint8)
    qs = rng.integers(-4, 5, size=(b, dims)).astype(np.float32)
    rot = np.zeros((dims, dims), np.float32)
    rot[np.arange(dims), rng.permutation(dims)] = rng.choice([-1, 1], dims)
    dead = rng.random(n) < 0.05
    return codes, book.astype(np.float32), qs, rot, dead


@pytest.mark.parametrize("pool", [16, 64, 256, 1024])
@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_pool_plain_matches_jax(metric, groups, pool):
    """_pq_pool_plain against the JAX _pq_pool_impl on the same inputs,
    rows past n_valid and tombstones masked, a chunk that does not divide
    N (the JAX function takes codes padded to whole chunks), OPQ's rotation
    for L2 and cosine at pools 64 and 1024: ids equal, distances at rtol
    1e-5."""
    dims = GROUPS[groups]
    codes, book, qs, rot, dead = equal_norm_case(pool + groups, groups, dims)
    rotation = rot if metric != "manhattan" and pool in (64, 1024) else None
    n_pad = -(-N // CHUNK) * CHUNK
    jd, ji = jax_pool(
        jnp.asarray(qs), jnp.asarray(np.pad(codes, ((0, n_pad - N), (0, 0)))),
        jnp.asarray(book), None if rotation is None else jnp.asarray(rotation),
        jnp.asarray(N_VALID, jnp.int32), jnp.asarray(np.pad(dead,
                                                            (0, n_pad - N))),
        pool=pool, metric_value=METRICS[metric], chunk=CHUNK)
    td, ti = pq_sweep._pq_pool_plain(
        torch.from_numpy(qs), torch.from_numpy(codes), torch.from_numpy(book),
        None if rotation is None else torch.from_numpy(rotation), N_VALID,
        torch.from_numpy(dead), pool=pool, metric_value=METRICS[metric],
        chunk=CHUNK)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    live = ~dead[:N_VALID]
    assert (ti.numpy() >= 0).all() and live[ti.numpy()].all()


# (D, G) of the element rule and the staged windows: sub dividing 32 or
# not, G % 4 != 0 (byte loads), D % 32 != 0 (a chunk past D), sub = 1
RENDER_SHAPES = [(128, 32), (128, 16), (96, 12), (96, 32), (72, 12),
                 (30, 6), (960, 32), (64, 64), (100, 25), (45, 9)]


@pytest.mark.parametrize("dims,groups", RENDER_SHAPES)
def test_element_rule_is_the_bf16_decode(dims, groups):
    """The kernel's element (r, d): the codebook table (pq_table, rounded
    once to bf16, in pairs) at pair d // 2, the code of group d // sub,
    half d % 2; rendered as the kernel stages it, a 32-dim chunk at a
    time: the row's code bytes [w0, g_end) with w0 = d0 // sub rounded
    down to a word (at most 36 bytes in whole words, inside the 48-byte
    stage row and, when G % 4 == 0, inside the row), each dim's offset d //
    sub - w0.  Equals
    pq_decode(codes, codebook).to(bfloat16) bit for bit, on a normal
    codebook (ties to even included)."""
    rng = np.random.default_rng(dims + groups)
    n, sub = 300, dims // groups
    book = torch.from_numpy(rng.normal(size=(groups, 256, sub))
                            .astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, groups))
                             .astype(np.uint8))
    table = cb.pq_table(book)
    assert table.dtype == torch.bfloat16
    assert table.shape == (-(-dims // 2), 256, 2)
    if dims % 2:
        assert not table[-1, :, 1].any()
    rendered = torch.zeros((n, dims), dtype=torch.bfloat16)
    for d0 in range(0, dims, 32):
        w0 = (d0 // sub) & ~3
        g_end = min(groups, (min(d0 + 32, dims) - 1) // sub + 1)
        assert 1 <= g_end - w0 <= 35
        if groups % 4 == 0:
            assert w0 + 4 * -(-(g_end - w0) // 4) <= groups
        window = codes[:, w0:g_end].long()
        for dl in range(min(32, dims - d0)):
            offset = (d0 + dl) // sub - w0
            assert 0 <= offset < g_end - w0
            d = d0 + dl
            rendered[:, d] = table[d // 2, window[:, offset], d % 2]
    want = pq_decode(codes, book).to(torch.bfloat16)
    assert torch.equal(rendered.view(torch.int16), want.view(torch.int16))


def _l1_schedule(qs, rows, n_valid, dead, pool):
    """The PQ instance's Manhattan pool rendered in torch: every (query,
    row) score summed over the dims in ascending order in float32, each
    difference and sum rounded on its own (l1_chunk, a 32-dim step at a
    time, dims past D zero on both sides), over the decoded bf16 rows;
    rows >= n_valid and tombstones +inf; the ``pool`` least by (score,
    id)."""
    dims = qs.shape[1]
    width = 32 * -(-dims // 32)
    q = torch.nn.functional.pad(qs, (0, width - dims))
    p = torch.nn.functional.pad(rows.float(), (0, width - dims))
    acc = torch.zeros((q.shape[0], p.shape[0]), dtype=torch.float32)
    for d in range(width):
        acc = acc + (q[:, d, None] - p[None, :, d]).abs()
    mask = torch.arange(p.shape[0]) >= n_valid
    if dead is not None:
        mask |= dead
    acc[:, mask] = float("inf")
    # a stable sort of the scores keeps the lower id first among equals
    order = torch.sort(acc, dim=1, stable=True).indices[:, :pool]
    return torch.gather(acc, 1, order), order.to(torch.int32)


@pytest.mark.parametrize("dims,groups", [(64, 8), (72, 12), (30, 6)])
def test_manhattan_schedule_matches_the_twin(dims, groups):
    """The kernel's Manhattan order of summation (_l1_schedule) against the
    twin's torch.cdist: on the equal-norm integer case bit for bit, ids
    and distances; on normal codebooks and queries distances at rtol 1e-5
    and ids except float64 near-ties (< 1e-5 relative)."""
    codes, book, qs, _, dead = equal_norm_case(dims, groups, dims, n=700,
                                               b=8)
    tc, tb = torch.from_numpy(codes), torch.from_numpy(book)
    n_valid = 700 - 21
    kw = dict(pool=64, metric_value=METRICS["manhattan"], chunk=256)
    rows = pq_decode(tc, tb).to(torch.bfloat16)
    got = _l1_schedule(torch.from_numpy(qs), rows, n_valid,
                       torch.from_numpy(dead), 64)
    want = pq_sweep._pq_pool_plain(torch.from_numpy(qs), tc, tb, None,
                                   n_valid, torch.from_numpy(dead), **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    rng = np.random.default_rng(dims)
    tb = torch.from_numpy(rng.normal(size=book.shape).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=qs.shape).astype(np.float32))
    rows = pq_decode(tc, tb).to(torch.bfloat16)
    got = _l1_schedule(q, rows, n_valid, None, 64)
    want = pq_sweep._pq_pool_plain(q, tc, tb, None, n_valid, None, **kw)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5)
    diff = got[1] != want[1]
    r64, q64 = rows.double(), q.double()

    def d64(ids):
        return (r64[ids.long()] - q64[:, None]).abs().sum(-1)
    a, b = d64(got[1])[diff], d64(want[1])[diff]
    assert bool(((a - b).abs() <= 1e-5 * b).all())


def _c_pq_smem_bytes(qt, k_run, dims, q_res):
    """sweep_smem_bytes<uint8_t> of csrc/bruteforce_topk.cu for PQ codes,
    term by term: two ring stages of [128 x 48] code bytes, the table's
    [16 x 256] chunk of bf16 pairs and 32 offset bytes (+ a [QT x 36]
    float32 query chunk when queries stream), the resident [QT x (32
    ceil(D / 32) + 4)] queries, the score tile ([QT x 136] floats, at least the decoded bf16
    [128 x 40] tile), |q|^2, |p|^2 and the [QT x k_run] (score, id)
    lists."""
    stage = 128 * 48 + 32 * 256 * 2 + 32 + (0 if q_res else qt * 36 * 4)
    q_stride = 32 * -(-dims // 32) + 4
    scores = max(qt * 136, 128 * 40 // 2)
    return (2 * stage + 4 * ((qt * q_stride if q_res else 0) + scores + qt
                             + 128) + 8 * qt * k_run)


@pytest.mark.parametrize("dims", [64, 128, 960])
def test_pq_smem_bytes_and_launch_shape(dims):
    """_smem_bytes(pq=True) against the C formula, and _launch_shape's
    figure within SMEM_LIMIT at every pool tier (the wide selection's QT =
    64 up to 256, QT = 16 to 1024); at phase 8's pool of 32 and D = 128
    two blocks share an SM, with the queries streamed."""
    src = open(cb.__file__.replace("ops/cuda_bruteforce.py",
                                   "csrc/bruteforce_topk.cu")).read()
    assert "return std::is_same<T, uint8_t>::value;" in src
    assert ": pq_rows<T>() ? kTableBytes + kOffsetBytes : 0;" in src
    for qt in (64, 16):
        for k_run in (1, 32, 256, 1024):
            for q_res in (True, False):
                assert cb._smem_bytes(qt, k_run, 1, dims, q_res, True) == (
                    _c_pq_smem_bytes(qt, k_run, dims, q_res))
    for k_run in (1, 16, 32, 64, 256, 257, 512, 1024):
        qt, splits, q_res, smem = cb._launch_shape(1024, 1_000_000, k_run,
                                                   132, 1, dims, pq=True)
        assert qt == (64 if k_run <= 256 else 16) and 1 <= splits <= 128
        assert smem == cb._smem_bytes(qt, k_run, 1, dims, q_res, True)
        assert smem <= cb.SMEM_LIMIT
    if dims == 128:
        qt, _, q_res, smem = cb._launch_shape(1024, 1_000_000, 32, 132, 1,
                                              128, pq=True)
        assert (qt, q_res) == (64, False) and cb._blocks_per_sm(smem) == 2


def test_pq_entry_and_instance():
    """uint8 codes take bruteforce_topk_pq with the shared bound at every
    pool (the wide selection up to WIDE_MAX_K, the insertion into shared
    memory past it); its launches are counted under its name."""
    u8 = torch.uint8
    assert cb._instance(u8, 32) == ("bruteforce_topk_pq", True)
    assert cb._instance(u8, 256) == ("bruteforce_topk_pq", True)
    assert cb._instance(u8, 257) == ("bruteforce_topk_pq", True)
    assert cb._instance(u8, 1024) == ("bruteforce_topk_pq", True)
    name, scratch, args = cb._entry(u8, 64, 5, 33, "cpu")
    assert name == "bruteforce_topk_pq" and scratch.shape == (5, 33)
    assert args == (scratch.data_ptr(), 2)
    name, scratch, args = cb._entry(u8, 1024, 5, 33, "cpu")
    assert scratch.shape == (5, 33) and args == (scratch.data_ptr(), 32)
    assert "bruteforce_topk_pq" in cb.LAUNCHES


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_routing_on_the_cpu(metric):
    """A CPU tensor runs the twin (the same pool) and launches nothing,
    Manhattan included; a meta tensor raises, whatever the metric;
    pq_topk takes CUDA tensors only, every metric (Manhattan too)."""
    codes, book, qs, _, dead = equal_norm_case(7, 8, 64, n=500, b=4)
    args = [torch.from_numpy(a) for a in (qs, codes, book)]
    kw = dict(pool=32, metric_value=METRICS[metric], chunk=128)
    before = dict(cb.LAUNCHES)
    got = pq_sweep._pq_pool(*args, None, 480, torch.from_numpy(dead), **kw)
    want = pq_sweep._pq_pool_plain(*args, None, 480, torch.from_numpy(dead),
                                   **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cb.LAUNCHES == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pq_sweep._pq_pool(*meta, None, 480, None, **kw)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cb.pq_topk(args[0], args[1], cb.pq_table(args[2]), 32,
                   METRICS[metric], 480)
    with pytest.raises(ValueError, match="or Manhattan, not metric 3"):
        cb.pq_topk(args[0], args[1], cb.pq_table(args[2]), 32, 3, 480)

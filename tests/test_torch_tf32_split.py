"""The exact-sweep kernel's 3xTF32 arithmetic, emulated in numpy.

csrc/bruteforce_topk.cu scores on the tensor cores: each operand is split
as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and TF32 mma.sync adds
lo.hi + hi.lo + hi.hi per 8-dim step into a float32 accumulator (a bf16 row
is exact in TF32: lo_q.p + hi_q.p).  cvt.rna keeps 10 mantissa bits,
rounding to nearest with ties away from zero: on the float32 bits that is
(bits + 0x1000) & ~0x1fff.  The emulation multiplies the TF32 values
exactly and sums in float32, as the mma does.

The bar is chip_smoke.py's kernel check, rtol 1e-5 on L2 distances (the
Pallas kernel's bf16x3 split is ~2^-18).  Three passes meet it on
bench.py's clustered recipe and at 960-d; one TF32 pass does not."""

import numpy as np
import pytest
import torch

RTOL = 1e-5


def tf32(x):
    """cvt.rna.tf32.f32 on float32 values."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def sweep_dot(q, p, passes):
    """q.p as the kernel's mma steps compute it: 8 dims at a time, each
    step's exact TF32 products added into a float32 accumulator."""
    qh, ql = split(q)
    ph, pl = split(p)
    terms = {1: [(qh, ph)], 2: [(ql, ph), (qh, ph)],
             3: [(ql, ph), (qh, pl), (qh, ph)]}[passes]
    acc = np.zeros((len(q), len(p)), np.float32)
    for k0 in range(0, q.shape[1], 8):
        for a, b in terms:
            a8 = a[:, k0:k0 + 8].astype(np.float64)
            b8 = b[:, k0:k0 + 8].astype(np.float64)
            acc += (a8 @ b8.T).astype(np.float32)     # 8 exact products
    return acc


def l2_rel_err(q, p, passes):
    """Largest relative error of the kernel's L2 distance, max(|p|^2 + |q|^2
    - 2 q.p, 0) sqrt'd, against float64 (passes=0: a float32 matmul)."""
    dot = sweep_dot(q, p, passes) if passes else q @ p.T
    qn = np.sum(q * q, axis=1, dtype=np.float32)[:, None]
    pn = np.sum(p * p, axis=1, dtype=np.float32)[None, :]
    d = np.sqrt(np.maximum(pn + qn - np.float32(2) * dot, 0))
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    ref = np.sqrt(np.maximum((q64 * q64).sum(1)[:, None]
                             + (p64 * p64).sum(1)[None, :]
                             - 2 * q64 @ p64.T, 0))
    return float(np.max(np.abs(d - ref) / ref))


def clustered(n, n_queries, dims=128, seed=0):
    """bench.py's recipe: 1000 centres at scale 4, unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(1000, dims)).astype(np.float32)
    pts = centers[rng.integers(0, 1000, n)] + rng.normal(
        size=(n, dims)).astype(np.float32)
    qs = centers[rng.integers(0, 1000, n_queries)] + rng.normal(
        size=(n_queries, dims)).astype(np.float32)
    return pts.astype(np.float32), qs.astype(np.float32)


def test_cvt_rna_rounds_to_10_mantissa_bits():
    rng = np.random.default_rng(1)
    x = rng.normal(size=10_000).astype(np.float32) * np.float32(1e3)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(hi - x) <= np.abs(x) * 2.0 ** -11)
    # hi + lo keeps 22 of float32's 24 bits
    assert np.all(np.abs(hi.astype(np.float64) + lo - x)
                  <= np.abs(x) * 2.0 ** -21)
    # ties round away from zero: 1 + 2^-11 is halfway between TF32 values
    tie = np.float32(1 + 2.0 ** -11)
    assert tf32(np.array([tie, -tie]))[0] == np.float32(1 + 2.0 ** -10)
    assert tf32(np.array([-tie]))[0] == -np.float32(1 + 2.0 ** -10)


@pytest.mark.parametrize("case", ["clustered-128", "randn-960"])
def test_three_passes_meet_the_kernel_check(case):
    if case == "clustered-128":
        p, q = clustered(4000, 128)
    else:
        rng = np.random.default_rng(2)
        p = rng.normal(size=(1500, 960)).astype(np.float32)
        q = rng.normal(size=(32, 960)).astype(np.float32)
    err = l2_rel_err(q, p, 3)
    assert err < RTOL, err
    assert err <= 2 * l2_rel_err(q, p, 0)       # as exact as float32


def test_one_pass_misses_the_kernel_check():
    p, q = clustered(4000, 128)
    assert l2_rel_err(q, p, 1) > 10 * RTOL


def test_bf16_rows_need_two_passes():
    """A bf16 row is exact in TF32, so p_lo is 0 and lo_q.p + hi_q.p is
    the whole product."""
    p, q = clustered(4000, 128, seed=3)
    p = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
    assert np.array_equal(tf32(p), p)
    assert l2_rel_err(q, p, 2) < RTOL
    assert l2_rel_err(q, p, 1) > 10 * RTOL

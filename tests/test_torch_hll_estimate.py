"""The port's HLL register reduction (B8) and estimator held against the
JAX package on identical numpy-seeded registers.

On the CPU `veneur_tpu_torch.ops.hll_estimate.register_moments` runs its
plain PyTorch version, the arithmetic the CUDA kernel is held to on the
card (`chip_smoke.py`).

Tolerances:
  * zero-register counts: exact (integer counts below 2^24).
  * the sum of 2^-r and the estimates: rtol 1e-6.  Every term is a
    power of two, but XLA, the Pallas kernel and PyTorch add them in
    different orders, which moves the last ulps of the sum (and, past
    the estimator tail's division, of the estimate before its floor).
  * accuracy against the true cardinality: 2%, the standard HLL error
    bound (~1.04/sqrt(m)) at p = 14 with margin, as tests/test_ops.py.
  * a numpy model of the CUDA kernel's summation order (`_b8_model`,
    the order depends on m alone): the same rules as the plain version
    against the Pallas kernel, and against the plain version also on
    rows of denormal terms, which the JAX package's CPU run flushes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from veneur_tpu.ops import hll_estimate as jhe
from veneur_tpu.sketches import hll as jhll
from veneur_tpu_torch.ops import hll_estimate as he
from veneur_tpu_torch.sketches import hll


def _registers(s, p, rng):
    """`[s, 2^p]` registers of rows with 10..30000 random members."""
    m = 1 << p
    regs = np.zeros((s, m), np.uint8)
    for row in range(s):
        n = int(rng.integers(10, 30000))
        hs = rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + 1
        idx, rank = jhll.split_hashes(hs.astype(np.uint64), p)
        np.maximum.at(regs, (np.full(n, row), idx), rank)
    return regs


@pytest.mark.parametrize("s,p", [(5, 14), (16, 11)])
def test_register_moments_plain_matches_pallas(s, p):
    regs = _registers(s, p, np.random.default_rng(11 + p))
    got = he.register_moments(torch.from_numpy(regs)).numpy()
    want = np.asarray(jhe.register_moments(jnp.asarray(regs),
                                           interpret=True))
    assert got.shape == want.shape == (s, 2)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 0], (regs == 0).sum(1))


@pytest.mark.parametrize("s,p", [(5, 14), (16, 11)])
def test_estimate_matches_pallas_and_xla(s, p):
    regs = _registers(s, p, np.random.default_rng(11 + p))
    t = torch.from_numpy(regs)
    got = he.estimate(t).numpy()
    pallas = np.asarray(jhe.estimate(jnp.asarray(regs), interpret=True))
    xla = np.asarray(jhll.estimate(jnp.asarray(regs)))
    np.testing.assert_allclose(got, pallas, rtol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6)
    # the plain tensor estimate is the same function
    np.testing.assert_allclose(hll.estimate(t).numpy(), xla, rtol=1e-6)


def test_estimate_accuracy():
    p, m = 14, 1 << 14
    regs = np.zeros((3, m), np.uint8)
    truth = [1000, 50_000, 400_000]
    for row, n in enumerate(truth):
        members = [b"row%d-%d" % (row, i) for i in range(n)]
        idx, rank = hll.hash_batch(members, p)
        np.maximum.at(regs, (np.full(n, row), idx), rank)
    est = he.estimate(torch.from_numpy(regs)).numpy()
    for row, n in enumerate(truth):
        assert abs(est[row] - n) / n < 0.02, (row, est[row], n)


def test_union_is_the_register_max():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 20, (4, 64), dtype=np.uint8)
    b = rng.integers(0, 20, (4, 64), dtype=np.uint8)
    got = hll.union(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jhll.union(jnp.asarray(a), jnp.asarray(b))))


def test_cpu_tensors_never_count_a_launch_and_bad_inputs_raise():
    he.reset_launches()
    he.register_moments(torch.zeros((2, 16), dtype=torch.uint8))
    assert he.launches == {"register_moments": 0}
    with pytest.raises(ValueError, match="uint8"):
        he.register_moments(torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        he.register_moments(torch.zeros((2, 16), dtype=torch.uint8,
                                        device="meta"))


# ---------------------------------------------------------------------------
# a numpy model of B8's kernel (ops/csrc/hll_estimate.cu): a warp a row
# ---------------------------------------------------------------------------

def _b8_model(regs):
    """B8's sum of 2^-r in the kernel's order, float32: lane l of 32
    takes the row's 16-byte quads l, l + 32, ...; each quad's word k
    (bytes 4k .. 4k + 3, a byte past the row adding 0) sums as (t0 + t1)
    + (t2 + t3) into the lane's accumulator k, quad after quad; the
    lane's total is (a0 + a1) + (a2 + a3), then an xor butterfly over
    the lanes (o = 16, 8, 4, 2, 1).  2^-r is exact in float32 for every
    byte: normal to r = 126, denormal to 149, then 0.  -> [S, 2] (zero
    count, sum)."""
    f = np.float32
    s, m = regs.shape
    quads = -(-m // 16)
    per = -(-quads // 32)                    # quads a lane
    r = np.zeros((s, 32 * per * 16), np.int64)
    r[:, :m] = regs
    t = np.ldexp(f(1.0), -r).astype(f)
    t[:, m:] = 0.0
    t = t.reshape(s, per, 32, 4, 4)          # [row, j, lane, word, byte]
    words = (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])
    acc = np.zeros((s, 32, 4), f)
    for j in range(per):
        acc = acc + words[:, j]
    lane = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[:, np.arange(32) ^ o]
    return np.stack([(regs == 0).sum(1).astype(f), lane[:, 0]], axis=1)


def _b8_rows(kind, s, m, rng):
    if kind == "geometric":
        p = max(4, (m - 1).bit_length())
        return np.ascontiguousarray(_registers(s, p, rng)[:, :m])
    return rng.integers(0, 256, (s, m)).astype(np.uint8)


@pytest.mark.parametrize("kind,s,m", [("geometric", 5, 1 << 14),
                                      ("bytes 0-255", 8, 2048),
                                      ("bytes 0-255", 6, 100),
                                      ("geometric", 7, 1000)])
def test_b8_kernel_order_matches_pallas(kind, s, m):
    """The kernel's order against the JAX package's kernel (interpret
    mode) and the plain version: zero counts exact, sums within rtol
    1e-6, on hashed rows and on bytes up to 255 (2^-r past r = 126 is
    denormal, and 0 from 150), at m a multiple of 16 or not."""
    regs = _b8_rows(kind, s, m, np.random.default_rng(m + s))
    got = _b8_model(regs)
    want = np.asarray(jhe.register_moments(jnp.asarray(regs),
                                           interpret=True))
    plain = he.register_moments_plain(torch.from_numpy(regs)).numpy()
    for ref in (want, plain):
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
        np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-6)


def test_b8_kernel_order_keeps_denormal_terms():
    """Rows of registers 127..255 sum denormal terms alone: the model
    holds the plain version's zero counts exactly and its sums within
    rtol 1e-6 (past 2^-126 the partial sums are normal and round), and
    rows of 150..255 sum to 0 in both.  The JAX package on the CPU
    flushes denormals, so it reads 0 for either."""
    rng = np.random.default_rng(7)
    regs = np.concatenate([rng.integers(127, 256, (3, 2048)),
                           rng.integers(150, 256, (2, 2048))]).astype(
                               np.uint8)
    got = _b8_model(regs)
    plain = he.register_moments_plain(torch.from_numpy(regs)).numpy()
    np.testing.assert_array_equal(got[:, 0], plain[:, 0])
    np.testing.assert_allclose(got[:, 1], plain[:, 1], rtol=1e-6)
    assert (got[:3, 1] > 0).all() and (got[3:, 1] == 0).all()
    want = np.asarray(jhe.register_moments(jnp.asarray(regs),
                                           interpret=True))
    np.testing.assert_array_equal(want[:, 1], 0.0)

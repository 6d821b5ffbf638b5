"""The 3xTF32 numerics of the port's tensor-core kernels, modelled on
the CPU: each f32 operand is split as big = tf32(x), small = tf32(x -
big) with ``cvt.rna``'s rounding (to nearest, ties away from zero, on
the 13 low mantissa bits; a NaN becomes the canonical NaN), and a
product is small.big + big.small + big.big, three ``mma.sync`` passes
per 8-deep k-step, as ``csrc/mma_tf32.cuh`` computes it. Each ``mma``
is modelled as the tensor cores return it: its exact sum added to the
accumulator and rounded toward zero. The kernels' summation order is
kept where it matters for that truncation: attention's scores fresh
for every key tile and each tile's p.v in a fresh fragment added to
the output in f32 (to nearest); the grouped matmul's 32-deep stages
in fresh partial sums added to the total in f32.

At the paths' widths (attention head dims 64, 80 and 128 over 511 and
512 tokens and over 4096; the grouped matmul's d 8192 and 24576), with
batch and heads cut, the model of the kernels' design stays within
their unchanged f32 tolerances of the plain versions (2e-5 and 2e-4),
while one TF32 pass does not, and neither does one accumulator for a
whole row or a whole depth where the row or depth is long. The model
is of the design, not of the compiled kernels, which only the card
runs: ``chip_smoke.py`` holds those at the same shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref  # noqa: E402

STAGE = 32          # the grouped matmul's d stage (f32)


def _round(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding the 13
    dropped ones to nearest with ties away from zero (a carry into the
    exponent is the right result); a NaN becomes the canonical NaN."""
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), nan, _round(x))


# the largest f32 that does not round up to inf as TF32
_BELOW_INF = torch.tensor(0x7F7FEFFF, dtype=torch.int32).view(torch.float32)


def _truncate(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, truncate: bool = True):
    """big and small as the grouped matmul and attention's p.v split
    (``split_finite``, and ``split<true>`` for a stage that holds a NaN,
    an inf or a value that rounds to inf; the two agree on every other
    x): big from x clamped below the values that round to inf (an inf x
    gets the largest finite TF32 as big and inf as small; a NaN the
    canonical NaN), small skipping the NaN test (x - big is NaN only
    where x is NaN), and truncated, not rounded, for a clamped x
    (``truncate=False``: rounded, as before; big + small can then reach
    2^128). Attention's q.k split (``split<false>``) is the same for
    finite x below FLT_MAX's last half TF32 ulp."""
    big = tf32(torch.clamp(x, -_BELOW_INF, _BELOW_INF))
    big = torch.where(torch.isnan(x), tf32(x), big)
    rest = x - big
    clamped = torch.isinf(tf32(x)) & ~torch.isnan(x)
    if truncate:
        return big, torch.where(clamped, _truncate(rest), _round(rest))
    return big, _round(rest)


def split_rounded(x: torch.Tensor):
    """The clamped split with a clamped x's small part rounded."""
    return split(x, truncate=False)


def split_unclamped(x: torch.Tensor):
    """Attention's split (``split<false>``): an inf x gives big = inf,
    small = -0."""
    big = tf32(x)
    return big, _round(x - big)


def _toward_zero(d: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero; a sum past FLT_MAX comes out inf,
    as the card's tensor cores return it."""
    y = d.to(torch.float32)
    over = (y.double().abs() > d.abs()) & torch.isfinite(y)
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c + a @ b for a (m, 8) and b (8, n) of TF32 values, as the tensor
    cores return it: the exact sum, rounded toward zero to f32."""
    return _toward_zero(c.double() + a.double() @ b.double())


def dot(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        passes: int = 3, splitter=split) -> torch.Tensor:
    """c + a @ b through one accumulator, 8-deep k-steps of ``mma``: the
    3xTF32 split (the small terms first), or one TF32 pass."""
    for k0 in range(0, a.shape[1], 8):
        ak, bk = a[:, k0:k0 + 8], b[k0:k0 + 8]
        if passes == 1:
            c = mma(c, tf32(ak), tf32(bk))
            continue
        ab, as_ = splitter(ak)
        bb, bs = splitter(bk)
        c = mma(mma(mma(c, as_, bb), ab, bs), ab, bb)
    return c


def gmm(x: torch.Tensor, w: torch.Tensor, stage: int | None = STAGE,
        passes: int = 3) -> torch.Tensor:
    """x (c, d) @ w (d, f) as ``gmm_mma_kernel`` sums it: each ``stage``
    of d into a fresh partial added to the total in f32; ``stage=None``
    sums the whole depth into one accumulator."""
    zero = torch.zeros((x.shape[0], w.shape[1]))
    if stage is None:
        return dot(zero, x, w, passes)
    total = zero
    for k0 in range(0, x.shape[1], stage):
        total = total + dot(zero, x[:, k0:k0 + stage], w[k0:k0 + stage],
                            passes)
    return total


def attention(q, k, v, causal=True, window=0, q0=0, fresh=True, passes=3,
              pv_split=split):
    """``attention_mma_kernel`` on rows q0.. of one head: q (sq, dh)
    scaled in f32 before the split, key tiles of BK (32 for dh 128, else
    64) with scores fresh for each, masked scores at -1e30 (-inf past
    sk), the online softmax, each tile's p.v in a fresh fragment added
    in f32 (``fresh=False``: into the output's accumulator itself),
    divided by the clamped sum at the end; q.k with the NaN-only split,
    p.v with ``pv_split`` (the kernel's second pass, the one whose output
    an inf in v reaches). Every tile is walked: a tile the kernel skips
    adds exactly 0 where v is finite."""
    sq, dh = q.shape
    sk = k.shape[0]
    bk = 32 if dh > 80 else 64
    pad = -sk % bk
    k = torch.cat([k, torch.zeros((pad, dh))])
    v = torch.cat([v, torch.zeros((pad, dh))])
    s_all = dot(torch.zeros((sq, sk + pad)), q * dh ** -0.5, k.T, passes,
                split_unclamped)
    qi = torch.arange(q0, q0 + sq)[:, None]
    ki = torch.arange(sk + pad)[None, :]
    keep = torch.ones_like(s_all, dtype=torch.bool)
    if causal:
        keep &= qi >= ki
    if window:
        keep &= qi - ki < window
    s_all = torch.where(keep, s_all, torch.tensor(ref.NEG_INF))
    s_all = torch.where(ki < sk, s_all, torch.tensor(-torch.inf))
    m = torch.full((sq, 1), ref.NEG_INF)
    l = torch.zeros((sq, 1))
    acc = torch.zeros((sq, dh))
    for k0 in range(0, sk + pad, bk):
        s = s_all[:, k0:k0 + bk]
        mt = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp(m - mt)
        m = mt
        p = torch.exp(s - mt)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        acc = acc * alpha
        if fresh:
            acc = acc + dot(torch.zeros_like(acc), p, v[k0:k0 + bk], passes,
                            pv_split)
        else:
            acc = dot(acc, p, v[k0:k0 + bk], passes, pv_split)
    return acc / torch.clamp(l, min=1e-30)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(got, want)
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()


def test_tf32_keeps_nan_and_inf():
    """GPU arithmetic's canonical NaN 0x7FFFFFFF, its negative and a NaN
    with only low mantissa bits stay NaN (the plain add and mask would
    carry the first two into -0 and +0 and round the third to inf); inf
    stays inf, and a NaN operand's 3xTF32 product is NaN."""
    x = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7F800000, -8388608],
                     dtype=torch.int32).view(torch.float32)
    plain = _round(x)
    assert not torch.isnan(plain[:3]).any()
    got = tf32(x)
    assert torch.isnan(got[:3]).all()
    assert torch.equal(got[3:], x[3:])
    a = torch.ones((1, 8))
    a[0, 3] = x[0]
    b = torch.randn((8, 2), generator=torch.Generator().manual_seed(0))
    assert torch.isnan(dot(torch.zeros((1, 2)), a, b)).all()


@pytest.mark.parametrize("side", ["a", "b"])
def test_split_carries_inf_and_values_near_max(side):
    """An inf operand, of either sign, times finite ones gives the +-inf
    of the plain f32 product, not NaN; and so does an inf beside a finite
    x within half a TF32 ulp of FLT_MAX, whose own products stay finite
    and agree. The split without the clamp turns them into NaN."""
    g = np.random.default_rng(7)
    a = torch.from_numpy(g.standard_normal((6, 16), np.float32))
    b = torch.from_numpy(g.uniform(-1, 1, (16, 5)).astype(np.float32))
    near_max = torch.tensor([0x7F7FFFFF, 0x7F7FF800],
                            dtype=torch.int32).view(torch.float32)
    a[0, 3], a[1, 12], a[2, 0], a[3, 9] = (torch.inf, -torch.inf,
                                           near_max[0], -near_max[1])
    a[4, 5], a[4, 6] = torch.inf, near_max[1]
    if side == "b":          # the same values as the second operand
        a, b = b.T.contiguous(), a.T.contiguous()
    want = a @ b
    assert torch.isinf(want).any() and torch.isfinite(want).any()
    got = dot(torch.zeros_like(want), a, b)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=2e-5)
    old = dot(torch.zeros_like(want), a, b, splitter=split_unclamped)
    assert torch.isnan(old).any()


def _same_specials(got, want):
    """NaN and +-inf at the same places, and the rest within 2e-5."""
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isinf(), want.isinf())
            and torch.equal(got[want.isinf()], want[want.isinf()])):
        return False
    fin = want.isfinite()
    return torch.allclose(got[fin], want[fin], rtol=2e-5, atol=2e-5)


def test_attention_pv_carries_inf_in_v():
    """An inf in v gives ``attention_ref``'s +-inf (and its NaN, where an
    inf meets one of the other sign) through the clamped split of p.v,
    and a finite v within half a TF32 ulp of FLT_MAX stays finite where
    its key holds the row's top weight, exactly 1; the NaN-only split
    gives NaN for the infs, and the clamped split with a rounded small
    part overflows to inf at that weight (as the card showed)."""
    g = np.random.default_rng(11)
    sq, dh = 96, 64
    q = torch.from_numpy(g.standard_normal((sq, dh), np.float32))
    k, v = (torch.from_numpy(g.standard_normal((sq, dh), np.float32))
            for _ in range(2))
    k[10] = q[0] * 4.0          # key 10: row 0's top weight, p = 1
    near = torch.tensor([0x7F7FFFFF], dtype=torch.int32).view(torch.float32)
    v[10, 0] = near[0]
    v[3, 5], v[70, 7] = torch.inf, -torch.inf
    v[40, 9], v[80, 9] = torch.inf, -torch.inf       # inf - inf: NaN
    want = ref.attention_ref(q[None, None], k[None, None], v[None, None],
                             causal=False)[0, 0]
    assert torch.isinf(want).any() and torch.isnan(want).any()
    assert torch.isfinite(want[:, 0]).all()
    got = attention(q, k, v, causal=False)
    assert _same_specials(got, want)
    assert not _same_specials(
        attention(q, k, v, causal=False, pv_split=split_unclamped), want)
    rounded = attention(q, k, v, causal=False, pv_split=split_rounded)
    assert torch.isinf(rounded[0, 0]) and not _same_specials(rounded, want)


def test_split_keeps_22_bits():
    g = np.random.default_rng(0)
    x = torch.from_numpy(
        (g.standard_normal(100_000) * 10.0 ** g.integers(-6, 6, 100_000))
        .astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    rest = (x.double() - big.double() - small.double()).abs()
    assert (rest <= x.double().abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("dh", [64, 80, 128])
@pytest.mark.parametrize("sq", [511, 512])
def test_attention_3xtf32_within_f32_tolerance(dh, sq):
    """One (batch, head) pair of each path's shape: granite's dh 64 and
    h2o-danube's 80 at 511 tokens, jamba's 128 at 512; causal GQA as on
    the path (two query heads on one kv head)."""
    g = np.random.default_rng(dh + sq)
    q = torch.from_numpy(g.standard_normal((1, 2, sq, dh), np.float32))
    k, v = (torch.from_numpy(g.standard_normal((1, 1, sq, dh), np.float32))
            for _ in range(2))
    want = ref.attention_ref(q, k, v, causal=True)
    for head in range(2):
        got = attention(q[0, head], k[0, 0], v[0, 0])
        torch.testing.assert_close(got, want[0, head], atol=2e-5,
                                   rtol=2e-5)
    one_pass = attention(q[0, 0], k[0, 0], v[0, 0], passes=1)
    assert (one_pass - want[0, 0]).abs().max().item() > 2e-5


def test_attention_3xtf32_window_and_masked_rows():
    """A window ending inside a key tile, and rows that see no key (sq
    past sk + window): the -1e30 scores average v, in both versions."""
    g = np.random.default_rng(3)
    q = torch.from_numpy(g.standard_normal((1, 1, 200, 64), np.float32))
    k, v = (torch.from_numpy(g.standard_normal((1, 1, 40, 64), np.float32))
            for _ in range(2))
    want = ref.attention_ref(q, k, v, causal=False, window=100)
    got = attention(q[0, 0], k[0, 0], v[0, 0], causal=False, window=100)
    torch.testing.assert_close(got, want[0, 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dh", [80, 128])
def test_attention_long_rows_need_fresh_fragments(dh):
    """The last 64 rows of a causal sq = sk = 4096 (h2o-danube's window,
    the longer contexts of granite and jamba), q at 3x its spread so
    that the softmax peaks and the output is of v's size: with each key
    tile's p.v in a fresh fragment the kernel's design stays within
    2e-5; summing all 3 x 4096 / 8 products into one accumulator does
    not."""
    g = np.random.default_rng(dh)
    s, rows = 4096, 64
    q = torch.from_numpy(g.standard_normal((rows, dh), np.float32)) * 3.0
    k, v = (torch.from_numpy(g.standard_normal((s, dh), np.float32))
            for _ in range(2))
    q_full = torch.zeros((1, 1, s, dh))
    q_full[0, 0, s - rows:] = q
    want = ref.attention_ref(q_full, k[None, None], v[None, None],
                             causal=True)[0, 0, s - rows:]
    got = attention(q, k, v, q0=s - rows)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    one_acc = attention(q, k, v, q0=s - rows, fresh=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one_acc, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("c,d", [(17, 8192), (64, 8192), (17, 24576)])
def test_gmm_3xtf32_within_f32_tolerance(c, d):
    """The grouped matmul on the tensor cores (c > 16) at jamba's
    gate/up depth (d 8192) and down depth (24576) on 512 columns, with
    the path's magnitudes (weights of std 1/sqrt(d))."""
    g = np.random.default_rng(c + d)
    f = 512
    x = torch.from_numpy(g.standard_normal((1, c, d), np.float32))
    w = torch.from_numpy(
        (g.standard_normal((1, d, f)) * d ** -0.5).astype(np.float32))
    want = ref.gmm_ref(x, w)
    got = gmm(x[0], w[0])
    torch.testing.assert_close(got, want[0], atol=2e-4, rtol=2e-4)
    one_pass = gmm(x[0], w[0], passes=1)
    assert (one_pass - want[0]).abs().max().item() > 2e-4


def test_gmm_needs_stage_partials():
    """At jamba's down depth (d 24576: 3 x 3,072 products a sum) one
    accumulator for the whole depth leaves 2e-4; the 32-deep stages'
    fresh partials keep the sum within it."""
    g = np.random.default_rng(5)
    c, d, f = 17, 24576, 512
    x = torch.from_numpy(g.standard_normal((1, c, d), np.float32))
    w = torch.from_numpy(
        (g.standard_normal((1, d, f)) * d ** -0.5).astype(np.float32))
    want = ref.gmm_ref(x, w)[0]
    torch.testing.assert_close(gmm(x[0], w[0]), want, atol=2e-4, rtol=2e-4)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(gmm(x[0], w[0], stage=None), want,
                                   atol=2e-4, rtol=2e-4)

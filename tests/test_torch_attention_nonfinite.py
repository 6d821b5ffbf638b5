"""A CPU model of the attention kernel's tensor-core variant
(``csrc/flash_attention.cu``, ``attention_mma_kernel``) with an inf or
a NaN in v, held to ``attention_ref``'s pattern of +-inf and NaN.

The kernel walks, for a query tile of BQ = 64 rows, only the key tiles
of BK keys that some row of it can see (``key_tiles``); BK is 64, or 32
for f32 at a compiled head width above 80. ``attention_ref`` multiplies
a masked key's weight 0 by its v, so an inf or a NaN of v at any key a
row cannot see makes that column NaN in the row. Inside the walked
tiles the kernel does the same; for the skipped ones a fix-up kernel
(``hidden_keys_kernel``) scans each key tile of v and stores NaN in the
columns where the tile holds a non-finite value, in every row of each
query tile that skipped it. The model here is that loop in plain torch:
``attention_ref`` over each query tile's walked keys, plus that rule. With the rule it
reproduces ``attention_ref``'s pattern exactly for causal and windowed
calls with specials at masked keys in skipped tiles, in the diagonal
tile and nowhere; without it, it misses the skipped-tile cases, which
is the fault the fix-up repairs.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.ref import attention_ref  # noqa: E402

BQ = 64
WIDTHS = (16, 32, 64, 80, 128)   # the kernel's compiled head widths


def block_keys(dh: int, dtype=torch.float32) -> int:
    """The .cu's ``MmaTile<DH, T>::kBK`` at the compiled width of dh."""
    width = next(w for w in WIDTHS if w >= dh)
    return 32 if dtype == torch.float32 and width > 80 else 64


def key_tiles(q0, sq, sk, causal, window, bk):
    """The .cu's ``key_tiles``: [t_lo, t_hi) of the query tile at q0."""
    q_last = min(q0 + BQ, sq) - 1
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(sk, q_last + 1) if causal else sk
    if window and max(0, q_last - window + 1) >= hi:
        lo, hi = 0, sk           # the last row sees no key: walk them all
    return lo // bk, -(-hi // bk)


def hidden_masks(v, bk):
    """The fix-up's scan: (b, kvh, key tiles, dh) True where the tile's
    v holds an inf or a NaN in that column."""
    b, kvh, sk, dh = v.shape
    tiles = -(-sk // bk)
    pad = torch.zeros(b, kvh, tiles * bk, dh, dtype=torch.bool)
    pad[:, :, :sk] = ~v.isfinite()
    return pad.reshape(b, kvh, tiles, bk, dh).any(dim=3)


def tiled_attention(q, k, v, causal, window=0, rule=True):
    """The kernel's loop over query tiles and their walked key tiles."""
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    bk = block_keys(dh, q.dtype)
    scale = dh ** -0.5
    n_tiles = -(-sk // bk)
    masks = hidden_masks(v, bk)
    out = torch.empty_like(q)
    qi = torch.arange(sq)[:, None]
    for q0 in range(0, sq, BQ):
        t_lo, t_hi = key_tiles(q0, sq, sk, causal, window, bk)
        k0, k1 = t_lo * bk, min(t_hi * bk, sk)
        rows = slice(q0, q0 + BQ)
        # attention_ref over the walked keys: the same -1e30 mask at the
        # keys' own positions
        s = torch.einsum("bhqd,bhkd->bhqk",
                         q[:, :, rows].float() * scale,
                         k[:, :, k0:k1].float().repeat_interleave(
                             h // kvh, dim=1))
        kp = torch.arange(k0, k1)[None, :]
        seen = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            seen &= qi[rows] >= kp
        if window:
            seen &= qi[rows] - kp < window
        p = torch.softmax(torch.where(seen, s, -1e30), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, k0:k1].float()
                         .repeat_interleave(h // kvh, dim=1))
        if rule:
            skipped = [t for t in range(n_tiles) if t < t_lo or t >= t_hi]
            if skipped:
                cols = masks[:, :, skipped].any(dim=2)     # (b, kvh, dh)
                cols = cols.repeat_interleave(h // kvh, dim=1)
                o = torch.where(cols[:, :, None, :], math.nan, o)
        out[:, :, rows] = o.to(q.dtype)
    return out


def _inputs(sq, sk, dh, specials, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 4, sq, dh, generator=g)
    k = torch.randn(2, 2, sk, dh, generator=g)
    v = torch.randn(2, 2, sk, dh, generator=g)
    for (bb, hh, key, col), val in specials:
        v[bb, hh, key, col] = val
    return q, k, v


INF, NAN = math.inf, math.nan
# (sq, sk, dh, causal, window, specials at (batch, kv head, key, col))
CASES = {
    # causal: keys past every row of the first query tiles, in tiles that
    # those query tiles skip (and others walk)
    "causal_skipped": (200, 200, 16, True, 0, [
        ((0, 0, 150, 3), INF), ((1, 1, 199, 0), -INF),
        ((0, 1, 70, 5), NAN), ((1, 0, 130, 15), INF),
        ((1, 0, 131, 15), -INF)]),
    # causal, BK 32 (f32 at dh 128, compiled at 128 from dh 96)
    "causal_skipped_bk32": (150, 150, 96, True, 0, [
        ((0, 0, 40, 95), INF), ((1, 1, 100, 0), NAN)]),
    # a window: keys before every row of the last query tiles
    "window_skipped": (200, 200, 16, True, 50, [
        ((0, 0, 2, 1), NAN), ((1, 1, 60, 7), -INF)]),
    "window_bidirectional_skipped": (200, 200, 32, False, 40, [
        ((0, 0, 5, 31), INF), ((1, 0, 190, 2), NAN)]),
    # masked keys inside a walked (diagonal) tile only: row 10 cannot see
    # key 20, but the first query tile walks the key tile holding it
    "causal_diagonal": (64, 64, 16, True, 0, [
        ((0, 0, 20, 3), INF), ((1, 1, 63, 9), NAN)]),
    "window_diagonal": (64, 64, 16, True, 16, [((0, 1, 30, 4), -INF)]),
    # no special anywhere
    "causal_finite": (200, 200, 16, True, 0, []),
    "window_finite": (200, 137, 80, True, 33, []),
}
SKIPPED = {name for name in CASES if "skipped" in name}


def _pattern_equal(out, exp):
    inf = exp.isinf()
    return (torch.equal(out.isnan(), exp.isnan())
            and torch.equal(out.isinf(), inf)
            and torch.equal(out[inf], exp[inf]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_with_rule_matches_attention_ref(name):
    sq, sk, dh, causal, window, specials = CASES[name]
    q, k, v = _inputs(sq, sk, dh, specials)
    exp = attention_ref(q, k, v, causal=causal, window=window)
    out = tiled_attention(q, k, v, causal, window)
    assert _pattern_equal(out, exp)
    fin = exp.isfinite()
    torch.testing.assert_close(out[fin], exp[fin], rtol=1e-5, atol=1e-5)
    if specials:
        assert exp.isnan().any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_without_rule_misses_only_skipped_tiles(name):
    """The kernel without the fix-up: the same loop without the rule
    disagrees with ``attention_ref`` exactly where a special sits in a
    key tile some query tile skips (NaN there, finite here)."""
    sq, sk, dh, causal, window, specials = CASES[name]
    q, k, v = _inputs(sq, sk, dh, specials)
    exp = attention_ref(q, k, v, causal=causal, window=window)
    out = tiled_attention(q, k, v, causal, window, rule=False)
    if name in SKIPPED:
        assert not _pattern_equal(out, exp)
        missed = exp.isnan() & out.isfinite()
        assert missed.any()
        assert not (out.isnan() & ~exp.isnan()).any()
    else:
        assert _pattern_equal(out, exp)

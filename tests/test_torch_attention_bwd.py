"""The port's gradients through its zoo kernels, on the CPU.

* The backward kernel's algorithm (``csrc/flash_attention_bwd.cu``),
  written out in torch tile by tile as the two CUDA kernels walk it:
  the row statistics recomputed with an online softmax over the key
  tiles that some row of a query tile can see (all of them where a row
  sees no key), D = rowsum(dO o O), dQ over those key tiles, and dK, dV
  summed over a KV head's query heads and the query tiles that can see a
  key tile. In float64 it must give the plain version's VJP
  (``ref.attention_vjp_ref``) to 1e-12, causal, windowed, GQA, sq != sk,
  and rows that see no key.
* The tensor-core route's algorithm (the same file's
  ``attention_bwd_*_mma_kernel``s), modelled the same way: P from the
  forward's log-sum-exp and D, the dq and the dk / dv walks over the
  tiles the forward's ``key_tiles`` gives, in float64 against the same
  VJP to 1e-12.
* ``torch.autograd.gradcheck`` in float64 of the two
  ``torch.autograd.Function``s (``FlashAttention``, ``MoeGmm``), whose
  CPU path is the plain version in both directions: the wiring of the
  saved tensors, the transposes and the non-tensor arguments.
* Each of the four ``ops`` calls returns a result with a ``grad_fn``
  when its input requires grad (the plain versions on the CPU); the
  wiring of the WKV and scan ``autograd.Function``s (``Rwkv6Wkv``,
  ``SelectiveScan``) that take their gradients through the backward
  kernels on the card, their launches replaced by plain stand-ins.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as twkv  # noqa: E402
from repro_torch.kernels import selective_scan as tssm  # noqa: E402

F64 = torch.float64


def _tile_active(i0, i1, j0, j1, causal, window, sk):
    """The kernels' skip test: query rows [i0, i1) and keys [j0, j1)
    hold a visible pair, or a row of the tile sees no key."""
    lo, hi = i0 - (j1 - 1), (i1 - 1) - j0
    if causal:
        lo = max(lo, 0)
    if window > 0:
        hi = min(hi, window - 1)
    return lo <= hi or (window > 0 and i1 - 1 >= sk + window - 1)


def _visible(qi, ki, causal, window):
    vis = torch.ones(qi.shape[0], ki.shape[1], dtype=torch.bool)
    if causal:
        vis &= ki <= qi
    if window > 0:
        vis &= qi - ki < window
    return vis


def _bwd_model(q, k, v, o, do, causal, window, scale, tile):
    """dq, dk, dv as the two kernels compute them."""
    b, h, sq, _ = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    neg = torch.tensor(-1e30, dtype=q.dtype)
    zero = torch.zeros((), dtype=q.dtype)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    stats = torch.zeros((3, b, h, sq), dtype=q.dtype)
    # kernel 1: a (batch, head) and a query tile a block
    for bi in range(b):
        for hd in range(h):
            kh = hd // g
            for i0 in range(0, sq, tile):
                i1 = min(sq, i0 + tile)
                qs, dout = q[bi, hd, i0:i1] * scale, do[bi, hd, i0:i1]
                dd = (dout * o[bi, hd, i0:i1]).sum(-1)
                qi = torch.arange(i0, i1)[:, None]
                tiles = [(j0, min(sk, j0 + tile))
                         for j0 in range(0, sk, tile)
                         if _tile_active(i0, i1, j0, min(sk, j0 + tile),
                                         causal, window, sk)]
                m = torch.full((i1 - i0,), -math.inf, dtype=q.dtype)
                lsum = torch.zeros(i1 - i0, dtype=q.dtype)
                for j0, j1 in tiles:
                    ki = torch.arange(j0, j1)[None]
                    s = torch.where(_visible(qi, ki, causal, window),
                                    qs @ k[bi, kh, j0:j1].T, neg)
                    mn = torch.maximum(m, s.max(1).values)
                    lsum = lsum * torch.exp(m - mn) \
                        + torch.exp(s - mn[:, None]).sum(1)
                    m = mn
                linv = 1 / lsum
                stats[:, bi, hd, i0:i1] = torch.stack([m, linv, dd])
                acc = torch.zeros(i1 - i0, q.shape[3], dtype=q.dtype)
                for j0, j1 in tiles:
                    ki = torch.arange(j0, j1)[None]
                    vis = _visible(qi, ki, causal, window)
                    p = torch.exp(qs @ k[bi, kh, j0:j1].T - m[:, None]) \
                        * linv[:, None]
                    dp = dout @ v[bi, kh, j0:j1].T
                    acc += torch.where(vis, p * (dp - dd[:, None]),
                                       zero) @ k[bi, kh, j0:j1]
                dq[bi, hd, i0:i1] = acc * scale
    # kernel 2: a (batch, kv head) and a key tile a block
    for bi in range(b):
        for kh in range(kvh):
            for j0 in range(0, sk, tile):
                j1 = min(sk, j0 + tile)
                ki = torch.arange(j0, j1)[None]
                for hd in range(kh * g, (kh + 1) * g):
                    for i0 in range(0, sq, tile):
                        i1 = min(sq, i0 + tile)
                        if not _tile_active(i0, i1, j0, j1, causal, window,
                                            sk):
                            continue
                        qs, dout = q[bi, hd, i0:i1] * scale, \
                            do[bi, hd, i0:i1]
                        m, linv, dd = stats[:, bi, hd, i0:i1, None]
                        vis = _visible(torch.arange(i0, i1)[:, None], ki,
                                       causal, window)
                        s = torch.where(vis, qs @ k[bi, kh, j0:j1].T, neg)
                        p = torch.exp(s - m) * linv
                        dp = dout @ v[bi, kh, j0:j1].T
                        ds = torch.where(vis, p * (dp - dd), zero)
                        dv[bi, kh, j0:j1] += p.T @ dout
                        dk[bi, kh, j0:j1] += ds.T @ qs
    return dq, dk, dv


def _key_tiles(q0, bq, sq, sk, causal, window, bk):
    """The forward's ``key_tiles`` (``csrc/attention_tiles.cuh``): the
    key tiles [lo, hi) of ``bk`` keys that the query tile of ``bq`` rows
    from ``q0`` walks, all of them where its last row sees no key."""
    q_last = min(q0 + bq, sq) - 1
    lo = q0 - window + 1 if window and q0 - window + 1 > 0 else 0
    hi = q_last + 1 if causal and q_last + 1 < sk else sk
    if window and max(q_last - window + 1, 0) >= hi:
        lo, hi = 0, sk
    return lo // bk, -(-hi // bk)


def _mma_bwd_model(q, k, v, do, lse, dd, causal, window, scale, bq, bk,
                   bkv, bqkv):
    """dq, dk, dv as the tensor-core route's two kernels compute them,
    from the forward's ``lse`` and D = rowsum(dO o O): P = exp(S - lse)
    with no statistics pass, and a hidden key's weight 1 / sk in a row
    that sees no key (its lse rounds to -1e30, so exp(S - lse) would give
    1), else 0."""
    b, h, sq, _ = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    zero = torch.zeros((), dtype=q.dtype)

    def weights(hd, bi, kh, i0, i1, j0, j1):
        qi = torch.arange(i0, i1)[:, None]
        ki = torch.arange(j0, j1)[None]
        vis = _visible(qi, ki, causal, window)
        s = (q[bi, hd, i0:i1] * scale) @ k[bi, kh, j0:j1].T
        p = torch.exp(s - lse[bi, hd, i0:i1, None])
        blind = (window > 0) & (qi - (sk - 1) >= window)
        p = torch.where(vis, p, torch.where(blind, 1.0 / sk, zero))
        dp = do[bi, hd, i0:i1] @ v[bi, kh, j0:j1].T
        ds = torch.where(vis, p * (dp - dd[bi, hd, i0:i1, None]), zero)
        return p, ds

    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    # the dq kernel: a (batch, head) and a query tile of bq rows a block,
    # over the key tiles of bk that the query tile walks
    for bi in range(b):
        for hd in range(h):
            for i0 in range(0, sq, bq):
                i1 = min(sq, i0 + bq)
                lo, hi = _key_tiles(i0, bq, sq, sk, causal, window, bk)
                acc = torch.zeros(i1 - i0, q.shape[3], dtype=q.dtype)
                for kt in range(lo, hi):
                    j0, j1 = kt * bk, min(sk, kt * bk + bk)
                    _, ds = weights(hd, bi, hd // g, i0, i1, j0, j1)
                    acc += ds @ k[bi, hd // g, j0:j1]
                dq[bi, hd, i0:i1] = acc * scale
    # the dk / dv kernel: a (batch, query head) and a key tile of bkv
    # keys a block, over the query tiles of bqkv that walk the key tile;
    # then each head's share added over its kv group in order
    parts = torch.zeros((2, b, h) + k.shape[2:], dtype=q.dtype)
    for bi in range(b):
        for hd in range(h):
            for kt in range(-(-sk // bkv)):
                j0, j1 = kt * bkv, min(sk, kt * bkv + bkv)
                for i0 in range(0, sq, bqkv):
                    lo, hi = _key_tiles(i0, bqkv, sq, sk, causal, window,
                                        bkv)
                    if not lo <= kt < hi:
                        continue
                    i1 = min(sq, i0 + bqkv)
                    p, ds = weights(hd, bi, hd // g, i0, i1, j0, j1)
                    parts[1, bi, hd, j0:j1] += p.T @ do[bi, hd, i0:i1]
                    parts[0, bi, hd, j0:j1] += ds.T @ q[bi, hd, i0:i1]
    for j in range(g):
        dk += parts[0, :, j::g] * scale
        dv += parts[1, :, j::g]
    return dq, dk, dv


_BWD_CASES = [
    (1, 4, 2, 37, 37, 8, True, 0, 8),       # GQA 2:1, ragged last tile
    (1, 4, 2, 37, 37, 8, True, 5, 8),       # a window inside a tile
    (2, 2, 1, 30, 20, 4, False, 0, 8),      # bidirectional, sq > sk
    (1, 2, 2, 40, 10, 4, True, 3, 8),       # rows 12.. see no key
    (1, 2, 1, 40, 10, 4, False, 3, 8),      # the same, bidirectional
    (1, 3, 1, 33, 33, 6, False, 7, 16),     # GQA 3:1 with a window
    (1, 2, 2, 17, 33, 5, True, 0, 8),       # sq < sk
    (1, 2, 1, 12, 40, 8, True, 5, 16),      # sq <= 16: one 16-row tile
]


def _bwd_inputs(b, h, kvh, sq, sk, dh, causal, window):
    g = torch.Generator().manual_seed(sq * 100 + sk)
    q = torch.randn(b, h, sq, dh, generator=g, dtype=F64)
    k, v = (torch.randn(b, kvh, sk, dh, generator=g, dtype=F64)
            for _ in range(2))
    do = torch.randn(b, h, sq, dh, generator=g, dtype=F64)
    exp = ref.attention_vjp_ref(q, k, v, do, causal=causal, window=window)
    return q, k, v, do, exp


@pytest.mark.parametrize("b,h,kvh,sq,sk,dh,causal,window,tile", _BWD_CASES)
def test_backward_kernel_algorithm_matches_plain_vjp(b, h, kvh, sq, sk, dh,
                                                     causal, window, tile):
    q, k, v, do, exp = _bwd_inputs(b, h, kvh, sq, sk, dh, causal, window)
    o = ref.attention_ref(q, k, v, causal=causal, window=window)
    got = _bwd_model(q, k, v, o, do, causal, window, dh ** -0.5, tile)
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,h,kvh,sq,sk,dh,causal,window,tile", _BWD_CASES)
def test_mma_backward_algorithm_matches_plain_vjp(b, h, kvh, sq, sk, dh,
                                                  causal, window, tile):
    """The tensor-core route's algorithm (``attention_bwd_dq_mma_kernel``
    and ``attention_bwd_dkv_mma_kernel``): the forward's lse and D in
    place of a statistics pass, a dq walk over the key tiles each query
    tile walks, a dk / dv walk of each query head over the query tiles
    that walk each key tile with its shares added over the kv group
    (``attention_bwd_group_sum_kernel``), at the kernels' tile ratios:
    the dq walk's query tiles twice its key tiles (64 rows against 32
    keys), the dk / dv walk's key tiles twice its query tiles (64 keys
    against 32 rows). Without the 1 / sk rule
    the rows that see no key would be wrong, which the cases with them
    check."""
    q, k, v, do, exp = _bwd_inputs(b, h, kvh, sq, sk, dh, causal, window)
    o, lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                               return_lse=True)
    dd = (do * o).sum(-1)
    got = _mma_bwd_model(q, k, v, do, lse, dd, causal, window, dh ** -0.5,
                         bq=2 * tile, bk=tile, bkv=2 * tile, bqkv=tile)
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("causal,window,sq,sk,scale", [
    (True, 0, 5, 5, None), (False, 0, 4, 6, 0.3), (True, 2, 6, 6, None),
    (False, 2, 7, 3, None)])
def test_flash_attention_function_gradcheck(causal, window, sq, sk, scale):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, sq, 3, generator=g, dtype=F64, requires_grad=True)
    k, v = (torch.randn(1, 2, sk, 3, generator=g, dtype=F64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.FlashAttention.apply(q, k, v, causal, window,
                                                 scale), (q, k, v))


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_moe_gmm_function_gradcheck(needs):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 5, generator=g, dtype=F64,
                    requires_grad=needs[0])
    w = torch.randn(3, 5, 2, generator=g, dtype=F64,
                    requires_grad=needs[1])
    assert torch.autograd.gradcheck(tgmm.MoeGmm.apply, (x, w))


def test_ops_results_carry_grad_fn():
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()
    outs = {
        "flash_attention": ops.flash_attention(rnd(1, 2, 5, 4),
                                               rnd(1, 1, 5, 4),
                                               rnd(1, 1, 5, 4)),
        "moe_gmm": ops.moe_gmm(rnd(2, 3, 4), rnd(2, 4, 5)),
        "rwkv6_wkv": ops.rwkv6_wkv(
            rnd(1, 2, 3, 4), rnd(1, 2, 3, 4), rnd(1, 2, 3, 4),
            torch.sigmoid(rnd(1, 2, 3, 4)), rnd(2, 4))[0],
        "selective_scan": ops.selective_scan(
            torch.nn.functional.softplus(rnd(1, 3, 4)), rnd(1, 3, 2),
            rnd(1, 3, 2), rnd(1, 3, 4), -torch.exp(rnd(4, 2)))[0],
    }
    for name, out in outs.items():
        assert out.grad_fn is not None, name
        out.sum().backward()


@pytest.mark.parametrize("mod", [twkv, tssm], ids=["rwkv6_wkv",
                                                   "selective_scan"])
def test_recurrences_refuse_grad_on_the_card(mod, monkeypatch):
    """Once the WKV and scan wrappers refused, on the card, inputs that
    require grad; now each applies its ``torch.autograd.Function`` there.
    Its wiring, with the two kernel launches replaced by plain stand-ins
    (the CPU has no kernel): the forward asks for checkpoints, saves them
    with the inputs and is launched once; the backward is launched once
    with those checkpoints and the cotangents of y and the final state,
    and its gradients come back in the inputs' dtypes, equal to autograd
    through the plain version. (tests/test_torch_recurrence_bwd.py
    models the kernels' walks.)"""
    g = torch.Generator().manual_seed(7)
    if mod is twkv:
        xs = [torch.randn(1, 2, 5, 4, generator=g, dtype=F64)
              for _ in range(3)]
        xs += [torch.rand(1, 2, 5, 4, generator=g, dtype=F64) * 0.9,
               torch.randn(2, 4, generator=g, dtype=F64)]
        fwd, bwd, plain, fn = ("wkv_forward", "rwkv6_wkv_bwd",
                               ref.rwkv6_ref, twkv.Rwkv6Wkv)
        cots = (torch.randn(1, 2, 5, 4, generator=g, dtype=F64),
                torch.randn(1, 2, 4, 4, generator=g, dtype=F64))
    else:
        xs = [torch.rand(1, 5, 3, generator=g, dtype=F64),
              torch.randn(1, 5, 2, generator=g, dtype=F64),
              torch.randn(1, 5, 2, generator=g, dtype=F64),
              torch.randn(1, 5, 3, generator=g, dtype=F64),
              -torch.rand(3, 2, generator=g, dtype=F64) - 0.5]
        fwd, bwd, plain, fn = ("scan_forward", "selective_scan_bwd",
                               ref.selective_scan_ref, tssm.SelectiveScan)
        cots = (torch.randn(1, 5, 3, generator=g, dtype=F64),
                torch.randn(1, 3, 2, generator=g, dtype=F64))
    chk = torch.zeros(3)                 # the checkpoints' stand-in
    calls = []

    def fake_forward(*args, checkpoints=False):
        calls.append(("forward", checkpoints))
        return (*plain(*args), chk)

    def fake_backward(*args):
        calls.append(("backward", args[5]))
        torch.testing.assert_close(args[6], cots[0])
        torch.testing.assert_close(args[7], cots[1])
        return getattr(ref, plain.__name__.replace("_ref", "_vjp_ref"))(
            *args[:5], *args[6:])
    monkeypatch.setattr(mod, fwd, fake_forward)
    monkeypatch.setattr(mod, bwd, fake_backward)
    leaves = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(fn.apply(*leaves), leaves, cots)
    assert calls == [("forward", True), ("backward", chk)]
    ref_leaves = [x.clone().requires_grad_() for x in xs]
    exp = torch.autograd.grad(plain(*ref_leaves), ref_leaves, cots)
    for a, e, x in zip(got, exp, xs):
        assert a.dtype == x.dtype
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)

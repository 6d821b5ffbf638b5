"""The backward kernels of the port's two recurrences, on the CPU.

* The plain backward, autograd through ``ref.rwkv6_ref`` /
  ``ref.selective_scan_ref`` in float64, against ``jax.grad`` of the JAX
  package's ``wkv_scan`` and ``ssm_scan`` (its models' recurrences, which
  it differentiates) on the same numpy inputs, within 1e-6 relative.
* The kernels' walks (``csrc/rwkv6_wkv_bwd.cu``,
  ``csrc/selective_scan_bwd.cu``), written out in torch as they run:
  the forward writes the state before every 8th (WKV) or 4th (scan)
  step; the backward walks the chunks last to first, recomputes the
  states between from those checkpoints (the WKV in two halves of 4),
  carries G = dL/dstate back without dividing by a decay, and sums dB,
  dC over blocks of 128 channels and dA, du over the batch as per-block
  partials and a second pass. In float64 they must give the plain
  version's gradients to 1e-10 relative, at a length that is no multiple
  of the chunk (511), with decays near 0 and near 1. Only the card runs
  the compiled kernels (``chip_smoke.py`` holds them to the plain
  versions); ``tests/test_torch_attention_bwd.py`` holds the
  ``autograd.Function``s' wiring.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as twkv  # noqa: E402
from repro_torch.kernels import selective_scan as tssm  # noqa: E402

def _rel(got, exp) -> float:
    return max(float((g - e).abs().max() / e.abs().max())
               for g, e in zip(got, exp))


def wkv_inputs(rng, b, h, s, dh, w_lo, w_hi):
    r, k, v = (rng.normal(size=(b, h, s, dh)) for _ in range(3))
    w = rng.uniform(w_lo, w_hi, size=(b, h, s, dh))
    u = rng.normal(size=(h, dh))
    dy = rng.normal(size=(b, h, s, dh))
    ds = rng.normal(size=(b, h, dh, dh))
    return r, k, v, w, u, dy, ds


def scan_inputs(rng, b, s, di, n, dt_scale):
    dt = rng.uniform(0.001, 1.0, size=(b, s, di)) * dt_scale
    bm, cm, u = (rng.normal(size=sh) for sh in ((b, s, n), (b, s, n),
                                                (b, s, di)))
    a = -rng.uniform(0.5, 16.0, size=(di, n))
    dy = rng.normal(size=(b, s, di))
    dh = rng.normal(size=(b, di, n))
    return dt, bm, cm, u, a, dy, dh


# --- the plain backward against jax.grad ------------------------------------


def test_wkv_plain_vjp_matches_jax_grad():
    rng = np.random.default_rng(0)
    r, k, v, w, u, dy, ds = wkv_inputs(rng, 2, 2, 37, 8, 0.3, 0.999)
    got = ref.rwkv6_vjp_ref(*map(torch.from_numpy, (r, k, v, w, u, dy, ds)))
    with jax.enable_x64(True):
        sw = lambda x: jnp.asarray(x).swapaxes(1, 2)  # noqa: E731

        def loss(r, k, v, w, u):
            y, s_fin = jrwkv.wkv_scan(r, k, v, w, u,
                                      jnp.zeros(ds.shape, jnp.float64))
            return (jnp.sum(y * sw(dy)) + jnp.sum(s_fin * jnp.asarray(ds)))
        exp = jax.grad(loss, argnums=tuple(range(5)))(
            sw(r), sw(k), sw(v), sw(w), jnp.asarray(u))
        exp = [np.array(e) for e in exp]
    exp = [torch.from_numpy(e.swapaxes(1, 2).copy()) for e in exp[:4]] \
        + [torch.from_numpy(exp[4])]
    assert _rel(got, exp) < 1e-6


def test_scan_plain_vjp_matches_jax_grad():
    rng = np.random.default_rng(1)
    dt, bm, cm, u, a, dy, dh = scan_inputs(rng, 2, 64, 24, 4, 1.0)
    got = tssm.selective_scan_bwd(*map(torch.from_numpy,
                                       (dt, bm, cm, u, a)), None,
                                  *map(torch.from_numpy, (dy, dh)))
    with jax.enable_x64(True):
        def loss(dt, bm, cm, u, a):
            y, h = jmamba.ssm_scan(dt, bm, cm, u, a,
                                   jnp.zeros(dh.shape, jnp.float64))
            return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(h * jnp.asarray(dh))
        exp = jax.grad(loss, argnums=tuple(range(5)))(
            *map(jnp.asarray, (dt, bm, cm, u, a)))
        exp = [torch.from_numpy(np.array(e)) for e in exp]
    assert _rel(got, exp) < 1e-6


# --- the kernels' walks -----------------------------------------------------


def wkv_forward_walk(r, k, v, w, u):
    """y, S_final and the states before every 8th step, as the forward
    kernel writes them under grad."""
    b, h, s, dh = r.shape
    st = torch.zeros((b, h, dh, dh), dtype=r.dtype)
    ys, chk = [], []
    for t in range(s):
        if t % twkv.CHECKPOINT == 0:
            chk.append(st)
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        beta = (rt * u * kt).sum(-1, keepdim=True)
        ys.append(torch.einsum("bhj,bhji->bhi", rt, st) + beta * vt)
        st = w[:, :, t, :, None] * st + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, 2), st, torch.stack(chk, 2)


def wkv_backward_walk(r, k, v, w, u, chk, dy, ds):
    """dr, dk, dv, dw, du as ``csrc/rwkv6_wkv_bwd.cu`` walks them."""
    b, h, s, dh = r.shape
    ck, half = twkv.CHECKPOINT, twkv.CHECKPOINT // 2
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du_part = torch.zeros((b, h, dh), dtype=r.dtype)
    g = ds.clone()
    for c in reversed(range(chk.shape[2])):
        t0 = c * ck
        n = min(ck, s - t0)
        for c0 in reversed(range(0, n, half)):
            st = chk[:, :, c]
            for cc in range(c0):          # the half's start, recomputed
                t = t0 + cc
                st = w[:, :, t, :, None] * st \
                    + k[:, :, t, :, None] * v[:, :, t, None, :]
            hist = []
            for cc in range(c0, min(c0 + half, n)):
                t = t0 + cc
                hist.append(st)
                st = w[:, :, t, :, None] * st \
                    + k[:, :, t, :, None] * v[:, :, t, None, :]
            for q in reversed(range(len(hist))):
                t = t0 + c0 + q
                rt, kt, vt, wt, yt = (x[:, :, t] for x in (r, k, v, w, dy))
                vdy = (vt * yt).sum(-1, keepdim=True)
                beta = (rt * u * kt).sum(-1, keepdim=True)
                sp = hist[q]
                dr[:, :, t] = (sp * yt[..., None, :]).sum(-1) + u * kt * vdy
                dk[:, :, t] = (g * vt[..., None, :]).sum(-1) + u * rt * vdy
                dw[:, :, t] = (g * sp).sum(-1)
                dv[:, :, t] = (g * kt[..., :, None]).sum(-2) + beta * yt
                du_part += rt * kt * vdy
                g = wt[..., :, None] * g + rt[..., :, None] * yt[..., None, :]
    du = torch.zeros((h, dh), dtype=r.dtype)
    for part in du_part:                  # the second pass, in order
        du = du + part
    return dr, dk, dv, dw, du


def scan_forward_walk(dt, bm, cm, u, a):
    """y, h_final and h before every 4th step, as the forward kernel
    writes them under grad."""
    b, s, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=dt.dtype)
    ys, chk = [], []
    for t in range(s):
        if t % tssm.CHECKPOINT == 0:
            chk.append(h)
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h, torch.stack(chk, 1)


def scan_backward_walk(dt, bm, cm, u, a, chk, dy, dh):
    """d(dt), dB, dC, du, dA as ``csrc/selective_scan_bwd.cu`` walks
    them: dB and dC per block of 128 channels, then summed over the
    blocks in order; dA per batch row, then summed over the rows."""
    b, s, di = dt.shape
    n = a.shape[1]
    ck = tssm.CHECKPOINT
    nblk = -(-di // tssm.BLOCK)
    ddt, du = torch.zeros_like(dt), torch.zeros_like(dt)
    dbc_part = torch.zeros((nblk, 2, b, s, n), dtype=dt.dtype)
    da_part = torch.zeros((b, di, n), dtype=dt.dtype)
    gf = dh.clone()
    for c0 in reversed(range(0, s, ck)):
        steps = min(ck, s - c0)
        hist = [chk[:, c0 // ck]]
        for q in range(steps):
            t = c0 + q
            hist.append(torch.exp(dt[:, t, :, None] * a) * hist[-1]
                        + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :])
        for q in reversed(range(steps)):
            t = c0 + q
            d, uu, yy = dt[:, t, :, None], u[:, t, :, None], dy[:, t, :, None]
            bk, ck_ = bm[:, t, None, :], cm[:, t, None, :]
            dec = torch.exp(d * a)
            hp = hist[q]
            g = yy * ck_ + gf
            ddt[:, t] = (g * (a * dec * hp + uu * bk)).sum(-1)
            du[:, t] = (g * bk).sum(-1) * d[..., 0]
            terms = (g * d * uu, yy * hist[q + 1])       # dB, dC
            for which, term in enumerate(terms):
                for blk in range(nblk):
                    cols = slice(blk * tssm.BLOCK, (blk + 1) * tssm.BLOCK)
                    dbc_part[blk, which, :, t] = term[:, cols].sum(1)
            da_part += g * d * dec * hp
            gf = dec * g
    dbc = torch.zeros((2, b, s, n), dtype=dt.dtype)
    for part in dbc_part:
        dbc = dbc + part
    da = torch.zeros((di, n), dtype=dt.dtype)
    for part in da_part:
        da = da + part
    return ddt, dbc[0], dbc[1], du, da


@pytest.mark.parametrize("w_lo,w_hi", [(1e-6, 0.05), (0.995, 0.999999)],
                         ids=["w_near_0", "w_near_1"])
def test_wkv_backward_walk_matches_autograd(w_lo, w_hi):
    rng = np.random.default_rng(2)
    ins = [torch.from_numpy(x) for x in
           wkv_inputs(rng, 1, 2, 511, 6, w_lo, w_hi)]
    r, k, v, w, u, dy, ds = ins
    y, s_fin, chk = wkv_forward_walk(r, k, v, w, u)
    ey, es = ref.rwkv6_ref(r, k, v, w, u)
    assert _rel((y, s_fin), (ey, es)) < 1e-12
    got = wkv_backward_walk(r, k, v, w, u, chk, dy, ds)
    exp = ref.rwkv6_vjp_ref(r, k, v, w, u, dy, ds)
    assert _rel(got, exp) < 1e-10


@pytest.mark.parametrize("dt_scale", [40.0, 1e-3],
                         ids=["decay_near_0", "decay_near_1"])
def test_scan_backward_walk_matches_autograd(dt_scale):
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(x) for x in
           scan_inputs(rng, 2, 511, 136, 4, dt_scale)]
    dt, bm, cm, u, a, dy, dh = ins
    y, h_fin, chk = scan_forward_walk(dt, bm, cm, u, a)
    ey, eh = ref.selective_scan_ref(dt, bm, cm, u, a)
    assert _rel((y, h_fin), (ey, eh)) < 1e-12
    got = scan_backward_walk(dt, bm, cm, u, a, chk, dy, dh)
    exp = ref.selective_scan_vjp_ref(dt, bm, cm, u, a, dy, dh)
    assert _rel(got, exp) < 1e-10

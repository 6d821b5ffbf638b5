"""The backward kernels of the port's two recurrences, on the CPU.

* The plain backward, autograd through ``ref.rwkv6_ref`` /
  ``ref.selective_scan_ref`` in float64, against ``jax.grad`` of the JAX
  package's ``wkv_scan`` and ``ssm_scan`` (its models' recurrences, which
  it differentiates) on the same numpy inputs, within 1e-6 relative.
* The kernels' walks (``csrc/rwkv6_wkv_bwd.cu``,
  ``csrc/selective_scan_bwd.cu``), written out in torch as they run:
  the forward writes the state before every 8th (WKV) or 4th (scan)
  step (the scan's state-major); the backward walks the chunks last to
  first, recomputes the states between from those checkpoints (the WKV
  in two halves of 4, the second first; the scan 3 steps a group, the
  state after it being the later group's checkpoint), carries G =
  dL/dstate back without dividing by a decay, and adds its sums in the
  kernels' orders: the WKV's over a thread's columns and then its
  row's lanes, dv over a thread's rows, its warp's and the warps; the
  scan's dB, dC over a warp's channels, its block's warps and the
  blocks, dA and du over the batch as per-block partials and a second
  pass. In float64 they must give the plain version's gradients to
  1e-10 relative, at a length that is no multiple of the chunk (511),
  with decays near 0 and near 1, at both compiled widths of each and
  with masked widths. Only the card runs the compiled kernels
  (``chip_smoke.py`` holds them to the plain versions);
  ``tests/test_torch_attention_bwd.py`` holds the
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


def lane_sum(x, dim):
    """Sum over ``dim`` (a power of two) as a shuffle butterfly adds it,
    from the top lane bit down: at each level every lane adds its
    partner's partial (every lane ends with the same sum)."""
    p = x.shape[dim]
    off = p // 2
    while off:
        x = x + x.index_select(dim, torch.arange(p) ^ off)
        off //= 2
    return x.select(dim, 0)


def in_order(x, dim):
    """Sum over ``dim`` one term after another from zero, in order."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def wkv_backward_walk(r, k, v, w, u, chk, dy, ds):
    """dr, dk, dv, dw, du as ``csrc/rwkv6_wkv_bwd.cu`` walks them at the
    compiled width DH (32 or 64; rows and columns past dh zero): a block
    a pair, thread (rg, cg) a 2-row x 8-column tile; chunks of 8 last to
    first, each in halves of 4, the second half's states recomputed
    from the chunk's checkpoint first (7 updates), then the first's (3);
    dr / dk / dw summed over a row's 8 columns in a thread, then over the
    DH / 8 column lanes by a butterfly, the bonus terms added after; dv
    over each quad of rows as (row 0 + row 2) + (row 1 + row 3), then the
    quads in order; du a register a row, the steps last first, then the
    batch in order (at DH 64 these are the first design's orders)."""
    b, h, s, dh = r.shape
    DH = 32 if dh <= 32 else 64
    CG = DH // 8                                 # column lanes
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x, (0, DH - dh) if x.dim() in (2, 4) else (0, DH - dh, 0, DH - dh))
    r, k, v, w, dy = (pad(x) for x in (r, k, v, w, dy))
    g, chk = (torch.nn.functional.pad(x, (0, DH - dh, 0, DH - dh))
              for x in (ds, chk))
    u = pad(u)
    ck, half = twkv.CHECKPOINT, twkv.CHECKPOINT // 2
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du_part = torch.zeros((b, h, DH), dtype=r.dtype)

    def advance(st, t):
        return w[:, :, t, :, None] * st \
            + k[:, :, t, :, None] * v[:, :, t, None, :]

    for c in reversed(range(chk.shape[2])):
        t0 = c * ck
        n = min(ck, s - t0)
        steps = range(t0, t0 + n)
        vt, yt = v[:, :, t0:t0 + n], dy[:, :, t0:t0 + n]
        lanes = lambda x: x.reshape(*x.shape[:-1], DH // 32, 32)  # noqa: E731
        vdy = lane_sum(lanes(vt * yt).sum(-2), -1)       # (b, h, n)
        beta = lane_sum(lanes(r[:, :, t0:t0 + n] * u[:, None]
                              * k[:, :, t0:t0 + n]).sum(-2), -1)
        part = torch.zeros((b, h, n, 3, DH), dtype=r.dtype)
        dvp = torch.zeros((b, h, n, DH // 4, DH), dtype=r.dtype)
        for c0 in reversed(range(0, n, half)):
            st = chk[:, :, c]
            for cc in range(c0):              # the half's start, recomputed
                st = advance(st, t0 + cc)
            hist = [st]
            for cc in range(c0 + 1, min(c0 + half, n)):
                hist.append(advance(hist[-1], t0 + cc - 1))
            for q in reversed(range(len(hist))):
                t = t0 + c0 + q
                rt, kt, wt, vt_, yt_ = (x[:, :, t] for x in (r, k, w, v, dy))
                sp = hist[q]
                def cols(x):                  # a thread's 8, then lanes
                    return lane_sum(x.reshape(b, h, DH, CG, 8).sum(-1), -1)
                part[:, :, c0 + q, 0] = cols(sp * yt_[..., None, :])
                part[:, :, c0 + q, 1] = cols(g * vt_[..., None, :])
                part[:, :, c0 + q, 2] = cols(g * sp)
                pv = (g * kt[..., :, None]).reshape(b, h, DH // 4, 4, DH)
                dvp[:, :, c0 + q] = (pv[..., 0, :] + pv[..., 2, :]) \
                    + (pv[..., 1, :] + pv[..., 3, :])
                g = wt[..., :, None] * g + rt[..., :, None] * yt_[..., None, :]
        for cc in range(n):                   # the chunk's outputs
            t = t0 + cc
            rt, kt, yt_ = r[:, :, t], k[:, :, t], dy[:, :, t]
            dv[:, :, t] = beta[..., cc, None] * yt_ + in_order(dvp[:, :, cc], 2)
            dr[:, :, t] = u * kt * vdy[..., cc, None] + part[:, :, cc, 0]
            dk[:, :, t] = u * rt * vdy[..., cc, None] + part[:, :, cc, 1]
            dw[:, :, t] = part[:, :, cc, 2]
        for cc in reversed(range(n)):         # du, the steps last first
            t = t0 + cc
            du_part += r[:, :, t] * k[:, :, t] * vdy[..., cc, None]
    du = in_order(du_part, 0)                 # the second pass, in order
    return tuple(x[..., :dh] for x in (dr, dk, dv, dw, du))


def scan_forward_walk(dt, bm, cm, u, a):
    """y, h_final and h before every 4th step, as the forward kernel
    writes them under grad (state-major: (b, ceil(s / 4), n, di))."""
    b, s, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=dt.dtype)
    ys, chk = [], []
    for t in range(s):
        if t % tssm.CHECKPOINT == 0:
            chk.append(h)
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h, torch.stack(chk, 1).transpose(2, 3)


def scan_backward_walk(dt, bm, cm, u, a, chk, dy, dh):
    """d(dt), dB, dC, du, dA as ``csrc/selective_scan_bwd.cu`` walks
    them: a thread a channel with all its states (n of 4, 8 or 16, others
    at 16 with the states past n zero); groups of 4 steps last to first,
    h recomputed from a group's checkpoint (3 updates; h after the group
    is the later group's checkpoint, 4 updates at the sequence's end);
    d(dt) and du summed over the even and the odd states apart, d(dt)'s
    A term as log2-scaled A times ln 2; dB's terms G du and dC's dy h of
    a step summed over a warp's 32 channels, the even and the odd ones
    apart, each in order, then over the 4 warps of a 128-channel block
    in order, then over the blocks in order; dA per batch row, then the
    rows in order."""
    b, s, di = dt.shape
    n = a.shape[1]
    N = n if n in (4, 8, 16) else 16
    ck = tssm.CHECKPOINT
    nblk = -(-di // tssm.BLOCK)
    padc = nblk * tssm.BLOCK - di
    pad_n = lambda x: torch.nn.functional.pad(x, (0, N - n))  # noqa: E731
    a2 = pad_n(a) * np.log2(np.e)
    bm, cm, dhp = pad_n(bm), pad_n(cm), pad_n(dh)
    chk = pad_n(chk.transpose(2, 3))       # (b, groups, di, N)
    ddt, du = torch.zeros_like(dt), torch.zeros_like(dt)
    dbc = torch.zeros((nblk, 2, b, s, N), dtype=dt.dtype)
    da_part = torch.zeros((b, di, N), dtype=dt.dtype)
    gf = dhp.clone()
    nxt = None                              # the later group's checkpoint
    parity = lambda x: in_order(  # noqa: E731
        x.reshape(b, di, N // 2, 2).sum(-2), -1)
    for c0 in reversed(range(0, s, ck)):
        steps = min(ck, s - c0)
        tail = c0 + ck >= s
        hist = [chk[:, c0 // ck]]
        for q in range(steps if tail else ck - 1):
            t = c0 + q
            hist.append(torch.exp2(dt[:, t, :, None] * a2) * hist[-1]
                        + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :])
        if not tail:
            hist.append(nxt)
        nxt = hist[0]
        for q in reversed(range(steps)):
            t = c0 + q
            d, uu, yy = dt[:, t, :, None], u[:, t, :, None], dy[:, t, :, None]
            bk, ck_ = bm[:, t, None, :], cm[:, t, None, :]
            dec = torch.exp2(d * a2)
            g = yy * ck_ + gf
            gahp = g * (dec * hist[q])
            sdu, s1 = parity(g * bk), parity(gahp * a2)
            ddt[:, t] = s1 * np.log(2.0) + uu[..., 0] * sdu
            du[:, t] = sdu * d[..., 0]
            for which, term in enumerate((g * (d * uu), yy * hist[q + 1])):
                term = torch.nn.functional.pad(term, (0, 0, 0, padc))
                # warp, row r // 2, r % 2
                lanes = term.reshape(b, nblk, 4, 16, 2, N)
                pair = in_order(lanes, 3)           # the even and odd rows
                warps = pair[..., 0, :] + pair[..., 1, :]
                dbc[:, which, :, t] = in_order(warps, 2).permute(1, 0, 2)
            da_part += gahp * d
            gf = dec * g
    dbc = in_order(dbc, 0)[..., :n]
    return (ddt, dbc[0], dbc[1], du, in_order(da_part, 0)[..., :n])


@pytest.mark.parametrize("w_lo,w_hi,dh", [
    pytest.param(1e-6, 0.05, 6, id="w_near_0"),
    pytest.param(0.995, 0.999999, 6, id="w_near_1"),
    pytest.param(0.45, 0.95, 64, id="dh64"),
    pytest.param(1e-6, 0.999999, 40, id="dh40_masked")])
def test_wkv_backward_walk_matches_autograd(w_lo, w_hi, dh):
    rng = np.random.default_rng(2)
    ins = [torch.from_numpy(x) for x in
           wkv_inputs(rng, 1, 2 if dh == 6 else 1, 511, dh, w_lo, w_hi)]
    r, k, v, w, u, dy, ds = ins
    y, s_fin, chk = wkv_forward_walk(r, k, v, w, u)
    ey, es = ref.rwkv6_ref(r, k, v, w, u)
    assert _rel((y, s_fin), (ey, es)) < 1e-12
    got = wkv_backward_walk(r, k, v, w, u, chk, dy, ds)
    exp = ref.rwkv6_vjp_ref(r, k, v, w, u, dy, ds)
    assert _rel(got, exp) < 1e-10


@pytest.mark.parametrize("dt_scale,n", [
    pytest.param(40.0, 4, id="decay_near_0"),
    pytest.param(1e-3, 4, id="decay_near_1"),
    pytest.param(1.0, 16, id="n16"),
    pytest.param(1.0, 5, id="n5_masked")])
def test_scan_backward_walk_matches_autograd(dt_scale, n):
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(x) for x in
           scan_inputs(rng, 2, 511, 136, n, dt_scale)]
    dt, bm, cm, u, a, dy, dh = ins
    y, h_fin, chk = scan_forward_walk(dt, bm, cm, u, a)
    ey, eh = ref.selective_scan_ref(dt, bm, cm, u, a)
    assert _rel((y, h_fin), (ey, eh)) < 1e-12
    got = scan_backward_walk(dt, bm, cm, u, a, chk, dy, dh)
    exp = ref.selective_scan_vjp_ref(dt, bm, cm, u, a, dy, dh)
    assert _rel(got, exp) < 1e-10

"""The arithmetic of the port's two recurrence kernels, modelled on the
CPU in their own order, against the JAX package's oracles and a float64
recurrence.

* ``csrc/rwkv6_wkv.cu`` splits each value column's key rows over RG
  row groups (neighbouring lanes): each sums its rows' read-out in row
  order, then adds its part of the bonus as a scalar a step (beta =
  sum_j r_j u_j k_j, times v_i), and a butterfly of shuffles adds the
  RG partial sums; head dims up to 64 run in the width of 32 or 64 with
  zero rows and columns.
* ``csrc/selective_scan.cu`` takes the decay as ``ex2.approx.ftz`` of
  round(dt * round(A * log2 e)), whose result may be up to ~2 ulp off
  (and is 0 below 2^-126);
  the model pushes every decay 2 ulp the same way, the worst case for a
  sum of 512 steps, and must stay within the path's tolerance (2e-5 of
  the output's largest magnitude) of an exact float64 recurrence.

A fused multiply-add is modelled in float64 (the product of two f32 is
exact there) and rounded once to f32. The model is of the designs; only
the card runs the compiled kernels, and ``chip_smoke.py`` holds those to
the plain versions at the same tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

# compiled widths and their row groups (csrc/rwkv6_wkv.cu `Tile`)
WKV_ROW_GROUPS = {32: 4, 64: 8}


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def wkv_kernel_order(r, k, v, w, u):
    """y (b, h, s, dh) and S_final (b, h, dh, dh) as the WKV kernel sums
    them, in f32, from f32 tensors r, k, v, w (b, h, s, dh), u (h, dh)."""
    b, h, s, dh = r.shape
    width = min(d for d in WKV_ROW_GROUPS if d >= dh)
    groups = WKV_ROW_GROUPS[width]
    rows = width // groups                          # key rows a lane
    pad = width - dh
    r, k, v, w = (torch.nn.functional.pad(x, (0, pad)) for x in (r, k, v, w))
    u = torch.nn.functional.pad(u, (0, pad))
    state = torch.zeros((b, h, width, width))       # [j, i]
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]      # (b, h, j, i)
        # each row group g sums rows g * rows + jj in order, jj = 0, 1, ..
        acc = torch.zeros((b, h, groups, width))
        beta = torch.zeros((b, h, groups))
        for jj in range(rows):
            js = torch.arange(groups) * rows + jj
            acc = _fma(rt[..., js, None], state[:, :, js], acc)
            beta = _fma(rt[..., js] * u[None, :, js], kt[..., js], beta)
        acc = _fma(beta[..., None], vt[:, :, None, :], acc)
        # the shuffle butterfly: lanes g and g ^ off add, off = groups/2..1
        off = groups // 2
        while off:
            acc = acc + acc[:, :, torch.arange(groups) ^ off]
            off //= 2
        ys.append(acc[:, :, 0])
        state = _fma(wt[..., :, None], state, kv)
    y = torch.stack(ys, dim=2)
    return y[..., :dh], state[:, :, :dh, :dh]


def _wkv_inputs(b, h, s, dh, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, dh)) for _ in range(3))
    w = 1 / (1 + np.exp(-rng.normal(size=(b, h, s, dh)))) * 0.5 + 0.45
    u = rng.normal(size=(h, dh)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


@pytest.mark.parametrize("dh", [16, 48, 64])
def test_wkv_kernel_order_matches_jax(dh):
    """The kernel's read-out order stays within its 5e-5 of the JAX
    oracle and the Pallas kernel (interpret mode) at 64 steps; dh 16 and
    48 run in the widths of 32 and 64, zero-padded."""
    b, h, s = 1, 2, 64
    ins = _wkv_inputs(b, h, s, dh, dh)
    y, s_fin = wkv_kernel_order(*map(torch.from_numpy, ins))
    js = list(map(jnp.asarray, ins))
    for ey, es in (jref.rwkv6_ref(*js),
                   jops.rwkv6_wkv(*js, chunk=32, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=5e-5,
                                   rtol=5e-5)
        np.testing.assert_allclose(s_fin.numpy(), np.asarray(es),
                                   atol=5e-5, rtol=5e-5)


def _ulps(x: torch.Tensor, n: int) -> torch.Tensor:
    """x moved n f32 ulps up (n > 0) or down."""
    to = torch.full_like(x, torch.inf if n > 0 else -torch.inf)
    for _ in range(abs(n)):
        x = torch.nextafter(x, to)
    return x


def scan_kernel_order(dt, bm, cm, u, a, ulps: int):
    """y (b, s, di) and h_final (b, di, n) as the scan kernel computes
    them in f32: decay = 2 ** round(dt * round(A log2 e)), moved ``ulps``
    ulps (``ex2.approx``'s error, all one way); h = fma(decay, h, du *
    B); y summed in two accumulators over alternating states."""
    b, s, di = dt.shape
    n = a.shape[1]
    a2 = a * np.float32(np.log2(np.e))                 # rounded to f32
    h = torch.zeros((b, di, n))
    ys = []
    for t in range(s):
        d = dt[:, t, :, None]
        x = d * a2                                     # rounded to f32
        decay = _ulps(torch.exp2(x.double()).float(), ulps)
        decay = torch.where(decay < 2.0 ** -126, 0.0, decay)   # .ftz
        du = d * u[:, t, :, None]
        h = _fma(decay, h, du * bm[:, t, None, :])
        acc = torch.zeros((2, b, di))
        for k in range(n):
            acc[k % 2] = _fma(h[..., k], cm[:, t, None, k], acc[k % 2])
        ys.append(acc[0] + acc[1])
    return torch.stack(ys, dim=1), h


def scan_exact(dt, bm, cm, u, a):
    """The selective scan in float64 with an exact exp."""
    dt, bm, cm, u, a = (x.double() for x in (dt, bm, cm, u, a))
    b, s, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("ulps", [2, -2])
def test_scan_ex2_within_path_tolerance(ulps):
    """jamba's dt (softplus around its b_dt of -4.6), A = -exp(0.5
    normal), n 16 over 512 steps: with every decay 2 ulp off the same
    way, the exp2-on-pre-scaled-A order stays within 2e-5 (relative to
    the output's largest magnitude) of the exact recurrence (at about a
    quarter of it), and 16 ulp would not; the JAX oracle stays within
    it too."""
    b, s, di, n = 1, 512, 64, 16
    rng = np.random.default_rng(16 + ulps)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, di)) - 4.6))
    bm, cm = (rng.normal(size=(b, s, n)) for _ in range(2))
    u = rng.normal(size=(b, s, di))
    a = -np.exp(rng.normal(size=(di, n)) * 0.5)
    ins = [x.astype(np.float32) for x in (dt, bm, cm, u, a)]
    ey, eh = scan_exact(*map(torch.from_numpy, ins))
    scale = max(ey.abs().max().item(), eh.abs().max().item())
    y, h = scan_kernel_order(*map(torch.from_numpy, ins), ulps)
    for got, want in ((y, ey), (h, eh)):
        torch.testing.assert_close(got.double(), want, atol=2e-5 * scale,
                                   rtol=2e-5)
    # the bound has teeth: decays 16 ulp off would break it
    y16, _ = scan_kernel_order(*map(torch.from_numpy, ins), 8 * ulps)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y16.double(), ey, atol=2e-5 * scale,
                                   rtol=2e-5)
    jy, jh = jref.selective_scan_ref(*map(jnp.asarray, ins))
    for got, want in ((jy, ey), (jh, eh)):
        torch.testing.assert_close(torch.from_numpy(np.array(got)).double(),
                                   want, atol=2e-5 * scale, rtol=2e-5)

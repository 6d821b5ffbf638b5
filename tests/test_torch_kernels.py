"""The PyTorch port's plain kernel versions against the JAX package's
oracles and Pallas kernels (in interpret mode), on shared numpy inputs,
and the port's kernel dispatch on CPU tensors. The CUDA kernels
themselves run only on the card: ``chip_smoke.py`` holds them against
these plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as twkv  # noqa: E402

ATT_CASES = [
    # b, h, kvh, s, dh, causal, window, dtype (tests/test_kernels.py)
    (2, 4, 2, 256, 64, True, 0, "float32"),
    (1, 4, 4, 128, 32, True, 64, "float32"),
    (2, 2, 1, 128, 128, False, 0, "float32"),
    (1, 8, 2, 512, 64, True, 128, "float32"),
    (1, 2, 2, 256, 64, True, 0, "bfloat16"),
    # the split-NN tower's call, rows cut from 512 to 4
    (4, 4, 4, 8, 16, False, 0, "float32"),
    # h2o-danube-1.8b's head dim of 80 (causal GQA 4:1, a window)
    (2, 8, 2, 96, 80, True, 64, "float32"),
]


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("b,h,kvh,s,dh,causal,window,dtype", ATT_CASES)
def test_attention_ref_matches_jax(b, h, kvh, s, dh, causal, window,
                                   dtype):
    rng = np.random.default_rng(b * 1000 + h * 100 + s)
    qj, qt = _both(rng.normal(size=(b, h, s, dh)), dtype)
    kj, kt = _both(rng.normal(size=(b, kvh, s, dh)), dtype)
    vj, vt = _both(rng.normal(size=(b, kvh, s, dh)), dtype)
    out = tref.attention_ref(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    got = out.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for expect in (jref.attention_ref(qj, kj, vj, causal=causal,
                                      window=window),
                   jops.flash_attention(qj, kj, vj, causal=causal,
                                        window=window, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                                   atol=tol, rtol=tol)


def _quant_input(rows: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d))
         * rng.uniform(0.01, 10.0, size=(rows, 1))).astype(np.float32)
    x[0] = 0.0                                   # an all-zero row
    # absmax 127 makes the scale exactly 1, so these are exact .5 ties
    # that half-to-even rounding sends to 0, 2, 2 and -4
    x[1, :5] = [127.0, 0.5, 1.5, 2.5, -3.5]
    x[1, 5:] = 0.25
    return x


@pytest.mark.parametrize("rows,d", [(4096, 64), (300, 64), (7, 1000),
                                    (32, 64)])
def test_quantize_ref_matches_jax(rows, d):
    x = _quant_input(rows, d, rows + d)
    q, scale = tref.quantize_int8_ref(torch.from_numpy(x))
    q, scale = q.numpy(), scale.numpy()
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q[1, :5], [127, 0, 2, 2, -4])
    np.testing.assert_array_equal(q[0], 0)
    # the oracle eagerly, and jitted as the tower runs it (XLA turns its
    # division by 127 into a multiply by the reciprocal: the scales may
    # differ by an ulp, which rtol 1e-6 covers)
    expects = [jref.quantize_int8_ref(jnp.asarray(x)),
               jax.jit(jref.quantize_int8_ref)(jnp.asarray(x))]
    if rows % 256 == 0 or rows < 256:
        # the Pallas kernel needs rows to divide its block
        expects.append(jops.quantize_int8(jnp.asarray(x),
                                          block_r=min(rows, 256),
                                          interpret=True))
    for jq, js in expects:
        np.testing.assert_array_equal(q, np.asarray(jq))
        np.testing.assert_allclose(scale, np.asarray(js), rtol=1e-6,
                                   atol=0)
    # where the reference runs (jitted, and the Pallas kernel) the scale
    # is the same float, bit for bit
    np.testing.assert_array_equal(scale, np.asarray(expects[1][1]))


def test_quantize_ref_bfloat16_input():
    x = _quant_input(64, 64, 3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, scale = tref.quantize_int8_ref(xt)
    jq, js = jax.jit(jref.quantize_int8_ref)(
        jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))


WKV_CASES = [
    # b, h, s, dh, dtype (tests/test_kernels.py)
    (1, 2, 64, 32, "float32"),
    (2, 4, 128, 64, "float32"),
    (1, 2, 128, 32, "bfloat16"),
]


def _wkv_inputs(b, h, s, dh, seed):
    """r, k, v, w (b, h, s, dh) and u (h, dh) as numpy f32, drawn as the
    JAX kernel test draws them (w = sigmoid(normal) * 0.5 + 0.45)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, dh)) for _ in range(3))
    w = 1 / (1 + np.exp(-rng.normal(size=(b, h, s, dh)))) * 0.5 + 0.45
    u = rng.normal(size=(h, dh)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


@pytest.mark.parametrize("b,h,s,dh,dtype", WKV_CASES)
def test_rwkv6_ref_matches_jax(b, h, s, dh, dtype):
    r, k, v, w, u = _wkv_inputs(b, h, s, dh, h * s)
    (rj, rt), (kj, kt), (vj, vt), (wj, wt) = (_both(a, dtype)
                                              for a in (r, k, v, w))
    y, s_fin = tref.rwkv6_ref(rt, kt, vt, wt, torch.from_numpy(u))
    assert y.dtype == s_fin.dtype == torch.float32
    assert y.shape == (b, h, s, dh) and s_fin.shape == (b, h, dh, dh)
    tol = 5e-2 if dtype == "bfloat16" else 5e-5
    uj = jnp.asarray(u)
    for ey, es in (jref.rwkv6_ref(rj, kj, vj, wj, uj),
                   jops.rwkv6_wkv(rj, kj, vj, wj, uj, chunk=32,
                                  interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(s_fin.numpy(), np.asarray(es),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_ref_ragged_length_and_state(with_s0):
    """A length no chunk divides (the Pallas kernel refuses it) and a
    nonzero starting state, against the JAX oracle."""
    b, h, s, dh = 2, 3, 100, 32
    r, k, v, w, u = _wkv_inputs(b, h, s, dh, 11)
    s0 = (np.random.default_rng(12).normal(size=(b, h, dh, dh)) * 0.5
          ).astype(np.float32) if with_s0 else None
    y, s_fin = tref.rwkv6_ref(
        *map(torch.from_numpy, (r, k, v, w, u)),
        None if s0 is None else torch.from_numpy(s0))
    ey, es = jref.rwkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                            None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(es), atol=5e-5,
                               rtol=5e-5)


GMM_CASES = [
    # e, c, d, f, dtype (tests/test_kernels.py)
    (4, 128, 64, 96, "float32"),
    (8, 256, 128, 128, "float32"),
    (2, 128, 128, 64, "bfloat16"),
]


def _gmm_inputs(e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, c, d)).astype(np.float32),
            rng.normal(size=(e, d, f)).astype(np.float32))


@pytest.mark.parametrize("e,c,d,f,dtype", GMM_CASES)
def test_gmm_ref_matches_jax(e, c, d, f, dtype):
    x, w = _gmm_inputs(e, c, d, f, e * c + d)
    (xj, xt), (wj, wt) = _both(x, dtype), _both(w, dtype)
    out = tref.gmm_ref(xt, wt)
    assert out.dtype == xt.dtype and out.shape == (e, c, f)
    tol = 5e-2 if dtype == "bfloat16" else 2e-4
    for expect in (jref.gmm_ref(xj, wj),
                   jops.moe_gmm(xj, wj, block_c=64, block_f=min(128, f),
                                block_d=min(64, d), interpret=True)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expect, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("c", [4, 37])
def test_gmm_ref_ragged_capacity_matches_jax(c):
    """Capacities no Pallas block divides (the MoE decode path's is 4);
    the CUDA kernel takes them, so the plain version is held to the JAX
    oracle there."""
    x, w = _gmm_inputs(3, c, 50, 33, c)
    np.testing.assert_allclose(
        tref.gmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.gmm_ref(jnp.asarray(x), jnp.asarray(w))),
        atol=2e-4, rtol=2e-4)


@pytest.fixture
def counters():
    for c in (tfa.launches, tq.launches, twkv.launches, tgmm.launches):
        c.reset()
    yield
    for c in (tfa.launches, tq.launches, twkv.launches, tgmm.launches):
        c.reset()


def test_ops_moe_gmm_dispatch_on_cpu(counters):
    x, w = map(torch.from_numpy, _gmm_inputs(2, 5, 8, 3, 1))
    exp = tref.gmm_ref(x, w)
    for got in (tops.moe_gmm(x, w), tops.moe_gmm(x, w, kernel="ref"),
                tgmm.moe_gmm(x, w)):
        assert torch.equal(got, exp)
    with pytest.raises(ValueError, match="kernel='pallas'"):
        tops.moe_gmm(x, w, kernel="pallas")
    with pytest.raises(ValueError, match="auto\\|pallas\\|ref"):
        tops.moe_gmm(x, w, kernel="cuda")
    assert tgmm.launches.count == 0


def test_ops_rwkv6_wkv_dispatch_on_cpu(counters):
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(1, 2, 16, 32, 3))
    exp = tref.rwkv6_ref(r, k, v, w, u)
    for got in (tops.rwkv6_wkv(r, k, v, w, u),
                tops.rwkv6_wkv(r, k, v, w, u, kernel="ref"),
                twkv.rwkv6_wkv(r, k, v, w, u)):
        assert all(torch.equal(a, b) for a, b in zip(got, exp))
    with pytest.raises(ValueError, match="kernel='pallas'"):
        tops.rwkv6_wkv(r, k, v, w, u, kernel="pallas")
    assert twkv.launches.count == 0


def test_ops_auto_takes_plain_version_on_cpu(counters):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 8, 16), generator=g)
    x = torch.randn((16, 64), generator=g)
    assert tops.default_backend(q) == "ref"
    for kernel in ("auto", "ref"):
        torch.testing.assert_close(
            tops.flash_attention(q, q, q, causal=False, kernel=kernel),
            tref.attention_ref(q, q, q, causal=False), rtol=0, atol=0)
        got = tops.quantize_int8(x, kernel=kernel)
        exp = tref.quantize_int8_ref(x)
        assert all(torch.equal(a, b) for a, b in zip(got, exp))
    # the wrappers take the plain version for a CPU tensor, uncounted
    torch.testing.assert_close(tfa.flash_attention(q, q, q),
                               tref.attention_ref(q, q, q), rtol=0, atol=0)
    assert torch.equal(tq.quantize_int8(x)[0], exp[0])
    assert tfa.launches.count == 0 and tq.launches.count == 0


def test_ops_pallas_on_cpu_raises(counters):
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="kernel='pallas'"):
        tops.flash_attention(q, q, q, kernel="pallas")
    with pytest.raises(ValueError, match="kernel='pallas'"):
        tops.quantize_int8(torch.zeros((4, 8)), kernel="pallas")
    with pytest.raises(ValueError, match="auto\\|pallas\\|ref"):
        tops.quantize_int8(torch.zeros((4, 8)), kernel="cuda")
    assert tfa.launches.count == 0 and tq.launches.count == 0


def test_kernel_sources_build_flags():
    """The build compiles every csrc source for sm_90a without fast
    math (quantize needs an IEEE division to agree bit for bit, the WKV
    recurrence keeps denormals as its plain version does)."""
    from repro_torch.kernels import _build
    names = [s.name for s in _build.sources()]
    assert names == ["flash_attention.cu", "flash_attention_bwd.cu",
                     "moe_gmm.cu", "quantize.cu", "rwkv6_wkv.cu",
                     "rwkv6_wkv_bwd.cu", "selective_scan.cu",
                     "selective_scan_bwd.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    for s in _build.sources():
        text = s.read_text()
        assert "Replaces: src/repro/kernels/" in text
        assert 'extern "C"' in text


def test_build_hash_covers_headers(tmp_path):
    """The build's key changes with a header's bytes, not only with a
    source's: an edit to ``mma_tf32.cuh`` must not reuse a library built
    from the old one. Checked on copies of the sources."""
    import shutil
    from repro_torch.kernels import _build
    names = [p.name for p in _build.inputs()]
    assert "mma_tf32.cuh" in names
    assert [p.name for p in _build.sources()] == [
        n for n in names if n.endswith(".cu")]
    for p in _build.inputs():
        shutil.copy(p, tmp_path / p.name)
    before = _build._digest(_build.inputs(tmp_path))
    assert before == _build._digest(_build.inputs())
    header = tmp_path / "mma_tf32.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._digest(_build.inputs(tmp_path)) != before
    source = tmp_path / "moe_gmm.cu"
    header.write_bytes((_build.CSRC / "mma_tf32.cuh").read_bytes())
    assert _build._digest(_build.inputs(tmp_path)) == before
    source.write_bytes(source.read_bytes() + b" ")
    assert _build._digest(_build.inputs(tmp_path)) != before


@pytest.mark.parametrize("kernel", ["flash_attention", "moe_gmm",
                                    "quantize_int8"])
def test_variant_refuses_cpu_tensors(kernel):
    """``variant`` names the CUDA kernel a call would run; on CPU tensors
    it raises (the wrapper's checks run before the library is loaded),
    as the kernel itself would."""
    if kernel == "flash_attention":
        args = (torch.zeros((1, 2, 4, 16)),) * 3
        fn = tfa.variant
    elif kernel == "moe_gmm":
        args = (torch.zeros((2, 3, 8)), torch.zeros((2, 8, 5)))
        fn = tgmm.variant
    else:
        args = (torch.zeros((4, 64)),)
        fn = tq.variant
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)

"""Selective SSM (S6 / Mamba-1) mixer of the port's model zoo, used by
Jamba's mamba layers; the counterpart of the JAX package's
``repro/models/mamba.py``.

Prefill (``mamba_mixer``) runs the recurrence through
``ops.selective_scan``: the hand-written CUDA kernel on a CUDA tensor,
the plain sequential loop on a CPU tensor, from h = 0. Where the JAX
package solves it with a chunked ``lax.associative_scan`` (``ssm_scan``,
the Pallas kernel's oracle), the kernel walks the whole sequence itself,
so no chunk has its counterpart here; the mixer still accepts only the
lengths ``ssm_scan`` accepts, so both packages take the same inputs.
Decode (``mamba_decode``) is the O(1) recurrent step on a cached state
and conv tail, in plain torch with no kernel, as the JAX package
computes it.

The JAX package's sharding constraints are the identity on one device,
and its ``reduce_dtype`` is ``None`` without mesh rules: neither has a
counterpart here.

``mamba_mixer_sharded`` runs the mixer on a mesh of more than one
device (``models/layers.py``'s ``*_sharded`` conventions) with
``d_inner`` split over ``model``: position j takes the channels j of
both halves of ``w_in`` (its u and its z columns: ``w_in``'s model
parts are contiguous blocks of the joint 2 d_inner columns, so a
column map, ``Layout.columns``, cuts them), its channels of the conv,
``w_dt``, ``b_dt``, ``a_log``, ``d_skip``, its rows of ``w_x`` and
``w_out``. ``u @ w_x`` is a partial product: its sum at the row's home
gives every position the whole dt_rank input, B and C. The scan kernel
runs on (b_row, s, d_inner / n) of the row whole (``Layout.enter``)
and the partial products with ``w_out`` are summed back into the row
(``Layout.leave``). Under a sequence split the row is gathered, as
RWKV's is (``models/rwkv.py``): the causal conv and the scan see the
whole sequence, and the ``w_x`` sum stays inside the layer, on the
gathered sequence. Where ``d_inner`` does not split over
``model`` (even where 2 d_inner does, so that ``w_in`` alone is split)
the mixer runs whole at the home, ``w_in`` gathered whole.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models.params import Spec

# the JAX package's ssm_scan chunk: a length must be a multiple of
# min(CHUNK, s)
CHUNK = 128


def mamba_spec(cfg: ModelConfig):
    mb = cfg.mamba
    d = cfg.d_model
    di = mb.d_inner(d)
    return {
        "w_in": Spec((d, 2 * di), ("embed", "d_inner")),
        "conv_w": Spec((mb.d_conv, di), ("conv", "d_inner"), scale=0.5),
        "conv_b": Spec((di,), ("d_inner",), init="zeros"),
        "w_x": Spec((di, mb.dt_rank + 2 * mb.d_state), ("d_inner", None)),
        "w_dt": Spec((mb.dt_rank, di), ("dt_rank", "d_inner")),
        "b_dt": Spec((di,), ("d_inner",), init="ones", scale=-4.6,
                     dtype=torch.float32),   # softplus(-4.6) ~ 0.01
        "a_log": Spec((di, mb.d_state), ("d_inner", "state"), init="ones",
                      scale=0.0, dtype=torch.float32),
        "d_skip": Spec((di,), ("d_inner",), init="ones",
                       dtype=torch.float32),
        "w_out": Spec((di, d), ("d_inner", "embed")),
    }


def _conv1d(x, w, b):
    """Causal depthwise conv. x: (b, s, di); w: (k, di). A sum of the k
    shifted products, as the JAX package writes it: ``F.conv1d`` would
    run through cuDNN, in TF32 by default on the card."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, params, proj):
    """``u @ w_x`` (b, s, dt_rank + 2N) -> dt (b, s, di) fp32 and B/C
    (b, s, N) fp32."""
    mb = cfg.mamba
    dt_r, bmat, cmat = torch.split(
        proj, [mb.dt_rank, mb.d_state, mb.d_state], dim=-1)
    # F.softplus returns x itself above its threshold of 20, where
    # jax.nn.softplus gives x + log1p(exp(-x)): under 1e-8 relative
    dt = F.softplus((dt_r @ params["w_dt"]).float() + params["b_dt"])
    return dt, bmat.float(), cmat.float()


def _dt_b_c(cfg: ModelConfig, params, u):
    """u: (b, s, di) post-conv. Returns dt (b, s, di) fp32, B/C (b, s, N)
    fp32."""
    return _split_proj(cfg, params, u @ params["w_x"])


def _check_length(s: int) -> None:
    if s % min(CHUNK, s):
        raise ValueError(f"mamba_mixer: sequence length {s} is not a "
                         f"multiple of min({CHUNK}, s), which the JAX "
                         f"package's ssm_scan requires")


def _inner(params, x):
    """x (b, s, d) -> u (post-conv, silu) and z, (b, s, di) each."""
    xz = x @ params["w_in"]
    u, z = xz.chunk(2, dim=-1)
    return F.silu(_conv1d(u, params["conv_w"], params["conv_b"])), z


def _scan_out(params, dtype, u, z, dt, bmat, cmat):
    """The scan of u, the skip and the z gate, then ``w_out``."""
    a_mat = -torch.exp(params["a_log"])
    # the kernel takes contiguous dt, u (b, s, di) and B, C (b, s, N)
    y, _ = ops.selective_scan(dt, bmat.contiguous(), cmat.contiguous(),
                              u.contiguous(), a_mat)
    y = y + params["d_skip"] * u.float()
    y = y.to(dtype) * F.silu(z)
    return y @ params["w_out"]


def mamba_mixer(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Training / prefill. x: (b, s, d) -> (b, s, d)."""
    _check_length(x.shape[1])
    u, z = _inner(params, x)
    return _scan_out(params, x.dtype, u, z, *_dt_b_c(cfg, params, u))


def mamba_mixer_sharded(cfg: ModelConfig, lay, params, hs):
    """:func:`mamba_mixer` of each row (``hs`` in ``lay``'s form) over
    ``d_inner`` split across ``model``; see the module's doc."""
    _check_length(sum(c.shape[1] for c in lay.cells(hs[0])))
    di = cfg.mamba.d_inner(cfg.d_model)
    n = lay.n_tp(params["conv_w"])
    c = di // n
    w = {k: lay.weights(v, n) for k, v in params.items() if k != "w_in"}
    if "model" in params["w_in"].axes:
        w["w_in"] = lay.columns(params["w_in"], [
            [(j * c, (j + 1) * c), (di + j * c, di + (j + 1) * c)]
            for j in range(n)])
    else:
        w["w_in"] = lay.weights(params["w_in"], n)
    out = []
    for r, h in enumerate(hs):
        devs = [lay.dev(r, j) for j in range(n)]
        ps = [{k: v[j][r] for k, v in w.items()} for j in range(n)]
        xs = lay.enter(r, h, n)
        uz = [_inner(p, x) for p, x in zip(ps, xs)]
        proj = M.fan_out(M.psum([u @ p["w_x"] for p, (u, _) in zip(ps, uz)],
                                lay.home(r)), devs)
        out.append(lay.leave(r, [
            _scan_out(p, xs[0].dtype, u, z, *_split_proj(cfg, p, pr))
            for p, (u, z), pr in zip(ps, uz, proj)]))
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    mb = cfg.mamba
    di = mb.d_inner(cfg.d_model)
    return {
        "h": torch.zeros((batch, di, mb.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, mb.d_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(cfg: ModelConfig, params, x, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d). O(1) state update; ``cache`` is not changed."""
    xz = x @ params["w_in"]
    u, z = xz.chunk(2, dim=-1)
    window = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
    u = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"])
               + params["conv_b"])[:, None, :]
    dt, bmat, cmat = _dt_b_c(cfg, params, u)
    a_mat = -torch.exp(params["a_log"])
    a = torch.exp(dt[:, 0, :, None] * a_mat)            # (b, di, N)
    bx = (dt[:, 0] * u[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = a * cache["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None, :]
    y = y + params["d_skip"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"]
    return out, {"h": h, "conv": window[:, 1:].to(cache["conv"].dtype)}
